"""Beam-search runner (counterpart of
``neuralmonkey_tpu/runners/beam_search_runner.py``): the whole search
runs on the device; the runner picks the ``rank``-th hypothesis and
maps ids to tokens."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from ..model.part import Context
from .base_runner import BaseRunner, ExecutionResult


class BeamSearchRunner(BaseRunner):

    def __init__(self, output_series: str, decoder,
                 rank: int = 1,
                 postprocess: Callable = None,
                 visualize_attention: bool = False) -> None:
        # `decoder` is a BeamSearchDecoder wrapping the parent decoder
        super().__init__(output_series, decoder)
        if rank < 1 or rank > decoder.beam_size:
            raise ValueError(
                f"Rank must be in [1, beam_size={decoder.beam_size}], "
                f"got {rank}")
        self.rank = rank
        self.postprocess = postprocess
        # the search records the first attention's weights of the final
        # hypotheses (single model only); the training loop writes the
        # rank-th hypothesis's map as a PNG
        self.visualize_attention = visualize_attention

    @property
    def all_parts(self):
        return [self.decoder, self.decoder.parent_decoder]

    def fetches(self, ctx: Context) -> Dict:
        output = self.decoder.search(
            ctx, with_attention=self.visualize_attention)
        out = self._outputs(output)
        if output.attention is not None:
            out["attention"] = output.attention
        return out

    def ensemble_fetches(self, contexts: List[Context]) -> Dict:
        """The search of the models of ``contexts`` (one a parameter
        set), their distributions averaged at every step."""
        return self._outputs(self.decoder.ensemble_search(contexts))

    @staticmethod
    def _outputs(output) -> Dict:
        return {"token_ids": output.token_ids,
                "scores": output.scores,
                "lengths": output.lengths}

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        ids = np.asarray(fetched["token_ids"])[:num_examples]
        picked = ids[:, self.rank - 1, :]  # best-first sorted
        sentences = self.decoder.vocabulary.vectors_to_sentences(picked)
        if self.postprocess is not None:
            sentences = self.postprocess(sentences)
        scores = np.asarray(fetched["scores"])[:num_examples,
                                               self.rank - 1]
        aux = None
        if "attention" in fetched:
            # (B, K, T_out, T_src) -> the rank-th hypothesis's map, cut
            # to its emitted length
            att = np.asarray(fetched["attention"])[:num_examples,
                                                   self.rank - 1]
            lengths = np.asarray(fetched["lengths"])[:num_examples,
                                                     self.rank - 1]
            aux = {"attention": [m[:int(n)] if int(n) > 0 else m
                                 for m, n in zip(att, lengths)]}
        return ExecutionResult(
            outputs=sentences,
            losses={"beam_score": float(np.mean(scores))},
            size=num_examples, aux=aux)
