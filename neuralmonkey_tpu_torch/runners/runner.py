"""Greedy runner (counterpart of ``neuralmonkey_tpu/runners/runner.py``):
greedy decode on the device, ids -> tokens on the host, optional
postprocess. When the batch carries reference targets it also fetches
``train_xent`` and ``runtime_xent``; validation without an evaluator
tracks the best checkpoint by ``runtime_xent``."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from ..model.part import Context
from .base_runner import BaseRunner, ExecutionResult


class GreedyRunner(BaseRunner):

    def __init__(self, output_series: str, decoder,
                 postprocess: Callable = None,
                 visualize_attention: bool = False) -> None:
        super().__init__(output_series, decoder)
        if visualize_attention:
            raise NotImplementedError(
                "visualize_attention is not ported to "
                "neuralmonkey_tpu_torch yet")
        self.postprocess = postprocess

    @property
    def loss_names(self) -> List[str]:
        return ["train_xent", "runtime_xent"]

    def fetches(self, ctx: Context) -> Dict:
        # the runtime loss runs the logit-stacking greedy loop, so with
        # targets the ids come from it (memoized) rather than from the
        # early-exit loop that plain decoding uses
        if self.decoder.target_ids_key not in ctx.batch:
            return {"decoded": self.decoder.decoded(ctx)}
        return {"decoded": self.decoder.greedy_outputs(ctx)[1],
                "train_xent": self.decoder.train_loss(ctx),
                "runtime_xent": self.decoder.runtime_loss(ctx)}

    def ensemble_fetches(self, contexts: List[Context]) -> Dict:
        """Greedy ids of the models of ``contexts`` (one a parameter
        set), their distributions averaged at every step."""
        return {"decoded": self.decoder.ensemble_greedy_ids(contexts)}

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        ids = np.asarray(fetched["decoded"])[:num_examples]
        sentences = self.decoder.vocabulary.vectors_to_sentences(ids)
        if self.postprocess is not None:
            sentences = self.postprocess(sentences)
        losses = {name: float(fetched[name]) for name in self.loss_names
                  if name in fetched}
        return ExecutionResult(outputs=sentences, losses=losses,
                               size=num_examples)


PlainRunner = GreedyRunner
