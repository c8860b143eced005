"""Greedy runner (counterpart of ``neuralmonkey_tpu/runners/runner.py``):
greedy decode on the device, ids -> tokens on the host, optional
postprocess. When the batch carries reference targets it also fetches
``train_xent`` and ``runtime_xent``; validation without an evaluator
tracks the best checkpoint by ``runtime_xent``. With
``visualize_attention`` it fetches the first attention's weights too."""

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
        self.postprocess = postprocess
        # fetch the first attention's weights with the ids; the training
        # loop writes them as PNG maps at each new best validation
        self.visualize_attention = visualize_attention

    @property
    def loss_names(self) -> List[str]:
        return ["train_xent", "runtime_xent"]

    def fetches(self, ctx: Context) -> Dict:
        # the runtime loss and the attention maps run the logit-stacking
        # greedy loop, so then the ids come from it (memoized) rather
        # than from the early-exit loop that plain decoding uses
        wants_losses = self.decoder.target_ids_key in ctx.batch
        if not (wants_losses or self.visualize_attention):
            return {"decoded": self.decoder.decoded(ctx)}
        _, decoded, aux = self.decoder.greedy_outputs(ctx)
        out = {"decoded": decoded}
        if wants_losses:
            out["train_xent"] = self.decoder.train_loss(ctx)
            out["runtime_xent"] = self.decoder.runtime_loss(ctx)
        weights = aux.get("attention_weights", ())
        if self.visualize_attention and weights:
            # stacked (T_out, B, T_src) -> (B, T_out, T_src)
            out["attention"] = weights[0].transpose(0, 1)
        return out

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
        aux = None
        if "attention" in fetched:
            aux = {"attention":
                   np.asarray(fetched["attention"])[:num_examples]}
        return ExecutionResult(outputs=sentences, losses=losses,
                               size=num_examples, aux=aux)


PlainRunner = GreedyRunner
