"""Greedy runner (counterpart of ``neuralmonkey_tpu/runners/runner.py``):
greedy decode on the device, ids -> tokens on the host, optional
postprocess. The JAX runner's loss fetches (``train_xent``,
``runtime_xent``) are not ported yet."""

from __future__ import annotations

from typing import Any, Callable, Dict

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

    def fetches(self, ctx: Context) -> Dict:
        return {"decoded": self.decoder.decoded(ctx)}

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        ids = np.asarray(fetched["decoded"])[:num_examples]
        sentences = self.decoder.vocabulary.vectors_to_sentences(ids)
        if self.postprocess is not None:
            sentences = self.postprocess(sentences)
        return ExecutionResult(outputs=sentences, losses={},
                               size=num_examples)


PlainRunner = GreedyRunner
