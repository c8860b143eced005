"""Plain runner (counterpart of
``neuralmonkey_tpu/runners/plain_runner.py``, reference
nm/runners/plain_runner.py): single-label outputs from a Classifier, or
label sequences from any part with a (B, T)-shaped ``decoded`` (the CTC
decoder)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from ..model.part import Context
from .base_runner import BaseRunner, ExecutionResult


class PlainRunner(BaseRunner):

    def __init__(self, output_series: str, decoder,
                 postprocess: Callable = None) -> None:
        super().__init__(output_series, decoder)
        self.postprocess = postprocess

    @property
    def loss_names(self) -> List[str]:
        return ["loss"]

    def fetches(self, ctx: Context) -> Dict:
        out = {"decoded": self.decoder.decoded(ctx)}
        label_key = getattr(self.decoder, "label_key", None)
        if label_key is not None and label_key in ctx.batch:
            out["loss"] = self.decoder.train_loss(ctx)
        return out

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        ids = np.asarray(fetched["decoded"])[:num_examples]
        vocabulary = self.decoder.vocabulary
        if ids.ndim == 1:
            outputs = [[vocabulary.index_to_word[int(i)]] for i in ids]
        else:
            outputs = vocabulary.vectors_to_sentences(ids)
        if self.postprocess is not None:
            outputs = self.postprocess(outputs)
        losses = ({"loss": float(fetched["loss"])}
                  if "loss" in fetched else {})
        return ExecutionResult(outputs=outputs, losses=losses,
                               size=num_examples)
