"""Label runner (counterpart of
``neuralmonkey_tpu/runners/label_runner.py``, reference
nm/runners/label_runner.py): per-token tags from a SequenceLabeler, cut
to each sentence's input length."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from ..model.part import Context
from .base_runner import BaseRunner, ExecutionResult


class LabelRunner(BaseRunner):

    def __init__(self, output_series: str, decoder,
                 postprocess: Callable = None) -> None:
        super().__init__(output_series, decoder)
        self.postprocess = postprocess

    @property
    def loss_names(self) -> List[str]:
        return ["loss"]

    def fetches(self, ctx: Context) -> Dict:
        out = {"decoded": self.decoder.decoded(ctx),
               "mask": self.decoder.input_mask(ctx)}
        if self.decoder.labels_key in ctx.batch:
            out["loss"] = self.decoder.train_loss(ctx)
        return out

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        ids = np.asarray(fetched["decoded"])[:num_examples]
        mask = np.asarray(fetched["mask"])[:num_examples]
        vocabulary = self.decoder.vocabulary
        sentences = [[vocabulary.index_to_word[int(i)]
                      for i in row[:int(m.sum())]]
                     for row, m in zip(ids, mask)]
        if self.postprocess is not None:
            sentences = self.postprocess(sentences)
        losses = ({"loss": float(fetched["loss"])}
                  if "loss" in fetched else {})
        return ExecutionResult(outputs=sentences, losses=losses,
                               size=num_examples)
