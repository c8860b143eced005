"""Logits runner (counterpart of
``neuralmonkey_tpu/runners/logits_runner.py``, reference
nm/runners/logits_runner.py): a decoder's logits, or with ``normalize``
its probabilities, as tab-separated strings, optionally of one
vocabulary entry only."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..model.part import Context
from .base_runner import BaseRunner, ExecutionResult


class LogitsRunner(BaseRunner):

    def __init__(self, output_series: str, decoder,
                 normalize: bool = True,
                 pick_index: int = None,
                 pick_value: str = None) -> None:
        super().__init__(output_series, decoder)
        self.normalize = normalize
        if pick_value is not None:
            pick_index = decoder.vocabulary.get_word_index(pick_value)
        self.pick_index = pick_index

    def fetches(self, ctx: Context) -> Dict:
        logits = (self.decoder.logits(ctx)
                  if hasattr(self.decoder, "logits")
                  else self.decoder.train_logits(ctx))
        if self.normalize:
            logits = torch.softmax(logits, dim=-1)
        return {"logits": logits}

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        values = np.asarray(fetched["logits"])[:num_examples]
        outputs = []
        for row in values:
            if self.pick_index is not None:
                picked = row[..., self.pick_index]
                outputs.append(
                    "\t".join(f"{v:.6f}" for v in np.atleast_1d(picked)))
            else:
                flat = (row.reshape(-1, row.shape[-1]) if row.ndim > 1
                        else row[None])
                outputs.append("\t".join(
                    ",".join(f"{v:.6f}" for v in step) for step in flat))
        return ExecutionResult(outputs=outputs, losses={},
                               size=num_examples)
