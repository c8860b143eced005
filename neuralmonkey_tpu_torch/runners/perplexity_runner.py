"""Perplexity runner (counterpart of
``neuralmonkey_tpu/runners/perplexity_runner.py``, reference
nm/runners/perplexity_runner.py): per-sentence perplexities from the
teacher-forced cross-entropy."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..model.part import Context
from .base_runner import BaseRunner, ExecutionResult


class PerplexityRunner(BaseRunner):

    @property
    def loss_names(self) -> List[str]:
        return ["xents"]

    def fetches(self, ctx: Context) -> Dict:
        return {"xents": self.decoder.train_xents(ctx),
                "mask": ctx.batch[self.decoder.target_mask_key]}

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        xents = np.asarray(fetched["xents"])[:num_examples]
        lengths = np.asarray(fetched["mask"])[:num_examples].sum(axis=1)
        per_token = xents / np.maximum(lengths, 1.0)
        return ExecutionResult(outputs=[float(p) for p in np.exp(per_token)],
                               losses={"xents": float(np.mean(per_token))},
                               size=num_examples)
