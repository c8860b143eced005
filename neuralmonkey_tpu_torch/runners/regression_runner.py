"""Regression runner (counterpart of
``neuralmonkey_tpu/runners/regression_runner.py``, reference
nm/runners/regression_runner.py)."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from ..model.part import Context
from .base_runner import BaseRunner, ExecutionResult


class RegressionRunner(BaseRunner):

    def __init__(self, output_series: str, decoder,
                 postprocess: Callable = None) -> None:
        super().__init__(output_series, decoder)
        self.postprocess = postprocess

    @property
    def loss_names(self) -> List[str]:
        return ["mse"]

    def fetches(self, ctx: Context) -> Dict:
        out = {"predictions": self.decoder.predictions(ctx)}
        if self.decoder.target_key in ctx.batch:
            out["mse"] = self.decoder.train_loss(ctx)
        return out

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        preds = np.asarray(fetched["predictions"])[:num_examples]
        if preds.shape[-1] == 1:
            outputs = [float(p[0]) for p in preds]
        else:
            outputs = [p.tolist() for p in preds]
        if self.postprocess is not None:
            outputs = self.postprocess(outputs)
        losses = ({"mse": float(fetched["mse"])}
                  if "mse" in fetched else {})
        return ExecutionResult(outputs=outputs, losses=losses,
                               size=num_examples)
