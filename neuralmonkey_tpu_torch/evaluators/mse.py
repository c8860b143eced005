"""Mean squared / absolute error (counterpart of
``neuralmonkey_tpu/evaluators/mse.py``, reference nm/evaluators/mse.py).
Lower is better."""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from .evaluator import Evaluator


class MeanSquaredErrorEvaluator(Evaluator):

    def score_instance(self, hypothesis: Any, reference: Any) -> float:
        hyp = np.asarray(hypothesis, dtype=np.float64)
        ref = np.asarray(reference, dtype=np.float64)
        return float(np.mean((hyp - ref) ** 2))

    @staticmethod
    def compare_scores(score1: float, score2: float) -> int:
        return (score1 < score2) - (score1 > score2)


class MeanAbsoluteErrorEvaluator(Evaluator):

    def score_instance(self, hypothesis: Any, reference: Any) -> float:
        hyp = np.asarray(hypothesis, dtype=np.float64)
        ref = np.asarray(reference, dtype=np.float64)
        return float(np.mean(np.abs(hyp - ref)))

    @staticmethod
    def compare_scores(score1: float, score2: float) -> int:
        return (score1 < score2) - (score1 > score2)


MSE = MeanSquaredErrorEvaluator(name="MSE")
MAE = MeanAbsoluteErrorEvaluator(name="MAE")
MeanSquaredError = MSE
