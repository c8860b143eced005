"""Word error rate (counterpart of ``neuralmonkey_tpu/evaluators/wer.py``,
reference nm/evaluators/wer.py). Lower is better."""

from __future__ import annotations

from typing import List, Sequence

from .edit_distance import levenshtein
from .evaluator import Evaluator


class WEREvaluator(Evaluator):
    """Corpus WER: total edit distance / total reference length."""

    def __call__(self, hypotheses: Sequence[List[str]],
                 references: Sequence[List[str]]) -> float:
        if len(hypotheses) != len(references):
            raise ValueError("Hypotheses and references differ in length")
        total_dist = 0
        total_len = 0
        for hyp, ref in zip(hypotheses, references):
            total_dist += levenshtein(hyp, ref)
            total_len += len(ref)
        if total_len == 0:
            return 0.0 if total_dist == 0 else float(total_dist)
        return total_dist / total_len

    @staticmethod
    def compare_scores(score1: float, score2: float) -> int:
        return (score1 < score2) - (score1 > score2)


WER = WEREvaluator(name="WER")
