"""Levenshtein distance and the edit-distance evaluator (counterpart of
``neuralmonkey_tpu/evaluators/edit_distance.py``, reference
nm/evaluators/edit_distance.py)."""

from __future__ import annotations

from typing import List, Sequence

from .evaluator import Evaluator


def levenshtein(seq1: Sequence, seq2: Sequence) -> int:
    """Token-level Levenshtein distance (insert/delete/substitute = 1)."""
    if len(seq1) < len(seq2):
        seq1, seq2 = seq2, seq1
    previous = list(range(len(seq2) + 1))
    for i, tok1 in enumerate(seq1, start=1):
        current = [i]
        for j, tok2 in enumerate(seq2, start=1):
            cost = 0 if tok1 == tok2 else 1
            current.append(min(previous[j] + 1,
                               current[j - 1] + 1,
                               previous[j - 1] + cost))
        previous = current
    return previous[-1]


class EditDistanceEvaluator(Evaluator):
    """Normalized edit similarity: 1 - dist/len(ref). Higher is better."""

    def score_instance(self, hypothesis: List[str],
                       reference: List[str]) -> float:
        if not reference and not hypothesis:
            return 1.0
        denom = max(len(reference), len(hypothesis), 1)
        return 1.0 - levenshtein(hypothesis, reference) / denom

    @staticmethod
    def compare_scores(score1: float, score2: float) -> int:
        return (score1 > score2) - (score1 < score2)


EditDistance = EditDistanceEvaluator(name="edit_distance")
