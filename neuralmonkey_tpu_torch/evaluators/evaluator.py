"""Evaluator protocol (reference nm/evaluators/evaluator.py)."""

from __future__ import annotations

from typing import Any, Callable, List, Sequence


def check_lengths(func: Callable) -> Callable:
    def wrapper(self, hypotheses, references, *args, **kwargs):
        if len(hypotheses) != len(references):
            raise ValueError(
                f"{getattr(self, 'name', type(self).__name__)}: hypothesis "
                f"and reference lists differ in length "
                f"({len(hypotheses)} vs {len(references)})")
        return func(self, hypotheses, references, *args, **kwargs)
    return wrapper


class Evaluator:
    """Base evaluator: higher score = better unless overridden."""

    def __init__(self, name: str = None) -> None:
        self.name = name if name is not None else type(self).__name__

    def __call__(self, hypotheses: Sequence[Any],
                 references: Sequence[Any]) -> float:
        if len(hypotheses) != len(references):
            raise ValueError("Hypotheses and references differ in length")
        if not hypotheses:
            return 0.0
        total = sum(self.score_instance(h, r)
                    for h, r in zip(hypotheses, references))
        return total / len(hypotheses)

    def score_instance(self, hypothesis: Any, reference: Any) -> float:
        raise NotImplementedError

    @staticmethod
    def compare_scores(score1: float, score2: float) -> int:
        """Return 1 if score1 is better, -1 if worse, 0 if equal."""
        return (score1 > score2) - (score1 < score2)


class SequenceEvaluator(Evaluator):
    """Evaluator over flat token sequences (token-level metrics)."""

    def __call__(self, hypotheses: Sequence[Sequence[Any]],
                 references: Sequence[Sequence[Any]]) -> float:
        if len(hypotheses) != len(references):
            raise ValueError("Hypotheses and references differ in length")
        correct = 0
        total = 0
        for hyp, ref in zip(hypotheses, references):
            for h, r in zip(hyp, ref):
                total += 1
                correct += int(self.compare_tokens(h, r))
        return correct / total if total else 0.0

    @staticmethod
    def compare_tokens(hyp_token: Any, ref_token: Any) -> bool:
        return hyp_token == ref_token
