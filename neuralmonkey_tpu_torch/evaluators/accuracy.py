"""Token- and sequence-level accuracy (counterpart of
``neuralmonkey_tpu/evaluators/accuracy.py``, reference
nm/evaluators/accuracy.py)."""

from __future__ import annotations

from typing import Any, List, Sequence

from .evaluator import Evaluator, SequenceEvaluator


class AccuracyEvaluator(SequenceEvaluator):
    """Per-token accuracy over aligned sequences (also accepts scalar
    labels, treating each example as a length-1 sequence)."""

    def __call__(self, hypotheses: Sequence[Any],
                 references: Sequence[Any]) -> float:
        if len(hypotheses) != len(references):
            raise ValueError("Hypotheses and references differ in length")
        correct = 0
        total = 0
        for hyp, ref in zip(hypotheses, references):
            if isinstance(hyp, (list, tuple)) \
                    and isinstance(ref, (list, tuple)):
                for h, r in zip(hyp, ref):
                    total += 1
                    correct += int(str(h) == str(r))
            else:
                total += 1
                correct += int(str(hyp) == str(ref))
        return correct / total if total else 0.0


class AccuracySeqLevelEvaluator(Evaluator):
    """Whole-sequence exact-match accuracy."""

    def score_instance(self, hypothesis: Any, reference: Any) -> float:
        return float(hypothesis == reference)


Accuracy = AccuracyEvaluator(name="Accuracy")
AccuracySeqLevel = AccuracySeqLevelEvaluator(name="AccuracySeqLevel")
