"""Sentence GLEU (counterpart of ``neuralmonkey_tpu/evaluators/gleu.py``,
reference nm/evaluators/gleu.py; Wu et al. 2016).

min(precision, recall) over the n-grams of orders 1..n: the reward of
self-critical training, since it behaves well on one sentence.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence

from .evaluator import Evaluator


def _ngrams(tokens: Sequence[str], max_n: int) -> Counter:
    counts: Counter = Counter()
    for order in range(1, max_n + 1):
        for i in range(len(tokens) - order + 1):
            counts[tuple(tokens[i:i + order])] += 1
    return counts


def gleu_sentence(hypothesis: Sequence[str], reference: Sequence[str],
                  max_n: int = 4) -> float:
    hyp_counts = _ngrams(hypothesis, max_n)
    ref_counts = _ngrams(reference, max_n)
    overlap = sum((hyp_counts & ref_counts).values())
    hyp_total = sum(hyp_counts.values())
    ref_total = sum(ref_counts.values())
    if hyp_total == 0 or ref_total == 0:
        return 0.0
    return min(overlap / hyp_total, overlap / ref_total)


class GLEUEvaluator(Evaluator):
    """The mean sentence GLEU of a corpus; ``deduplicate`` drops
    repeated neighbouring tokens of each hypothesis first."""

    def __init__(self, n: int = 4, deduplicate: bool = False,
                 name: str = None) -> None:
        super().__init__(name if name is not None else f"GLEU-{n}")
        self.n = n
        self.deduplicate = deduplicate

    def score_instance(self, hypothesis: List[str],
                       reference: List[str]) -> float:
        if self.deduplicate:
            hypothesis = [tok for i, tok in enumerate(hypothesis)
                          if i == 0 or hypothesis[i - 1] != tok]
        return gleu_sentence(hypothesis, reference, self.n)


GLEU = GLEUEvaluator()
