"""Corpus BLEU (reference nm/evaluators/bleu.py).

Pure-Python corpus-level BLEU with the reference's semantics: modified
n-gram precisions up to ``n`` (default 4), geometric mean, brevity
penalty. Zero precisions are handled with exponential smoothing in the
style of Chen & Cherry (2014) smoothing 3 — each zero-match order k
contributes precision 1/(2^j · total_k), j counting the zero orders so
far. On corpora with no higher-order matches this differs from NIST +1
smoothing (the reference used a raw geometric mean that hit -inf there;
any positive-match corpus scores identically).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence

from .evaluator import Evaluator


def _ngram_counts(sentence: Sequence[str], order: int) -> Counter:
    return Counter(
        tuple(sentence[i:i + order])
        for i in range(len(sentence) - order + 1))


class BLEUEvaluator(Evaluator):

    def __init__(self, n: int = 4, deduplicate: bool = False,
                 name: str = None,
                 multiple_references_separator: str = None) -> None:
        super().__init__(name if name is not None else f"BLEU-{n}")
        self.n = n
        self.deduplicate = deduplicate
        self.multiple_references_separator = multiple_references_separator

    def __call__(self, hypotheses: Sequence[List[str]],
                 references: Sequence[List[str]]) -> float:
        if len(hypotheses) != len(references):
            raise ValueError(
                "Hypotheses and references differ in length "
                f"({len(hypotheses)} vs {len(references)})")
        if self.deduplicate:
            hypotheses = [self._deduplicate(h) for h in hypotheses]
        listed_refs: List[List[List[str]]]
        if self.multiple_references_separator is not None:
            sep = self.multiple_references_separator
            listed_refs = [self._split_refs(r, sep) for r in references]
        else:
            listed_refs = [[list(r)] for r in references]
        return 100.0 * self.bleu(
            [list(h) for h in hypotheses], listed_refs, self.n)

    @staticmethod
    def _deduplicate(sentence: Sequence[str]) -> List[str]:
        out: List[str] = []
        for tok in sentence:
            if not out or out[-1] != tok:
                out.append(tok)
        return out

    @staticmethod
    def _split_refs(reference: Sequence[str], sep: str) -> List[List[str]]:
        refs: List[List[str]] = [[]]
        for token in reference:
            if token == sep:
                refs.append([])
            else:
                refs[-1].append(token)
        return refs

    @staticmethod
    def ngram_counts(sentence: Sequence[str], n: int,
                     lowercase: bool = False) -> Counter:
        if lowercase:
            sentence = [t.lower() for t in sentence]
        return _ngram_counts(sentence, n)

    @staticmethod
    def effective_reference_length(hypothesis: Sequence[str],
                                   references: Sequence[Sequence[str]]
                                   ) -> int:
        """Closest reference length (ties go to the shorter)."""
        hyp_len = len(hypothesis)
        return min((abs(len(r) - hyp_len), len(r))
                   for r in references)[1]

    @classmethod
    def modified_ngram_precision(
            cls, hypotheses: Sequence[Sequence[str]],
            references_list: Sequence[Sequence[Sequence[str]]],
            n: int) -> "tuple[int, int]":
        matched = 0
        total = 0
        for hyp, refs in zip(hypotheses, references_list):
            hyp_counts = _ngram_counts(hyp, n)
            max_ref: Counter = Counter()
            for ref in refs:
                for ngram, count in _ngram_counts(ref, n).items():
                    if count > max_ref[ngram]:
                        max_ref[ngram] = count
            for ngram, count in hyp_counts.items():
                matched += min(count, max_ref[ngram])
            total += sum(hyp_counts.values())
        return matched, total

    @classmethod
    def bleu(cls, hypotheses: Sequence[Sequence[str]],
             references_list: Sequence[Sequence[Sequence[str]]],
             ngrams: int = 4) -> float:
        log_precisions = []
        smooth = 1.0
        for order in range(1, ngrams + 1):
            matched, total = cls.modified_ngram_precision(
                hypotheses, references_list, order)
            if total == 0:
                if order == 1:
                    return 0.0
                # effective order: all hypotheses shorter than `order`
                break
            if matched == 0:
                # exponential smoothing (Chen & Cherry smoothing 3 style)
                smooth *= 2.0
                precision = 1.0 / (smooth * total)
            else:
                precision = matched / total
            log_precisions.append(math.log(precision))

        hyp_len = sum(len(h) for h in hypotheses)
        ref_len = sum(
            cls.effective_reference_length(h, refs)
            for h, refs in zip(hypotheses, references_list))
        if hyp_len == 0:
            return 0.0
        brevity = (1.0 if hyp_len >= ref_len
                   else math.exp(1.0 - ref_len / hyp_len))
        return brevity * math.exp(
            sum(log_precisions) / len(log_precisions))


# config-visible instances (reference exports these names)
BLEU = BLEUEvaluator()
BLEU1 = BLEUEvaluator(n=1, name="BLEU-1")
BLEU4 = BLEUEvaluator(n=4, name="BLEU-4")
BLEU4_dedup = BLEUEvaluator(n=4, deduplicate=True, name="BLEU-4-dedup")
