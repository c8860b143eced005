"""Word-alignment parsing (counterpart of
``neuralmonkey_tpu/processors/alignment.py``, reference
nm/processors/alignment.py):
reads Pharaoh-format alignments ("0-0 1-2 ...") into (tgt, src) index
pair lists; ``WordAlignmentPreprocessor`` turns them into dense
target-normalized matrices for the alignment objective."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def parse_alignment(line_tokens: List[str]) -> List[Tuple[int, int]]:
    """Tokenized "src-tgt" pairs -> [(src, tgt), ...]."""
    pairs = []
    for token in line_tokens:
        if not token:
            continue
        src, _, tgt = token.partition("-")
        pairs.append((int(src), int(tgt)))
    return pairs


class WordAlignmentPreprocessor:
    """Per-sentence preprocessor: pairs -> dense (tgt_len, src_len)
    matrix, rows normalized to distributions (as the reference's
    alignment target)."""

    def __init__(self, source_len: int, target_len: int,
                 dtype=np.float32,
                 normalize: bool = True,
                 zero_based: bool = True) -> None:
        self.source_len = source_len
        self.target_len = target_len
        self.dtype = dtype
        self.normalize = normalize
        self.zero_based = zero_based

    def __call__(self, sentence) -> np.ndarray:
        if sentence and isinstance(sentence[0], str):
            pairs = parse_alignment(sentence)
        else:
            pairs = list(sentence)
        matrix = np.zeros((self.target_len, self.source_len),
                          self.dtype)
        for src, tgt in pairs:
            if not self.zero_based:
                src, tgt = src - 1, tgt - 1
            if 0 <= tgt < self.target_len and 0 <= src < self.source_len:
                matrix[tgt, src] = 1.0
        if self.normalize:
            sums = matrix.sum(axis=1, keepdims=True)
            matrix = np.divide(matrix, sums,
                               out=np.zeros_like(matrix),
                               where=sums > 0)
        return matrix
