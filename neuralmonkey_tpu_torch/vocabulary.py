"""Vocabulary: token <-> id mapping with special symbols.

The port's own copy of ``neuralmonkey_tpu/vocabulary.py``, with the
pure-Python id encoder only: the JAX package's C++ fill loop
(``neuralmonkey_tpu/native/``) is not ported.

TPU-native rebuild of the reference vocabulary (SURVEY.md §3.1, reference:
nm/vocabulary.py). File formats (plain wordlists with optional counts) are
preserved so existing vocabulary files load unchanged. Special tokens and
their fixed indices match the reference:

    <pad>=0, <s>=1, </s>=2, <unk>=3

Unlike the reference (time-major TF feeds), tensors here are batch-major
``(batch, time)`` numpy int32 arrays plus float mask — the natural layout
for JAX/TPU where the batch dimension shards over the ``data`` mesh axis.
"""

from __future__ import annotations

import collections
import gzip
import json
import os
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .logging import log, warn

PAD_TOKEN = "<pad>"
START_TOKEN = "<s>"
END_TOKEN = "</s>"
UNK_TOKEN = "<unk>"

SPECIAL_TOKENS = [PAD_TOKEN, START_TOKEN, END_TOKEN, UNK_TOKEN]

PAD_TOKEN_INDEX = 0
START_TOKEN_INDEX = 1
END_TOKEN_INDEX = 2
UNK_TOKEN_INDEX = 3


def _open_maybe_gzip(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode, encoding="utf-8")
    return open(path, mode, encoding="utf-8")


class Vocabulary:
    """Ordered token vocabulary with the reference's special symbols."""

    def __init__(self, tokens: Optional[Iterable[str]] = None,
                 unk_sample_prob: float = 0.0) -> None:
        self.index_to_word: List[str] = list(SPECIAL_TOKENS)
        self.word_to_index: Dict[str, int] = {
            t: i for i, t in enumerate(self.index_to_word)}
        self.word_count: Dict[str, int] = {t: 0 for t in SPECIAL_TOKENS}
        self.unk_sample_prob = unk_sample_prob
        if tokens is not None:
            self.add_tokenized_text(list(tokens))

    # ------------------------------------------------------------------ #
    # construction / mutation
    # ------------------------------------------------------------------ #
    def add_word(self, word: str, occurences: int = 1) -> None:
        if word not in self.word_to_index:
            self.word_to_index[word] = len(self.index_to_word)
            self.index_to_word.append(word)
            self.word_count[word] = 0
        self.word_count[word] += occurences

    def add_tokenized_text(self, tokenized_text: Sequence[str]) -> None:
        for word in tokenized_text:
            self.add_word(word)

    def truncate(self, size: int) -> None:
        """Keep only the `size` most frequent words (plus specials)."""
        if size < len(SPECIAL_TOKENS):
            raise ValueError(
                f"Cannot truncate vocabulary below {len(SPECIAL_TOKENS)}")
        words = [w for w in self.index_to_word if w not in SPECIAL_TOKENS]
        words.sort(key=lambda w: self.word_count.get(w, 0), reverse=True)
        kept = words[: size - len(SPECIAL_TOKENS)]
        self.index_to_word = list(SPECIAL_TOKENS) + kept
        self.word_to_index = {t: i for i, t in enumerate(self.index_to_word)}
        self.word_count = {w: self.word_count.get(w, 0)
                           for w in self.index_to_word}

    def truncate_by_min_freq(self, min_freq: int) -> None:
        if min_freq <= 1:
            return
        kept = [w for w in self.index_to_word
                if w in SPECIAL_TOKENS or self.word_count.get(w, 0) >= min_freq]
        self.index_to_word = kept
        self.word_to_index = {t: i for i, t in enumerate(kept)}
        self.word_count = {w: self.word_count.get(w, 0) for w in kept}

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.index_to_word)

    def __contains__(self, word: str) -> bool:
        return word in self.word_to_index

    def get_word_index(self, word: str) -> int:
        return self.word_to_index.get(word, UNK_TOKEN_INDEX)

    def get_unk_sampled_word_index(self, word: str) -> int:
        """Optionally replace rare words by <unk> during training
        (reference's unk-sampling regularizer)."""
        idx = self.word_to_index.get(word, UNK_TOKEN_INDEX)
        if (self.unk_sample_prob > 0.0 and idx >= len(SPECIAL_TOKENS)
                and self.word_count.get(word, 0) <= 1
                and random.random() < self.unk_sample_prob):
            return UNK_TOKEN_INDEX
        return idx

    # ------------------------------------------------------------------ #
    # tensor conversion (batch-major for TPU)
    # ------------------------------------------------------------------ #
    def sentences_to_tensor(
        self,
        sentences: Sequence[Sequence[str]],
        max_len: Optional[int] = None,
        pad_to_max_len: bool = False,
        train_mode: bool = False,
        add_start_symbol: bool = False,
        add_end_symbol: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Convert tokenized sentences to a padded id matrix and mask.

        Returns ``(ids, mask)`` of shape ``(batch, time)``; ``mask`` is
        float32, 1.0 over real tokens (including the end symbol when
        added), 0.0 over padding — the same weighting the reference used
        for per-token loss masking.
        """
        lengths = [len(s) for s in sentences]
        extra = (1 if add_start_symbol else 0) + (1 if add_end_symbol else 0)
        tgt_len = (max(lengths) if lengths else 0) + extra
        if max_len is not None:
            cap = max_len + extra
            tgt_len = cap if pad_to_max_len else min(tgt_len, cap)
        tgt_len = max(tgt_len, 1)

        batch = len(sentences)
        ids = np.full((batch, tgt_len), PAD_TOKEN_INDEX, dtype=np.int32)
        mask = np.zeros((batch, tgt_len), dtype=np.float32)

        lookup = (self.get_unk_sampled_word_index if train_mode
                  else self.get_word_index)

        for b, sent in enumerate(sentences):
            if max_len is not None:
                sent = list(sent)[:max_len]
            toks: List[int] = []
            if add_start_symbol:
                toks.append(START_TOKEN_INDEX)
            toks.extend(lookup(w) for w in sent)
            if add_end_symbol:
                toks.append(END_TOKEN_INDEX)
            toks = toks[:tgt_len]
            ids[b, : len(toks)] = toks
            mask[b, : len(toks)] = 1.0
        return ids, mask

    def vectors_to_sentences(
        self, vectors: np.ndarray
    ) -> List[List[str]]:
        """Convert a ``(batch, time)`` id matrix back to token lists,
        cutting each sentence at the first ``</s>``."""
        vectors = np.asarray(vectors)
        if vectors.ndim != 2:
            raise ValueError(
                f"Expected (batch, time) matrix, got shape {vectors.shape}")
        sentences: List[List[str]] = []
        for row in vectors:
            sent: List[str] = []
            for idx in row:
                idx = int(idx)
                if idx == END_TOKEN_INDEX:
                    break
                if idx in (PAD_TOKEN_INDEX, START_TOKEN_INDEX):
                    continue
                if 0 <= idx < len(self.index_to_word):
                    sent.append(self.index_to_word[idx])
                else:
                    sent.append(UNK_TOKEN)
            sentences.append(sent)
        return sentences

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #
    def save_wordlist(self, path: str, overwrite: bool = False,
                      save_frequencies: bool = False) -> None:
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(f"Wordlist file exists: {path}")
        with _open_maybe_gzip(path, "wt") as f:
            for word in self.index_to_word:
                if save_frequencies:
                    f.write(f"{word}\t{self.word_count.get(word, 0)}\n")
                else:
                    f.write(word + "\n")
        log(f"Vocabulary of size {len(self)} saved to {path}")

    def log_sample(self, size: int = 5) -> None:
        sample = random.sample(self.index_to_word,
                               min(size, len(self.index_to_word)))
        log(f"Vocabulary sample: {sample}")


# ---------------------------------------------------------------------- #
# factory functions (config-visible API, names match the reference)
# ---------------------------------------------------------------------- #
def from_wordlist(path: str,
                  encoding: str = "utf-8",
                  contains_header: bool = False,
                  contains_frequencies: bool = False) -> Vocabulary:
    """Load a vocabulary from a wordlist file (one token per line,
    optionally ``token<TAB>count``). Special tokens in the file are kept
    at their positions if present; otherwise they are prepended."""
    del encoding  # always utf-8; kept for config compatibility
    vocab = Vocabulary()
    seen_specials = 0
    with _open_maybe_gzip(path) as f:
        lines = f.read().splitlines()
    if contains_header:
        lines = lines[1:]
    for i, line in enumerate(lines):
        if not line:
            continue
        if contains_frequencies:
            parts = line.rsplit("\t", 1)
            if len(parts) != 2:
                raise ValueError(
                    f"Vocabulary file {path} line {i}: expected "
                    f"'word<TAB>count', got {line!r}")
            word, count = parts[0], int(parts[1])
        else:
            word, count = line, 1
        if word in SPECIAL_TOKENS:
            seen_specials += 1
            continue
        vocab.add_word(word, count)
    if 0 < seen_specials < len(SPECIAL_TOKENS):
        warn(f"Vocabulary {path} contains only {seen_specials} of "
             f"{len(SPECIAL_TOKENS)} special tokens")
    log(f"Vocabulary of size {len(vocab)} loaded from wordlist {path}")
    return vocab


def from_t2t_vocabulary(path: str, encoding: str = "utf-8") -> Vocabulary:
    """Load a tensor2tensor-style vocabulary (quoted tokens, one per
    line)."""
    del encoding
    vocab = Vocabulary()
    with _open_maybe_gzip(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("'") and line.endswith("'") and len(line) >= 2:
                line = line[1:-1]
            if not line or line in ("<pad>", "<EOS>") or line in SPECIAL_TOKENS:
                continue
            vocab.add_word(line)
    log(f"Vocabulary of size {len(vocab)} loaded from t2t file {path}")
    return vocab


def from_nematus_json(path: str, max_size: Optional[int] = None,
                      pad_to_max_size: bool = False) -> Vocabulary:
    """Load a nematus-style JSON vocabulary {token: id}."""
    with open(path, encoding="utf-8") as f:
        contents = json.load(f)
    vocab = Vocabulary()
    for word, _ in sorted(contents.items(), key=lambda kv: kv[1]):
        if word in SPECIAL_TOKENS or word in ("eos", "UNK"):
            continue
        vocab.add_word(word)
        if max_size is not None and len(vocab) >= max_size:
            break
    if pad_to_max_size and max_size is not None:
        pad_id = 0
        while len(vocab) < max_size:
            vocab.add_word(f"<pad_{pad_id}>")
            pad_id += 1
    return vocab


def from_bpe(path: str, encoding: str = "utf-8") -> Vocabulary:
    """Build a vocabulary from a BPE merges file (reference factory):
    every merge's left/right pieces and their concatenation become
    tokens, so any BPE-segmented text is coverable."""
    del encoding
    vocab = Vocabulary()
    with _open_maybe_gzip(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 2:
                continue
            left, right = parts
            merged = (left + right).replace("</w>", "")
            for piece in (left.replace("</w>", ""), merged):
                if piece:
                    vocab.add_word(piece)
                    vocab.add_word(piece + "@@")
    log(f"Vocabulary of size {len(vocab)} built from BPE merges {path}")
    return vocab


def from_dataset(datasets: Sequence, series_ids: Sequence[str],
                 max_size: int, save_file: Optional[str] = None,
                 overwrite: bool = False, min_freq: Optional[int] = None,
                 unk_sample_prob: float = 0.5) -> Vocabulary:
    """Build a vocabulary from dataset series (reference factory)."""
    vocab = Vocabulary(unk_sample_prob=unk_sample_prob)
    counter: collections.Counter = collections.Counter()
    for dataset in datasets:
        for series_id in series_ids:
            if not dataset.has_series(series_id):
                continue
            for sentence in dataset.get_series(series_id):
                counter.update(sentence)
    for word, count in counter.most_common():
        if min_freq is not None and count < min_freq:
            continue
        vocab.add_word(word, count)
    vocab.truncate(max_size + len(SPECIAL_TOKENS))
    log(f"Vocabulary of size {len(vocab)} built from dataset series "
        f"{list(series_ids)}")
    if save_file is not None:
        os.makedirs(os.path.dirname(save_file) or ".", exist_ok=True)
        vocab.save_wordlist(save_file, overwrite, save_frequencies=True)
    return vocab
