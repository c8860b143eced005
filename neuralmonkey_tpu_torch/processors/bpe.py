"""Byte-pair-encoding pre- and postprocessors (counterpart of
``neuralmonkey_tpu/processors/bpe.py``).

The algorithm of Sennrich et al. (2016), merge-file compatible with
subword-nmt (the ``#version:`` header, ``</w>`` end-of-word handling).
The JAX package's C++ codec is not ported: words are merged by the
Python loop below, with a per-word cache.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..logging import log


def join_subwords(sentence: List[str], separator: str) -> List[str]:
    """Glue ``separator``-marked subwords back into words."""
    output: List[str] = []
    joining = False
    for token in sentence:
        ends_joined = token.endswith(separator)
        core = token[: -len(separator)] if ends_joined else token
        if joining and output:
            output[-1] += core
        else:
            output.append(core)
        joining = ends_joined
    return output


class BPECodec:
    """Applies a learned BPE merge table to tokenized words."""

    def __init__(self, merge_file: str, separator: str = "@@",
                 encoding: str = "utf-8") -> None:
        self.separator = separator
        self.version = (0, 1)
        self.bpe_codes: Dict[Tuple[str, str], int] = {}
        with open(merge_file, encoding=encoding) as f:
            first = f.readline()
            if first.startswith("#version:"):
                ver = first.strip().split(":")[1].strip()
                self.version = tuple(int(x) for x in ver.split("."))
            else:
                self._add_code(first)
            for line in f:
                self._add_code(line)
        self._cache: Dict[str, List[str]] = {}
        log(f"BPE codes loaded from {merge_file} "
            f"({len(self.bpe_codes)} merges, v{self.version})")

    def _add_code(self, line: str) -> None:
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            return
        parts = line.split()
        if len(parts) >= 2:
            pair = (parts[0], parts[1])
            if pair not in self.bpe_codes:
                self.bpe_codes[pair] = len(self.bpe_codes)

    def _encode_word(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        if not word:
            return []
        if self.version >= (0, 2):
            symbols = list(word[:-1]) + [word[-1] + "</w>"]
        else:
            symbols = list(word) + ["</w>"]

        while len(symbols) > 1:
            best_rank, best_i = min(
                (self.bpe_codes.get((symbols[i], symbols[i + 1]),
                                    float("inf")), i)
                for i in range(len(symbols) - 1))
            if best_rank == float("inf"):
                break
            first, second = symbols[best_i], symbols[best_i + 1]
            merged: List[str] = []
            i = 0
            while i < len(symbols):
                if (i < len(symbols) - 1 and symbols[i] == first
                        and symbols[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged

        # strip the end-of-word marker
        if symbols[-1] == "</w>":
            symbols = symbols[:-1]
        elif symbols[-1].endswith("</w>"):
            symbols = symbols[:-1] + [symbols[-1][: -len("</w>")]]
        out = [s + self.separator for s in symbols[:-1]] + [symbols[-1]]
        self._cache[word] = out
        return out

    def encode(self, sentence: List[str]) -> List[str]:
        output: List[str] = []
        for word in sentence:
            output.extend(self._encode_word(word))
        return output

    def decode(self, sentence: List[str]) -> List[str]:
        return join_subwords(sentence, self.separator)


class BPEPreprocessor:
    """Config-visible preprocessor: tokens -> BPE subwords."""

    def __init__(self, merge_file: str, separator: str = "@@",
                 encoding: str = "utf-8") -> None:
        self.codec = BPECodec(merge_file, separator, encoding)

    def __call__(self, sentence: List[str]) -> List[str]:
        return self.codec.encode(sentence)


class BPEPostprocessor:
    """Config-visible postprocessor: BPE subwords -> tokens, over a
    batch of sentences."""

    def __init__(self, separator: str = "@@") -> None:
        self.separator = separator

    def decode(self, sentence: List[str]) -> List[str]:
        return join_subwords(sentence, self.separator)

    def __call__(self, decoded_sentences: List[List[str]]
                 ) -> List[List[str]]:
        return [self.decode(s) for s in decoded_sentences]
