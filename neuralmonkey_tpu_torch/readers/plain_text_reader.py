"""Plain-text readers (reference nm/readers/plain_text_reader.py).

Readers are callables ``(paths) -> iterable of items``; text readers
yield token lists. Gzip files are handled transparently.
"""

from __future__ import annotations

import gzip
from typing import Callable, Iterable, List


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="utf-8")
    return open(path, encoding="utf-8")


def tokenized_text_reader(paths: List[str]) -> Iterable[List[str]]:
    """Whitespace-tokenized UTF-8 text, one sentence per line."""
    for path in paths:
        with _open(path) as f:
            for line in f:
                yield line.rstrip("\n").split()


def string_reader(paths: List[str]) -> Iterable[str]:
    """Raw lines (no tokenization) — e.g. file names for image readers."""
    for path in paths:
        with _open(path) as f:
            for line in f:
                yield line.rstrip("\n")


def column_separated_reader(column: int, delimiter: str = "\t",
                            header: bool = False) -> Callable:
    """Reader factory: pick one column of a delimited file, tokenize."""
    def reader(paths: List[str]) -> Iterable[List[str]]:
        for path in paths:
            with _open(path) as f:
                lines = iter(f)
                if header:
                    next(lines, None)
                for line in lines:
                    fields = line.rstrip("\n").split(delimiter)
                    yield fields[column].split()
    return reader


def t2t_tokenized_text_reader(paths: List[str]) -> Iterable[List[str]]:
    """Tensor2tensor-style tokenization: split words/non-words, preserve
    inner spaces as token joiners."""
    import re
    pattern = re.compile(r"\w+|[^\w\s]+", re.UNICODE)
    for path in paths:
        with _open(path) as f:
            for line in f:
                yield pattern.findall(line.rstrip("\n"))


# Reference-compatible alias: the default reader.
UtfPlainTextReader = tokenized_text_reader
T2TReader = t2t_tokenized_text_reader
