"""Readers for float/int vectors stored as text lines (counterpart of
``neuralmonkey_tpu/readers/string_vector_reader.py``, reference
nm/readers/string_vector_reader.py)."""

from __future__ import annotations

from typing import Iterable, List

import numpy as np


def get_string_vector_reader(dtype=np.float32, columns: int = None):
    def reader(paths: List[str]) -> Iterable[np.ndarray]:
        for path in paths:
            with open(path, encoding="utf-8") as f:
                for lineno, line in enumerate(f, 1):
                    numbers = line.split()
                    if columns is not None and len(numbers) != columns:
                        raise ValueError(
                            f"{path}:{lineno}: expected {columns} columns, "
                            f"got {len(numbers)}")
                    yield np.array(numbers, dtype=dtype)
    return reader


def FloatVectorReader(paths: List[str]) -> Iterable[np.ndarray]:
    return get_string_vector_reader(np.float32)(paths)


def IntVectorReader(paths: List[str]) -> Iterable[np.ndarray]:
    return get_string_vector_reader(np.int32)(paths)
