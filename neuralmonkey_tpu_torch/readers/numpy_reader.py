"""Numpy feature readers (counterpart of
``neuralmonkey_tpu/readers/numpy_reader.py``, reference
nm/readers/numpy_reader.py)."""

from __future__ import annotations

import os
from typing import Iterable, List

import numpy as np


def single_tensor(paths: List[str]) -> Iterable[np.ndarray]:
    """One big .npy/.npz per file; yields rows of the stacked tensor."""
    arrays = []
    for path in paths:
        loaded = np.load(path)
        if isinstance(loaded, np.lib.npyio.NpzFile):
            loaded = loaded[list(loaded.keys())[0]]
        arrays.append(loaded)
    tensor = np.concatenate(arrays, axis=0) if len(arrays) > 1 else arrays[0]
    yield from tensor


def from_file_list(prefix: str = "",
                   shape: List[int] = None,
                   suffix: str = "",
                   default_tensor_name: str = "arr_0"):
    """Reader factory: each line of the series file is the path of one
    example's .npy/.npz feature file (under ``prefix``, plus
    ``suffix``), reshaped to ``shape`` when given."""
    def reader(paths: List[str]) -> Iterable[np.ndarray]:
        for list_path in paths:
            with open(list_path, encoding="utf-8") as f:
                for line in f:
                    loaded = np.load(os.path.join(
                        prefix, line.rstrip("\n") + suffix))
                    if isinstance(loaded, np.lib.npyio.NpzFile):
                        loaded = loaded[default_tensor_name]
                    if shape is not None:
                        loaded = loaded.reshape(shape)
                    yield loaded
    return reader


# the reference's name
numpy_file_list_reader = from_file_list
