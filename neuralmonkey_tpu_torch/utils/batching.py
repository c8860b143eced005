"""Static-shape batch padding.

XLA compiles one program per input shape, so batches are padded to a
small fixed set of (batch, time) shapes (SURVEY.md §8.3 item 2): the
batch axis to the configured batch size, time axes to the next length
bucket. Masks keep the semantics exact; runners slice padding rows off
on collect.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Next-length buckets for time axes. Chosen to keep recompiles few while
# wasting <~25% padding FLOPs at any length; tails round to multiples
# of 64 (lane-friendly).
LENGTH_BUCKETS = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)

# Keys with these suffixes have a time axis at position 1 that is padded
# to a bucket; everything else is padded on the batch axis only.
TIME_PADDED_SUFFIXES = (".ids", ".mask", ".train_inputs",
                        ".train_targets", ".train_mask", ".seq",
                        ".seq_mask")


def bucket_length(length: int) -> int:
    for bucket in LENGTH_BUCKETS:
        if length <= bucket:
            return bucket
    return ((length + 63) // 64) * 64


def pad_batch(batch: Dict[str, np.ndarray], batch_size: int
              ) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad all arrays to static shapes. Returns (padded, real_size)."""
    real_size = None
    padded: Dict[str, np.ndarray] = {}
    for key, array in batch.items():
        array = np.asarray(array)
        if real_size is None:
            real_size = array.shape[0]
        elif array.shape[0] != real_size:
            raise ValueError(
                f"Inconsistent batch sizes: {key} has {array.shape[0]}, "
                f"expected {real_size}")
        pads = [(0, 0)] * array.ndim
        if batch_size > array.shape[0]:
            pads[0] = (0, batch_size - array.shape[0])
        elif array.shape[0] > batch_size:
            raise ValueError(
                f"Batch larger than batch_size: {array.shape[0]} > "
                f"{batch_size}")
        if array.ndim >= 2 and key.endswith(TIME_PADDED_SUFFIXES):
            target = bucket_length(array.shape[1])
            pads[1] = (0, target - array.shape[1])
        if any(p != (0, 0) for p in pads):
            array = np.pad(array, pads, mode="constant")
        padded[key] = array
    if real_size is None:
        raise ValueError("Empty batch")
    return padded, real_size
