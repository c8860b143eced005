"""Dependency-free PNG writing (stdlib zlib and struct only), a copy of
``neuralmonkey_tpu/utils/png.py``: attention maps as 8-bit grayscale
heatmaps in the experiment output directory and in TensorBoard image
summaries. The two packages write the same bytes."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload)))


def png_bytes(array: np.ndarray,
              scale: int = 8,
              normalize: bool = True) -> "tuple[bytes, int, int]":
    """Encode a 2-D array as a grayscale PNG heatmap.

    Returns ``(png_data, height, width)``. ``scale`` integer-upsamples
    tiny matrices (attention maps are a few dozen cells) so they are
    visible; ``normalize`` maps [min, max] -> [0, 255].
    """
    data = np.asarray(array, np.float64)
    if data.ndim != 2:
        raise ValueError(f"Need a 2-D array, got shape {data.shape}")
    if normalize:
        lo, hi = float(data.min()), float(data.max())
        data = (data - lo) / (hi - lo) if hi > lo \
            else np.zeros_like(data)
    pixels = (np.clip(data, 0.0, 1.0) * 255).astype(np.uint8)
    if scale > 1:
        pixels = np.repeat(np.repeat(pixels, scale, axis=0),
                           scale, axis=1)
    height, width = pixels.shape
    raw = b"".join(b"\x00" + pixels[row].tobytes()
                   for row in range(height))
    header = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", header)
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    return png, height, width


def write_png(path: str, array: np.ndarray,
              scale: int = 8,
              normalize: bool = True) -> None:
    """Write a 2-D array as a grayscale PNG heatmap (see png_bytes)."""
    png, _, _ = png_bytes(array, scale=scale, normalize=normalize)
    with open(path, "wb") as f:
        f.write(png)
