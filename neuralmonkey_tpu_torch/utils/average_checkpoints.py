"""Checkpoint parameter averaging (counterpart of
``neuralmonkey_tpu/utils/average_checkpoints.py``): the checkpoints'
parameters folded into one set, decoded in one forward pass where a
logit ensemble takes one a checkpoint.

Usage: python -m neuralmonkey_tpu_torch.utils.average_checkpoints \\
           out.npz ckpt1 ckpt2 [...]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from ..logging import log
from .saving import load_flat


def average_flat(flats: List[Dict[str, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
    """The mean of each key over ``flats`` (flat checkpoints with the
    same keys, in the first's order), summed in float32 (float64 for
    float64 leaves) and cast back to the leaf's dtype."""
    keys = set(flats[0])
    for flat in flats[1:]:
        if set(flat) != keys:
            raise ValueError(
                "Checkpoints have different parameter sets; "
                f"e.g. {sorted(keys ^ set(flat))[:3]}")

    def mean(key):
        stack = [flat[key] for flat in flats]
        out = np.mean(stack, axis=0, dtype=np.float64
                      if stack[0].dtype == np.float64 else np.float32)
        return out.astype(stack[0].dtype)

    return {key: mean(key) for key in flats[0]}


def average_checkpoints(paths: List[str], out_path: str) -> None:
    """Write the average of the checkpoints at ``paths`` to
    ``out_path`` (through a temporary file and a rename)."""
    averaged = average_flat([load_flat(path) for path in paths])
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **averaged)
    os.replace(tmp, out_path)
    log(f"Averaged {len(paths)} checkpoints -> {out_path}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="neuralmonkey_tpu_torch.utils.average_checkpoints")
    parser.add_argument("output", help="output checkpoint path")
    parser.add_argument("checkpoints", nargs="+",
                        help="input checkpoint paths")
    args = parser.parse_args(argv)
    average_checkpoints(args.checkpoints, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
