"""Compute-precision policy (counterpart of
``neuralmonkey_tpu/ops/policy.py``).

Master parameters always live in float32: checkpoints, optimizer
moments and updates. Under ``bfloat16`` every forward pass casts the
matrix-shaped float32 parameters to bf16 at use (``Context.get_params``,
once per part and pass, under autograd, so gradients reach the float32
masters through the cast); vectors (biases, layer-norm scales) stay
float32. Parameter products then multiply bf16 operands and keep
float32 sums and outputs (``ops/nn.pdot``); losses, softmaxes, the
recurrent carries and the beam search's selection stay float32.

Selection precedence: :func:`set_compute_dtype` (the experiment's
``[main] compute_dtype`` key), then ``NM_COMPUTE_DTYPE``, then float32.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from ..parallel import tensor

_EXPLICIT: Optional[str] = None
_VALID = ("float32", "bfloat16")


def set_compute_dtype(name: Optional[str]) -> None:
    global _EXPLICIT
    if name is not None and name not in _VALID:
        raise ValueError(
            f"compute_dtype must be one of {_VALID}, got {name!r}")
    _EXPLICIT = name


def compute_dtype() -> Optional[torch.dtype]:
    """The activation dtype, or None for full float32."""
    name = _EXPLICIT or os.environ.get("NM_COMPUTE_DTYPE") or None
    if name in (None, "", "float32"):
        return None
    if name != "bfloat16":
        raise ValueError(f"Unsupported NM_COMPUTE_DTYPE {name!r}")
    return torch.bfloat16


def cast_params_for_compute(tree: Any) -> Any:
    """Cast the float32 leaves with two or more dims to the policy
    dtype; vectors (biases, layer-norm scales) stay float32."""
    dtype = compute_dtype()
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_params_for_compute(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_params_for_compute(v) for v in tree)
    if (isinstance(tree, torch.Tensor) and tree.dtype == torch.float32
            and tree.dim() >= 2):
        # a tensor-parallel shard stays marked as one
        return tensor.keep_split(tree, tree.to(dtype))
    return tree
