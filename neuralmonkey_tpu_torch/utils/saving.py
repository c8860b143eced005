"""Checkpoints as ``.npz`` files with flat ``part/sub/leaf`` keys.

Counterpart of ``neuralmonkey_tpu/utils/saving.py``. The port keeps
the JAX package's parameter names and layouts, so both packages write
and read the same files: a JAX checkpoint loads into the port with no
renames and no transposes (``params_from_jax``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts (and lists/tuples) of leaves -> ``{"a/b/c": leaf}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for key, value in items:
        flat.update(flatten_tree(value, _join(prefix, key)))
    return flat


def map_leaves(fn, tree: Any, prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(flat name, leaf)``
    (lists and tuples become lists)."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, _join(prefix, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v, _join(prefix, i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _join(prefix: str, key: Any) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def save_tree(path: str, tree: Any, meta: Dict[str, Any] = None) -> None:
    """Write a tree of tensors as an ``.npz`` file at exactly ``path``,
    and ``meta`` (step, epoch, best score) beside it as
    ``<path>.meta.json``, as the JAX package does."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = {key: value.detach().cpu().numpy()
            for key, value in flatten_tree(tree).items()}
    tmp_path = path + ".tmp"
    # np.savez appends .npz to a path without it; write via a file
    with open(tmp_path, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp_path, path)
    if meta is not None:
        with open(path + ".meta.json", "w", encoding="utf-8") as f:
            json.dump(meta, f)


def load_meta(path: str) -> Optional[Dict[str, Any]]:
    """The meta of a checkpoint (through a ``.best`` link to its
    target), or None."""
    meta_path = os.path.realpath(path) + ".meta.json"
    if not os.path.exists(meta_path):
        return None
    with open(meta_path, encoding="utf-8") as f:
        return json.load(f)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path, allow_pickle=False) as data:
        return {key: data[key] for key in data.files}


def params_from_jax(flat: Dict[str, np.ndarray],
                    template: Any) -> Any:
    """The JAX package's parameters (flat keys, numpy arrays, as its
    ``utils/saving.py`` ``flatten_tree`` or a checkpoint give them) as
    a tree of float32 tensors shaped like ``template``, the
    port's own initialization. Every key and shape must match the
    template: a missing or extra key or a shape mismatch raises."""
    expected = flatten_tree(template)
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise KeyError(f"checkpoint keys differ from the model: missing "
                       f"{missing[:5]}, extra {extra[:5]}")
    for key, value in expected.items():
        if tuple(np.shape(flat[key])) != tuple(value.shape):
            raise ValueError(
                f"checkpoint shape mismatch at '{key}': "
                f"{tuple(np.shape(flat[key]))} vs expected "
                f"{tuple(value.shape)}")

    def rebuild(node: Any, prefix: str) -> Any:
        if isinstance(node, dict):
            return {k: rebuild(v, _join(prefix, k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rebuild(v, _join(prefix, i)) for i, v in enumerate(node)]
        return torch.from_numpy(np.array(flat[prefix], dtype=np.float32))

    return rebuild(template, "")
