"""Sequence and context parallelism of the Transformer's residual stream
(counterpart of ``neuralmonkey_tpu/ops/sharding.py``).

The JAX package constrains the residual stream's (B, T, D) activations
to shard their time axis over ``model`` (Megatron sequence parallelism,
``sequence_sharding``) or ``context`` (the ring attention's context
parallelism), and GSPMD inserts the collectives. Here they are explicit:

- :func:`stream_axis` says which axis a pass of T steps splits its
  stream over: ``model`` under sequence sharding, ``context`` under
  context parallelism, or none where the axis does not divide T (the
  stream then stays whole on every rank, as at one device, which
  computes the same function as the JAX package's padded layout);
- :func:`constrain_sequence` takes this rank's slice of the whole
  stream, :func:`gather_sequence` gives every rank the whole stream
  back;
- inside a layer, :func:`enter_block` makes a block's input from the
  stream (under sequence sharding an all-gather of the time axis before
  the column-parallel projections; under plain tensor parallelism
  Megatron's f) and :func:`exit_block` returns the block's output to
  it (a reduce-scatter of the time axis after the row-parallel ones in
  place of the all-reduce; under plain tensor parallelism the
  all-reduce). Under context parallelism the blocks run on the slice and
  the attention rides the ring (``parallel/ring_attention.py``).

A parameter used on a slice of the time axis gets from each rank the
gradient of its slice alone: :func:`slice_params` sums those over the
stream's axis (the layer norms and the output biases under sequence
sharding; every layer parameter under context parallelism). The mesh
the manager registers says which axes are on (``parallel/mesh.py``,
its ``sequence`` flag for sequence sharding).
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import torch

from ..parallel import mesh, tensor

def stream_axis(time: int) -> Optional[str]:
    """The axis a residual stream of ``time`` steps splits over, or
    None (it stays whole)."""
    grid = mesh.current()
    if grid.sequence and grid.size("model") > 1:
        return "model" if time % grid.size("model") == 0 else None
    context = grid.size("context")
    if context > 1 and time % context == 0:
        return "context"
    return None


def constrain_sequence(x: torch.Tensor, axis: Optional[str],
                       time_axis: int = 1) -> torch.Tensor:
    """This rank's slice of the whole stream ``x`` along ``axis``."""
    return tensor.scatter_to(x, time_axis, axis) if axis else x


def gather_sequence(x: torch.Tensor, axis: Optional[str],
                    time_axis: int = 1) -> torch.Tensor:
    """The whole stream from the ranks' slices along ``axis``."""
    return tensor.gather_from(x, time_axis, axis) if axis else x


def time_slice(length: int, axis: Optional[str]) -> slice:
    """The positions of a ``length``-step time axis this rank holds."""
    if not axis:
        return slice(0, length)
    size = length // mesh.size(axis)
    start = mesh.index(axis) * size
    return slice(start, start + size)


def slice_params(tree: Any, axis: Optional[str]) -> Any:
    """``tree`` whose gradients are summed over ``axis`` (parameters a
    rank uses on its slice of the stream)."""
    return tensor.split_params(tree, axis) if axis else tree


def enter_block(x: torch.Tensor, split: bool, axis: Optional[str]
                ) -> torch.Tensor:
    """A block's input from the stream ``x``: ``split`` when the block's
    weights are split over the model axis."""
    if axis == "model":
        return tensor.gather_sum(x, 1) if split else tensor.gather_from(x, 1)
    return tensor.copy_to(x) if split else x


def exit_block(y: torch.Tensor, split: bool, axis: Optional[str]
               ) -> torch.Tensor:
    """A block's output ``y`` (its split weights' partial product when
    ``split``) back onto the stream."""
    if axis == "model":
        return (tensor.reduce_scatter(y, 1) if split
                else tensor.scatter_to(y, 1))
    return tensor.reduce_from(y) if split else y


def shard_seed(seed: Optional[int], axes: Iterable[str]) -> Optional[int]:
    """A dropout seed for a tensor split over ``axes``: each part draws
    its own mask (the index of the part folded in); None stays None."""
    if seed is None:
        return None
    from ..model.part import fold_seed
    index, split = 0, False
    for axis in axes:
        if axis and mesh.size(axis) > 1:
            index = index * mesh.size(axis) + mesh.index(axis)
            split = True
    return fold_seed(seed, index) if split else seed
