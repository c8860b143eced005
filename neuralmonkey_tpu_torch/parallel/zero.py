"""ZeRO-1 and FSDP layouts over the data-parallel ranks (counterpart of
``TPUManager._add_data_axis``, ``_param_shardings`` and
``_opt_state_shardings`` in ``neuralmonkey_tpu/runtime.py``).

A :class:`Shard` says how one tensor divides among the ranks of the
``data`` axis: in equal chunks along one dim (the JAX package's rule:
the largest dim the number of ranks divides, the first of equal ones,
never the dim a tensor is split on over the ``model`` axis), whole on
one owner rank, or whole on every rank (a tensor with no such dim, a
scalar). Chunks and owners go in sorted name order into one flat buffer
a rank, so every collective moves one buffer in an order fixed on all
ranks. The tensors here are a rank's model shards: their collectives
run over its data group (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from . import distributed, tensor

Flat = Dict[str, torch.Tensor]


class Shard(NamedTuple):
    dim: Optional[int] = None    # equal chunks along this dim
    owner: Optional[int] = None  # whole on this rank alone

    @property
    def replicated(self) -> bool:
        return self.dim is None and self.owner is None


def data_axis(shape: Sequence[int], world: int,
              skip: Optional[int] = None) -> Optional[int]:
    """``_add_data_axis``: the largest dim that ``world`` divides (the
    first of equal ones) other than ``skip`` (the dim a tensor is split
    on over the model axis), or None (the tensor stays whole)."""
    if world <= 1:
        return None
    best = None
    for i, size in enumerate(shape):
        if i != skip and size % world == 0 and (
                best is None or size > shape[best]):
            best = i
    return best


def slice_plan(shapes: Dict[str, Sequence[int]], world: int,
               skip: Optional[Dict[str, Optional[int]]] = None
               ) -> Dict[str, Shard]:
    skip = skip or {}
    return {name: Shard(dim=data_axis(shape, world, skip.get(name)))
            for name, shape in shapes.items()}


def owner_plan(shapes: Dict[str, Sequence[int]], world: int
               ) -> Dict[str, Shard]:
    """Each tensor whole on one rank: in sorted name order, to the rank
    that holds the fewest elements so far (the lowest of equal ones)."""
    if world <= 1:
        return {name: Shard() for name in shapes}
    held = [0] * world
    plan = {}
    for name in sorted(shapes):
        owner = held.index(min(held))
        held[owner] += _numel(shapes[name])
        plan[name] = Shard(owner=owner)
    return plan


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for size in shape:
        n *= int(size)
    return n


def region(tensor: torch.Tensor, shard: Shard, rank: int, world: int
           ) -> Optional[torch.Tensor]:
    """Rank ``rank``'s part of the whole ``tensor`` (a view), or None
    where it holds none."""
    if shard.dim is not None:
        size = tensor.shape[shard.dim] // world
        return tensor.narrow(shard.dim, rank * size, size)
    if shard.owner is not None and shard.owner != rank:
        return None
    return tensor


def region_shape(shape: Sequence[int], shard: Shard, rank: int,
                 world: int) -> Optional[List[int]]:
    shape = list(shape)
    if shard.dim is not None:
        shape[shard.dim] //= world
    elif shard.owner is not None and shard.owner != rank:
        return None
    return shape


def _layout(shapes: Dict[str, Sequence[int]], plan: Dict[str, Shard],
            world: int):
    """The divided tensors in sorted order, and each rank's (name,
    region shape) list and buffer size."""
    names = sorted(n for n in shapes if not plan[n].replicated)
    per_rank = [[(n, region_shape(shapes[n], plan[n], r, world))
                 for n in names if region_shape(
                     shapes[n], plan[n], r, world) is not None]
                for r in range(world)]
    sizes = [sum(_numel(s) for _, s in parts) for parts in per_rank]
    return names, per_rank, max(sizes, default=0)


def _pack(parts: Flat, order, size: int, like: torch.Tensor
          ) -> torch.Tensor:
    buffer = like.new_zeros(size, dtype=torch.float32)
    offset = 0
    for name, shape in order:
        n = _numel(shape)
        buffer[offset:offset + n].copy_(parts[name].reshape(-1))
        offset += n
    return buffer


def gather_into(targets: Flat, plan: Dict[str, Shard], local: Flat) -> None:
    """Fill every divided whole tensor of ``targets`` from the ranks'
    parts (``local`` holds this rank's): one all-gather of one buffer a
    rank. Replicated tensors are left as they are."""
    world, rank = distributed.data_count(), distributed.data_index()
    shapes = {n: t.shape for n, t in targets.items()}
    names, per_rank, size = _layout(shapes, plan, world)
    if not names:
        return
    like = targets[names[0]]
    gathered = distributed.all_gather_flat(
        _pack(local, per_rank[rank], size, like))
    for r, order in enumerate(per_rank):
        offset = r * size
        for name, shape in order:
            n = _numel(shape)
            region(targets[name], plan[name], r, world).copy_(
                gathered[offset:offset + n].view(shape))
            offset += n


# the float32 bytes of whole tensors that gather_to_host gathers at once
HOST_GATHER_BYTES = 1 << 26


def gather_to_host(parts: Flat, plan: Dict[str, Shard],
                   meta: Dict[str, torch.Tensor], device: torch.device,
                   limit: int = HOST_GATHER_BYTES,
                   model_dims: Optional[Dict[str, Optional[int]]] = None
                   ) -> Flat:
    """Every tensor of ``meta`` (this rank's model shards' shapes and
    dtypes) whole on the host, from the ranks' ``parts`` (this rank's,
    on ``device``): the ones ``plan`` keeps whole over the data axis
    copied, the divided ones all-gathered over it, and those split
    along ``model_dims[name]`` over the model axis then gathered over
    that; in sorted name order, in groups of at most ``limit`` bytes of
    whole float32 tensors (a larger tensor alone), each group on the
    host before the next is gathered, so that the device never holds
    all of them whole."""
    model_dims = model_dims or {}
    split = {name for name in meta if model_dims.get(name) is not None}
    host = {name: parts[name].detach().cpu() for name in meta
            if plan[name].replicated and name not in split}
    names = sorted(name for name in meta
                   if not plan[name].replicated or name in split)
    models = distributed.mesh.size("model")
    group, size = [], 0
    for i, name in enumerate(names):
        group.append(name)
        size += 4 * meta[name].numel() * (models if name in split else 1)
        if size < limit and i < len(names) - 1:
            continue
        whole = {n: (parts[n] if plan[n].replicated else torch.empty(
            meta[n].shape, dtype=meta[n].dtype, device=device))
            for n in group}
        gather_into(whole, plan, parts)
        for n in group:
            value = whole[n]
            if n in split:
                value = tensor.all_gather(value.to(device), model_dims[n],
                                          "model")
            host[n] = value.detach().cpu()
        group, size = [], 0
    return host


def reduce_scatter(full: Flat, plan: Dict[str, Shard]) -> Flat:
    """Each divided tensor's part for this rank, summed over the ranks'
    whole ``full`` tensors: one reduce-scatter of one buffer. Each
    divided tensor is popped from ``full`` once its parts are packed."""
    world, rank = distributed.data_count(), distributed.data_index()
    shapes = {n: t.shape for n, t in full.items()}
    names, per_rank, size = _layout(shapes, plan, world)
    if not names:
        return {}
    dtypes = {n: full[n].dtype for n, _ in per_rank[rank]}
    send = full[names[0]].new_zeros(world * size, dtype=torch.float32)
    # each rank's segment filled in its own order (the names sorted)
    offsets = [r * size for r in range(world)]
    for name in names:
        whole = full.pop(name)
        for r in range(world):
            part = region(whole, plan[name], r, world)
            if part is not None:
                send[offsets[r]:offsets[r] + part.numel()].view(
                    part.shape).copy_(part)
                offsets[r] += part.numel()
    mine = distributed.reduce_scatter_flat(send)
    del send
    out, offset = {}, 0
    for name, shape in per_rank[rank]:
        n = _numel(shape)
        out[name] = mine[offset:offset + n].view(shape).to(dtypes[name])
        offset += n
    return out


def all_reduce(tensors: Flat) -> Flat:
    """``tensors`` summed over the ranks: one all-reduce of one buffer
    in sorted name order. Empties ``tensors``: each is let go once
    packed."""
    names = sorted(tensors)
    if not names:
        return {}
    meta = {n: (tensors[n].shape, tensors[n].dtype) for n in names}
    bucket = tensors[names[0]].new_empty(
        sum(_numel(shape) for shape, _ in meta.values()),
        dtype=torch.float32)
    offset = 0
    for name in names:
        t = tensors.pop(name)
        bucket[offset:offset + t.numel()].copy_(t.reshape(-1))
        offset += t.numel()
    distributed.all_reduce_(bucket)
    out, offset = {}, 0
    for name in names:
        shape, dtype = meta[name]
        n = _numel(shape)
        out[name] = bucket[offset:offset + n].view(shape).to(dtype)
        offset += n
    return out


def sharded_norm(tensors: Flat, plan: Dict[str, Shard],
                 device: torch.device,
                 model_split: Optional[Sequence[str]] = None
                 ) -> torch.Tensor:
    """The global L2 norm of tensors held as ``plan`` divides them over
    the data axis and ``model_split`` names the ones split over the
    model axis (each rank holding its parts, on ``device``): each
    tensor's squares summed over the ranks it is divided among, and
    counted once where it is whole on several. With nothing divided,
    ``optax.global_norm``'s sum on this rank."""
    model_split = set(model_split or ())
    if all(shard.replicated for shard in plan.values()) \
            and not model_split:
        return torch.sqrt(sum(t.square().sum() for t in tensors.values()))
    # [data and model, data alone, model alone, neither]
    sums = [torch.zeros((), device=device) for _ in range(4)]
    for name, t in tensors.items():
        slot = ((0 if name in model_split else 1)
                if not plan[name].replicated
                else (2 if name in model_split else 3))
        sums[slot] = sums[slot] + t.square().sum()
    over_data = tensor.all_reduce(torch.stack(sums[:2]), "data")
    over_model = tensor.all_reduce(over_data[0] + sums[2], "model")
    return torch.sqrt(over_model + over_data[1] + sums[3])
