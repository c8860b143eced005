"""ZeRO-1 and FSDP layouts over the data-parallel ranks (counterpart of
``TPUManager._add_data_axis``, ``_param_shardings`` and
``_opt_state_shardings`` in ``neuralmonkey_tpu/runtime.py``).

A :class:`Shard` says how one tensor divides among the ranks of the
``data`` axis: in equal chunks along one dim (the JAX package's rule:
the largest dim the number of ranks divides, the first of equal ones,
never a dim a tensor is split on over the model, expert or pipe axes), whole on
one owner rank, or whole on every rank (a tensor with no such dim, a
scalar). Chunks and owners go in sorted name order into one flat buffer
a rank, so every collective moves one buffer in an order fixed on all
ranks. The tensors here are a rank's shards over the other axes: their
collectives run over its data group (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import (Callable, Collection, Dict, List, NamedTuple, Optional,
                    Sequence, Union)

import torch

from . import distributed, mesh, tensor

# the axes besides ``data`` a tensor's parts may be split over, in the
# order their groups reduce and gather
AXES = ("model", "expert", "pipe")

Flat = Dict[str, torch.Tensor]


class Shard(NamedTuple):
    dim: Optional[int] = None    # equal chunks along this dim
    owner: Optional[int] = None  # whole on this rank alone

    @property
    def replicated(self) -> bool:
        return self.dim is None and self.owner is None


def data_axis(shape: Sequence[int], world: int,
              skip: Union[None, int, Collection[int]] = None
              ) -> Optional[int]:
    """``_add_data_axis``: the largest dim that ``world`` divides (the
    first of equal ones) other than those of ``skip`` (the dims a tensor
    is split on over the model, expert or pipe axes), or None (the
    tensor stays whole)."""
    if world <= 1:
        return None
    skip = {skip} if isinstance(skip, int) else set(skip or ())
    best = None
    for i, size in enumerate(shape):
        if i not in skip and size % world == 0 and (
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


def _groups(names: Sequence[str], size: Callable[[str], int],
            limit: int) -> List[List[str]]:
    """``names`` in order, in runs of at most ``limit`` bytes (``size``
    of each; a larger tensor alone)."""
    groups: List[List[str]] = []
    total = limit
    for name in names:
        bytes_ = size(name)
        if total + bytes_ > limit:
            groups.append([])
            total = 0
        groups[-1].append(name)
        total += bytes_
    return groups


def gather_whole(parts: Flat, plan: Dict[str, Shard],
                 meta: Dict[str, torch.Tensor], device: torch.device,
                 limit: int = HOST_GATHER_BYTES,
                 split_dims: Optional[Dict[str, Dict[str, int]]] = None,
                 keep: Callable[[torch.Tensor], torch.Tensor] = lambda v: v
                 ) -> Flat:
    """Every tensor of ``meta`` (this rank's shards' shapes and dtypes)
    whole, from the ranks' ``parts`` (this rank's, on ``device``), each
    passed through ``keep`` (``gather_to_host``: to the host): the ones
    ``plan`` keeps whole over the data axis as they are, the divided ones
    all-gathered over it, and those split along ``split_dims[name][axis]``
    over the model, expert or pipe axes then gathered over those; in
    sorted name order, in groups of at most ``limit`` bytes of whole
    float32 tensors (a larger tensor alone), each group kept before the
    next is gathered."""
    split_dims = split_dims or {}
    split = {name for name in meta if split_dims.get(name)}
    out = {name: keep(parts[name]) for name in meta
           if plan[name].replicated and name not in split}
    names = sorted(name for name in meta
                   if not plan[name].replicated or name in split)

    def whole_bytes(name: str) -> int:
        count = 1
        for axis in split_dims.get(name, {}):
            count *= mesh.size(axis)
        return 4 * meta[name].numel() * count
    for group in _groups(names, whole_bytes, limit):
        whole = {n: (parts[n] if plan[n].replicated else torch.empty(
            meta[n].shape, dtype=meta[n].dtype, device=device))
            for n in group}
        gather_into(whole, plan, parts)
        for n in group:
            value = whole[n]
            dims = split_dims.get(n, {})
            for axis in AXES:
                if axis in dims:
                    value = tensor.all_gather(value.to(device), dims[axis],
                                              axis)
            out[n] = keep(value)
    return out


def gather_to_host(parts: Flat, plan: Dict[str, Shard],
                   meta: Dict[str, torch.Tensor], device: torch.device,
                   limit: int = HOST_GATHER_BYTES,
                   split_dims: Optional[Dict[str, Dict[str, int]]] = None
                   ) -> Flat:
    """``gather_whole`` onto the host, a group at a time, so that the
    device never holds all of the tensors whole."""
    return gather_whole(parts, plan, meta, device, limit, split_dims,
                        keep=lambda v: v.detach().cpu())


def _owner_groups(owners: Dict[str, Shard], meta: Dict[str, torch.Tensor],
                  limit: int) -> List[List[str]]:
    """The names of each owner rank's tensors in sorted order, owner by
    owner, in groups of at most ``limit`` bytes: a group never holds
    more than one rank's share."""
    by_owner: Dict[int, List[str]] = {}
    for name in sorted(meta):
        by_owner.setdefault(owners[name].owner, []).append(name)
    return [group for owner in sorted(by_owner)
            for group in _groups(by_owner[owner],
                                 lambda n: 4 * meta[n].numel(), limit)]


def owner_gather(parts: Flat, plan: Dict[str, Shard],
                 owners: Dict[str, Shard], meta: Dict[str, torch.Tensor],
                 limit: int = HOST_GATHER_BYTES) -> Flat:
    """The whole tensors this rank owns under ``owners`` (an
    ``owner_plan``), from the ranks' ``parts`` held as ``plan`` divides
    them: one owner's group at a time all-gathered (see
    ``_owner_groups``), each rank keeping what it owns, so no rank ever
    holds more than one group of the others' tensors."""
    rank = distributed.data_index()
    mine: Flat = {}
    for group in _owner_groups(owners, meta, limit):
        whole = {n: (parts[n] if plan[n].replicated
                     else parts[n].new_empty(meta[n].shape)) for n in group}
        gather_into(whole, plan, parts)
        mine.update({n: whole[n].clone() if plan[n].replicated
                     else whole[n] for n in group
                     if owners[n].owner == rank})
    return mine


def owner_scatter(owned: Flat, owners: Dict[str, Shard],
                  plan: Dict[str, Shard], targets: Flat,
                  meta: Dict[str, torch.Tensor],
                  limit: int = HOST_GATHER_BYTES) -> None:
    """Copy into each of this rank's ``targets`` (its parts as ``plan``
    divides them) its part of the whole tensor its owner holds in
    ``owned`` (``owners``: an ``owner_plan``): one owner's group at a
    time all-gathered, as ``owner_gather``."""
    world, rank = distributed.data_count(), distributed.data_index()
    for group in _owner_groups(owners, meta, limit):
        whole = {n: owned[n] if n in owned else torch.empty(
            meta[n].shape, dtype=meta[n].dtype, device=targets[n].device)
            for n in group}
        gather_into(whole, owners, owned)
        for n in group:
            targets[n].copy_(region(whole[n], plan[n], rank, world))


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
                 split: Optional[Dict[str, Collection[str]]] = None
                 ) -> torch.Tensor:
    """The global L2 norm of tensors held as ``plan`` divides them over
    the data axis and ``split`` names the axes each is split over besides
    (each rank holding its parts, on ``device``): each tensor's squares
    summed over the ranks it is divided among, and counted once where it
    is whole on several. With nothing divided, ``optax.global_norm``'s
    sum on this rank."""
    split = {name: set(axes) for name, axes in (split or {}).items()
             if axes}
    if all(shard.replicated for shard in plan.values()) and not split:
        return torch.sqrt(sum(t.square().sum() for t in tensors.values()))

    def axes_of(name):
        axes = set(split.get(name, ()))
        if not plan[name].replicated:
            axes.add("data")
        return tuple(a for a in ("data",) + AXES if a in axes)
    # one sum per set of axes, the sets fixed by the plan on every rank
    keys = sorted({axes_of(name) for name in plan})
    sums = [torch.zeros((), device=device) for _ in keys]
    for name, t in tensors.items():
        slot = keys.index(axes_of(name))
        sums[slot] = sums[slot] + t.square().sum()
    total = torch.stack(sums)
    for axis in ("data",) + AXES:
        over = torch.tensor([axis in key for key in keys], device=device)
        if mesh.size(axis) > 1 and bool(over.any()):
            total = torch.where(over, tensor.all_reduce(total, axis), total)
    return torch.sqrt(total.sum())
