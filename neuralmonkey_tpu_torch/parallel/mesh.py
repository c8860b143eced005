"""The rank grid: the processes of a group laid out on the JAX
package's mesh axes (counterpart of ``TPUManager``'s mesh construction in
``neuralmonkey_tpu/runtime.py``).

The axes run major to minor: ``data``, ``pipe``, ``expert``,
``context``, ``model``. So the model group (tensor and sequence
parallelism) holds neighbouring ranks, the context group (the ring
attention) the next, then the expert group (expert parallelism) and
the pipe group (the pipeline's stages), and ``data = world / span``
replicas of the model split along the outermost axis. Rank ``r`` has
the coordinates of ``r`` written in that mixed radix.

Every rank builds one ``torch.distributed`` group for each model group,
each context group, each expert group, each pipe group and each data
group, all of them, in one fixed order (``new_group`` is a collective
over the whole world: a rank that skipped one would hang the others).
An axis that is the whole world has the default group. Groups are
built once per layout and kept.

``CUDAManager`` registers its mesh with :func:`enable`; the model code
asks :func:`current` for the groups and this rank's coordinates. With
no process group, or none registered, the mesh is one replica per rank
(``data = world``): data parallelism alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

AXES = ("data", "pipe", "expert", "context", "model")


class Mesh:
    """The grid of ``world`` ranks over ``AXES``; ``sizes`` holds the
    sizes of the axes after ``data`` (missing ones are 1). ``sequence``:
    the Transformer's residual stream splits its time axis over the
    model axis too (sequence sharding, ``ops/sharding.py``)."""

    def __init__(self, world: int, rank: int,
                 sizes: Optional[Dict[str, int]] = None,
                 sequence: bool = False) -> None:
        sizes = dict(sizes or {})
        extra = [(name, int(sizes.get(name, 1))) for name in AXES[1:]
                 if int(sizes.get(name, 1)) > 1]
        span = 1
        for _, size in extra:
            span *= size
        if world % span:
            raise ValueError(
                f"{world} devices not divisible by "
                + "*".join(f"{name}={size}" for name, size in extra))
        self.world = world
        self.rank = rank
        self.sequence = sequence
        self.sizes = {"data": world // span,
                      **{name: int(sizes.get(name, 1))
                         for name in AXES[1:]}}
        self.coords = self.coords_of(rank)
        self._groups: Dict[str, object] = {}

    @property
    def shape(self) -> Dict[str, int]:
        """The axes this run has: ``data`` and those larger than 1."""
        return {name: size for name, size in self.sizes.items()
                if name == "data" or size > 1}

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def coords_of(self, rank: int) -> Dict[str, int]:
        coords = {}
        for name in reversed(AXES):
            coords[name] = rank % self.sizes[name]
            rank //= self.sizes[name]
        return coords

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for name in AXES:
            rank = rank * self.sizes[name] + coords.get(name, 0)
        return rank

    def axis_ranks(self, axis: str) -> List[Tuple[int, ...]]:
        """Every group of ranks that differ along ``axis`` alone, in
        rank order (the groups' fixed order of creation)."""
        others = [name for name in AXES if name != axis]
        seen, groups = set(), []
        for rank in range(self.world):
            coords = self.coords_of(rank)
            key = tuple(coords[name] for name in others)
            if key in seen:
                continue
            seen.add(key)
            groups.append(tuple(
                self.rank_of({**coords, axis: i})
                for i in range(self.sizes[axis])))
        return groups

    def build_groups(self) -> None:
        """Create the model, context, expert, pipe and data groups on
        every rank (a collective over the world); a size-1 axis has none,
        an axis that is the whole world the default group."""
        if not dist.is_initialized() or self.world == 1:
            return
        key = (id(dist.group.WORLD), self.world,
               tuple(self.sizes[name] for name in AXES))
        if key in _GROUP_CACHE:
            self._groups = _GROUP_CACHE[key]
            return
        groups: Dict[str, object] = {}
        for axis in ("model", "context", "expert", "pipe", "data"):
            if self.sizes[axis] == 1:
                continue
            if self.sizes[axis] == self.world:
                groups[axis] = None
                continue
            for ranks in self.axis_ranks(axis):
                group = dist.new_group(list(ranks))
                if self.rank in ranks:
                    groups[axis] = group
        _GROUP_CACHE[key] = groups
        self._groups = groups

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None: the default
        group, when the axis spans the world)."""
        return self._groups.get(axis)


_GROUP_CACHE: Dict[tuple, Dict[str, object]] = {}
_CURRENT: Optional[Mesh] = None
_DEFAULTS: Dict[Tuple[int, int], Mesh] = {}


def enable(mesh: Mesh) -> None:
    """Register ``mesh`` as the one the model code runs on (the
    manager does this when it is made)."""
    global _CURRENT
    _CURRENT = mesh


def disable() -> None:
    global _CURRENT
    _CURRENT = None


def current() -> Mesh:
    """The registered mesh, or one replica per rank."""
    if _CURRENT is not None:
        if not dist.is_initialized() or _CURRENT.world == \
                dist.get_world_size():
            return _CURRENT
    world, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    if (world, rank) not in _DEFAULTS:
        _DEFAULTS[(world, rank)] = Mesh(world, rank)
    return _DEFAULTS[(world, rank)]


def size(axis: str) -> int:
    return current().size(axis)


def index(axis: str) -> int:
    return current().index(axis)


def group(axis: str):
    return current().group(axis)
