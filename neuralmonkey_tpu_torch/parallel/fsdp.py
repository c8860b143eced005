"""FSDP's gathers at use (counterpart of ``fsdp=True`` in
``neuralmonkey_tpu/runtime.py``, whose divided parameters XLA
all-gathers at use and whose gradients it reduce-scatters: ZeRO-3).

Under ``fsdp`` each data rank keeps its parts of the parameters at rest
(``zero.slice_plan``). A pass reads them through :class:`AtUse` in
gather units that follow from the parameter tree alone: each
``layer_<i>`` sub-tree of a part (a Transformer's layers) is a unit of
its own, ``<part>/layer_<i>``, and the part's other leaves (embeddings,
output projection, layer norms; a pipelined part's stacked ``layers``,
which its layer loop reads as one tree) are one more, ``<part>``.
``Context.get_params`` hands out a :class:`PartView` of the part: each
read of a layer all-gathers its unit over the data group, and the
part's other unit is gathered once and kept while the part's outermost
memoized method runs (:class:`Pins`), so that a tied table read at a
decoder's input and at its output is gathered once.

In a training pass each gather is one autograd Function, ``_Gather``.
The tensors it makes do not stay for the backward: under
:meth:`AtUse.saving` the forward saves a handle in place of any tensor
that lies in a gathered leaf (or in its cast under the bf16 policy),
and the backward gathers the unit again at the first unpack, keeping it
until the unit's gradient is complete. That gradient, the backward of
``_Gather``, is reduce-scattered to this rank's parts under the
update's plan (slices for an elementwise rule, each parameter whole on
its owner for Adafactor; leaves whole on every rank all-reduced), and
freed. The units' reductions go in the reverse order of their forward
gathers on every rank: a unit ready early waits for its turn. The
backward's gathers go where the autograd engine unpacks, which the
graph fixes: every unit lies on the device of one worker thread.
"""

from __future__ import annotations

import contextlib
import re
import weakref
from collections.abc import Mapping
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Sequence, Tuple)

import torch

from ..ops.policy import cast_params_for_compute
from ..utils.saving import flatten_tree, map_leaves
from . import distributed, tensor, zero

_LAYER = re.compile(r"layer_\d+")


def is_layer(key: Any) -> bool:
    return bool(_LAYER.fullmatch(str(key)))


def unit_names(tree: Dict[str, Any]) -> Dict[str, List[str]]:
    """The gather units of a parameter tree (``{part: sub-tree}``), each
    with its flat leaf names in the tree's order: ``<part>/layer_<i>``
    for each layer sub-tree of a part, ``<part>`` for the part's other
    leaves (none where it has none)."""
    units: Dict[str, List[str]] = {}
    for part, sub in tree.items():
        rest: List[str] = []
        for key, value in sub.items():
            leaves = list(flatten_tree(value, f"{part}/{key}"))
            if is_layer(key):
                units[f"{part}/{key}"] = leaves
            else:
                rest.extend(leaves)
        if rest:
            units[part] = rest
    return units


class Stats:
    """What the gathers did: the bytes of the tensors they handed out
    that are alive now (``alive``) and at most since :meth:`reset`
    (``peak``); with ``record`` set, each collective of a unit in the
    order this rank posted it since :meth:`reset` (``events``:
    ``("gather", unit)`` in a forward, ``("regather", unit)`` in a
    backward, ``("reduce", unit)`` for its gradient). Off by default:
    the events of a long run would grow without bound."""

    def __init__(self, record: bool = False) -> None:
        self.alive = 0
        self.record = record
        self.reset()

    def reset(self) -> None:
        self.events: List[Tuple[str, str]] = []
        self.peak = self.alive

    def post(self, kind: str, unit: str) -> None:
        if self.record:
            self.events.append((kind, unit))

    def track(self, value: torch.Tensor) -> None:
        size = value.numel() * value.element_size()
        self.alive += size
        self.peak = max(self.peak, self.alive)
        weakref.finalize(value, self._free, size)

    def _free(self, size: int) -> None:
        self.alive -= size


class _Handle(NamedTuple):
    """What the forward keeps of a saved tensor lying in a gathered
    leaf: its unit, the leaf (name, cast) and the view's geometry."""
    unit: str
    key: Tuple[str, bool]
    size: Tuple[int, ...]
    stride: Tuple[int, ...]
    offset: int


class _Gather(torch.autograd.Function):
    """A unit's leaves whole from this rank's parts; the backward hands
    the unit's gradient to :meth:`AtUse._unit_done` (the parts get none
    through autograd)."""

    @staticmethod
    def forward(ctx, at_use, unit, *parts):  # pylint: disable=arguments-differ
        del parts
        ctx.at_use, ctx.unit = at_use, unit
        return tuple(at_use._gather_leaves(unit, "gather"))

    @staticmethod
    def backward(ctx, *grads):  # pylint: disable=arguments-differ
        ctx.at_use._unit_done(ctx.unit, grads)
        return (None, None) + (None,) * len(grads)


class AtUse:
    """A parameter set each rank holds its parts of (``rest``, divided
    as ``plan`` says; ``meta`` the whole shapes of this rank's model
    shards, ``split`` their split dims), read by a pass unit by unit;
    ``stats`` records its gathers.

    For a training pass ``grad_plan`` is the update's plan, ``split_batch``
    whether the ranks hold their rows of the batch (else the reduced
    gradients are their mean) and ``trainable`` says which parameters
    train (the others' gradients are zeros); :meth:`gradients` returns
    this rank's parts of the reduced gradients after the backward."""

    def __init__(self, rest: Dict[str, Any], plan: Dict[str, zero.Shard],
                 meta: Dict[str, torch.Tensor],
                 split: Dict[str, Dict[str, int]], stats: Stats,
                 grad_plan: Optional[Dict[str, zero.Shard]] = None,
                 split_batch: bool = False,
                 trainable: Optional[Callable[[str], bool]] = None) -> None:
        self.rest = rest
        self.units = unit_names(rest)
        self._parts = flatten_tree(rest)
        self._plan, self._meta, self._split = plan, meta, split
        self._stats = stats
        self._grad_plan = grad_plan if grad_plan is not None else plan
        self._split_batch = split_batch
        self._trainable = trainable or (lambda name: True)
        # the units gathered with gradients in forward order, the
        # gathers each awaits the backward of, the gradients of those
        # done, and how many of the reversed order are reduced
        self._order: List[str] = []
        self._pending: Dict[str, int] = {}
        self._ready: Dict[str, List[torch.Tensor]] = {}
        self._reduced = 0
        # the units gathered again for the backward, and the storages of
        # the leaves handed out with gradients, by address
        self._again: Dict[str, Dict[Tuple[str, bool], torch.Tensor]] = {}
        self._leaves: Dict[int, Tuple[Any, str, Tuple[str, bool]]] = {}
        self.grads: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------------ #
    # gathers
    # ------------------------------------------------------------------ #
    def _gather_leaves(self, unit: str, kind: str) -> List[torch.Tensor]:
        """The unit's leaves whole over the data axis (one all-gather;
        a leaf whole at rest is itself)."""
        names = self.units[unit]
        whole = {n: (self._parts[n] if self._plan[n].replicated
                     else self._parts[n].new_empty(self._meta[n].shape))
                 for n in names}
        zero.gather_into(whole, self._plan, self._parts)
        self._stats.post(kind, unit)
        return [whole[n] for n in names]

    def gather(self, unit: str) -> Dict[str, Any]:
        """The unit's sub-tree (a layer's, or its part's other leaves by
        key) whole, each leaf marked with its model-axis split and cast
        under the bf16 policy; with gradients enabled through
        ``_Gather``."""
        names = self.units[unit]
        parts = [self._parts[n] for n in names]
        grad = torch.is_grad_enabled() and any(p.requires_grad
                                                for p in parts)
        if grad:
            leaves = _Gather.apply(self, unit, *parts)
            if isinstance(leaves, torch.Tensor):
                leaves = (leaves,)
            if unit not in self._pending:
                self._order.append(unit)
                self._pending[unit] = 0
            self._pending[unit] += 1
        else:
            leaves = self._gather_leaves(unit, "gather")
        out = {}
        for name, leaf in zip(names, leaves):
            leaf = tensor.mark_axes(leaf, self._split.get(name))
            cast = cast_params_for_compute(leaf)
            if not self._plan[name].replicated:
                handed = [(leaf, (name, False))]
                if cast is not leaf:
                    handed.append((cast, (name, True)))
                for value, key in handed:
                    self._stats.track(value)
                    if grad:
                        self._leaves[value.untyped_storage().data_ptr()] = (
                            weakref.ref(value), unit, key)
            out[name] = cast
        part, _, layer = unit.partition("/")
        sub = self.rest[part]
        if layer:
            return map_leaves(lambda n, _: out[n], sub[layer], unit)
        return {k: map_leaves(lambda n, _: out[n], v, f"{part}/{k}")
                for k, v in sub.items() if not is_layer(k)}

    def _gather_again(self, unit: str
                      ) -> Dict[Tuple[str, bool], torch.Tensor]:
        with torch.no_grad():
            leaves = self._gather_leaves(unit, "regather")
        again = {}
        for name, leaf in zip(self.units[unit], leaves):
            if self._plan[name].replicated:
                continue
            cast = cast_params_for_compute(leaf)
            again[(name, False)], again[(name, True)] = leaf, cast
            self._stats.track(leaf)
            if cast is not leaf:
                self._stats.track(cast)
        return again

    # ------------------------------------------------------------------ #
    # the backward
    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def saving(self) -> Iterator[None]:
        """Within the block, a tensor the forward saves for the backward
        that lies in a gathered leaf is kept as a handle and gathered
        again when the backward unpacks it."""
        with torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                      self._unpack):
            yield

    def _pack(self, value: torch.Tensor) -> Any:
        if value.layout != torch.strided or value.numel() == 0:
            return value
        address = value.untyped_storage().data_ptr()
        entry = self._leaves.get(address)
        if entry is None:
            return value
        ref, unit, key = entry
        leaf = ref()
        # a leaf freed since: another tensor may lie at its address
        if leaf is None or leaf.dtype != value.dtype:
            return value
        return _Handle(unit, key, tuple(value.shape), value.stride(),
                       value.storage_offset())

    def _unpack(self, saved: Any) -> torch.Tensor:
        if not isinstance(saved, _Handle):
            return saved
        if saved.unit not in self._again:
            self._again[saved.unit] = self._gather_again(saved.unit)
        return self._again[saved.unit][saved.key].as_strided(
            saved.size, saved.stride, saved.offset)

    def _unit_done(self, unit: str, grads: Sequence[torch.Tensor]) -> None:
        """One gather's gradients of ``unit``: summed with the unit's
        others; once all are in, the unit's regathered leaves go and the
        units whose turn has come are reduced."""
        done = self._ready.get(unit)
        self._ready[unit] = (list(grads) if done is None else
                             [a + b for a, b in zip(done, grads)])
        self._pending[unit] -= 1
        if self._pending[unit] == 0:
            self._again.pop(unit, None)
            order = self._order[::-1]
            while (self._reduced < len(order)
                   and not self._pending[order[self._reduced]]):
                self._reduce(order[self._reduced])
                self._reduced += 1

    def _reduce(self, unit: str) -> None:
        """The unit's whole gradients summed over the data ranks into
        this rank's parts under the update's plan (the mean on a batch
        every rank holds whole), then let go."""
        grads = {name: (grad if self._trainable(name)
                        else torch.zeros_like(grad))
                 for name, grad in zip(self.units[unit],
                                       self._ready.pop(unit))}
        whole = {name: grads.pop(name) for name in sorted(grads)
                 if self._grad_plan[name].replicated}
        reduced = zero.reduce_scatter(grads, self._grad_plan)
        reduced.update(zero.all_reduce(whole))
        if not self._split_batch:
            world = distributed.data_count()
            reduced = {name: part / world for name, part in reduced.items()}
        self.grads.update(reduced)
        self._stats.post("reduce", unit)

    def gradients(self) -> Dict[str, torch.Tensor]:
        """After the backward: this rank's parts under the update's plan
        of every parameter's gradient. A unit whose gradients the
        backward left incomplete is reduced now, in its turn; a
        parameter no gradient reached gets zeros; the gradients the
        parameter terms left on the parts at rest (their own, exact:
        ``leaf_sum``) are added."""
        order = self._order[::-1]
        for unit in order[self._reduced:]:
            if unit in self._ready:
                self._reduce(unit)
        self._reduced = len(order)
        self._again.clear()
        world, rank = distributed.data_count(), distributed.data_index()
        for name, m in self._meta.items():
            shape = zero.region_shape(m.shape, self._grad_plan[name], rank,
                                      world)
            if name not in self.grads and shape is not None:
                self.grads[name] = self._parts[name].new_zeros(shape)
        terms = {name: part.grad for name, part in self._parts.items()
                 if part.grad is not None}
        if terms:
            terms = {name: terms.get(name, torch.zeros_like(part))
                     for name, part in self._parts.items()}
            if self._grad_plan != self._plan:
                terms = zero.owner_gather(terms, self._plan,
                                          self._grad_plan, self._meta)
            for name, grad in terms.items():
                self.grads[name] = self.grads[name] + grad
            for part in self._parts.values():
                part.grad = None
        return self.grads

    # ------------------------------------------------------------------ #
    # terms of the parameters alone
    # ------------------------------------------------------------------ #
    def leaf_sum(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 scopes: Optional[Sequence[str]] = None) -> torch.Tensor:
        """The sum over the parameters (of the parts in ``scopes``, or
        all) of ``fn`` (a sum over a tensor's elements), from this rank's
        parts: the divided ones' sums added over the data ranks, whose
        gradient passes (each rank's for its own parts, exactly), so that
        it is not reduced with the model's gradients again; a tensor
        split over the model axis summed over it too."""
        divided, whole = [], []
        for name, part in self._parts.items():
            if scopes and name.split("/", 1)[0] not in scopes:
                continue
            value = tensor.whole_sum(part, fn(part))
            (whole if self._plan[name].replicated else divided).append(value)
        total = sum(whole)
        if divided:
            total = total + distributed.global_sum(sum(divided), split=True)
        return total


class Pins:
    """The units a pass keeps gathered: the parts whose memoized methods
    are running, outermost first (``Context.cached`` enters and leaves
    them), and each part's other unit, held until the outermost running
    method of a part of its key ends (of any part where none runs; to
    the pass's end outside them), once for each gradient mode."""

    def __init__(self) -> None:
        self._frames: List[Any] = []
        self._held: Dict[Tuple[str, bool], Tuple[Any, Optional[int]]] = {}

    def enter(self, part: Any) -> None:
        self._frames.append(part)

    def leave(self) -> None:
        self._frames.pop()
        depth = len(self._frames)
        self._held = {pin: held for pin, held in self._held.items()
                      if held[1] is None or held[1] < depth}

    def get(self, key: str, gather: Callable[[str], Any]) -> Any:
        """The unit ``key`` from ``gather``, gathered at its first read."""
        pin = (key, torch.is_grad_enabled())
        if pin not in self._held:
            depth = next((i for i, part in enumerate(self._frames)
                          if part.param_key == key),
                         0 if self._frames else None)
            self._held[pin] = (gather(key), depth)
        return self._held[pin][0]


class PartView(Mapping):
    """A part's parameter tree under FSDP (``Context.get_params``): each
    read of ``layer_<i>`` gathers that layer's unit; any other key reads
    the part's other unit, gathered once while the part is in use
    (``pins``). Reading every key (``dict(view)``, ``items()``) gathers
    every layer at once: a copy with some keys replaced is
    :func:`replace_items`'s."""

    def __init__(self, at_use: AtUse, key: str, pins: Pins,
                 replaced: Optional[Dict[str, Any]] = None) -> None:
        self._at_use, self._key, self._pins = at_use, key, pins
        self._tree = at_use.rest[key]
        self._replaced = replaced or {}

    def __getitem__(self, item: str) -> Any:
        if item in self._replaced:
            return self._replaced[item]
        if item not in self._tree:
            raise KeyError(item)
        if is_layer(item):
            return self._at_use.gather(f"{self._key}/{item}")
        return self._pins.get(self._key, self._at_use.gather)[item]

    def __contains__(self, item: object) -> bool:
        return item in self._replaced or item in self._tree

    def __iter__(self) -> Iterator[str]:
        return iter(self._tree)

    def __len__(self) -> int:
        return len(self._tree)

    def replace(self, items: Dict[str, Any]) -> "PartView":
        return PartView(self._at_use, self._key, self._pins,
                        {**self._replaced, **items})


def replace_items(params: Any, items: Dict[str, Any]) -> Any:
    """A part's tree (a dict, or a :class:`PartView`) with ``items`` in
    place of those keys; a view stays a view, so that the copy gathers
    no unit."""
    if isinstance(params, PartView):
        return params.replace(items)
    return {**params, **items}
