"""GPipe pipeline parallelism over the ``pipe`` axis (counterpart of
``neuralmonkey_tpu/parallel/pipeline.py``).

A Transformer part built with ``pipeline_stages`` stacks its layers'
parameters on a leading layer axis declared ``('pipe', ...)``; under
``CUDAManager(num_pipeline_stages=S)`` each rank of a pipe group holds
the ``L/S`` layers of its stage (the manager splits the leaves) and the
layer loop runs through :func:`gpipe_apply`: the batch is cut into M
microbatches, stage ``s`` runs microbatch ``t - s`` at tick ``t`` and
hands its activation to stage ``s + 1`` (``tensor.exchange``: every
send and receive of a tick posted at once). The JAX package computes
masked garbage on the fill and drain ticks; here a stage with no
microbatch at a tick computes nothing, which is the same function. The
last stage's output is replicated over the pipe group by a sum in which
the other stages add zeros, as the JAX package's ``psum``.

The exchange is not differentiable, and autograd chooses the order of
independent backward nodes while gloo pairs each send with a receive in
the order posted; so the whole schedule is one autograd Function
(:class:`_GPipe`) whose backward runs the reverse schedule itself: at
each backward tick a stage takes its output's gradient (the last stage
from the loss, the others from the next stage), back-propagates its
microbatch through its layers and sends its input's gradient to the
previous stage. Every stage reads the input ``x`` and the per-microbatch
tensors whole (the masks, the encoder states of the decoder's
cross-attention), so their gradients are summed over the pipe group
(Megatron's f); the replicated output takes its gradient on the last
stage alone (every rank computes the same loss from it).

With ``aux_fn`` each layer returns routing sums linear in its tokens
(the MoE FFN's); a stage adds them over its microbatches, folds each of
its layers once (``aux_fn``) and the folded values are summed over the
pipe group: the sequential stack's per-layer values, summed over every
layer.

Dropout inside a pipelined layer draws the whole batch's mask and takes
its microbatch's rows (:func:`batch_rows`), so a pipelined run equals
one process's run of the same stacked layout; attention dropout, whose
keep bits hash the position inside one kernel call, folds the
microbatch's ordinal into its seed instead, as the JAX package folds it
into the key.

Where the pipeline does not apply (no pipe mesh, or a batch the
microbatches or the data ranks do not divide: the JAX package's
sequential fallback), :func:`whole_stack` gathers a rank's stacked
leaves over the pipe group for the call (each rank's gradient is its
stage's part) and the layers run one after another.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

from ..logging import log
from . import distributed, mesh, tensor

_PIPE_MESH: Optional[mesh.Mesh] = None
_FALLBACKS: set = set()
# the activations' dtypes, by the code a stage sends the next
_DTYPES = (torch.float32, torch.float64, torch.bfloat16, torch.float16)


def enable_pipeline(grid: mesh.Mesh) -> None:
    """Register the mesh whose ``pipe`` axis pipelined parts stage over
    (the manager does this when ``num_pipeline_stages > 1``)."""
    global _PIPE_MESH
    _PIPE_MESH = grid


def disable_pipeline() -> None:
    global _PIPE_MESH
    _PIPE_MESH = None


def pipeline_mesh() -> Optional[mesh.Mesh]:
    return _PIPE_MESH


def log_fallback(part: str, reason: str) -> None:
    """Log, once per (part, reason), that a pipelined part runs its
    stacked layers one after another."""
    if (part, reason) not in _FALLBACKS:
        _FALLBACKS.add((part, reason))
        log(f"{part}: {reason}: the stacked layers run one after another "
            "(the JAX package's sequential fallback)")


# ---------------------------------------------------------------------- #
# the microbatch a layer runs on
# ---------------------------------------------------------------------- #
class Microbatch(NamedTuple):
    index: int   # the ordinal
    start: int   # its first row in the rank's batch
    rows: int
    total: int   # the rows of the rank's batch


_MICROBATCH: contextvars.ContextVar = contextvars.ContextVar(
    "nm_microbatch", default=None)


@contextlib.contextmanager
def _on_microbatch(mb: Optional[Microbatch]) -> Iterator[None]:
    token = _MICROBATCH.set(mb)
    try:
        yield
    finally:
        _MICROBATCH.reset(token)


def current_microbatch() -> Optional[Microbatch]:
    """The microbatch the pipeline is running, or None outside it."""
    return _MICROBATCH.get()


def batch_rows(shape, batch_dim: int = 0):
    """(the shape to draw a random tensor of ``shape`` at, the function
    that takes this microbatch's rows of that draw): inside the pipeline
    the whole batch's shape along ``batch_dim``, so that a microbatch's
    mask is its rows of the whole batch's; elsewhere ``shape`` and the
    identity."""
    mb = _MICROBATCH.get()
    shape = tuple(shape)
    if mb is None or shape[batch_dim] != mb.rows:
        return shape, lambda draw: draw
    whole = shape[:batch_dim] + (mb.total,) + shape[batch_dim + 1:]
    return whole, lambda draw: draw.narrow(batch_dim, mb.start, mb.rows)


# ---------------------------------------------------------------------- #
# trees of tensors
# ---------------------------------------------------------------------- #
def _flatten(tree: Any) -> tuple:
    """(leaves, rebuild) of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
        sizes = [len(p[0]) for p in parts]

        def rebuild_dict(leaves):
            out, at = {}, 0
            for k, (_, rebuild), n in zip(keys, parts, sizes):
                out[k] = rebuild(leaves[at:at + n])
                at += n
            return out
        return [leaf for p in parts for leaf in p[0]], rebuild_dict
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        parts = [_flatten(v) for v in tree]
        sizes = [len(p[0]) for p in parts]

        def rebuild_seq(leaves):
            out, at = [], 0
            for (_, rebuild), n in zip(parts, sizes):
                out.append(rebuild(leaves[at:at + n]))
                at += n
            return kind(out)
        return [leaf for p in parts for leaf in p[0]], rebuild_seq
    return [tree], lambda leaves: leaves[0]


def layer_params(stacked: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (each leaf's leading layer axis),
    each leaf marked with its other splits (``tensor.index_layer``)."""
    leaves, rebuild = _flatten(stacked)
    return rebuild([tensor.index_layer(leaf, i) for leaf in leaves])


def stack_layers(layers: List[Any]) -> Any:
    """Per-layer trees of one structure stacked leaf by leaf on a leading
    layer axis (the pipeline's parameter layout)."""
    flat = [_flatten(layer) for layer in layers]
    rebuild = flat[0][1]
    return rebuild([torch.stack(leaves)
                    for leaves in zip(*(f[0] for f in flat))])


def whole_stack(stacked: Any) -> Any:
    """A stacked tree with every leaf whole over the pipe group: the
    stages' layers all-gathered where a leaf is split over the pipe axis
    (each rank's gradient is its stage's part of the whole one)."""
    leaves, rebuild = _flatten(stacked)
    out = []
    for leaf in leaves:
        dims = tensor.split_axes(leaf)
        if "pipe" not in dims:
            out.append(leaf)
            continue
        whole = tensor.gather_from(leaf, dims.pop("pipe"), "pipe")
        out.append(tensor.mark_axes(whole, dims))
    return rebuild(out)


def stacked_depth(stacked: Any) -> int:
    """The number of layers a stacked tree holds whole."""
    leaf = _flatten(stacked)[0][0]
    stages = mesh.size("pipe") if "pipe" in tensor.split_axes(leaf) else 1
    return leaf.shape[0] * stages


def takes(batch: int, n_microbatches: int) -> Optional[str]:
    """None where :func:`gpipe_apply` takes a rank's batch of ``batch``
    rows in ``n_microbatches`` microbatches; else why not (the JAX
    package's conditions of its fallback and its ValueErrors, on the
    global batch)."""
    if _PIPE_MESH is None:
        return "no pipeline mesh"
    dp = mesh.size("data")
    whole = batch * dp if distributed.batch_is_split() else batch
    if whole % n_microbatches:
        return f"batch {whole} not divisible by {n_microbatches} microbatches"
    if (whole // n_microbatches) % dp:
        return (f"microbatch size {whole // n_microbatches} not divisible "
                f"by data-parallel degree {dp}")
    return None


# ---------------------------------------------------------------------- #
# the schedule
# ---------------------------------------------------------------------- #
class _Plan:
    """What one stage runs: its layers, their per-layer aux, the
    microbatches and the peers."""

    def __init__(self, layer_fn, aux_fn, layer_aux, n_micro, batch,
                 aux_rebuild, per_example, param_rebuild, x):
        self.layer_fn = layer_fn
        self.aux_fn = aux_fn
        self.layer_aux = layer_aux
        self.n_micro = n_micro
        self.n_stages = mesh.size("pipe")
        self.stage = mesh.index("pipe")
        ranks = tensor.ranks_of("pipe")
        self.prev = ranks[self.stage - 1] if self.stage > 0 else None
        self.next = (ranks[self.stage + 1]
                     if self.stage < self.n_stages - 1 else None)
        rows = batch // n_micro
        self.micro = [Microbatch(m, m * rows, rows, batch)
                      for m in range(n_micro)]
        self.aux_rebuild = aux_rebuild
        self.per_example = per_example
        self.param_rebuild = param_rebuild
        self.shape = (rows,) + tuple(x.shape[1:])
        self.device = x.device
        self.stats: list = []
        # per microbatch with a graph: (input, output, stats) and the aux
        # tensors' copies that collect their gradients
        self.records: list = []
        self.aux_copies: list = []
        self.keys: List[str] = []

    @property
    def ticks(self) -> int:
        return self.n_micro + self.n_stages - 1

    def chunk(self, leaf, m: int):
        mb = self.micro[m]
        return leaf.narrow(0, mb.start, mb.rows)

    def run_stage(self, params, h, aux, m: int):
        """This stage's layers on microbatch ``m``: (h, per-layer
        stats)."""
        stats = []
        with _on_microbatch(self.micro[m]):
            for j, layer_a in enumerate(self.layer_aux):
                out = self.layer_fn(layer_params(params, j), layer_a, h,
                                    aux)
                if self.aux_fn is not None:
                    h, layer_stats = out
                    stats.append(layer_stats)
                else:
                    h = out
        if tuple(h.shape) != self.shape:
            raise ValueError(
                f"a pipelined layer must keep its input's shape "
                f"{self.shape}; it returned {tuple(h.shape)}")
        return h, stats

    def _dtypes(self, t: int, sent, inbox_dtype) -> Optional[torch.dtype]:
        """The dtype of the activations this stage receives, learnt at the
        tick of its first receive: a stage's output dtype may differ from
        its input's (a bf16 stream promoted by a float32 residual), so
        each stage tells the next its own once a pass (``sent``: this
        tick's output, when it is the stage's first)."""
        sends, recvs = [], []
        if sent is not None:
            sends.append((torch.tensor([_DTYPES.index(sent.dtype)],
                                       device=self.device), self.next))
        code = None
        if inbox_dtype is None and self.prev is not None and \
                t == self.stage - 1:
            code = torch.zeros(1, dtype=torch.int64, device=self.device)
            recvs.append((code, self.prev))
        if sends or recvs:
            tensor.exchange(sends, recvs)
        return _DTYPES[int(code)] if code is not None else inbox_dtype

    def forward(self, x, aux_leaves, params, graph: bool):
        """The stage's ticks: (the outputs on the last stage (B, ...),
        per local layer its stats summed over the microbatches). With
        ``graph`` each microbatch's graph is kept for :meth:`backward`."""
        inbox: Dict[int, torch.Tensor] = {}
        outs = [None] * self.n_micro
        acc: Optional[list] = None
        self.records = [None] * self.n_micro
        self.aux_copies = [None] * self.n_micro
        inbox_dtype = None
        for t in range(self.ticks):
            m = t - self.stage
            sends, recvs = [], []
            if 0 <= m < self.n_micro:
                h_in = self.chunk(x, m) if self.prev is None else \
                    inbox.pop(m)
                aux_m = [self.chunk(a, m) if example else a
                         for a, example in zip(aux_leaves,
                                                self.per_example)]
                if graph:
                    h_in = h_in.detach().requires_grad_(
                        self.prev is not None or x.requires_grad)
                    aux_m = [_leaf_copy(a) for a in aux_m]
                with torch.set_grad_enabled(graph):
                    h, stats = self.run_stage(
                        params, h_in, self.aux_rebuild(aux_m), m)
                if self.next is None:
                    outs[m] = h.detach()
                else:
                    sends.append((h, self.next))
                if stats:
                    flat = [{k: v.detach() for k, v in s.items()}
                            for s in stats]
                    acc = flat if acc is None else [
                        {k: a[k] + s[k] for k in a}
                        for a, s in zip(acc, flat)]
                if graph:
                    self.records[m] = (h_in, h, stats)
                    self.aux_copies[m] = aux_m
            inbox_dtype = self._dtypes(
                t, sends[0][0] if sends and m == 0 else None, inbox_dtype)
            m_prev = t - (self.stage - 1)
            if self.prev is not None and 0 <= m_prev < self.n_micro:
                buffer = torch.empty(self.shape, dtype=inbox_dtype,
                                     device=self.device)
                recvs.append((buffer, self.prev))
                inbox[m_prev] = buffer
            tensor.exchange(sends, recvs)
        # the last stage's output dtype, then its output, on every stage
        code = tensor.all_reduce(torch.tensor(
            [_DTYPES.index(outs[0].dtype) + 1 if self.next is None else 0],
            device=self.device), "pipe")
        dtype = _DTYPES[int(code) - 1]
        if self.next is None:
            out = torch.cat(outs)
        else:
            out = torch.zeros((self.shape[0] * self.n_micro,)
                              + self.shape[1:], dtype=dtype,
                              device=self.device)
        self.stats = acc or []
        return tensor.all_reduce(out, "pipe")

    def fold(self, stats: list) -> Dict[str, torch.Tensor]:
        """Each local layer's stats folded by ``aux_fn``, summed over the
        layers (zeros on a stage without layers' stats)."""
        total: Optional[Dict[str, torch.Tensor]] = None
        for layer_stats in stats:
            folded = self.aux_fn(layer_stats)
            total = folded if total is None else {
                k: total[k] + folded[k] for k in total}
        return total

    def backward(self, grad_out, stat_grads, aux_leaves, params, x):
        """The reverse schedule: gradients of ``x``, of the aux leaves and
        of the stage's parameters (the copies ``params``)."""
        inbox: Dict[int, torch.Tensor] = {}
        chunks = (grad_out.chunk(self.n_micro) if self.next is None
                  else None)
        grad_x = [None] * self.n_micro
        for t in reversed(range(self.ticks)):
            m = t - self.stage
            sends, recvs = [], []
            if 0 <= m < self.n_micro:
                h_in, h, stats = self.records[m]
                self.records[m] = None
                g_out = (chunks[m].contiguous() if chunks is not None
                         else inbox.pop(m))
                outputs, grads = ([h], [g_out]) if h.requires_grad \
                    else ([], [])
                for layer_stats, layer_grads in zip(stats, stat_grads):
                    for key, value in layer_stats.items():
                        g = layer_grads.get(key)
                        if g is not None and value.requires_grad:
                            outputs.append(value)
                            grads.append(g)
                if outputs:
                    with _on_microbatch(self.micro[m]):
                        torch.autograd.backward(outputs, grads)
                g_in = (h_in.grad if h_in.grad is not None
                        else torch.zeros_like(h_in))
                if self.prev is not None:
                    sends.append((g_in, self.prev))
                elif h_in.requires_grad:
                    grad_x[m] = g_in
            m_next = t - (self.stage + 1)
            if self.next is not None and 0 <= m_next < self.n_micro:
                # the gradient of this stage's output, in its dtype
                buffer = torch.empty(self.shape,
                                     dtype=self.records[m_next][1].dtype,
                                     device=self.device)
                recvs.append((buffer, self.next))
                inbox[m_next] = buffer
            tensor.exchange(sends, recvs)
        out = []
        if x.requires_grad:
            local = (torch.cat(grad_x) if self.prev is None
                     else torch.zeros_like(x))
            out.append(tensor.all_reduce(local, "pipe"))
        else:
            out.append(None)
        for i, (leaf, example) in enumerate(zip(aux_leaves,
                                                self.per_example)):
            if not (isinstance(leaf, torch.Tensor) and leaf.requires_grad):
                out.append(None)
                continue
            parts = [self._aux_grad(m, i) for m in range(self.n_micro)]
            local = (torch.cat(parts) if example
                     else sum(parts[1:], parts[0]))
            out.append(tensor.all_reduce(local, "pipe"))
        out.extend(p.grad if p.grad is not None else
                   (torch.zeros_like(p) if p.requires_grad else None)
                   for p in params)
        self.records, self.aux_copies = [], []
        return out

    def _aux_grad(self, m: int, i: int) -> torch.Tensor:
        copy = self.aux_copies[m][i]
        return copy.grad if copy.grad is not None else torch.zeros_like(copy)


def _leaf_copy(value):
    """A detached copy of a tensor that collects its own gradient (a
    non-tensor as it is)."""
    if not isinstance(value, torch.Tensor):
        return value
    return value.detach().requires_grad_(value.requires_grad)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, n_aux, x, *rest):  # pylint: disable=arguments-differ
        aux_leaves, params = list(rest[:n_aux]), list(rest[n_aux:])
        copies = [tensor.keep_split(p, p.detach().requires_grad_(
            p.requires_grad)) for p in params]
        out = plan.forward(x, [_leaf_copy(a) for a in aux_leaves],
                           plan.param_rebuild(copies), graph=True)
        ctx.plan, ctx.copies, ctx.aux_leaves, ctx.x = (plan, copies,
                                                       aux_leaves, x)
        if plan.aux_fn is None:
            return out
        stats = [{k: v.detach().requires_grad_() for k, v in s.items()}
                 for s in plan.stats]
        ctx.stats = stats
        with torch.enable_grad():
            folded = plan.fold(stats)
        ctx.folded = folded
        plan.keys = sorted(folded)
        totals = [tensor.all_reduce(folded[k].detach(), "pipe")
                  for k in plan.keys]
        return (out, *totals)

    @staticmethod
    def backward(ctx, grad_out, *grad_totals):  # pylint: disable=arguments-differ
        plan = ctx.plan
        stat_grads: list = []
        if plan.aux_fn is not None:
            # the folded totals pass their gradient to this stage's layers
            leaves = [ctx.folded[k] for k in plan.keys]
            wanted = [(leaf, g) for leaf, g in zip(leaves, grad_totals)
                      if g is not None and leaf.requires_grad]
            inputs = [v for s in ctx.stats for v in s.values()]
            grads = (torch.autograd.grad([w[0] for w in wanted],
                                         inputs, [w[1] for w in wanted],
                                         allow_unused=True)
                     if wanted else [None] * len(inputs))
            at = 0
            for layer_stats in ctx.stats:
                stat_grads.append(dict(zip(layer_stats,
                                           grads[at:at + len(layer_stats)])))
                at += len(layer_stats)
        grads = plan.backward(grad_out, stat_grads, ctx.aux_leaves,
                              ctx.copies, ctx.x)
        return (None, None, *grads)


def gpipe_apply(layer_fn: Callable,
                stacked_params: Any,
                per_layer_aux: Optional[List[Any]],
                x: torch.Tensor,
                mb_aux: Any,
                n_microbatches: int = None,
                aux_fn: Callable = None):
    """Run a homogeneous layer stack as a GPipe pipeline over the pipe
    group.

    ``layer_fn(layer_params, layer_aux, x_mb, aux_mb)`` is one layer on
    one microbatch (with ``aux_fn``, ``(x_mb, stats)``, the stats a dict
    of sums linear in the microbatch's tokens). ``stacked_params`` holds
    the layers' parameters on a leading axis: this rank's stage's where
    the leaves are split over the pipe axis (the manager's layout), or
    all of them (the stage takes its part). ``per_layer_aux`` is one
    entry a layer (the dropout seeds) or None. ``x`` is (B, ...) this
    rank's rows; ``mb_aux`` a tree whose tensors with B rows travel with
    the microbatches (masks, encoder states), the rest read whole.
    ``n_microbatches`` defaults to the stage count.

    Returns the stack's output (B, ...), replicated over the pipe group;
    with ``aux_fn`` also the dict of each layer's ``aux_fn`` of its
    microbatch-summed stats, summed over all the layers."""
    if _PIPE_MESH is None:
        raise RuntimeError(
            "gpipe_apply called without a registered pipeline mesh "
            "(CUDAManager(num_pipeline_stages=...) registers one)")
    n_stages = mesh.size("pipe")
    n_micro = n_microbatches or n_stages
    reason = takes(x.shape[0], n_micro)
    if reason is not None:
        raise ValueError(reason)
    leaves, param_rebuild = _flatten(stacked_params)
    n_layers = stacked_depth(stacked_params)
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers not divisible by {n_stages} stages")
    per_stage = n_layers // n_stages
    stage = mesh.index("pipe")
    leaves = [leaf if "pipe" in tensor.split_axes(leaf) else
              leaf.narrow(0, stage * per_stage, per_stage)
              for leaf in leaves]
    layer_aux = (list(per_layer_aux[stage * per_stage:
                                    (stage + 1) * per_stage])
                 if per_layer_aux is not None else [None] * per_stage)
    aux_leaves, aux_rebuild = _flatten(mb_aux)
    per_example = [isinstance(a, torch.Tensor) and a.dim() > 0
                   and a.shape[0] == x.shape[0] for a in aux_leaves]
    plan = _Plan(layer_fn, aux_fn, layer_aux, n_micro, x.shape[0],
                 aux_rebuild, per_example, param_rebuild, x)
    tensors = [x] + [a for a in aux_leaves if isinstance(a, torch.Tensor)]
    graph = torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors + leaves)
    if not graph:
        out = plan.forward(x, aux_leaves, param_rebuild(leaves), False)
        if aux_fn is None:
            return out
        folded = plan.fold(plan.stats)
        return out, {k: tensor.all_reduce(folded[k], "pipe")
                     for k in sorted(folded)}
    results = _GPipe.apply(plan, len(aux_leaves), x, *aux_leaves, *leaves)
    if aux_fn is None:
        return results
    out, *totals = results
    return out, dict(zip(plan.keys, totals))
