"""Tensor parallelism over the ``model`` axis, and the time-axis
collectives of sequence and context parallelism: the collectives that
GSPMD inserts for the JAX package from its partition specs, written
out as ``torch.autograd.Function``s (as ``distributed._GlobalSum`` is).

Every rank of a model group computes the same function of the same
rows: a tensor is either whole on each of them (replicated) or split
in equal parts along one dim. The manager marks each parameter it
splits with its dim on each axis it is split over (:func:`mark_axes`:
the model axis here, the pipe and expert axes of the pipeline's stacked
layers and a MoE FFN's experts); the model code asks :func:`split_dim`
whether a layer's weights are split over the model axis, and takes the
collectives below only then. Gradients follow Megatron's rule: a rank's
gradient of a replicated tensor is the whole gradient, so

- :func:`copy_to` (Megatron's f) is the identity forward and sums the
  gradient over the group: a replicated input feeding split weights;
- :func:`reduce_from` (Megatron's g) sums forward and passes the
  gradient: the partial products of split weights;
- :func:`gather_from` concatenates the parts forward, and gives each
  rank its part of the (replicated) gradient;
- :func:`scatter_to` takes this rank's part forward and concatenates
  the parts' gradients;
- :func:`gather_sum` concatenates forward and reduce-scatters the
  gradient (a sliced stream feeding split weights: the block input of
  sequence parallelism);
- :func:`reduce_scatter` sums and takes this rank's part forward, and
  concatenates the gradients (the block output of sequence
  parallelism).

The vocabulary-parallel pieces (the embedding lookup, the log-softmax
cross-entropy with label smoothing, the gathered logits of decoding)
are built from these.

Under gloo a CUDA tensor is exchanged through the host, as gloo's
collectives on the card are; point-to-point exchanges (the ring) take
``dist.batch_isend_irecv``, so that two ranks that are each other's
next and previous never block on a send.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import mesh

_SPLIT_ATTR = "_nm_split_dims"


# ---------------------------------------------------------------------- #
# which tensors are split
# ---------------------------------------------------------------------- #
def mark_axes(tensor: torch.Tensor, dims: Optional[Dict[str, int]]
              ) -> torch.Tensor:
    """Record the dim ``tensor`` is split along over each mesh axis of
    ``dims`` (``model``, ``pipe``, ``expert``; this rank's part of each);
    empty or None: whole."""
    dims = {axis: int(dim) for axis, dim in (dims or {}).items()
            if dim is not None}
    if dims:
        setattr(tensor, _SPLIT_ATTR, dims)
    elif hasattr(tensor, _SPLIT_ATTR):
        delattr(tensor, _SPLIT_ATTR)
    return tensor


def split_axes(tensor: Any) -> Dict[str, int]:
    """The dims ``tensor`` is split along, by mesh axis."""
    return dict(getattr(tensor, _SPLIT_ATTR, {}))


def axis_dim(tensor: Any, axis: str) -> Optional[int]:
    """The dim ``tensor`` is split along over ``axis``, or None."""
    return getattr(tensor, _SPLIT_ATTR, {}).get(axis)


def split_dim(tensor: Any) -> Optional[int]:
    """The dim ``tensor`` is split along over the model axis, or None."""
    return axis_dim(tensor, "model")


def is_split(tensor: Any) -> bool:
    return split_dim(tensor) is not None


def keep_split(like: torch.Tensor, tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` (a cast or copy of ``like``) marked as ``like`` is."""
    return mark_axes(tensor, split_axes(like))


def index_layer(stacked: torch.Tensor, i: int) -> torch.Tensor:
    """Layer ``i`` of a stacked leaf (leading layer axis), marked with the
    dims of its other axes' splits (each one less)."""
    dims = {axis: dim - 1 for axis, dim in split_axes(stacked).items()
            if axis != "pipe" and dim > 0}
    return mark_axes(stacked[i], dims)


# ---------------------------------------------------------------------- #
# plain collectives along an axis (no gradient)
# ---------------------------------------------------------------------- #
def _gloo_host(x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend() == "gloo"


def all_reduce(x: torch.Tensor, axis: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or ``op``) over this rank's ``axis`` group: a new
    tensor."""
    out = x.detach().clone()
    if mesh.size(axis) > 1:
        dist.all_reduce(out, op=op, group=mesh.group(axis))
    return out


def all_gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The ``axis`` ranks' ``x`` (one shape), concatenated along ``dim``
    in the order of the axis."""
    count = mesh.size(axis)
    if count == 1:
        return x
    x = x.detach().contiguous()
    out = x.new_empty(count * x.numel())
    dist.all_gather_into_tensor(out, x.reshape(-1), group=mesh.group(axis))
    return torch.cat(out.view((count,) + tuple(x.shape)).unbind(0), dim=dim)


def own_part(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``dim``."""
    count = mesh.size(axis)
    if count == 1:
        return x
    size = x.shape[dim] // count
    return x.narrow(dim, mesh.index(axis) * size, size)


def reduce_scatter_dim(x: torch.Tensor, dim: int, axis: str
                       ) -> torch.Tensor:
    """This rank's part along ``dim`` of ``x`` summed over the ``axis``
    ranks."""
    count = mesh.size(axis)
    if count == 1:
        return x
    parts = torch.stack(x.detach().chunk(count, dim=dim)).contiguous()
    out = parts.new_empty(parts[0].numel())
    dist.reduce_scatter_tensor(out, parts.reshape(-1),
                               group=mesh.group(axis))
    return out.view(parts.shape[1:])


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[torch.Tensor, int]]) -> None:
    """Point-to-point: send each (tensor, global rank) of ``sends`` and
    fill each (buffer, global rank) of ``recvs``, all posted at once
    (``batch_isend_irecv``) and waited for; CUDA tensors go through the
    host under gloo."""
    host = any(_gloo_host(t) for t, _ in list(sends) + list(recvs))
    staged = [(t.detach().cpu() if host else t.detach().contiguous(), peer)
              for t, peer in sends]
    buffers = [(torch.empty(b.shape, dtype=b.dtype) if host else b, peer)
               for b, peer in recvs]
    ops = ([dist.P2POp(dist.isend, t, peer) for t, peer in staged]
           + [dist.P2POp(dist.irecv, b, peer) for b, peer in buffers])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if host:
        for (target, _), (buffer, _) in zip(recvs, buffers):
            target.copy_(buffer)


# ---------------------------------------------------------------------- #
# differentiable collectives (Megatron's f and g, gathers and scatters)
# ---------------------------------------------------------------------- #
class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):  # pylint: disable=arguments-differ
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        return all_reduce(grad, ctx.axis), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):  # pylint: disable=arguments-differ
        del ctx
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, grad_sum):  # pylint: disable=arguments-differ
        ctx.dim, ctx.axis, ctx.grad_sum = dim, axis, grad_sum
        return all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        if ctx.grad_sum:
            return reduce_scatter_dim(grad, ctx.dim, ctx.axis), None, None, \
                None
        return own_part(grad, ctx.dim, ctx.axis).contiguous(), None, None, \
            None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, reduce):  # pylint: disable=arguments-differ
        ctx.dim, ctx.axis = dim, axis
        if reduce:
            return reduce_scatter_dim(x, dim, axis)
        return own_part(x, dim, axis).contiguous()

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        return all_gather(grad.contiguous(), ctx.dim, ctx.axis), None, \
            None, None


def copy_to(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Megatron's f: the identity, the gradient summed over ``axis``."""
    if mesh.size(axis) == 1:
        return x
    return _Copy.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``axis``, the gradient passed."""
    if mesh.size(axis) == 1:
        return x
    return _Reduce.apply(x, axis)


def gather_from(x: torch.Tensor, dim: int, axis: str = "model"
                ) -> torch.Tensor:
    """The ``axis`` ranks' parts concatenated along ``dim`` for a
    computation every rank makes whole: each rank's gradient is its part
    of the whole one."""
    if mesh.size(axis) == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), axis, False)


def gather_sum(x: torch.Tensor, dim: int, axis: str = "model"
               ) -> torch.Tensor:
    """The ``axis`` ranks' parts concatenated along ``dim`` for split
    weights: the ranks' partial gradients summed, each rank's part kept."""
    if mesh.size(axis) == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), axis, True)


def scatter_to(x: torch.Tensor, dim: int, axis: str = "model"
               ) -> torch.Tensor:
    """This rank's part of a whole ``x`` along ``dim``; the gradients of
    the parts concatenated."""
    if mesh.size(axis) == 1:
        return x
    return _Scatter.apply(x, dim % x.dim(), axis, False)


def reduce_scatter(x: torch.Tensor, dim: int, axis: str = "model"
                   ) -> torch.Tensor:
    """This rank's part along ``dim`` of ``x`` summed over ``axis``; the
    gradients of the parts concatenated."""
    if mesh.size(axis) == 1:
        return x
    return _Scatter.apply(x, dim % x.dim(), axis, True)


def split_params(tree: Any, axis: str) -> Any:
    """``tree``'s tensors through :func:`copy_to` over ``axis``: the
    parameters of a computation each rank makes on its own slice of the
    time axis, whose gradients are summed over the slices."""
    if mesh.size(axis) == 1:
        return tree
    if isinstance(tree, dict):
        return {k: split_params(v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(split_params(v, axis) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return keep_split(tree, copy_to(tree, axis))
    return tree


def whole_sum(param: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value``, a sum over the elements of ``param``, summed over the
    model axis where ``param`` is a shard of a split tensor (its
    gradient passes, each rank's for its own shard)."""
    return reduce_from(value) if is_split(param) else value


# ---------------------------------------------------------------------- #
# heads of split attention weights
# ---------------------------------------------------------------------- #
def heads_split(weight: torch.Tensor, n_heads: int) -> bool:
    """Whether a projection's split columns hold whole heads (the heads
    divide the model axis); when they do not, the projections gather
    their columns and the attention runs whole, as the JAX package's
    sharded flash gate sends such shapes to its dense path."""
    return is_split(weight) and n_heads % mesh.size("model") == 0


def local_heads(weight: torch.Tensor, n_heads: int) -> int:
    return n_heads // mesh.size("model") if heads_split(weight, n_heads) \
        else n_heads


# ---------------------------------------------------------------------- #
# the vocabulary split over the model axis
# ---------------------------------------------------------------------- #
def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding`` of a table whose rows (the vocabulary) may be
    split over the model axis: each rank looks up the ids it holds,
    zeros elsewhere, and the parts are summed."""
    if split_dim(table) != 0:
        return F.embedding(ids, table)
    rows = table.shape[0]
    local = ids.long() - mesh.index("model") * rows
    inside = (local >= 0) & (local < rows)
    part = F.embedding(local.clamp(0, rows - 1), table)
    part = part * inside[..., None].to(part.dtype)
    return reduce_from(part)


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor,
                       eps: float = 0.0) -> torch.Tensor:
    """Per-token ``-log softmax(logits)[target]`` (label-smoothed by
    ``eps``: ``(1 - eps)`` of it plus ``eps`` times the mean negative
    log-probability) of logits whose last axis is this rank's part of
    the vocabulary: the log-sum-exp from the all-reduced maximum (no
    gradient) and the summed exponentials, the target logit from the rank
    that holds it."""
    vocab_part = logits.shape[-1]
    peak = all_reduce(logits.detach().amax(dim=-1, keepdim=True), "model",
                      dist.ReduceOp.MAX)
    lse = (peak + reduce_from((logits - peak).exp().sum(
        dim=-1, keepdim=True)).log())[..., 0]
    local = targets.long() - mesh.index("model") * vocab_part
    inside = (local >= 0) & (local < vocab_part)
    picked = logits.gather(-1, local.clamp(0, vocab_part - 1)[..., None])
    target_logit = reduce_from(torch.where(inside, picked[..., 0],
                                           picked.new_zeros(())))
    target_ll = target_logit - lse
    if not eps:
        return -target_ll
    vocab = vocab_part * mesh.size("model")
    mean_ll = reduce_from(logits.sum(dim=-1)) / vocab - lse
    return -((1.0 - eps) * target_ll + eps * mean_ll)


def ranks_of(axis: str) -> List[int]:
    """The global ranks of this rank's ``axis`` group, in its order."""
    current = mesh.current()
    return [current.rank_of({**current.coords, axis: i})
            for i in range(current.size(axis))]
