"""Mixture-of-experts FFN on one device (counterpart of
``neuralmonkey_tpu/ops/moe.py``).

A Transformer FFN becomes E expert FFNs and a learned router; each token
goes to its top-k experts within a fixed capacity per expert. Routing is
GShard's grouped dense dispatch: tokens are grouped (one group per batch
row), the dispatch and combine tensors are one-hots ``(G, S, E, C)``,
and the expert FFNs are einsums over them, as in the JAX package, which
computes all of it outside any Pallas kernel.

Routing is the JAX package's choice for choice: float32 router logits,
top-k with the lowest expert index winning a tie (a stable sort), and
the capacity positions from a slot-major cumulative sum, so that every
token's first choice ranks before any token's second choice. A token
past an expert's capacity gets nothing from it; the caller's residual
connection carries it. The auxiliary losses are Switch Transformer's
load balance, E · sum_e(load_e · mean_prob_e) (1 at perfect balance),
and the router z-loss, the mean of logsumexp(logits)².

On a batch split over data-parallel ranks the routing sums are summed
over the ranks before they fold into the losses, as the JAX package
adds them over its pipeline's microbatches; a group's capacity depends
on its own size alone, so splitting the batch drops the same tokens.

Tensor parallelism takes the ``model`` dims of ``moe_partition_specs``:
each rank holds its hidden columns of every expert, the router stays
whole; the experts' outputs are summed over the model axis before they
are combined, so the gates' gradients are whole on every rank.

Expert parallelism takes the ``expert`` dim (``CUDAManager(
num_expert_shards=S)`` registers the mesh: :func:`enable_expert_sharding`):
each rank of an expert group holds E/S experts. The batch splits over
the data axis alone, so the ranks of an expert group hold the same rows
and route them the same way, whole; each runs its own experts on the
tokens dispatched to them (:func:`constrain_dispatch`, the counterpart
of the JAX package's sharding constraint) and the partial outputs are
summed over the expert group. The tokens and the combine weights enter
the experts through Megatron's f over the expert axis, so their
gradients (and the router's, through the gates) are summed over the
group's experts; the routing sums are not, as every rank computed them
whole. A pipelined part's stacked experts declare ``('pipe', 'expert',
...)`` (:func:`moe_stacked_partition_specs`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from . import nn, sharding
from .attention import seeded_dropout
from ..parallel import mesh, pipeline
from ..parallel import tensor as tp
from ..parallel.distributed import global_sum

_EXPERT_MESH: Optional[mesh.Mesh] = None


def enable_expert_sharding(grid: mesh.Mesh) -> None:
    """Register the mesh whose ``expert`` axis the experts split over
    (the manager does this when ``num_expert_shards > 1``)."""
    global _EXPERT_MESH
    _EXPERT_MESH = grid


def disable_expert_sharding() -> None:
    global _EXPERT_MESH
    _EXPERT_MESH = None


def expert_sharding_mesh() -> Optional[mesh.Mesh]:
    return _EXPERT_MESH


def constrain_dispatch(x: torch.Tensor, expert_axis: int = 0
                       ) -> torch.Tensor:
    """This rank's experts of an intermediate indexed by every expert
    along ``expert_axis`` (the dispatch and combine one-hots), where an
    expert mesh is registered; ``x`` itself without one."""
    if _EXPERT_MESH is None:
        return x
    return tp.own_part(x, expert_axis, "expert")


def moe_init(gen: torch.Generator, model_dim: int, hidden_dim: int,
             n_experts: int) -> Dict:
    """The router and E stacked expert FFNs (leading axis = expert)."""
    def stack_linear(in_dim, out_dim):
        return {"w": torch.stack([nn.glorot_uniform(gen, (in_dim, out_dim))
                                  for _ in range(n_experts)]),
                "b": torch.zeros(n_experts, out_dim)}

    return {"router": nn.linear_init(gen, model_dim, n_experts,
                                     use_bias=False),
            "in": stack_linear(model_dim, hidden_dim),
            "out": stack_linear(hidden_dim, model_dim)}


def moe_partition_specs(prefix: str) -> Dict[str, tuple]:
    """The specs of a ``moe_init`` subtree: the experts' leading axis
    over ``expert``, their hidden dim Megatron-style over ``model``
    (in-columns, out-rows); the router whole."""
    return {f"{prefix}/in/w": ("expert", None, "model"),
            f"{prefix}/in/b": ("expert", "model"),
            f"{prefix}/out/w": ("expert", "model", None),
            f"{prefix}/out/b": ("expert", None)}


def moe_stacked_partition_specs(prefix: str) -> Dict[str, tuple]:
    """The specs of a pipelined part's stacked ``moe_init`` subtree (EP x
    PP): the leading layer axis over ``pipe``, then
    :func:`moe_partition_specs`'s; the router declared too, so that its
    stacked layers follow their stage."""
    out = {k: ("pipe",) + v for k, v in moe_partition_specs(prefix).items()}
    out[f"{prefix}/router/w"] = ("pipe", None, None)
    return out


def moe_capacity(group_size: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert capacity of a token group."""
    return max(1, min(group_size, int(math.ceil(
        capacity_factor * top_k * group_size / n_experts))))


def moe_combine_stats(stats: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The balance and z losses from the routing sums (linear in the
    tokens: the JAX package's pipeline adds them over microbatches
    before combining)."""
    count = stats["count"].clamp_min(1.0)
    load = stats["top1_sum"] / count
    prob_mean = stats["prob_sum"] / count
    n_experts = stats["top1_sum"].shape[-1]
    return {"balance": n_experts * (load * prob_mean).sum(),
            "z": stats["z_sum"] / count}


def top_k_lowest_index(x: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, the
    lowest index first among equal ones."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands under its promotion: the bf16
    expert weights of the compute policy beside float32 tokens are
    widened (their products are exact in float32)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    wide = nn.widened(dtype)
    return torch.einsum(spec, a.to(wide), b.to(wide)).to(dtype)


def moe_ffn(params: Dict, x: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            top_k: int = 2,
            capacity_factor: float = 1.5,
            activation: Optional[Callable] = None,
            dropout_seed: Optional[int] = None,
            dropout_keep_prob: float = 1.0,
            router_noise: float = 0.0,
            noise_seed: Optional[int] = None,
            return_stats: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mixture-of-experts position-wise FFN.

    ``x`` is (G, S, D), group-major; ``mask`` (G, S) keeps padding
    tokens out of dispatch and out of the losses. ``router_noise`` is
    multiplicative jitter on the router input, uniform in [1 - eps,
    1 + eps], drawn from ``noise_seed`` when one is given (training).
    ``activation`` is the experts' hidden nonlinearity, ReLU when None.
    Returns (output (G, S, D), {"balance", "z"} float32 scalars); with
    ``return_stats`` the routing sums behind them instead (``top1_sum``,
    ``prob_sum`` (E,), ``count``, ``z_sum``), linear in the tokens, for
    :func:`moe_combine_stats` after a pipeline adds them over its
    microbatches."""
    g, s, _ = x.shape
    w_in, b_in = params["in"]["w"], params["in"]["b"]
    w_out, b_out = params["out"]["w"], params["out"]["b"]
    experts_split = tp.axis_dim(w_in, "expert") is not None
    n_experts = w_in.shape[0] * (mesh.size("expert") if experts_split
                                 else 1)
    k = min(top_k, n_experts)
    cap = moe_capacity(s, n_experts, k, capacity_factor)

    router_in = x.float()
    if noise_seed is not None and router_noise > 0.0:
        gen = torch.Generator(device=x.device).manual_seed(noise_seed)
        # a pipelined microbatch's rows of the whole batch's draw
        shape, rows = pipeline.batch_rows(router_in.shape)
        router_in = router_in * rows(router_in.new_empty(shape).uniform_(
            1.0 - router_noise, 1.0 + router_noise, generator=gen))
    logits = torch.einsum("gsd,de->gse", router_in,
                          params["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)

    gate_vals, gate_idx = top_k_lowest_index(probs, k)      # (G, S, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # one-hots by comparison: F.one_hot checks its indices on the host
    experts = torch.arange(n_experts, device=x.device)
    sel = (gate_idx[..., None] == experts).float()         # (G, S, k, E)
    if mask is not None:
        sel = sel * mask[..., None, None].float()

    # capacity positions in slot-major order
    sel_flat = sel.transpose(1, 2).reshape(g, k * s, n_experts)
    pos = torch.cumsum(sel_flat, dim=1) - sel_flat
    kept = sel_flat * (pos < cap)
    # a position past the capacity has an all-zero one-hot
    pos_oh = (pos.long()[..., None] == torch.arange(
        cap, device=x.device)).float()
    dispatch_flat = kept[..., None] * pos_oh                # (G, kS, E, C)
    gates_flat = gate_vals.transpose(1, 2).reshape(g, k * s)
    combine_flat = gates_flat[..., None, None] * dispatch_flat
    # the k slots fold back onto the token axis
    dispatch = dispatch_flat.reshape(g, k, s, n_experts, cap).sum(1)
    combine = combine_flat.reshape(g, k, s, n_experts, cap).sum(1)

    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)
    split = tp.is_split(w_in)
    x_in = tp.copy_to(x) if split else x
    if experts_split:
        # this rank's experts: the tokens and gates enter them through f
        x_in = tp.copy_to(x_in, "expert")
        dispatch = constrain_dispatch(dispatch, 2)
        combine = constrain_dispatch(tp.copy_to(combine, "expert"), 2)
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, x_in)
    hidden = (activation or torch.relu)(
        _einsum("egcd,edh->egch", expert_in, w_in)
        + b_in[:, None, None, :])
    hidden = seeded_dropout(hidden, dropout_keep_prob, sharding.shard_seed(
        dropout_seed, ("model" if split else None,
                       "expert" if experts_split else None)), batch_dim=1)
    if split:
        expert_out = (tp.reduce_from(_einsum("egch,ehd->egcd", hidden,
                                             w_out))
                      + b_out[:, None, None, :])
    else:
        expert_out = (_einsum("egch,ehd->egcd", hidden, w_out)
                      + b_out[:, None, None, :])
    y = torch.einsum("gsec,egcd->gsd", combine, expert_out)
    if experts_split:
        y = tp.reduce_from(y, "expert")

    top1 = sel[:, :, 0, :]                                  # (G, S, E)
    z_sq = torch.logsumexp(logits, dim=-1) ** 2             # (G, S)
    if mask is not None:
        m = mask.float()
        stats = {"top1_sum": top1.sum((0, 1)),
                 "prob_sum": (probs * m[..., None]).sum((0, 1)),
                 "count": m.sum(), "z_sum": (z_sq * m).sum()}
    else:
        stats = {"top1_sum": top1.sum((0, 1)), "prob_sum": probs.sum((0, 1)),
                 "count": logits.new_tensor(float(g * s)),
                 "z_sum": z_sq.sum()}
    stats = {key: global_sum(value) for key, value in stats.items()}
    if return_stats:
        return y.to(x.dtype), stats
    return y.to(x.dtype), moe_combine_stats(stats)
