"""Fused Bahdanau decoder step: kernel K2 and its plain PyTorch version.

Counterpart of the Bahdanau half of
``neuralmonkey_tpu/ops/pallas_attention.py`` (``fused_bahdanau_step``).
The kernel is ``csrc/bahdanau.cu``, one thread-block cluster a batch
row laid out by :func:`bahdanau_plan`; it runs inside an autograd
Function whose backward recomputes through the plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import kernel_config

NEG_INF = -1e9


def bahdanau_reference(keys: torch.Tensor, states: torch.Tensor,
                       mask: torch.Tensor, projected_query: torch.Tensor,
                       similarity_v: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2 (``pallas_attention._reference_bahdanau``)."""
    energies = torch.einsum(
        "bta,a->bt", torch.tanh(keys + projected_query[:, None, :]),
        similarity_v)
    valid = mask > 0
    energies = torch.where(valid, energies, NEG_INF)
    weights = torch.exp(energies - energies.amax(dim=-1, keepdim=True))
    weights = weights * valid
    weights = weights / weights.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    context = torch.einsum("bt,btd->bd", weights, states)
    return context, weights


# csrc/bahdanau.cu: threads a block, the largest portable cluster, the
# float4 of the states a thread may hold in registers, and the shared
# floats beside the energies: the block reductions' scratch and the
# context's partial sums
BAHDANAU_THREADS, MAX_CLUSTER, HELD_FLOAT4 = 256, 8, 8
_RED_FLOATS, _PART_FLOATS = 32, 1024


class BahdanauPlan(NamedTuple):
    """The launch of K2: ``grid`` = B·``cluster`` blocks in clusters of
    ``cluster`` blocks, one cluster a batch row. Block rank r computes
    the energies of source positions r·``positions`` up to (r + 1)·
    ``positions`` and the context of columns r·``columns`` up to
    (r + 1)·``columns`` (a multiple of 4), both cut at T and D. When
    ``staged``, the energies' operands (pq, v, the mask row and the
    block's keys) are copied into shared memory, otherwise read in
    place; when ``resident``, the block's T × ``columns`` slice of the
    states is loaded into registers beside them, at most
    ``HELD_FLOAT4`` float4 a thread, otherwise the context pass reads it
    from device memory after the softmax. ``smem_bytes`` of shared
    memory a block."""
    cluster: int
    positions: int
    columns: int
    staged: bool
    resident: bool
    grid: int
    threads: int
    smem_bytes: int


def _bahdanau_smem(time: int, att: int, positions: int,
                   staged: bool) -> int:
    """Bytes of the kernel's layout (``smem_floats`` in the source)."""
    def round4(n):
        return -(-n // 4) * 4
    return 4 * (round4(time) + _RED_FLOATS + _PART_FLOATS
                + ((2 + positions) * round4(att) + round4(time)
                   if staged else 0))


def bahdanau_plan(batch: int, time: int, att: int, dim: int, sm_count: int,
                  smem_per_block: int) -> BahdanauPlan:
    """The layout of K2 (csrc/bahdanau.cu) on a card of ``sm_count`` SMs
    with ``smem_per_block`` bytes of shared memory a block: the fewest
    blocks a row, a power of two up to ``MAX_CLUSTER``, that fill the
    card, but no more than there are source positions or 4-column
    groups. Positions and columns are cut into contiguous chunks, one a
    block. The energies' operands are staged whenever they fit beside
    the energies; the states slice is held in registers whenever D is a
    multiple of 4 and a thread's share of it, each 4-column unit's T
    rows split over the threads left to it, is at most ``HELD_FLOAT4``
    float4. Raises ``ValueError`` where the energies do not fit."""
    if min(batch, time, att, dim, sm_count) < 1:
        raise ValueError(f"fused_bahdanau_step: no plan for B {batch}, "
                         f"T {time}, A {att}, D {dim} on {sm_count} SMs")
    cluster = 1
    while cluster < MAX_CLUSTER and batch * cluster < sm_count:
        cluster *= 2
    cluster = min(cluster, time, -(-dim // 4))
    positions = -(-time // cluster)
    columns = -(-dim // (4 * cluster)) * 4
    units = columns // 4
    resident = (dim % 4 == 0 and units <= BAHDANAU_THREADS
                and time <= HELD_FLOAT4 * (BAHDANAU_THREADS // units))
    staged = _bahdanau_smem(time, att, positions, True) <= smem_per_block
    smem = _bahdanau_smem(time, att, positions, staged)
    if smem > smem_per_block:
        raise ValueError(f"fused_bahdanau_step: T {time} does not fit "
                         f"{smem_per_block} bytes of shared memory")
    return BahdanauPlan(cluster, positions, columns, staged, resident,
                        batch * cluster, BAHDANAU_THREADS, smem)


def _bahdanau_kernel(keys, states, mask, projected_query, similarity_v):
    batch, time, att_dim = keys.shape
    state_dim = states.shape[-1]
    kernel_config.check_cuda_inputs(
        "fused_bahdanau_step", keys=keys, states=states, mask=mask,
        projected_query=projected_query, similarity_v=similarity_v)
    if (states.shape[:2] != (batch, time) or mask.shape != (batch, time)
            or projected_query.shape != (batch, att_dim)
            or similarity_v.shape != (att_dim,)):
        raise ValueError(
            "fused_bahdanau_step: inconsistent shapes keys "
            f"{tuple(keys.shape)}, states {tuple(states.shape)}, mask "
            f"{tuple(mask.shape)}, query {tuple(projected_query.shape)}, "
            f"v {tuple(similarity_v.shape)}")
    plan = bahdanau_plan(batch, time, att_dim, state_dim,
                         *kernel_config.tensor_device_limits(keys))
    context = keys.new_empty(batch, state_dim)
    weights = keys.new_empty(batch, time)
    kernel_config.launch("fused_bahdanau_step", keys, states, mask,
                         projected_query, similarity_v, context, weights,
                         batch, time, att_dim, state_dim, plan.cluster,
                         plan.positions, plan.columns, int(plan.staged),
                         int(plan.resident), plan.smem_bytes)
    return context, weights


class _BahdanauStep(torch.autograd.Function):
    """``pallas_attention.fused_bahdanau_step``'s custom VJP: the
    forward is K2 on CUDA tensors (the plain version on the CPU); the
    backward recomputes through the plain version and differentiates
    it (``_bahdanau_bwd``), as the JAX package has no backward
    kernel."""

    @staticmethod
    def forward(ctx, keys, states, mask, projected_query, similarity_v):
        if keys.is_cuda:
            out = _bahdanau_kernel(keys, states, mask, projected_query,
                                   similarity_v)
        else:
            out = bahdanau_reference(keys, states, mask, projected_query,
                                     similarity_v)
        ctx.save_for_backward(keys, states, mask, projected_query,
                              similarity_v)
        return out

    @staticmethod
    def backward(ctx, dcontext, dweights):
        keys, states, mask, projected_query, similarity_v = \
            ctx.saved_tensors
        inputs = [t.detach().requires_grad_(needs)
                  for t, needs in zip((keys, states, projected_query,
                                       similarity_v),
                                      (ctx.needs_input_grad[0],
                                       ctx.needs_input_grad[1],
                                       ctx.needs_input_grad[3],
                                       ctx.needs_input_grad[4]))]
        with torch.enable_grad():
            context, weights = bahdanau_reference(
                inputs[0], inputs[1], mask, inputs[2], inputs[3])
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(
                (context, weights), wanted, (dcontext, dweights),
                allow_unused=True))
        k, s, q, v = (next(grads) if t.requires_grad else None
                      for t in inputs)
        return k, s, None, q, v


def fused_bahdanau_step(keys: torch.Tensor, states: torch.Tensor,
                        mask: torch.Tensor, projected_query: torch.Tensor,
                        similarity_v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder attention step: (context (B, D), weights (B, T)).

    ``keys`` (B, T, A) are the precomputed key projections, ``states``
    (B, T, D) the attended values, ``projected_query`` (B, A) the
    projected decoder state. Launches K2 for CUDA tensors, runs the
    plain version otherwise; differentiable through the plain
    version."""
    if keys.is_cuda:
        mask = mask.to(torch.float32).contiguous()
    return _BahdanauStep.apply(keys, states, mask, projected_query,
                               similarity_v)
