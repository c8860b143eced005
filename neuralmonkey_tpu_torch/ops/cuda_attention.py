"""Fused Bahdanau decoder step: kernel K2 and its plain PyTorch version.

Counterpart of the Bahdanau half of
``neuralmonkey_tpu/ops/pallas_attention.py`` (``fused_bahdanau_step``).
The kernel is ``csrc/bahdanau.cu``; it runs inside an autograd
Function whose backward recomputes through the plain version.
"""

from __future__ import annotations

from typing import Tuple

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
    if batch == 0 or time == 0 or time * 4 > 48 * 1024:
        raise ValueError(f"fused_bahdanau_step: unsupported (B, T) = "
                         f"{(batch, time)}")
    context = keys.new_empty(batch, state_dim)
    weights = keys.new_empty(batch, time)
    kernel_config.launch("fused_bahdanau_step", keys, states, mask,
                         projected_query, similarity_v, context, weights,
                         batch, time, att_dim, state_dim)
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
