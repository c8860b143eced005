"""Lineage decode attention: kernel ``lineage_attention`` and its plain
PyTorch version.

Counterpart of ``neuralmonkey_tpu/ops/lineage_attention.py``. Beam
search keeps the Transformer decoder's self-attention caches
unpermuted, each slot's rows written by that slot, and resolves the
ancestry in score space, on one identity: the softmax over t of the
ancestry-selected scores equals the softmax over the flat (slot, time)
lanes of all scores plus a bias that is 0 where slot == anc[k, t] (and
t is inside the causal window) and -1e9 elsewhere.

Cache layout (``NM_LINEAGE_KERNEL=1``), time-major interleaved lanes,
``lane = t * K + j``:

    k_cache: (B, H, Dh, K*T)      v_cache: (B, H, K*T, Dh)

so a window of ``win`` positions is the contiguous prefix of
``win * K`` lanes, and a step writes K contiguous lanes. The kernel is
``csrc/lineage_attention.cu``. The TPU kernel's padding of the beam to
8 rows, its 128-lane window rounding and its VMEM lane budget are TPU
layout rules: here the kernel takes the K rows and exactly the window's
lanes.
"""

from __future__ import annotations

import math

import torch

from . import kernel_config
from .flash_attention import MAX_HEAD_DIM

NEG_INF = -1e9


def lane_window(win: int, beam: int, total: int) -> int:
    """Lanes to read for a ``win``-position window: ``win * beam``,
    capped at the ``total`` lanes of the cache."""
    return min(win * beam, total)


def lineage_bias(anc: torch.Tensor, step: int, win: int, beam: int,
                 lanes: int, cache_len: int) -> torch.Tensor:
    """(B, K, lanes) float32 additive bias: 0 where lane ``t*K + j`` has
    ``j == anc[b, k, t]``, ``t <= step`` and ``t < win``; -1e9
    elsewhere. Built once per step and shared by every layer and
    head."""
    lane = torch.arange(lanes, device=anc.device)
    t_of, j_of = lane // beam, lane % beam
    anc_t = anc[:, :, t_of.clamp_max(cache_len - 1)]
    ok = (anc_t == j_of) & (t_of <= step) & (t_of < win)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def lineage_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor,
                                bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel on the same operands: q (B, H, K,
    Dh), the caches, bias (B, K, W) -> (B, H, K, Dh), reading the first
    W lanes of the caches (one softmax per slot over the flat lanes)."""
    lanes = bias.shape[-1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q * scale, k_cache[..., :lanes]) + bias[:, None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    w = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return torch.matmul(w, v_cache[:, :, :lanes])


def lineage_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Fused lineage decode attention (see the module docstring):
    launches the kernel for CUDA tensors, runs the plain version
    otherwise."""
    if not q.is_cuda:
        return lineage_attention_reference(q, k_cache, v_cache, bias)
    batch, heads, beam, head_dim = q.shape
    total, lanes = k_cache.shape[-1], bias.shape[-1]
    if (k_cache.shape != (batch, heads, head_dim, total)
            or v_cache.shape != (batch, heads, total, head_dim)
            or bias.shape != (batch, beam, lanes) or not 0 < lanes <= total
            or head_dim > MAX_HEAD_DIM):
        raise ValueError(
            f"lineage_attention: q {tuple(q.shape)}, k {tuple(k_cache.shape)}"
            f", v {tuple(v_cache.shape)}, bias {tuple(bias.shape)} (head "
            f"dim at most {MAX_HEAD_DIM})")
    kernel_config.check_cuda_inputs("lineage_attention", q=q, k=k_cache,
                                    v=v_cache, bias=bias)
    out = torch.empty_like(q)
    kernel_config.launch("lineage_attention", q, k_cache, v_cache, bias, out,
                         batch, heads, beam, head_dim, total, lanes,
                         1.0 / math.sqrt(head_dim))
    return out
