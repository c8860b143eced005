"""Fused softmax cross-entropy over the vocabulary projection: kernels
B7 (``fused_xent_fwd``, ``fused_xent_bwd_dx``, ``fused_xent_bwd_dw``)
and their plain PyTorch versions.

Counterpart of ``neuralmonkey_tpu/ops/fused_xent.py``. The per-token
label-smoothed cross-entropy of ``logits = x @ w + b`` is computed
without writing the (N, V) logits to memory: the forward folds the
log-sum-exp, the label logit and the real-vocabulary logit sum into the
logit tiles, and the backward recomputes the tiles and folds
``dl = g·(softmax − (1−ε)·onehot − ε/V)`` into ``dx = dl·Wᵀ``,
``dW = xᵀ·dl`` and ``db = Σ dl`` (``csrc/fused_xent.cu``), each logit
tile computed once, on the tensor cores (3xTF32).

Opt-in, as in the JAX package: the decoders take this path when
``NM_FUSED_XENT=1`` (:func:`eligible`), for every float32 shape; the
TPU's ``d % 128`` and ``n % 8`` gates do not apply to the kernels.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import torch

from . import kernel_config

TILE = 128
# csrc/fused_xent.cu's dx kernel: threads a block (8 warps, a 64 x 32 warp
# tile each), the 4 x 4 x 4 sums each thread keeps in registers, and its
# shared memory: two stages of a 128 x 36 x tile and a W tile (128 x 36 or
# 32 x 136), and the dl of two vocabulary tiles, 128 x 260; one block an SM
DX_THREADS, DX_THREAD_SUMS = 256, 64
DX_SMEM_BYTES = 4 * (2 * (TILE * 36 + max(TILE * 36, 32 * 136))
                     + TILE * (2 * TILE + 4))
# the dx grid aims at this many blocks for each SM, in waves
DX_WAVES = 2
# csrc/fused_xent.cu's dW kernel: dx's threads, sums and stages, and the dl
# of two row tiles one above the other, 256 x 136
DW_SMEM_BYTES = 4 * (2 * (TILE * 36 + max(TILE * 36, 32 * 136))
                     + 2 * TILE * (TILE + 8))


class BackwardPlan(NamedTuple):
    """The launch of ``fused_xent_bwd_dx`` or ``fused_xent_bwd_dw``: a
    ``grid`` of (owned tiles, ``splits``) blocks of ``threads``. A dx
    block owns ``rows`` rows, a dW block ``vocab_tile`` vocabulary
    columns; either owns every column or row of D (in passes of
    ``d_tile``) and walks the tiles of the other axis ``walks[s]`` =
    (first, end), computing each of their logit tiles once, with
    ``smem_bytes`` of shared memory and ``thread_sums`` register sums a
    thread. With ``splits`` > 1 the partials go to a scratch of S planes
    that a second kernel folds."""
    rows: int
    vocab_tile: int
    d_tile: int
    splits: int
    tiles_per_chunk: int
    grid: Tuple[int, int]
    walks: Tuple[Tuple[int, int], ...]
    threads: int
    thread_sums: int
    smem_bytes: int


def _backward_plan(name: str, n: int, d: int, v: int, sm_count: int,
                   smem_limit: int, smem_bytes: int,
                   owns_rows: bool) -> BackwardPlan:
    """The tiles of the walked axis cut into the fewest contiguous
    chunks that make about ``DX_WAVES`` blocks for each SM, so that the
    card is full and the scratch small."""
    if min(n, d, v, sm_count) < 1:
        raise ValueError(f"{name}: no plan for N {n}, D {d}, V {v} on "
                         f"{sm_count} SMs")
    if smem_bytes > smem_limit:
        raise ValueError(f"{name}: {smem_bytes} bytes of shared memory do "
                         f"not fit {smem_limit}")
    row_tiles, vocab_tiles = -(-n // TILE), -(-v // TILE)
    owned, walked = ((row_tiles, vocab_tiles) if owns_rows
                     else (vocab_tiles, row_tiles))
    wanted = max(1, round(DX_WAVES * sm_count / owned))
    per_chunk = -(-walked // min(walked, wanted))
    splits = -(-walked // per_chunk)
    walks = tuple((s * per_chunk, min(walked, (s + 1) * per_chunk))
                  for s in range(splits))
    return BackwardPlan(TILE, TILE, TILE, splits, per_chunk,
                        (owned, splits), walks, DX_THREADS, DX_THREAD_SUMS,
                        smem_bytes)


def dx_plan(n: int, d: int, v: int, sm_count: int,
            smem_limit: int) -> BackwardPlan:
    """The layout of ``fused_xent_bwd_dx`` (csrc/fused_xent.cu) on a card
    of ``sm_count`` SMs with ``smem_limit`` bytes of shared memory a
    block: the vocabulary cut into the fewest contiguous chunks that
    make about ``DX_WAVES`` blocks for each SM, so that the card is full
    and the (S, N, D) scratch small. Raises ``ValueError`` where the
    block does not fit."""
    return _backward_plan("fused_xent_bwd_dx", n, d, v, sm_count,
                          smem_limit, DX_SMEM_BYTES, owns_rows=True)


def dw_plan(n: int, d: int, v: int, sm_count: int,
            smem_limit: int) -> BackwardPlan:
    """The layout of ``fused_xent_bwd_dw`` (csrc/fused_xent.cu): dx's
    (:func:`dx_plan`) with rows and vocabulary swapped, the row tiles cut
    into the fewest contiguous chunks that make about ``DX_WAVES`` blocks
    for each SM (one chunk, no scratch, at the decoder's loss tail).
    Raises ``ValueError`` where the block does not fit."""
    return _backward_plan("fused_xent_bwd_dw", n, d, v, sm_count,
                          smem_limit, DW_SMEM_BYTES, owns_rows=False)


def eligible(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the fused path is switched on (``NM_FUSED_XENT=1``) and
    takes these operands (float32)."""
    if os.environ.get("NM_FUSED_XENT") not in ("1", "true", "True"):
        return False
    return x.dtype == torch.float32 and w.dtype == torch.float32


def xent_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   targets: torch.Tensor, eps: float,
                   transposed: bool) -> torch.Tensor:
    """Per-token nll (N,) through materialized logits
    (``fused_xent.xent_reference``)."""
    logits = (x @ w.T if transposed else x @ w) + b
    log_probs = torch.log_softmax(logits, dim=-1)
    target_ll = log_probs.gather(1, targets.long()[:, None])[:, 0]
    if eps:
        return -((1.0 - eps) * target_ll + eps * log_probs.mean(dim=-1))
    return -target_ll


def _nll_from_parts(lse, lab, lsum, eps: float, vocab: int):
    if eps:
        return -((1.0 - eps) * (lab - lse) + eps * (lsum / vocab - lse))
    return -(lab - lse)


def fwd_reference(x, w, b, targets, eps: float, transposed: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``fused_xent_fwd``: (nll (N,), lse (N,)) from
    the log-sum-exp, label logit and logit sum of each row."""
    logits = (x @ w.T if transposed else x @ w) + b
    lse = torch.logsumexp(logits, dim=1)
    lab = logits.gather(1, targets.long()[:, None])[:, 0]
    lsum = logits.sum(dim=1)
    return _nll_from_parts(lse, lab, lsum, eps, logits.shape[1]), lse


def dlogits_reference(x, w, b, targets, lse, g, eps: float,
                      transposed: bool) -> torch.Tensor:
    """The (N, V) logit gradient both backward kernels recompute."""
    logits = (x @ w.T if transposed else x @ w) + b
    vocab = logits.shape[1]
    dl = torch.exp(logits - lse[:, None])
    dl[torch.arange(len(targets)), targets.long()] -= 1.0 - eps
    if eps:
        dl = dl - eps / vocab
    return g[:, None] * dl


def bwd_dx_reference(x, w, b, targets, lse, g, eps: float,
                     transposed: bool) -> torch.Tensor:
    """Plain version of ``fused_xent_bwd_dx``: dx = dl·Wᵀ (N, D)."""
    dl = dlogits_reference(x, w, b, targets, lse, g, eps, transposed)
    return dl @ w if transposed else dl @ w.T


def bwd_dw_reference(x, w, b, targets, lse, g, eps: float,
                     transposed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``fused_xent_bwd_dw``: (dW in w's layout, db)."""
    dl = dlogits_reference(x, w, b, targets, lse, g, eps, transposed)
    dw = dl.T @ x if transposed else x.T @ dl
    return dw, dl.sum(dim=0)


def _check(name: str, x, w, b, targets, transposed: bool, **more) -> None:
    n, d = x.shape
    v = w.shape[0] if transposed else w.shape[1]
    if (w.shape[1 if transposed else 0] != d or b.shape != (v,)
            or targets.shape != (n,) or targets.dtype != torch.int32):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)} "
            f"(transposed={transposed}), b {tuple(b.shape)}, targets "
            f"{tuple(targets.shape)} {targets.dtype}")
    if n == 0 or d == 0 or v == 0:
        raise ValueError(f"{name}: empty operands {(n, d, v)}")
    if not targets.is_cuda or targets.device != x.device:
        raise ValueError(f"{name}: targets on {targets.device}, x on "
                         f"{x.device}")
    kernel_config.check_cuda_inputs(name, x=x, w=w, b=b, **more)


def xent_fwd(x, w, b, targets, eps: float, transposed: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse): launches ``fused_xent_fwd`` for CUDA tensors, runs
    the plain version otherwise."""
    if not x.is_cuda:
        return fwd_reference(x, w, b, targets, eps, transposed)
    _check("fused_xent_fwd", x, w, b, targets, transposed)
    n = x.shape[0]
    vocab = w.shape[0] if transposed else w.shape[1]
    partials = x.new_empty(4, n, -(-vocab // TILE))
    lse, nll = x.new_empty(n), x.new_empty(n)
    kernel_config.launch("fused_xent_fwd", x, w, b, targets, partials[0],
                         partials[1], partials[2], partials[3], lse, nll,
                         n, x.shape[1], vocab, int(transposed), eps)
    return nll, lse


def xent_bwd_dx(x, w, b, targets, lse, g, eps: float,
                transposed: bool) -> torch.Tensor:
    """dx = dl·Wᵀ: launches ``fused_xent_bwd_dx``, laid out by
    :func:`dx_plan`, for CUDA tensors; runs the plain version
    otherwise."""
    if not x.is_cuda:
        return bwd_dx_reference(x, w, b, targets, lse, g, eps, transposed)
    _check("fused_xent_bwd_dx", x, w, b, targets, transposed, lse=lse, g=g)
    dx = torch.empty_like(x)
    n, d = x.shape
    vocab = w.shape[0] if transposed else w.shape[1]
    plan = dx_plan(n, d, vocab, *kernel_config.tensor_device_limits(x))
    scratch = x.new_empty(plan.splits, n, d) if plan.splits > 1 else None
    kernel_config.launch("fused_xent_bwd_dx", x, w, b, targets, lse, g, dx,
                         scratch, n, d, vocab, int(transposed), plan.splits,
                         plan.tiles_per_chunk, eps)
    return dx


def xent_bwd_dw(x, w, b, targets, lse, g, eps: float, transposed: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW = xᵀ·dl in w's layout, db = Σₙ dl): launches
    ``fused_xent_bwd_dw``, laid out by :func:`dw_plan`, for CUDA
    tensors; runs the plain version otherwise."""
    if not x.is_cuda:
        return bwd_dw_reference(x, w, b, targets, lse, g, eps, transposed)
    _check("fused_xent_bwd_dw", x, w, b, targets, transposed, lse=lse, g=g)
    dw, db = torch.empty_like(w), torch.empty_like(b)
    n, d = x.shape
    vocab = w.shape[0] if transposed else w.shape[1]
    plan = dw_plan(n, d, vocab, *kernel_config.tensor_device_limits(x))
    scratch = db_scratch = None
    if plan.splits > 1:
        scratch = x.new_empty(plan.splits, *w.shape)
        db_scratch = x.new_empty(plan.splits, vocab)
    kernel_config.launch("fused_xent_bwd_dw", x, w, b, targets, lse, g, dw,
                         db, scratch, db_scratch, n, d, vocab,
                         int(transposed), plan.splits, plan.tiles_per_chunk,
                         eps)
    return dw, db


class _FusedXent(torch.autograd.Function):
    """``fused_xent._fused``'s custom VJP: the forward keeps only the
    per-row log-sum-exp; the backward recomputes the logits."""

    @staticmethod
    def forward(ctx, x, w, b, targets, eps: float, transposed: bool):
        nll, lse = xent_fwd(x, w, b, targets, eps, transposed)
        ctx.save_for_backward(x, w, b, targets, lse)
        ctx.eps, ctx.transposed = eps, transposed
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, b, targets, lse = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = xent_bwd_dx(x, w, b, targets, lse, g, ctx.eps,
                             ctx.transposed)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = xent_bwd_dw(x, w, b, targets, lse, g, ctx.eps,
                                 ctx.transposed)
        return dx, dw, db, None, None, None


def fused_softmax_xent(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       targets: torch.Tensor, eps: float = 0.0,
                       transposed: bool = False) -> torch.Tensor:
    """Per-token label-smoothed cross-entropy (N,) of
    ``logits = x @ w + b`` without materialized logits on the card.

    x: (N, D) f32; w: (V, D) when ``transposed`` (a tied embedding
    table) else (D, V); b: (V,); targets: (N,) ints in [0, V)."""
    return _FusedXent.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                            targets.to(torch.int32).contiguous(),
                            float(eps or 0.0), bool(transposed))
