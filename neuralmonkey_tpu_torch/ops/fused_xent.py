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
``NM_FUSED_XENT=1`` (:func:`eligible`), for float32 and bf16 operands of
every shape; the TPU's ``d % 128`` and ``n % 8`` gates do not apply to
the kernels. Under the bf16 compute policy the projection is the bf16
use-site table beside float32 states: the JAX package widens such a
mixed pair and runs its float32 kernels, and so do these, reading W as
bf16 (the ``*_bf16w`` instances, half W's bytes); dW is returned rounded
to bf16, W's dtype, as the JAX custom VJP's cotangent is. A bf16 x is
widened (exact); its dx is returned in bf16.

The bf16-W kernels run on Hopper's warpgroup products (laid out by
:func:`wgmma_fwd_plan`, :func:`wgmma_dx_plan` and :func:`wgmma_dw_plan`)
wherever W's bf16 rows start on 16-byte boundaries (:func:`wgmma_takes`);
the other strides go to the design that widens W as it stages it (the
``*_bf16w_widened`` instances), decided from the shapes before any
launch.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import torch

from ..parallel import mesh
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


# csrc/fused_xent.cu's bf16-W backward on warpgroup products (namespace
# wgk; csrc/wgmma_xent.cuh): two warpgroups of 128 threads for the products
# and a third whose first thread issues the TMA copies (384 threads; the
# third gives its registers to the other two). A block owns 512 columns
# (dx) or rows (dW) of D, 256 a warpgroup, as 64 x 256 float32 sums in
# registers beside the 64 x 64 logit sums (160 a product thread), and walks
# tiles of the other axis through a ring of stages. dx: 64 rows, 128
# vocabulary columns a walked tile, 4 stages of 40960 bytes (x's three bf16
# parts, 64 x 64, and W's 128 x 64; or W's 32 x 512) and dl's three parts,
# 64 x 128. dW: 64 vocabulary columns, 128 rows a walked tile, 6 stages of
# 28672 bytes (x's parts, 128 x 32, and W's 64 x 32; or one part of x,
# 16 x 512) and dl's parts, 128 x 64. Both take 1024 bytes more, so that
# the ring starts on the 1024-byte boundary its swizzled tiles need, and
# 128 for the stages' mbarriers. One block an SM.
WGMMA_THREADS, WGMMA_THREAD_SUMS, WGMMA_D_PASS = 384, 160, 512
WGMMA_DX_ROWS, WGMMA_DX_VOCAB_TILE = 64, 128
WGMMA_DX_STAGES, WGMMA_DX_STAGE_BYTES = 4, 2 * (3 * 64 * 64 + 128 * 64)
WGMMA_DX_SMEM_BYTES = (WGMMA_DX_STAGES * WGMMA_DX_STAGE_BYTES
                       + 2 * 3 * 64 * 128 + 1024 + 128)
WGMMA_DW_ROWS, WGMMA_DW_VOCAB_TILE = 128, 64
WGMMA_DW_STAGES, WGMMA_DW_STAGE_BYTES = 6, 2 * (3 * 128 * 32 + 64 * 32)
WGMMA_DW_SMEM_BYTES = (WGMMA_DW_STAGES * WGMMA_DW_STAGE_BYTES
                       + 2 * 3 * 128 * 64 + 1024 + 128)
# the S split: the fewest chunks whose grid keeps this share of its waves'
# SMs busy
WGMMA_FILL = 0.85
# the forward (wgk::xent_fwd_wg_kernel): 128 rows a block (64 a product
# warpgroup, as 64 x 256 sums: 128 a product thread), 256 vocabulary columns
# a walked tile, 5 stages of 40960 bytes (x's three bf16 parts, 128 x 32,
# and W's 256 x 32), 1024 + 128 bytes more as the backward's; one block an SM
WGMMA_FWD_ROWS, WGMMA_FWD_VOCAB_TILE, WGMMA_FWD_THREAD_SUMS = 128, 256, 128
WGMMA_FWD_STAGES = 5
WGMMA_FWD_STAGE_BYTES = 2 * (3 * 128 * 32 + 256 * 32)
WGMMA_FWD_SMEM_BYTES = WGMMA_FWD_STAGES * WGMMA_FWD_STAGE_BYTES + 1024 + 128


class WgmmaPlan(NamedTuple):
    """The launch of a bf16-W backward kernel on warpgroup products: a
    ``grid`` of (owned tiles, ``splits``, ``d_passes``) blocks of
    ``threads``. A dx block owns ``rows`` rows and walks vocabulary tiles
    of ``vocab_tile`` columns; a dW block owns ``vocab_tile`` columns and
    walks row tiles of ``rows`` rows; either owns ``d_pass`` columns or
    rows of D (pass p of ``d_passes``) and walks ``walks[s]`` = (first,
    end), computing each logit tile once a pass, with ``stages`` ring
    stages of ``stage_bytes``, ``smem_bytes`` of shared memory in all,
    ``blocks_per_sm`` blocks an SM and ``thread_sums`` register sums a
    thread. With ``splits`` > 1 the partials go to a scratch of S planes
    that a second kernel folds in the order 0 .. S-1."""
    rows: int
    vocab_tile: int
    d_pass: int
    d_passes: int
    splits: int
    grid: Tuple[int, int, int]
    walks: Tuple[Tuple[int, int], ...]
    stages: int
    stage_bytes: int
    threads: int
    thread_sums: int
    smem_bytes: int
    blocks_per_sm: int


def wgmma_takes(d: int, v: int, transposed: bool) -> bool:
    """Whether the bf16-W backward runs on warpgroup products: W's bf16
    rows (D values tied, V untied) start on 16-byte boundaries, as its
    16-byte copies (and a TMA descriptor) need. Other strides take the
    instances that widen W as they stage it (``*_bf16w_widened``)."""
    return (d if transposed else v) % 8 == 0


def _split_count(owned: int, walked: int, passes: int, sm_count: int) -> int:
    """The fewest chunks of the ``walked`` tiles whose grid of ``owned``
    x S x ``passes`` blocks (one an SM) fills the card and keeps
    ``WGMMA_FILL`` of its waves' SMs busy; else the best-filling S."""
    best, best_fill = 1, -1.0
    for splits in range(1, walked + 1):
        blocks = owned * splits * passes
        fill = blocks / (-(-blocks // sm_count) * sm_count)
        if blocks >= sm_count and fill >= WGMMA_FILL:
            return splits
        if fill > best_fill:
            best, best_fill = splits, fill
        if blocks >= 4 * sm_count:
            break
    return best


def _wgmma_plan(name: str, n: int, d: int, v: int, sm_count: int,
                smem_limit: int, owns_rows: bool) -> WgmmaPlan:
    if min(n, d, v, sm_count) < 1:
        raise ValueError(f"{name}: no plan for N {n}, D {d}, V {v} on "
                         f"{sm_count} SMs")
    if owns_rows:
        rows, vocab_tile = WGMMA_DX_ROWS, WGMMA_DX_VOCAB_TILE
        stages, stage_bytes = WGMMA_DX_STAGES, WGMMA_DX_STAGE_BYTES
        smem_bytes = WGMMA_DX_SMEM_BYTES
        owned, walked = -(-n // rows), -(-v // vocab_tile)
    else:
        rows, vocab_tile = WGMMA_DW_ROWS, WGMMA_DW_VOCAB_TILE
        stages, stage_bytes = WGMMA_DW_STAGES, WGMMA_DW_STAGE_BYTES
        smem_bytes = WGMMA_DW_SMEM_BYTES
        owned, walked = -(-v // vocab_tile), -(-n // rows)
    if smem_bytes > smem_limit:
        raise ValueError(f"{name}: {smem_bytes} bytes of shared memory do "
                         f"not fit {smem_limit}")
    passes = -(-d // WGMMA_D_PASS)
    splits = _split_count(owned, walked, passes, sm_count)
    walks = tuple((s * walked // splits, (s + 1) * walked // splits)
                  for s in range(splits))
    return WgmmaPlan(rows, vocab_tile, WGMMA_D_PASS, passes, splits,
                     (owned, splits, passes), walks, stages, stage_bytes,
                     WGMMA_THREADS, WGMMA_THREAD_SUMS, smem_bytes,
                     smem_limit // smem_bytes)


def wgmma_dx_plan(n: int, d: int, v: int, sm_count: int,
                  smem_limit: int) -> WgmmaPlan:
    """The layout of ``fused_xent_bwd_dx_bf16w`` (csrc/fused_xent.cu,
    ``wgk::xent_bwd_dx_wg_kernel``) on a card of ``sm_count`` SMs with
    ``smem_limit`` bytes of shared memory a block: 64-row blocks, the
    vocabulary tiles cut into the fewest balanced chunks that fill the
    card (:func:`_split_count`). Raises ``ValueError`` where the block
    does not fit."""
    return _wgmma_plan("fused_xent_bwd_dx_bf16w", n, d, v, sm_count,
                       smem_limit, owns_rows=True)


def wgmma_dw_plan(n: int, d: int, v: int, sm_count: int,
                  smem_limit: int) -> WgmmaPlan:
    """The layout of ``fused_xent_bwd_dw_bf16w`` (``wgk::
    xent_bwd_dw_wg_kernel``): 64-column vocabulary blocks, the row tiles
    cut into the fewest balanced chunks that fill the card (one chunk, no
    scratch, at the decoder's loss tail). Raises ``ValueError`` where the
    block does not fit."""
    return _wgmma_plan("fused_xent_bwd_dw_bf16w", n, d, v, sm_count,
                       smem_limit, owns_rows=False)


def _fwd_split_count(owned: int, walked: int, sm_count: int) -> int:
    """The chunks of the ``walked`` tiles that give the shortest walk:
    waves of ``owned`` x S blocks (one an SM) times the longest chunk's
    tiles; the fewest chunks among equals (the fewest partials)."""
    best, best_cost = 1, None
    for splits in range(1, walked + 1):
        waves = -(-owned * splits // sm_count)
        cost = waves * -(-walked // splits)
        if best_cost is None or cost < best_cost:
            best, best_cost = splits, cost
    return best


def wgmma_fwd_plan(n: int, d: int, v: int, sm_count: int,
                   smem_limit: int) -> WgmmaPlan:
    """The layout of ``fused_xent_fwd_bf16w`` (csrc/fused_xent.cu,
    ``wgk::xent_fwd_wg_kernel``) on a card of ``sm_count`` SMs with
    ``smem_limit`` bytes of shared memory a block: 128-row blocks, each
    summing over all of D (``d_pass``: D rounded up to 8, one pass) and
    walking a balanced, contiguous chunk of 256-column vocabulary tiles;
    the chunks S by :func:`_fwd_split_count`, each writing one partial a
    row that a second kernel folds. Raises ``ValueError`` where the
    block does not fit."""
    name = "fused_xent_fwd_bf16w"
    if min(n, d, v, sm_count) < 1:
        raise ValueError(f"{name}: no plan for N {n}, D {d}, V {v} on "
                         f"{sm_count} SMs")
    if WGMMA_FWD_SMEM_BYTES > smem_limit:
        raise ValueError(f"{name}: {WGMMA_FWD_SMEM_BYTES} bytes of shared "
                         f"memory do not fit {smem_limit}")
    owned = -(-n // WGMMA_FWD_ROWS)
    walked = -(-v // WGMMA_FWD_VOCAB_TILE)
    splits = _fwd_split_count(owned, walked, sm_count)
    walks = tuple((s * walked // splits, (s + 1) * walked // splits)
                  for s in range(splits))
    return WgmmaPlan(WGMMA_FWD_ROWS, WGMMA_FWD_VOCAB_TILE, -(-d // 8) * 8, 1,
                     splits, (owned, splits, 1), walks, WGMMA_FWD_STAGES,
                     WGMMA_FWD_STAGE_BYTES, WGMMA_THREADS,
                     WGMMA_FWD_THREAD_SUMS, WGMMA_FWD_SMEM_BYTES,
                     smem_limit // WGMMA_FWD_SMEM_BYTES)


FLOATS = (torch.float32, torch.bfloat16)


def eligible(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the fused path is switched on (``NM_FUSED_XENT=1``) and
    takes these operands (float32 or bf16 each), with no model axis
    (the shape gate of tensor parallelism)."""
    if os.environ.get("NM_FUSED_XENT") not in ("1", "true", "True"):
        return False
    if mesh.size("model") > 1:
        # the vocabulary splits over the model axis: the plain path, as
        # the JAX package keeps its reference there
        kernel_config.log_plain_path(
            "fused_xent", "the vocabulary is split over the model axis")
        return False
    return x.dtype in FLOATS and w.dtype in FLOATS


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


def _wide(t: torch.Tensor) -> torch.Tensor:
    """A bf16 operand widened to float32 (exactly); others as they are."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _instance(name: str, w: torch.Tensor, transposed: bool) -> str:
    """The kernel that takes ``w``: ``name``, or its bf16-W instance: the
    one on warpgroup products where :func:`wgmma_takes` W's layout, else
    the one that widens W."""
    if w.dtype != torch.bfloat16:
        return name
    d, v = w.shape[::-1] if transposed else w.shape
    return (f"{name}_bf16w" if wgmma_takes(d, v, transposed)
            else f"{name}_bf16w_widened")


def _parts(x: torch.Tensor) -> torch.Tensor:
    """The scratch of x's three bf16 parts, (3, N, D rounded up to 8)."""
    n, d = x.shape
    return torch.empty(3, n, -(-d // 8) * 8, dtype=torch.bfloat16,
                       device=x.device)


def _aligned(w: torch.Tensor) -> torch.Tensor:
    """``w``, or a copy of it that starts on a 16-byte boundary."""
    return w if w.data_ptr() % 16 == 0 else w.clone()


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
    w_dtype = torch.bfloat16 if "_bf16w" in name else torch.float32
    kernel_config.check_cuda_inputs(name, x=x, w=w, b=b, **more,
                                    dtypes={"w": w_dtype})


def xent_fwd(x, w, b, targets, eps: float, transposed: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse): launches ``fused_xent_fwd`` (for a bf16 ``w`` its
    bf16-W instance on warpgroup products where :func:`wgmma_takes` W's
    layout, else the widening one) for CUDA tensors
    (:func:`launch_fwd`); runs the plain version otherwise."""
    if not x.is_cuda:
        return fwd_reference(x, _wide(w), b, targets, eps, transposed)
    return launch_fwd(_instance("fused_xent_fwd", w, transposed), x, w, b,
                      targets, eps, transposed)


def launch_fwd(name: str, x, w, b, targets, eps: float, transposed: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse) by the CUDA instance ``name`` (``fused_xent_fwd``, its
    ``_bf16w`` instance, laid out by :func:`wgmma_fwd_plan`, or its
    ``_bf16w_widened`` one): per-row partials of each chunk of the
    vocabulary (a 128-column tile's, or a plan's chunk's), then a fold."""
    _check(name, x, w, b, targets, transposed)
    n, d = x.shape
    vocab = w.shape[0] if transposed else w.shape[1]
    lse, nll = x.new_empty(n), x.new_empty(n)
    if name == "fused_xent_fwd_bf16w":
        plan = wgmma_fwd_plan(n, d, vocab,
                              *kernel_config.tensor_device_limits(x))
        partials = x.new_empty(4, n, plan.splits)
        kernel_config.launch(name, x, _aligned(w), b, targets, partials[0],
                             partials[1], partials[2], partials[3], lse, nll,
                             _parts(x), n, d, vocab, int(transposed),
                             plan.splits, eps)
        return nll, lse
    partials = x.new_empty(4, n, -(-vocab // TILE))
    kernel_config.launch(name, x, w, b, targets, partials[0],
                         partials[1], partials[2], partials[3], lse, nll,
                         n, d, vocab, int(transposed), eps)
    return nll, lse


def xent_bwd_dx(x, w, b, targets, lse, g, eps: float,
                transposed: bool) -> torch.Tensor:
    """dx = dl·Wᵀ: launches ``fused_xent_bwd_dx`` (for a bf16 ``w`` its
    bf16-W instance on warpgroup products where :func:`wgmma_takes` W's
    layout, else the widening one) for CUDA tensors
    (:func:`launch_bwd_dx`); runs the plain version otherwise."""
    if not x.is_cuda:
        return bwd_dx_reference(x, _wide(w), b, targets, lse, g, eps,
                                transposed)
    return launch_bwd_dx(_instance("fused_xent_bwd_dx", w, transposed), x,
                         w, b, targets, lse, g, eps, transposed)


def launch_bwd_dx(name: str, x, w, b, targets, lse, g, eps: float,
                  transposed: bool) -> torch.Tensor:
    """dx by the CUDA instance ``name`` (``fused_xent_bwd_dx``, its
    ``_bf16w`` instance, laid out by :func:`wgmma_dx_plan`, or its
    ``_bf16w_widened`` one), laid out by :func:`dx_plan` otherwise."""
    _check(name, x, w, b, targets, transposed, lse=lse, g=g)
    dx = torch.empty_like(x)
    n, d = x.shape
    vocab = w.shape[0] if transposed else w.shape[1]
    limits = kernel_config.tensor_device_limits(x)
    if name == "fused_xent_bwd_dx_bf16w":
        plan = wgmma_dx_plan(n, d, vocab, *limits)
        scratch = x.new_empty(plan.splits, n, d) if plan.splits > 1 else None
        kernel_config.launch(name, x, _aligned(w), b, targets, lse, g, dx,
                             scratch, _parts(x), n, d, vocab,
                             int(transposed), plan.splits, eps)
        return dx
    plan = dx_plan(n, d, vocab, *limits)
    scratch = x.new_empty(plan.splits, n, d) if plan.splits > 1 else None
    kernel_config.launch(name, x, w, b, targets, lse, g, dx,
                         scratch, n, d, vocab, int(transposed), plan.splits,
                         plan.tiles_per_chunk, eps)
    return dx


def xent_bwd_dw(x, w, b, targets, lse, g, eps: float, transposed: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW = xᵀ·dl in w's layout, float32, db = Σₙ dl): launches
    ``fused_xent_bwd_dw`` (for a bf16 ``w`` its bf16-W instance on
    warpgroup products where :func:`wgmma_takes` W's layout, else the
    widening one) for CUDA tensors (:func:`launch_bwd_dw`); runs the plain
    version otherwise."""
    if not x.is_cuda:
        return bwd_dw_reference(x, _wide(w), b, targets, lse, g, eps,
                                transposed)
    return launch_bwd_dw(_instance("fused_xent_bwd_dw", w, transposed), x,
                         w, b, targets, lse, g, eps, transposed)


def launch_bwd_dw(name: str, x, w, b, targets, lse, g, eps: float,
                  transposed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW, db) by the CUDA instance ``name`` (``fused_xent_bwd_dw``, its
    ``_bf16w`` instance, laid out by :func:`wgmma_dw_plan`, or its
    ``_bf16w_widened`` one), laid out by :func:`dw_plan` otherwise."""
    _check(name, x, w, b, targets, transposed, lse=lse, g=g)
    dw = torch.empty(w.shape, device=w.device)
    db = torch.empty_like(b)
    n, d = x.shape
    vocab = w.shape[0] if transposed else w.shape[1]
    limits = kernel_config.tensor_device_limits(x)
    wgmma = name == "fused_xent_bwd_dw_bf16w"
    plan = (wgmma_dw_plan if wgmma else dw_plan)(n, d, vocab, *limits)
    scratch = db_scratch = None
    if plan.splits > 1:
        scratch = x.new_empty(plan.splits, *w.shape)
        db_scratch = x.new_empty(plan.splits, vocab)
    if wgmma:
        kernel_config.launch(name, x, _aligned(w), b, targets, lse, g, dw,
                             db, scratch, db_scratch, _parts(x), n, d,
                             vocab, int(transposed), plan.splits, eps)
        return dw, db
    kernel_config.launch(name, x, w, b, targets, lse, g, dw,
                         db, scratch, db_scratch, n, d, vocab,
                         int(transposed), plan.splits, plan.tiles_per_chunk,
                         eps)
    return dw, db


class _FusedXent(torch.autograd.Function):
    """``fused_xent._fused``'s custom VJP: the forward keeps only the
    per-row log-sum-exp; the backward recomputes the logits. A bf16 x
    is widened (exactly); dx and dW come back in x's and w's dtypes."""

    @staticmethod
    def forward(ctx, x, w, b, targets, eps: float, transposed: bool):
        ctx.x_dtype = x.dtype
        x = _wide(x)
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
                             ctx.transposed).to(ctx.x_dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = xent_bwd_dw(x, w, b, targets, lse, g, ctx.eps,
                                 ctx.transposed)
            dw = dw.to(w.dtype)
        return dx, dw, db, None, None, None


def fused_softmax_xent(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       targets: torch.Tensor, eps: float = 0.0,
                       transposed: bool = False) -> torch.Tensor:
    """Per-token label-smoothed cross-entropy (N,) of
    ``logits = x @ w + b`` without materialized logits on the card.

    x: (N, D) f32 or bf16; w: (V, D) when ``transposed`` (a tied
    embedding table) else (D, V), f32 or bf16; b: (V,) f32; targets:
    (N,) ints in [0, V)."""
    return _FusedXent.apply(x.contiguous(), w.contiguous(), b.contiguous(),
                            targets.to(torch.int32).contiguous(),
                            float(eps or 0.0), bool(transposed))
