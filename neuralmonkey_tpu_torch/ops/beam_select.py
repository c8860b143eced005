"""Beam-selection kernels: K3 (fused logits + reductions), ``rowmax_lse``
and K4 (top-k).

Counterpart of ``neuralmonkey_tpu/ops/beam_select.py``. The
hierarchical beam selector (``models/decoders/beam_search_decoder.py``
``_select_hier``) needs, per step, the maximum of every 128-column
group of each row of logits (``rowmax``) and each row's log-sum-exp
(``lse``). ``fused_logits_rowmax_lse`` computes both in the epilogue of
the logit projection itself (K3, ``csrc/beam_select.cu``), which the
beam search arms unless ``NM_FUSED_LOGITS=0``; ``rowmax_lse`` computes
them over existing logits, in one read, when it does not.
``small_topk`` is the exact top-k both selection stages use (K4).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..parallel import mesh
from . import kernel_config, nn

LANE = 128
# K4 (csrc/beam_select.cu): sorted lists of 16, 32 or 64 entries a lane, so
# k up to 64 (the JAX small_topk runs its reference past that too); a warp
# reads a row in chunks of TOPK_WARP_SPAN entries (32 a lane), and a row
# longer than one chunk is shared by a warp a chunk (rounded up to a power
# of two, at most 8); one-warp rows go 4 to a block
TOPK_LIST_SIZES = (16, 32, 64)
TOPK_WARP_SPAN = 1024
TOPK_ROWS_PER_BLOCK = 4
# a warp's shared floats: its k-list (64 entries, for a long row's merge)
# and its candidates (256 entries), values then indices
_TOPK_WARP_FLOATS = 2 * (64 + 256)


def topk_kernel_takes(k: int) -> bool:
    """Whether K4 takes this k (at most 64): the shape gate of
    :func:`small_topk`."""
    return 0 < k <= TOPK_LIST_SIZES[-1]


class TopkPlan(NamedTuple):
    """The launch of K4: per-lane lists of ``k_max`` entries,
    ``warps_per_row`` warps a row, ``rows_per_block`` rows a block in
    ``blocks`` blocks, float4 loads when ``vec``, ``smem_bytes`` of
    shared memory a block (each warp's candidates, and its k-list, which
    a row's warps merge)."""
    k_max: int
    warps_per_row: int
    rows_per_block: int
    blocks: int
    vec: bool
    smem_bytes: int


def topk_plan(batch: int, n: int, k: int, aligned: bool = True
              ) -> TopkPlan:
    """Lay out K4 for ``batch`` rows of ``n`` entries: one warp a row up
    to ``TOPK_WARP_SPAN`` entries, 4 rows a block; past it, a warp per
    ``TOPK_WARP_SPAN`` entries (2, 4 or 8) and fewer rows a block, so
    that a long row's chunks are read at once (at 64 x 2400 on an H100,
    4 warps a row took 0.0090 ms against one warp's 0.0108). Float4
    loads need ``n`` a multiple of 4 and an ``aligned`` row base."""
    if not (topk_kernel_takes(k) and batch > 0 and k <= n):
        raise ValueError(f"small_topk: no plan for k={k} over {batch} rows "
                         f"of {n} (k at most {TOPK_LIST_SIZES[-1]})")
    k_max = next(size for size in TOPK_LIST_SIZES if k <= size)
    warps = 1
    if n > TOPK_WARP_SPAN:
        warps = min(8, 1 << (-(-n // TOPK_WARP_SPAN) - 1).bit_length())
    rows = max(1, TOPK_ROWS_PER_BLOCK // warps)
    smem = 4 * warps * rows * _TOPK_WARP_FLOATS
    return TopkPlan(k_max, warps, rows, -(-batch // rows),
                    aligned and n % 4 == 0, smem)


def rowmax_lse_reference(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``rowmax_lse``."""
    n, vp = x.shape
    rowmax = x.reshape(n, vp // LANE, LANE).amax(dim=2)
    return rowmax, torch.logsumexp(x, dim=1)


def rowmax_lse(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-128-column-group maxima (N, R) and per-row log-sum-exp (N,)
    of (N, R·128) f32 logits. Launches ``rowmax_lse`` for CUDA tensors,
    runs the plain version otherwise."""
    n, vp = x.shape
    if vp % LANE:
        raise ValueError(f"rowmax_lse: x {tuple(x.shape)}; the row length "
                         f"must be a multiple of {LANE}")
    if not x.is_cuda:
        return rowmax_lse_reference(x)
    if n == 0 or vp == 0:
        raise ValueError(f"rowmax_lse: empty x {(n, vp)}")
    kernel_config.check_cuda_inputs("rowmax_lse", x=x)
    if x.data_ptr() % 16:
        raise ValueError("rowmax_lse: x is not 16-byte aligned")
    groups = vp // LANE
    rowmax = x.new_empty(n, groups)
    partial_sums = x.new_empty(n, groups)
    lse = x.new_empty(n)
    kernel_config.launch("rowmax_lse", x, rowmax, partial_sums, lse, n, vp)
    return rowmax, lse


def fused_logits_reference(x: torch.Tensor, w: torch.Tensor,
                           b: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Plain version of K3: (logits (N, Vp), rowmax (N, Vp/128),
    lse (N,)) of ``x @ w + b``, float32 (a bf16 operand widened)."""
    logits = nn.dot(x, w) + b
    return (logits, *rowmax_lse_reference(logits))


def fused_logits_rowmax_lse(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Logit projection with the selector's two reductions fused into
    its epilogue, so the (N, Vp) logits are written once and never
    re-read. ``x`` (N, D) prelogit rows, ``w`` (D, Vp) with Vp a
    multiple of 128, ``b`` (1, Vp) or (Vp,) bias (pad columns carry a
    large negative bias). Launches K3 for CUDA tensors, runs the plain
    version otherwise, and under a model axis (its shape gate, as the
    JAX package's). K3 computes in float32: a bf16 x or w is widened
    first, exactly, so it computes the plain version's float32 logits;
    any other dtype raises. The beam search arms it with a float32 w
    under either policy (the bf16 table widened,
    ``prepare_selection_fusion``), as the JAX package does."""
    b = b.reshape(-1)
    n, d = x.shape
    vp = w.shape[1]
    if w.shape[0] != d or b.shape[0] != vp or vp % LANE:
        raise ValueError(
            f"fused_logits_rowmax_lse: x {tuple(x.shape)}, w "
            f"{tuple(w.shape)}, b {tuple(b.shape)}; Vp must be a "
            f"multiple of {LANE}")
    if mesh.size("model") > 1:
        # under tensor parallelism the JAX package keeps K3 on its
        # reference (its vocabulary would split over the model axis)
        kernel_config.log_plain_path(
            "fused_logits_rowmax_lse", "a model axis is on")
        return fused_logits_reference(x, w, b)
    if not x.is_cuda:
        return fused_logits_reference(x, w, b)
    x, w = (t.float() if t.dtype == torch.bfloat16 else t for t in (x, w))
    if n == 0 or d == 0:
        raise ValueError(f"fused_logits_rowmax_lse: empty x {(n, d)}")
    kernel_config.check_cuda_inputs("fused_logits_rowmax_lse",
                                    x=x, w=w, b=b)
    groups = vp // LANE
    logits = x.new_empty(n, vp)
    rowmax = x.new_empty(n, groups)
    partial_sums = x.new_empty(n, groups)
    lse = x.new_empty(n)
    kernel_config.launch("fused_logits_rowmax_lse", x, w, b, logits,
                         rowmax, partial_sums, lse, n, d, vp)
    return logits, rowmax, lse


def topk_reference(x: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4. A stable descending sort puts equal values
    in index order, which is ``lax.top_k``'s tie rule; ``torch.topk``
    promises no tie order and cannot stand in."""
    values, indices = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], indices[:, :k].to(torch.int32)


def small_topk(x: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the trailing axis of (B, n) f32: values (B, k)
    best first and int32 indices (B, k), ties to the lowest index.
    Launches K4 for CUDA tensors when it takes k (at most 64), runs the
    plain version otherwise, as the JAX ``small_topk`` does past its
    gate."""
    batch, n = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"small_topk: k={k} for rows of {n}")
    if not x.is_cuda:
        return topk_reference(x, k)
    if not topk_kernel_takes(k):
        kernel_config.log_plain_path(
            "small_topk", f"k {k} > {TOPK_LIST_SIZES[-1]}")
        return topk_reference(x, k)
    if batch == 0:
        raise ValueError(f"small_topk: empty x {(batch, n)}")
    x = x.contiguous()
    kernel_config.check_cuda_inputs("small_topk", x=x)
    plan = topk_plan(batch, n, k, aligned=x.data_ptr() % 16 == 0)
    values = x.new_empty(batch, k)
    indices = torch.empty(batch, k, dtype=torch.int32, device=x.device)
    kernel_config.launch("small_topk", x, values, indices, batch, n, k,
                         plan.k_max, plan.warps_per_row, plan.rows_per_block,
                         int(plan.vec), plan.smem_bytes)
    return values, indices
