"""Flash attention: kernels ``flash_attention_fwd``,
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` and their
plain PyTorch versions.

Counterpart of the flash half of ``neuralmonkey_tpu/ops/pallas_attention.py``
(``_flash_attention_pallas``, ``_flash_backward_pallas``). The kernels
are ``csrc/flash_attention.cu``; :class:`_FlashAttention` launches the
forward on CUDA tensors and saves ``out`` and the per-row log-sum-exp;
its backward launches the dq and dkv kernels with
``dcap = rowsum(dO * O)``. On the CPU the same Function runs the plain
versions, which repeat the kernels' arithmetic on dense scores.

Semantics, as in the TPU kernels: masked scores are -1e9 (not -inf),
so a query row with no valid key gets uniform weights; the row sum is
floored at 1e-20; attention dropout falls after the softmax, so the
normaliser sums the undropped probabilities and the context sums
``p * keep / kp``. The keep bit of score (b, h, q, k) is a counter-based
hash of two int32 key words, ``b * heads + h`` and ``q * Tk + k``
(:func:`keep_hash`), computed in uint32 arithmetic in the kernels and
here, so the kernels, the plain versions and the JAX package draw the
same mask from the same key words.

``NM_FLASH_BWD=0`` takes the gradient of CPU tensors by autograd
through the dense plain version (the JAX package's XLA
rematerialisation) instead of the backward kernels' plain version; on
CUDA tensors it raises, since the backward kernels are the only
gradient on the card. The JAX package picks its remat below 2 GB of
scores by a measurement on its TPU, which does not carry over.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import torch

from . import kernel_config

NEG_INF = -1e9
KEEP_BITS = 23
MAX_HEAD_DIM = 256
_U32 = 0xFFFFFFFF
_MIX1, _MIX2, _GOLD = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9

KeyWords = Tuple[int, int]


# ---------------------------------------------------------------------- #
# the dropout hash (``_fmix32``, ``_keep_hash``, ``_keep_thresh``)
# ---------------------------------------------------------------------- #
def _mul32(h: torch.Tensor, const: int) -> torch.Tensor:
    """``h * const mod 2**32`` for int64 tensors holding uint32 values,
    in two 16-bit halves so no product leaves int64."""
    lo = h * (const & 0xFFFF)
    hi = ((h * (const >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on uint32 values held in int64."""
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX2)
    return h ^ (h >> 16)


def keep_hash(k0: int, k1: int, bh: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """The keep bits of the scores at (batch·head ``bh``, ``pos`` =
    q·Tk + k) as uint32 values in int64."""
    h = fmix32((pos & _U32) ^ (k0 & _U32))
    return fmix32(h ^ _mul32(bh & _U32, _GOLD) ^ (k1 & _U32))


def keep_threshold(keep_prob: float) -> int:
    return int(round(keep_prob * (1 << KEEP_BITS)))


def keep_mask_dense(key_words: KeyWords, batch: int, heads: int,
                    q_len: int, kv_len: int, keep_prob: float,
                    device=None) -> torch.Tensor:
    """The kernels' keep mask materialised: (B, H, Tq, Tk) bool."""
    bh = torch.arange(batch * heads, dtype=torch.int64,
                      device=device).reshape(batch, heads, 1, 1)
    pos = (torch.arange(q_len, dtype=torch.int64, device=device)[:, None]
           * kv_len
           + torch.arange(kv_len, dtype=torch.int64, device=device)[None])
    bits = keep_hash(key_words[0], key_words[1], bh, pos[None, None])
    return (bits & ((1 << KEEP_BITS) - 1)) < keep_threshold(keep_prob)


def dropout_key_words(seed: int) -> KeyWords:
    """Two int32 key words for the keep hash, drawn from a CPU generator
    seeded with ``seed`` (the JAX package's ``rng_to_key_words``). The
    words are host integers, so the card and the CPU draw the same mask
    from the same seed and the launch needs no device read."""
    gen = torch.Generator().manual_seed(seed)
    words = torch.randint(-2 ** 31, 2 ** 31, (2,), generator=gen,
                          dtype=torch.int64)
    return int(words[0]), int(words[1])


# ---------------------------------------------------------------------- #
# plain versions
# ---------------------------------------------------------------------- #
def _scores(q, k, mask, causal: bool, scale: float) -> torch.Tensor:
    """(B, H, Tq, Tk) scaled scores with masked entries at -1e9."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    valid = (mask > 0)[:, None, None, :]
    if causal:
        q_len, kv_len = q.shape[2], k.shape[2]
        valid = valid & torch.ones(q_len, kv_len, dtype=torch.bool,
                                   device=q.device).tril()
    return torch.where(valid, s, NEG_INF)


def _keep_scaled(x: torch.Tensor, key_words: Optional[KeyWords],
                 keep_prob: float) -> torch.Tensor:
    if key_words is None or keep_prob >= 1.0:
        return x
    batch, heads, q_len, kv_len = x.shape
    keep = keep_mask_dense(key_words, batch, heads, q_len, kv_len,
                           keep_prob, x.device)
    return torch.where(keep, x, 0.0) * (1.0 / keep_prob)


def flash_forward_reference(q, k, v, mask, causal: bool,
                            key_words: Optional[KeyWords] = None,
                            keep_prob: float = 1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``flash_attention_fwd``: (out (B, H, Tq, Dh),
    lse (B, H, Tq)). Differentiable by autograd (the remat backward)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, mask, causal, scale)
    row_max = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - row_max)
    row_sum = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    pv = _keep_scaled(p, key_words, keep_prob)
    out = torch.matmul(pv, v) / row_sum
    lse = (row_max + torch.log(row_sum))[..., 0]
    return out, lse


def flash_backward_reference(q, k, v, mask, out, lse, g, causal: bool,
                             key_words: Optional[KeyWords] = None,
                             keep_prob: float = 1.0
                             ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the dq and dkv kernels: (dq, dk, dv) from the
    probabilities recomputed as ``exp(s - lse)``."""
    return _backward_reference(q, k, v, mask, lse, g, (g * out).sum(dim=-1),
                               causal, key_words, keep_prob)


def _backward_reference(q, k, v, mask, lse, g, dcap, causal: bool,
                        key_words: Optional[KeyWords], keep_prob: float):
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, mask, causal, scale) - lse[..., None])
    dcap = dcap[..., None]
    dp = _keep_scaled(torch.matmul(g, v.transpose(-1, -2)), key_words,
                       keep_prob)
    pd = _keep_scaled(p, key_words, keep_prob)
    ds = p * (dp - dcap)
    dq = torch.matmul(ds, k) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q) * scale
    dv = torch.matmul(pd.transpose(-1, -2), g)
    return dq, dk, dv


# ---------------------------------------------------------------------- #
# kernel wrappers
# ---------------------------------------------------------------------- #
# csrc/flash_attention.cu: every kernel runs blocks of THREADS threads,
# each owning ROWS rows and walking the other axis TILE rows at a time
THREADS, ROWS, TILE = 128, 32, 32


def kernel_takes(head_dim: int) -> bool:
    """Whether the kernels take this head dim (1 to 256, padded to 32,
    64, 128 or 256). The JAX flash kernels pad any head dim; past 256 the
    wrappers raise on CUDA tensors (ROADMAP queue C) and run the plain
    versions on the CPU."""
    return 0 < head_dim <= MAX_HEAD_DIM


def _width(name: str, head_dim: int) -> int:
    """The head dimension rounded up to a width the kernels are built
    for (float4 columns of 8 threads need at least 32)."""
    if not kernel_takes(head_dim):
        raise ValueError(f"{name}: head dim {head_dim}")
    return next(w for w in (32, 64, 128, 256) if head_dim <= w)


class FlashForwardPlan(NamedTuple):
    """The launch of ``flash_attention_fwd``: a (``grid``) of blocks of
    ``threads``, each owning ``rows`` queries of one (batch, head) and
    walking the keys ``key_tile`` at a time through ``stages`` buffers;
    the head dimension padded to ``width``; ``smem_bytes`` of shared
    memory a block."""
    grid: Tuple[int, int]
    threads: int
    rows: int
    key_tile: int
    stages: int
    width: int
    smem_bytes: int


def flash_forward_plan(batch: int, heads: int, q_len: int, kv_len: int,
                       head_dim: int) -> FlashForwardPlan:
    """What ``nm_flash_fwd`` launches for these sizes (the same
    arithmetic as the C entry point)."""
    width = _width("flash_attention_fwd", head_dim)
    stages = 2 if kv_len > TILE else 1
    stage = TILE * (width + 4) + TILE * width + TILE
    smem = 4 * (ROWS * (width + 4) + stages * stage)
    return FlashForwardPlan((batch * heads, -(-q_len // ROWS)), THREADS,
                            ROWS, TILE, stages, width, smem)


class FlashBackwardLaunch(NamedTuple):
    """One backward kernel's launch: a (``grid``) of blocks of
    ``threads``; block (bh, y) owns ``rows`` rows of its axis (queries
    for dq, keys for dkv) from ``y * rows`` and walks the tiles
    ``walks[y]`` = [first, end) of the other axis, ``tile`` rows at a
    time through ``stages`` buffers; the head dimension padded to
    ``width``; ``smem_bytes`` of shared memory a block."""
    grid: Tuple[int, int]
    threads: int
    rows: int
    tile: int
    walks: Tuple[Tuple[int, int], ...]
    stages: int
    width: int
    smem_bytes: int


class FlashBackwardPlan(NamedTuple):
    dq: FlashBackwardLaunch
    dkv: FlashBackwardLaunch


def flash_backward_plan(batch: int, heads: int, q_len: int, kv_len: int,
                        head_dim: int, causal: bool) -> FlashBackwardPlan:
    """What ``nm_flash_bwd_dq`` and ``nm_flash_bwd_dkv`` launch for these
    sizes (the same arithmetic as the C entry points and kernels)."""
    width = _width("flash_attention_bwd", head_dim)

    def launch(own: int, other: int, vectors: int, walks):
        # a block holds its rows of two matrices (q and dO, or k and v)
        # and, a stage, a tile of the other two and ``vectors`` tile-long
        # vectors (the key mask; lse and dcap)
        stages = 2 if other > TILE else 1
        stage = 2 * TILE * (width + 4) + vectors * TILE
        smem = 4 * (2 * ROWS * (width + 4) + stages * stage)
        return FlashBackwardLaunch((batch * heads, -(-own // ROWS)),
                                   THREADS, ROWS, TILE, tuple(walks),
                                   stages, width, smem)

    key_tiles, query_tiles = -(-kv_len // TILE), -(-q_len // TILE)
    # causal: dq stops at the key tile holding its last query's diagonal,
    # dkv starts at the query tile holding its first key
    dq_walks = [(0, min(key_tiles, (y * ROWS + ROWS + TILE - 1) // TILE)
                 if causal else key_tiles)
                for y in range(-(-q_len // ROWS))]
    dkv_walks = [((y * ROWS) // TILE if causal else 0, query_tiles)
                 for y in range(-(-kv_len // ROWS))]
    return FlashBackwardPlan(launch(q_len, kv_len, 1, dq_walks),
                             launch(kv_len, q_len, 2, dkv_walks))


def _dropout_args(key_words: Optional[KeyWords], keep_prob: float):
    """(dropout, k0, k1, threshold, 1/keep_prob) as the kernels take
    them."""
    if key_words is None or keep_prob >= 1.0:
        return 0, 0, 0, 0, 1.0
    return 1, key_words[0], key_words[1], keep_threshold(keep_prob), \
        1.0 / keep_prob


def _check(name: str, q, k, v, mask, **more) -> Tuple[int, ...]:
    batch, heads, q_len, head_dim = q.shape
    kv_len = k.shape[2]
    if (k.shape != (batch, heads, kv_len, head_dim) or v.shape != k.shape
            or mask.shape != (batch, kv_len)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(mask.shape)}")
    if min(batch, heads, q_len, kv_len) == 0 or not kernel_takes(head_dim):
        raise ValueError(f"{name}: unsupported shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} (head dim at most "
                         f"{MAX_HEAD_DIM})")
    kernel_config.check_cuda_inputs(name, q=q, k=k, v=v, mask=mask, **more)
    return batch, heads, q_len, kv_len, head_dim


def flash_forward(q, k, v, mask, causal: bool,
                  key_words: Optional[KeyWords] = None,
                  keep_prob: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): launches ``flash_attention_fwd`` for CUDA tensors,
    runs the plain version otherwise."""
    if not q.is_cuda:
        return flash_forward_reference(q, k, v, mask, causal, key_words,
                                       keep_prob)
    batch, heads, q_len, kv_len, head_dim = _check(
        "flash_attention_fwd", q, k, v, mask)
    drop = _dropout_args(key_words, keep_prob)
    out = torch.empty_like(q)
    lse = q.new_empty(batch, heads, q_len)
    kernel_config.launch(
        "flash_attention_fwd", q, k, v, mask, out, lse, batch, heads,
        q_len, kv_len, head_dim, int(causal), *drop[:4],
        1.0 / math.sqrt(head_dim), drop[4])
    return out, lse


def _backward_sizes(q, k, v, mask, lse, g, dcap, causal: bool,
                    key_words: Optional[KeyWords], keep_prob: float):
    """The backward kernels' scalar arguments, after the checks."""
    batch, heads, q_len, kv_len, head_dim = _check(
        "flash_attention_bwd", q, k, v, mask, lse=lse, g=g, dcap=dcap)
    if g.shape != q.shape or lse.shape != q.shape[:3] \
            or dcap.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: g {tuple(g.shape)}, lse "
                         f"{tuple(lse.shape)}, dcap {tuple(dcap.shape)} for "
                         f"q {tuple(q.shape)}")
    drop = _dropout_args(key_words, keep_prob)
    return (batch, heads, q_len, kv_len, head_dim, int(causal), *drop[:4],
            1.0 / math.sqrt(head_dim), drop[4])


def flash_backward_dq(q, k, v, mask, lse, g, dcap, causal: bool,
                      key_words: Optional[KeyWords] = None,
                      keep_prob: float = 1.0) -> torch.Tensor:
    """dq: launches ``flash_attention_bwd_dq`` for CUDA tensors, runs the
    plain version otherwise; ``dcap = rowsum(g * out)`` (B, H, Tq)."""
    if not q.is_cuda:
        return _backward_reference(q, k, v, mask, lse, g, dcap, causal,
                                   key_words, keep_prob)[0]
    sizes = _backward_sizes(q, k, v, mask, lse, g, dcap, causal,
                            key_words, keep_prob)
    dq = torch.empty_like(q)
    kernel_config.launch("flash_attention_bwd_dq", q, k, v, mask, g, lse,
                         dcap, dq, *sizes)
    return dq


def flash_backward_dkv(q, k, v, mask, lse, g, dcap, causal: bool,
                       key_words: Optional[KeyWords] = None,
                       keep_prob: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv): launches ``flash_attention_bwd_dkv`` for CUDA tensors,
    runs the plain version otherwise."""
    if not q.is_cuda:
        return _backward_reference(q, k, v, mask, lse, g, dcap, causal,
                                   key_words, keep_prob)[1:]
    sizes = _backward_sizes(q, k, v, mask, lse, g, dcap, causal,
                            key_words, keep_prob)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernel_config.launch("flash_attention_bwd_dkv", q, k, v, mask, g, lse,
                         dcap, dk, dv, *sizes)
    return dk, dv


def flash_backward(q, k, v, mask, out, lse, g, causal: bool,
                   key_words: Optional[KeyWords] = None,
                   keep_prob: float = 1.0) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv): launches ``flash_attention_bwd_dq`` and
    ``flash_attention_bwd_dkv`` for CUDA tensors, runs the plain version
    otherwise."""
    if not q.is_cuda:
        return flash_backward_reference(q, k, v, mask, out, lse, g, causal,
                                        key_words, keep_prob)
    if out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} for "
                         f"q {tuple(q.shape)}")
    dcap = (g * out).sum(dim=-1)
    args = (q, k, v, mask, lse, g, dcap, causal, key_words, keep_prob)
    return (flash_backward_dq(*args), *flash_backward_dkv(*args))


def use_remat_backward(on_cuda: bool) -> bool:
    """Whether ``NM_FLASH_BWD=0`` asks for the dense remat backward; it
    raises for CUDA tensors, whose gradient the kernels compute."""
    if os.environ.get("NM_FLASH_BWD") not in ("0", "false", "False"):
        return False
    if on_cuda:
        raise NotImplementedError(
            "NM_FLASH_BWD=0: the remat backward through the plain version "
            "runs on CPU tensors only; on the card flash attention's "
            "gradient comes from the dq and dkv kernels (unset the switch)")
    return True


class _FlashAttention(torch.autograd.Function):
    """``pallas_attention.flash_attention``'s custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal: bool, key_words, keep_prob):
        out, lse = flash_forward(q, k, v, mask, causal, key_words,
                                 keep_prob)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.key_words, ctx.keep_prob = causal, key_words, \
            keep_prob
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, lse = ctx.saved_tensors
        args = (ctx.causal, ctx.key_words, ctx.keep_prob)
        if use_remat_backward(q.is_cuda):
            inputs = [t.detach().requires_grad_() for t in (q, k, v)]
            with torch.enable_grad():
                ref, _ = flash_forward_reference(*inputs, mask, *args)
                dq, dk, dv = torch.autograd.grad(ref, inputs, g)
        else:
            dq, dk, dv = flash_backward(q, k, v, mask, out, lse,
                                        g.contiguous(), *args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, causal: bool = False,
                    key_words: Optional[KeyWords] = None,
                    keep_prob: float = 1.0) -> torch.Tensor:
    """(B, H, Tq, Dh) x (B, H, Tk, Dh) -> (B, H, Tq, Dh) with a (B, Tk)
    key mask, an optional causal mask and, with ``key_words`` and
    ``keep_prob < 1``, attention dropout from the keep hash."""
    return _FlashAttention.apply(
        q.contiguous(), k.contiguous(), v.contiguous(),
        mask.to(torch.float32).contiguous(), bool(causal), key_words,
        float(keep_prob))
