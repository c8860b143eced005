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
``csrc/lineage_attention.cu``, a pipelined stream of lane tiles of the
caches laid out by :func:`lineage_plan`. The TPU kernel's padding of
the beam to 8 rows, its 128-lane window rounding and its VMEM lane
budget are TPU layout rules: here the kernel takes the K rows, exactly
the window's lanes, any number of them, and any head dim
(:func:`kernel_takes`): up to 512 in one pass, past it a chunked
instance (a block a slot and 512 context columns, the scores summed
over the whole head dim; counted as ``lineage_attention_chunked``). So
the decoder keeps its caches in the kernel's layout wherever it is
asked to (``NM_LINEAGE_KERNEL=1``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import kernel_config

NEG_INF = -1e9
# csrc/lineage_attention.cu: head dims up to 512 in one pass (padded to 32,
# 64, 128, 256 or 512); slot rows in tiles of 8, up to 4 tiles a block;
# stages of 32 lanes (16 past a padded 256), each 16-lane tile of a stage a
# warp's, for each slot tile. Past 512 the chunked instance: a block of
# WIDE_THREADS threads a slot, WIDE_LANES lanes a tile, WIDE_COLUMNS
# context columns a column block
MAX_HEAD_DIM = 512
WIDE_THREADS, WIDE_LANES, WIDE_COLUMNS = 128, 32, 512
HEAD_DIM_PADS = (32, 64, 128, 256, 512)
SLOT_TILE = 8
MAX_SLOT_TILES = 4
# an H100 SM's shared memory (228 KB), 1 KB of it reserved for each block,
# its thread limit and its registers
SM_SHARED_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024
SM_THREADS = 2048
SM_REGISTERS = 65536


def kernel_takes(head_dim: int) -> bool:
    """Whether the kernel takes this head dim: every positive one."""
    return head_dim > 0


def is_chunked(head_dim: int) -> bool:
    """Whether this head dim runs the chunked instance."""
    return head_dim > MAX_HEAD_DIM


def wide_smem_bytes(head_dim: int) -> int:
    """The chunked instance's shared bytes: q (rounded up to 4 floats),
    each warp's partial scores of a tile, the tile's weights, and the
    rescale, max and sum."""
    return 4 * (-(-head_dim // 4) * 4 + WIDE_THREADS // 32 * WIDE_LANES
                + WIDE_LANES + 4)


def lane_tile(dmax: int) -> int:
    """Lanes a stage at a padded head dim: 32, or 16 past 256 (two
    stages of 32 lanes would not fit)."""
    return 16 if dmax > 256 else 32


def thread_registers(dmax: int) -> int:
    """Registers a thread, as the kernel's launch bounds set them: 128,
    or 256 from a padded 256 (whose context takes 64 or 128 of them)."""
    return 256 if dmax >= 256 else 128


class LineagePlan(NamedTuple):
    """The launch of ``lineage_attention``: the head dim padded to
    ``dmax``; ``slots`` slot rows a block (the beam, or its share of
    ``groups`` groups, rounded up to the products' 8-wide tiles); a warp
    for each 16-lane tile of a ``tile``-lane stage and each 8 slots
    (``threads`` a block); the lanes cut into ``splits`` chunks of
    ``chunk`` lanes (a multiple of the tile), each block streaming its
    chunk through a ring of ``stages`` stages, with 16-byte copies when
    ``vec`` (4-byte otherwise); ``smem_bytes`` of shared memory a block;
    ``blocks_per_sm`` resident by shared memory, threads and registers.
    Past ``MAX_HEAD_DIM`` (the chunked instance) a block owns one slot
    (``slots`` 1, ``groups`` the beam) and one of ``column_blocks``
    blocks of ``dmax`` context columns, in one stage."""
    dmax: int
    slots: int
    groups: int
    tile: int
    threads: int
    splits: int
    chunk: int
    stages: int
    vec: bool
    smem_bytes: int
    blocks_per_sm: int
    column_blocks: int = 1


def lineage_smem_bytes(dmax: int, slots: int, tile: int, stages: int) -> int:
    """A block's shared bytes, as ``csrc/lineage_attention.cu`` lays them
    out: the ring (a K tile [d][lane] and a V tile [lane][d], rows padded
    by 8 floats, and a bias tile a stage), q [slot][d] (rows padded by 4),
    and each warp's 16 x 8 weights."""
    stage = dmax * (tile + 8) + tile * (dmax + 8) + slots * tile
    warps = tile // 16 * slots // SLOT_TILE
    return 4 * (stages * stage + slots * (dmax + 4) + warps * 128)


def _lane_split(lanes: int, tile: int, blocks: int, sm_count: int):
    """(splits, chunk): when ``blocks`` do not fill the card twice,
    chunks of whole tiles, enough that they do where the lanes allow
    (never an empty chunk)."""
    tiles = -(-lanes // tile)
    chunk_tiles = tiles
    if blocks < 2 * sm_count:
        chunk_tiles = max(1, tiles // -(-2 * sm_count // blocks))
    return -(-tiles // chunk_tiles), chunk_tiles * tile


def _wide_plan(batch: int, heads: int, beam: int, head_dim: int,
               lanes: int, sm_count: int, smem_limit: int) -> LineagePlan:
    """The chunked instance's launch past ``MAX_HEAD_DIM``."""
    smem = wide_smem_bytes(head_dim)
    if smem > smem_limit:
        raise ValueError(f"lineage_attention: Dh {head_dim} does not fit "
                         f"{smem_limit} bytes of shared memory")
    column_blocks = -(-head_dim // WIDE_COLUMNS)
    splits, chunk = _lane_split(
        lanes, WIDE_LANES, batch * heads * beam * column_blocks, sm_count)
    resident = min(SM_THREADS // WIDE_THREADS,
                   SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES),
                   SM_REGISTERS // (128 * WIDE_THREADS))
    return LineagePlan(WIDE_COLUMNS, 1, beam, WIDE_LANES, WIDE_THREADS,
                       splits, chunk, 1, False, smem, resident,
                       column_blocks)


def lineage_plan(batch: int, heads: int, beam: int, head_dim: int,
                 total: int, lanes: int, sm_count: int, smem_limit: int,
                 aligned: bool = True) -> LineagePlan:
    """Lay out one launch over caches of ``total`` lanes, ``lanes`` of
    them read. Stages: those that keep the most warps resident an SM (a
    block's warps work in step between its barriers, so resident blocks
    hide latency where more stages did not), then the most blocks, then
    the most stages; the most slot tiles a block that fit. Lane split:
    when ``batch * heads * groups`` blocks do not fill the card twice,
    chunks of whole tiles, enough that they do where the lanes allow
    (never an empty chunk). 16-byte copies need the caches'
    rows and the head dim in multiples of 4 floats and ``aligned``
    pointers."""
    if not (kernel_takes(head_dim) and min(batch, heads, beam, sm_count) > 0
            and 0 < lanes <= total):
        raise ValueError(
            f"lineage_attention: no plan for B {batch}, H {heads}, K {beam}"
            f", Dh {head_dim}, {lanes} of {total} lanes")
    if is_chunked(head_dim):
        return _wide_plan(batch, heads, beam, head_dim, lanes, sm_count,
                          smem_limit)
    dmax = next(pad for pad in HEAD_DIM_PADS if head_dim <= pad)
    tile = lane_tile(dmax)
    best = None
    # the most slot tiles a block (each K and V tile read by fewer groups)
    # that fit, wide heads taking fewer
    for slot_tiles in range(min(MAX_SLOT_TILES, -(-beam // SLOT_TILE)),
                            0, -1):
        slots = SLOT_TILE * slot_tiles
        threads = 32 * tile // 16 * slot_tiles
        for stages in (2, 3, 4):
            smem = lineage_smem_bytes(dmax, slots, tile, stages)
            if smem > smem_limit:
                break
            resident = min(
                SM_THREADS // threads,
                SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES),
                SM_REGISTERS // (thread_registers(dmax) * threads))
            key = (resident * threads, resident, stages)
            if best is None or key > best[0]:
                best = (key, slots, threads, stages, smem, resident)
        if best is not None:
            break
    if best is None:
        raise ValueError(f"lineage_attention: Dh {head_dim} does not fit "
                         f"{smem_limit} bytes of shared memory")
    _, slots, threads, stages, smem, resident = best
    groups = -(-beam // slots)
    splits, chunk = _lane_split(lanes, tile, batch * heads * groups,
                                sm_count)
    vec = aligned and total % 4 == 0 and head_dim % 4 == 0
    return LineagePlan(dmax, slots, groups, tile, threads, splits, chunk,
                       stages, vec, smem, resident)


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
            or not kernel_takes(head_dim)):
        raise ValueError(
            f"lineage_attention: q {tuple(q.shape)}, k {tuple(k_cache.shape)}"
            f", v {tuple(v_cache.shape)}, bias {tuple(bias.shape)}")
    kernel_config.check_cuda_inputs("lineage_attention", q=q, k=k_cache,
                                    v=v_cache, bias=bias)
    plan = lineage_plan(
        batch, heads, beam, head_dim, total, lanes,
        *kernel_config.tensor_device_limits(q),
        aligned=k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0)
    out = torch.empty_like(q)
    # each chunk's unnormalised context and its (max, sum) of every row,
    # written before the fold reads them
    part_o = part_ml = None
    if plan.splits > 1:
        part_o = q.new_empty(plan.splits, batch * heads * beam, head_dim)
        part_ml = q.new_empty(plan.splits, batch * heads * beam, 2)
    name = ("lineage_attention_chunked" if is_chunked(head_dim)
            else "lineage_attention")
    kernel_config.launch(name, q, k_cache, v_cache, bias, out,
                         part_o, part_ml, batch, heads, beam, head_dim, total,
                         lanes, plan.dmax, plan.tile, plan.slots, plan.groups,
                         plan.splits, plan.chunk, plan.stages, int(plan.vec),
                         plan.smem_bytes, 1.0 / math.sqrt(head_dim))
    return out
