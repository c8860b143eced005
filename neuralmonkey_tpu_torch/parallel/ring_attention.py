"""Ring-attention context parallelism over the ``context`` axis
(counterpart of ``neuralmonkey_tpu/parallel/ring_attention.py``).

Each rank of a context group holds T/C queries and T/C keys and values
of a sequence; the key, value and key-mask blocks travel around the
ring (``tensor.exchange``: each rank sends to the next and receives
from the previous) and every rank folds each visiting block into an
online softmax (running maximum, normalizer and context sum,
:func:`_fold`), so no rank ever holds more than a (T/C, T/C) score
tile. The JAX package folds its blocks outside any kernel; so do these,
in plain PyTorch on each block.

Two schedules, as in the JAX package:

- **contiguous** (non-causal, and the causal fallback): rank ``i`` owns
  queries ``[i·T/C, (i+1)·T/C)``; its own block is folded first, then
  C−1 rotations bring the others. Causality rides the blocks' global
  offsets (blocks above the diagonal are computed and masked).
- **zigzag** (causal self-attention with an even block): rank ``i``
  owns the thin chunks ``i`` and ``2C−1−i`` of T/2C each, exchanged in
  at entry and back at exit (``_zz_exchange``, ``_zz_unexchange``):
  after the diagonal step's 3 thin folds every step folds exactly 2
  valid thin blocks, about half the contiguous schedule's work.

The exchange is not differentiable in PyTorch, so the backward is
written out (:class:`_Ring`): a second pass around the ring recomputes
each block's probabilities from the saved log-sum-exp, adds to the
queries' gradient, and adds each block's key and value gradients to
accumulators that travel with the block and come home with one last
rotation.

Attention dropout: the keep mask of the global (query chunk, key chunk)
block is drawn from ``fold_seed(seed, q_chunk · n_chunks + kv_chunk)``
(:func:`_block_keep`), so any rank computing that block at any step of
either schedule draws the same mask; the normalizer sums the undropped
probabilities, as dropout after the softmax does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from ..model.part import fold_seed
from . import mesh, tensor

NEG_INF = -1e9

# score elements folded by this process (the zigzag's halved work shows
# in it); tests reset it
SCORE_ELEMENTS = [0]


def ring_eligible(q_len: int, kv_len: int) -> bool:
    """True when the context axis can split these time axes. Decode
    steps (``q_len`` 1) and ragged tails are not: they run on the whole
    time axis, as at one device."""
    cp = mesh.size("context")
    return cp >= 2 and q_len % cp == 0 and kv_len % cp == 0


def _block_keep(seed: int, q_chunk: int, kv_chunk: int, n_chunks: int,
                keep_prob: float, shape, device) -> torch.Tensor:
    """The keep mask of one global (q chunk, kv chunk) block: depends on
    the global chunk indices alone. Drawn on the host, so the card and
    the CPU draw the same bits."""
    gen = torch.Generator().manual_seed(
        fold_seed(seed, q_chunk * n_chunks + kv_chunk))
    return (torch.rand(tuple(shape), generator=gen) < keep_prob).to(device)


def blockwise_dropout_mask(seed: int, keep_prob: float, batch: int,
                           heads: int, tq: int, tk: int, cp: int,
                           causal: bool) -> torch.Tensor:
    """The whole (B, H, Tq, Tk) keep mask the ring draws block by block
    (the zigzag's thin chunks of T/2C when causal with an even block,
    else chunks of T/C), each block at its global offsets: the dense
    reference of the ring's dropout."""
    zigzag = causal and tq == tk and (tq // cp) % 2 == 0
    n_chunks = 2 * cp if zigzag else cp
    bq, bk = tq // n_chunks, tk // n_chunks
    return torch.cat([
        torch.cat([_block_keep(seed, qc, kc, n_chunks, keep_prob,
                               (batch, heads, bq, bk), "cpu")
                   for kc in range(n_chunks)], dim=3)
        for qc in range(n_chunks)], dim=2)


def _bias(mb, q_start, k_start, tq, tk, causal) -> torch.Tensor:
    bias = torch.where(mb > 0, 0.0, NEG_INF).to(torch.float32)[:, None,
                                                                 None, :]
    if causal:
        q_pos = q_start + torch.arange(tq, device=mb.device)
        k_pos = k_start + torch.arange(tk, device=mb.device)
        bias = bias + torch.where(q_pos[:, None] >= k_pos[None, :], 0.0,
                                  NEG_INF)[None, None]
    return bias


def _scores(q, kb, bias, scale) -> torch.Tensor:
    SCORE_ELEMENTS[0] += q.shape[0] * q.shape[1] * q.shape[2] * kb.shape[2]
    return torch.matmul(q.float(), kb.float().transpose(-1, -2)) * scale \
        + bias


def _fold(osm, q, kb, vb, bias, scale, keep=None, keep_prob=1.0):
    """Fold one visiting key/value block into the online softmax
    ``osm`` = (context sum, running maximum, normalizer)."""
    acc, m, l = osm
    scores = _scores(q, kb, bias, scale)
    new_m = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - new_m)
    p = torch.exp(scores - new_m)
    new_l = l * corr + p.sum(dim=-1, keepdim=True)
    pv = p * keep / keep_prob if keep is not None else p
    return acc * corr + torch.matmul(pv, vb.float()), new_m, new_l


class _Schedule:
    """The blocks a rank folds: its query slots (tensors and global chunk
    ids), the key/value blocks it starts with, and for each ring step
    the (query slot, key block, causal bias) pairs to fold."""

    def __init__(self, zigzag: bool, causal: bool, cp: int, my: int):
        self.zigzag, self.causal, self.cp, self.my = zigzag, causal, cp, my
        self.n_chunks = 2 * cp if zigzag else cp

    def q_ids(self) -> List[int]:
        return ([self.my, 2 * self.cp - 1 - self.my] if self.zigzag
                else [self.my])

    def kv_ids(self, j: int) -> List[int]:
        return [j, 2 * self.cp - 1 - j] if self.zigzag else [j]

    def pairs(self, step: int, j: int) -> List[Tuple[int, int, bool]]:
        if not self.zigzag:
            return [(0, 0, self.causal)]
        if step == 0:
            # q_lo x kv_hi lies above the diagonal: never computed
            return [(0, 0, True), (1, 0, False), (1, 1, True)]
        # both strictly below the diagonal
        return [(1, 0, False), (0, 0, False) if j < self.my
                else (1, 1, False)]


def _ring_ranks() -> Tuple[int, int]:
    ranks = tensor.ranks_of("context")
    cp, my = len(ranks), mesh.index("context")
    return ranks[(my + 1) % cp], ranks[(my - 1) % cp]


def _rotate(blocks: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every tensor of ``blocks`` sent to the next rank of the ring; the
    previous rank's received in its place."""
    nxt, prev = _ring_ranks()
    received = [torch.empty_like(b) for b in blocks]
    tensor.exchange([(b, nxt) for b in blocks],
                    [(r, prev) for r in received])
    return received


def _zz_owner(chunk: int, cp: int) -> int:
    return chunk if chunk < cp else 2 * cp - 1 - chunk


def _zz_exchange(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Contiguous -> zigzag: rank ``d`` holds thin chunks (2d, 2d+1) and
    ends with chunks (d, 2C−1−d). Returns (low chunk, high chunk)."""
    cp, my = mesh.size("context"), mesh.index("context")
    ranks = tensor.ranks_of("context")
    low, high = x.chunk(2, dim=axis)
    mine = {2 * my: low.contiguous(), 2 * my + 1: high.contiguous()}
    want = [my, 2 * cp - 1 - my]
    out = {}
    sends, recvs = [], []
    # both sides post in ascending chunk order, so two chunks between
    # one pair of ranks match in order
    for chunk in sorted(mine):
        owner = _zz_owner(chunk, cp)
        if owner == my:
            out[chunk] = mine[chunk]
        else:
            sends.append((mine[chunk], ranks[owner]))
    for chunk in sorted(want):
        if chunk not in out:
            buffer = torch.empty_like(low.contiguous())
            out[chunk] = buffer
            recvs.append((buffer, ranks[chunk // 2]))
    tensor.exchange(sends, recvs)
    return out[want[0]], out[want[1]]


def _zz_unexchange(lo: torch.Tensor, hi: torch.Tensor, axis: int
                   ) -> torch.Tensor:
    """Zigzag -> contiguous: each thin chunk back to its contiguous
    owner, the local (2t) block reassembled."""
    cp, my = mesh.size("context"), mesh.index("context")
    ranks = tensor.ranks_of("context")
    mine = {my: lo.contiguous(), 2 * cp - 1 - my: hi.contiguous()}
    out = {}
    sends, recvs = [], []
    for chunk in sorted(mine):
        owner = chunk // 2
        if owner == my:
            out[chunk] = mine[chunk]
        else:
            sends.append((mine[chunk], ranks[owner]))
    for chunk in (2 * my, 2 * my + 1):
        if chunk not in out:
            buffer = torch.empty_like(lo.contiguous())
            out[chunk] = buffer
            recvs.append((buffer, ranks[_zz_owner(chunk, cp)]))
    tensor.exchange(sends, recvs)
    return torch.cat([out[2 * my], out[2 * my + 1]], dim=axis)


def _ring_forward(plan: _Schedule, q_slots, kv, scale, seed, keep_prob):
    """(context sums' outputs, log-sum-exps) of each query slot."""
    osm = [(torch.zeros(q.shape[:3] + (kv[0][2].shape[-1],),
                        device=q.device),
            torch.full(q.shape[:3] + (1,), -math.inf, device=q.device),
            torch.zeros(q.shape[:3] + (1,), device=q.device))
           for q in q_slots]
    q_ids = plan.q_ids()
    for step in range(plan.cp):
        if step:
            kv = [tuple(_rotate(list(block))) for block in kv]
        j = (plan.my - step) % plan.cp
        kv_ids = plan.kv_ids(j)
        for qi, ki, tri in plan.pairs(step, j):
            mb, kb, vb = kv[ki]
            q = q_slots[qi]
            bias = _bias(mb, q_ids[qi] * q.shape[2], kv_ids[ki] * kb.shape[2],
                         q.shape[2], kb.shape[2], tri)
            keep = (_block_keep(seed, q_ids[qi], kv_ids[ki], plan.n_chunks,
                                keep_prob, q.shape[:3] + (kb.shape[2],),
                                q.device)
                    if seed is not None else None)
            osm[qi] = _fold(osm[qi], q, kb, vb, bias, scale, keep,
                            keep_prob)
    outs, lses = [], []
    for acc, m, l in osm:
        outs.append(acc / torch.clamp(l, min=1e-20))
        lses.append(m + torch.log(l))
    return outs, lses


def _ring_backward(plan: _Schedule, q_slots, kv, outs, lses, grads, scale,
                   seed, keep_prob):
    """(dq of each query slot, (dk, dv) of each starting key block)."""
    q_ids = plan.q_ids()
    dq = [torch.zeros(q.shape, device=q.device) for q in q_slots]
    deltas = [(g.float() * o).sum(dim=-1, keepdim=True)
              for g, o in zip(grads, outs)]
    acc = [(torch.zeros(kb.shape, device=kb.device),
            torch.zeros(vb.shape, device=vb.device)) for _, kb, vb in kv]
    for step in range(plan.cp):
        if step:
            moved = _rotate([t for block in kv for t in block]
                            + [t for pair in acc for t in pair])
            kv = [tuple(moved[3 * i:3 * i + 3]) for i in range(len(kv))]
            rest = moved[3 * len(kv):]
            acc = [tuple(rest[2 * i:2 * i + 2]) for i in range(len(kv))]
        j = (plan.my - step) % plan.cp
        kv_ids = plan.kv_ids(j)
        for qi, ki, tri in plan.pairs(step, j):
            mb, kb, vb = kv[ki]
            q, g = q_slots[qi], grads[qi].float()
            bias = _bias(mb, q_ids[qi] * q.shape[2], kv_ids[ki] * kb.shape[2],
                         q.shape[2], kb.shape[2], tri)
            p = torch.exp(_scores(q, kb, bias, scale) - lses[qi])
            dp = torch.matmul(g, vb.float().transpose(-1, -2))
            if seed is not None:
                keep = _block_keep(seed, q_ids[qi], kv_ids[ki],
                                   plan.n_chunks, keep_prob,
                                   q.shape[:3] + (kb.shape[2],), q.device)
                pd = p * keep / keep_prob
                dp = dp * keep / keep_prob
            else:
                pd = p
            ds = p * (dp - deltas[qi])
            dq[qi] = dq[qi] + torch.matmul(ds, kb.float()) * scale
            dk, dv = acc[ki]
            acc[ki] = (dk + torch.matmul(ds.transpose(-1, -2),
                                         q.float()) * scale,
                       dv + torch.matmul(pd.transpose(-1, -2), g))
    # the accumulators come home: one rotation more
    moved = _rotate([t for pair in acc for t in pair])
    acc = [tuple(moved[2 * i:2 * i + 2]) for i in range(len(kv))]
    return dq, acc


class _Ring(torch.autograd.Function):
    """The ring's forward and its written-out backward."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, zigzag, seed,
                keep_prob):  # pylint: disable=arguments-differ
        cp, my = mesh.size("context"), mesh.index("context")
        plan = _Schedule(zigzag, causal, cp, my)
        scale = 1.0 / math.sqrt(q.shape[-1])
        if zigzag:
            q_slots = list(_zz_exchange(q, 2))
            k_lo, k_hi = _zz_exchange(k, 2)
            v_lo, v_hi = _zz_exchange(v, 2)
            m_lo, m_hi = _zz_exchange(mask, 1)
            kv = [(m_lo, k_lo, v_lo), (m_hi, k_hi, v_hi)]
        else:
            q_slots, kv = [q], [(mask, k, v)]
        outs, lses = _ring_forward(plan, q_slots, kv, scale, seed,
                                   keep_prob)
        ctx.plan, ctx.scale, ctx.seed, ctx.keep_prob = plan, scale, seed, \
            keep_prob
        ctx.n_q, ctx.dtype = len(q_slots), v.dtype
        ctx.save_for_backward(*q_slots, *[t for b in kv for t in b],
                              *outs, *lses)
        out = (_zz_unexchange(outs[0], outs[1], 2) if zigzag else outs[0])
        return out.to(v.dtype)

    @staticmethod
    def backward(ctx, grad):  # pylint: disable=arguments-differ
        saved = list(ctx.saved_tensors)
        n_q = ctx.n_q
        q_slots = saved[:n_q]
        kv = [tuple(saved[n_q + 3 * i:n_q + 3 * i + 3]) for i in range(n_q)]
        outs = saved[4 * n_q:5 * n_q]
        lses = saved[5 * n_q:6 * n_q]
        zigzag = ctx.plan.zigzag
        grads = (list(_zz_exchange(grad.contiguous(), 2)) if zigzag
                 else [grad])
        dq, acc = _ring_backward(ctx.plan, q_slots, kv, outs, lses, grads,
                                 ctx.scale, ctx.seed, ctx.keep_prob)
        if zigzag:
            dq = _zz_unexchange(dq[0], dq[1], 2)
            dk = _zz_unexchange(acc[0][0], acc[1][0], 2)
            dv = _zz_unexchange(acc[0][1], acc[1][1], 2)
        else:
            dq, (dk, dv) = dq[0], acc[0]
        dtype = ctx.dtype
        return (dq.to(dtype), dk.to(dtype), dv.to(dtype), None, None, None,
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: torch.Tensor, causal: bool = False,
                   dropout_seed: Optional[int] = None,
                   dropout_keep_prob: float = 1.0,
                   schedule: str = "auto") -> torch.Tensor:
    """Context-parallel attention core on this rank's blocks.

    ``q`` (B, H, Tq/C, Dh) and ``k``, ``v`` (B, H, Tk/C, Dh) are this
    rank's contiguous slices of the time axes, ``key_mask`` (B, Tk/C)
    its slice of the key mask. ``causal`` applies the global causal
    triangle; ``dropout_seed`` with ``dropout_keep_prob < 1`` drops the
    softmax weights block by block (:func:`_block_keep`). ``schedule``
    is ``"auto"`` (zigzag for causal self-attention with an even block,
    else contiguous), ``"contiguous"`` or ``"zigzag"``. Returns this
    rank's (B, H, Tq/C, Dh) context in v's dtype: ``dot_product_
    attention`` with the same masks (and the blockwise dropout masks) up
    to the online softmax's reassociation."""
    if dropout_seed is not None and dropout_keep_prob >= 1.0:
        dropout_seed = None
    zigzag = causal and q.shape[2] == k.shape[2] and q.shape[2] % 2 == 0
    if schedule == "contiguous":
        zigzag = False
    elif schedule == "zigzag" and not zigzag:
        raise ValueError("zigzag needs causal, Tq == Tk, and an even "
                         "per-rank block")
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       key_mask.to(torch.float32).contiguous(),
                       bool(causal), zigzag, dropout_seed,
                       float(dropout_keep_prob))
