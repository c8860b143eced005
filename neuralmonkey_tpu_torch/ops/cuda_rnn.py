"""Fused masked GRU and LSTM scans and their BPTT: kernels K1,
``gru_bptt``, ``lstm_scan`` and ``lstm_bptt`` with their plain PyTorch
versions.

Counterpart of ``neuralmonkey_tpu/ops/pallas_rnn.py``. The input-side
products (``x @ gates_x`` and ``x @ cand_x`` for the GRU, ``x @ kernel_x``
for the LSTM) are hoisted out of the time loop into one matmul over
every direction (``pallas_rnn.py`` ``_hoisted_inputs_tm``,
``_lstm_hoisted_inputs_tm``); the serial part runs in one launch for all
directions: the forward in ``csrc/gru_scan.cu`` (K1) or
``csrc/lstm_scan.cu``, the reverse-time pass of the backward in
``csrc/gru_bptt.cu`` or ``csrc/lstm_bptt.cu``, or in their plain
versions for tensors on the CPU.

:class:`_GRUScan` and :class:`_LSTMScan` are the autograd Functions
around them, as ``pallas_rnn.gru_scan``'s and ``lstm_scan``'s custom
VJPs are. The gradient with respect to the hoisted inputs is exactly the
per-step pre-activation gradients the BPTT pass emits, so autograd
carries it through the hoisted matmul into the input weights, the
biases and the inputs; the recurrent weights' gradients are large
products over B·T (``torch.matmul``, where the JAX package leaves them
to XLA, ``_gru_scan_bwd``, ``_lstm_scan_bwd``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import kernel_config, nn
from .nn import Params

# the hidden sizes K1 takes: any whose three padded f32 state rows fit one
# H100 SM's 227 KiB, the bound of the kernel's first design (one batch row a
# block), which the card tests reach (H 19368); ``gru_scan_plan`` lays out
# every such size
_KERNEL_ROWS = 1
_SHARED_BYTES = 227 * 1024
# the LSTM kernels (csrc/lstm_scan.cu, csrc/lstm_bptt.cu) are column-split:
# each block keeps a column slice of W_h, whole or in k tiles, beside a tile
# of h rows, so their plans (``lstm_scan_plan``, ``lstm_bptt_plan``) lay out
# any H whose h row (H rounded up to 4, plus 4) fits beside a k tile and the
# sums; the LSTM path takes H up to the size of seven such rows, the bound
# the card tests reach (H 8300)
_LSTM_VECTORS = 7
# csrc/gru_bptt.cu keeps a column slice of W_gh and W_ch, whole or in k
# tiles, beside a few values of each batch row, so its plan
# (``gru_bptt_plan``) lays out far larger H; the GRU path takes H up to the
# bound of the kernel's first design, which the card tests reach
_GRU_BPTT_MAX_HIDDEN = 7264


def scan_fits(hidden: int) -> bool:
    """Whether the kernels take this hidden size: any size whose state
    tiles fit one SM's shared memory (H <= 19368). The GRU's shape gate:
    past it :func:`gru_scan` runs the plain scan whole, its gradient by
    autograd, as the JAX package does past its ``fits_vmem``."""
    return 3 * _KERNEL_ROWS * -(-hidden // 4) * 4 * 4 <= _SHARED_BYTES


def bptt_fits(hidden: int) -> bool:
    """Whether the GRU BPTT kernel takes this hidden size (H <= 7264).
    Past it a training call keeps K1 forward and ``_GRUScan.backward``
    runs the plain BPTT, so that only the part past its kernel's limit
    leaves the card's kernels (the JAX ``fits_vmem`` gates the forward
    and the backward together)."""
    return hidden <= _GRU_BPTT_MAX_HIDDEN


def lstm_scan_fits(hidden: int) -> bool:
    """Whether the LSTM kernels, forward and BPTT, take this hidden size
    (H <= 8300, seven padded h rows in one SM's shared memory). The
    LSTM's shape gate: past it :func:`lstm_scan` runs the plain scan
    whole, serving and training, as the JAX package does past its
    ``lstm_fits_vmem``."""
    return _LSTM_VECTORS * -(-hidden // 4) * 4 * 4 <= _SHARED_BYTES


# csrc/lstm_scan.cu (and csrc/gru_scan.cu): threads per block; a thread's
# tile is 4 rows x 4 gate columns, and the k split parts a tile's sum over
# at most 8 threads (16 in K1's second phase, which has half the columns)
LSTM_SCAN_THREADS = 256


class ColumnSplitPlan(NamedTuple):
    """The launch of ``lstm_scan``, ``lstm_bptt`` or K1 ``gru_scan``:
    ``blocks_per_dir`` blocks for each direction, each owning ``units``
    hidden units (the last block of a direction may own fewer); ``rows``
    batch rows of h staged per tile; the recurrent weights' slice in
    shared memory ``k_tile`` rows at a time (all of it, ``resident``,
    when ``k_tile`` covers H rounded up to 4); each 4 x 4 tile of a sum
    split over ``k_split`` threads; ``smem_bytes`` of shared memory per
    block."""
    blocks_per_dir: int
    units: int
    rows: int
    k_tile: int
    k_split: int
    smem_bytes: int
    resident: bool


def lstm_bptt_slice_stride(units: int) -> int:
    """Row stride (floats) of ``lstm_bptt``'s W_h slice: its 4U columns
    padded to an odd number of float4s, so that the partial product's
    reads of four slice rows fall in different banks."""
    return 4 * (units + 1 + units % 2)


def _column_split_plan(name: str, batch: int, hidden: int, n_dirs: int,
                       sm_count: int, smem_limit: int, stride,
                       gates: int = 4, sum_gates: int = 4,
                       quantum: int = 1) -> ColumnSplitPlan:
    """The column-split layout the LSTM kernels and K1 share: each block
    owns ``units`` hidden units (a multiple of ``quantum``) and their
    ``gates`` gate columns, a slice of ``stride(units)`` floats a depth;
    its partial sums cover ``sum_gates`` gate columns a unit."""
    if min(batch, hidden, n_dirs, sm_count) < 1 or sm_count < n_dirs:
        raise ValueError(f"{name}: no plan for B {batch}, H {hidden}, "
                         f"{n_dirs} directions on {sm_count} SMs")
    units = -(-hidden // (sm_count // n_dirs))
    units = -(-units // quantum) * quantum
    blocks = -(-hidden // units)
    cols, w_row = sum_gates * units, stride(units)
    h4 = -(-hidden // 4) * 4
    row_floats = h4 + 4 + 1  # the h row (padded stride) and its mask

    def rows_for(k_tile: int, k_split: int) -> int:
        free = smem_limit // 4 - k_tile * w_row
        rows = min(batch, free // (row_floats + k_split * cols))
        return rows if rows >= batch or rows < 4 else rows // 4 * 4

    def layout(k_tile: int):
        for k_split in (8, 4, 2, 1):
            rows = rows_for(k_tile, k_split)
            tasks = cols // 4 * -(-max(rows, 1) // 4)
            if k_split == 1 or tasks * k_split <= LSTM_SCAN_THREADS:
                return rows, k_split
        raise AssertionError("unreachable")

    rows, k_split = layout(h4)
    resident = rows >= min(batch, 16)
    k_tile = h4
    if not resident:
        quarter_rows = smem_limit // 4 // (4 * gates * units)
        k_tile = min(h4, max(4, quarter_rows // 4 * 4))
        rows, k_split = layout(k_tile)
    if rows < 1:
        raise ValueError(f"{name}: B {batch}, H {hidden} does not fit "
                         f"{smem_limit} bytes of shared memory")
    smem = 4 * (k_tile * w_row + rows * (h4 + 4) + k_split * rows * cols
                + rows)
    return ColumnSplitPlan(blocks, units, rows, k_tile, k_split, smem,
                           resident)


def lstm_scan_plan(batch: int, hidden: int, n_dirs: int, sm_count: int,
                   smem_limit: int) -> ColumnSplitPlan:
    """The layout of the persistent scan (csrc/lstm_scan.cu) on a card of
    ``sm_count`` SMs with ``smem_limit`` bytes of shared memory a block:
    at most one block per SM, every block resident (the launch is
    cooperative). The W_h slice stays in shared memory whenever it fits
    beside a tile of at least min(B, 16) rows of h; otherwise it streams
    in k tiles of about a quarter of the shared memory. Raises
    ``ValueError`` where no layout fits."""
    return _column_split_plan("lstm_scan", batch, hidden, n_dirs, sm_count,
                              smem_limit, lambda units: 4 * units)


def lstm_bptt_plan(batch: int, hidden: int, n_dirs: int, sm_count: int,
                   smem_limit: int) -> ColumnSplitPlan:
    """The layout of the persistent BPTT (csrc/lstm_bptt.cu): the scan's
    (:func:`lstm_scan_plan`), with the W_h slice's rows at
    :func:`lstm_bptt_slice_stride`. The same slice (or k tile) serves
    both of a step's products, z and the block's part of dz·W_hᵀ; the
    sums of z take ``k_split`` planes, the first of which then holds dz.
    Raises ``ValueError`` where no layout fits."""
    return _column_split_plan("lstm_bptt", batch, hidden, n_dirs, sm_count,
                              smem_limit, lstm_bptt_slice_stride)


def gru_scan_plan(batch: int, hidden: int, n_dirs: int, sm_count: int,
                  smem_limit: int) -> ColumnSplitPlan:
    """The layout of K1's persistent scan (csrc/gru_scan.cu) on a card of
    ``sm_count`` SMs with ``smem_limit`` bytes of shared memory a block:
    at most one block per SM, every block resident (the launch is
    cooperative). A block owns ``units`` hidden units (a multiple of 4)
    and keeps their three gate columns (r and u of W_gh, c of W_ch), 3U
    floats a depth, beside a tile of ``rows`` staged rows of h (or r⊙h)
    and the partial sums of the two gates of phase 1, which the one gate
    of phase 2 takes in twice as many parts (``k_split`` is phase 1's).
    The slice stays in shared memory whenever it fits beside at least
    min(B, 16) rows; otherwise it streams in k tiles of about a quarter
    of the shared memory. Raises ``ValueError`` where no layout fits."""
    return _column_split_plan("gru_scan", batch, hidden, n_dirs, sm_count,
                              smem_limit, lambda units: 3 * units, gates=3,
                              sum_gates=2, quantum=4)


# csrc/gru_bptt.cu's prologue tile stage (logit_tile.cuh): two 16 x 132 f32
# tiles, in the slice's place before the slice is loaded
_GRU_TILE_STAGE_FLOATS = 2 * 16 * 132


class GRUBpttPlan(NamedTuple):
    """The launch of ``gru_bptt``: ``blocks_per_dir`` blocks for each
    direction, over which the prologue's GEMM tiles are spread and each
    of which owns ``units`` hidden units (a multiple of 4; the last block
    of a direction may own fewer); the slice of those units' three gate
    columns in shared memory, transposed, ``k_tile`` depths at a time (all
    of it, ``resident``, when ``k_tile`` covers H rounded up to 4), beside
    ``rows`` batch rows of a step's dr, du·u(1−u), dxc and mask;
    ``smem_bytes`` of shared memory per block."""
    blocks_per_dir: int
    units: int
    rows: int
    k_tile: int
    smem_bytes: int
    resident: bool


def gru_bptt_plan(batch: int, hidden: int, n_dirs: int, sm_count: int,
                  smem_limit: int) -> GRUBpttPlan:
    """The layout of the persistent GRU BPTT (csrc/gru_bptt.cu) on a card
    of ``sm_count`` SMs with ``smem_limit`` bytes of shared memory a
    block: at most one block per SM, every block resident (the launch is
    cooperative). The slice (3U floats a depth) stays in shared memory
    whenever it fits beside at least min(B, 16) rows;
    otherwise the partial products stream it in the largest k tiles that
    leave room for those rows. Raises ``ValueError`` where no layout
    fits."""
    if min(batch, hidden, n_dirs, sm_count) < 1 or sm_count < n_dirs:
        raise ValueError(f"gru_bptt: no plan for B {batch}, H {hidden}, "
                         f"{n_dirs} directions on {sm_count} SMs")
    units = -(-hidden // (sm_count // n_dirs))
    units = -(-units // 4) * 4
    blocks = -(-hidden // units)
    w_row = 3 * units
    h4 = -(-hidden // 4) * 4
    row_floats = 3 * units + 1  # dr, du·u(1−u), dxc and the mask
    free = smem_limit // 4

    def rows_for(k_tile: int) -> int:
        left = free - max(k_tile * w_row, _GRU_TILE_STAGE_FLOATS)
        rows = min(batch, left // row_floats)
        return rows if rows >= batch or rows < 4 else rows // 4 * 4

    k_tile = h4
    resident = rows_for(h4) >= min(batch, 16)
    if not resident:
        fit = (free - min(batch, 16) * row_floats) // w_row
        k_tile = min(h4, max(4, fit // 4 * 4))
    rows = rows_for(k_tile)
    if rows < 1:
        raise ValueError(f"gru_bptt: B {batch}, H {hidden} does not fit "
                         f"{smem_limit} bytes of shared memory")
    smem = 4 * (max(k_tile * w_row, _GRU_TILE_STAGE_FLOATS)
                + rows * row_floats)
    return GRUBpttPlan(blocks, units, rows, k_tile, smem, resident)


def hoisted_inputs(directions: Sequence[Params],
                   inputs: torch.Tensor) -> torch.Tensor:
    """(B, T, D·3H) float32: per direction ``[x @ gates_x + gates_b |
    x @ cand_x + cand_b]``, from one matmul. Under the bf16 policy bf16
    inputs and weights multiply with float32 sums and output
    (``pallas_rnn._hoisted_inputs_tm``)."""
    w = torch.cat([torch.cat([p["gates_x"], p["cand_x"]], dim=1)
                   for p in directions], dim=1)
    b = torch.cat([torch.cat([p["gates_b"], p["cand_b"]])
                   for p in directions])
    return nn.dot(inputs, w) + b


def _directions(reverse_mask: int, n_dirs: int):
    return [bool((reverse_mask >> d) & 1) for d in range(n_dirs)]


def gru_scan_reference(x: torch.Tensor, mask: torch.Tensor,
                       wgh: torch.Tensor, wch: torch.Tensor,
                       reverse: Sequence[bool]
                       ) -> Tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Plain version of K1. ``x`` (B, T, D·3H) hoisted inputs,
    ``mask`` (B, T), ``wgh`` (D, H, 2H), ``wch`` (D, H, H). Returns
    outputs (B, T, D·H), zero at padding, the final carried states
    (B, D·H), and the carry after every step (B, T, D·H), which the
    BPTT reads; direction d fills columns d·H .. (d+1)·H."""
    batch, time, _ = x.shape
    n_dirs, hidden, _ = wch.shape
    outputs, finals, carries = [], [], []
    for d in range(n_dirs):
        xd = x[:, :, 3 * hidden * d:3 * hidden * (d + 1)]
        h = x.new_zeros(batch, hidden)
        out = x.new_zeros(batch, time, hidden)
        carry = x.new_zeros(batch, time, hidden)
        steps = range(time - 1, -1, -1) if reverse[d] else range(time)
        for t in steps:
            m = mask[:, t, None]
            gates = torch.sigmoid(xd[:, t, :2 * hidden] + h @ wgh[d])
            r, u = gates[:, :hidden], gates[:, hidden:]
            cand = torch.tanh(xd[:, t, 2 * hidden:] + (r * h) @ wch[d])
            new_h = u * h + (1.0 - u) * cand
            out[:, t] = m * new_h
            h = m * new_h + (1.0 - m) * h
            carry[:, t] = h
        outputs.append(out)
        finals.append(h)
        carries.append(carry)
    return (torch.cat(outputs, dim=-1), torch.cat(finals, dim=-1),
            torch.cat(carries, dim=-1))


def shift_carries(carries: torch.Tensor, n_dirs: int,
                  reverse: Sequence[bool]) -> torch.Tensor:
    """The state each step started from, (B, T, D·H): the previous
    scan step's carry, zero at the scan's first step
    (``pallas_rnn._shift_carries_tm``); a reversed direction's previous
    step is t + 1."""
    hidden = carries.shape[2] // n_dirs
    zero = carries.new_zeros(carries.shape[0], 1, hidden)
    shifted = []
    for d in range(n_dirs):
        c = carries[:, :, d * hidden:(d + 1) * hidden]
        shifted.append(torch.cat([c[:, 1:], zero], dim=1) if reverse[d]
                       else torch.cat([zero, c[:, :-1]], dim=1))
    return torch.cat(shifted, dim=-1)


def gru_bptt_reference(x: torch.Tensor, mask: torch.Tensor,
                       hprev: torch.Tensor, gout: torch.Tensor,
                       gfinal: torch.Tensor, wgh: torch.Tensor,
                       wch: torch.Tensor, reverse: Sequence[bool]
                       ) -> torch.Tensor:
    """Plain version of ``gru_bptt``, step for step the arithmetic of
    ``pallas_rnn._gru_bwd_kernel``: the reverse-time pass from
    ``dc = gfinal``, recomputing each step's gates and candidate from
    ``hprev``. Returns the pre-activation gradients (B, T, D·3H) laid
    out as ``x``: per direction ``[dxg (2H) | dxc (H)]``."""
    batch, time, _ = x.shape
    n_dirs, hidden, _ = wch.shape
    dx = torch.zeros_like(x)
    for d in range(n_dirs):
        cols = slice(d * hidden, (d + 1) * hidden)
        base = 3 * hidden * d
        dc = gfinal[:, cols]
        steps = range(time) if reverse[d] else range(time - 1, -1, -1)
        for t in steps:
            m = mask[:, t, None]
            h_prev = hprev[:, t, cols]
            gates = torch.sigmoid(x[:, t, base:base + 2 * hidden]
                                  + h_prev @ wgh[d])
            r, u = gates[:, :hidden], gates[:, hidden:]
            cand = torch.tanh(x[:, t, base + 2 * hidden:base + 3 * hidden]
                              + (r * h_prev) @ wch[d])
            dnew_h = m * (dc + gout[:, t, cols])
            dh_prev = (1.0 - m) * dc + dnew_h * u
            du = dnew_h * (h_prev - cand)
            da_c = dnew_h * (1.0 - u) * (1.0 - cand * cand)
            drh = da_c @ wch[d].T
            dh_prev = dh_prev + drh * r
            dgates = torch.cat([drh * h_prev, du], dim=-1) \
                * gates * (1.0 - gates)
            dh_prev = dh_prev + dgates @ wgh[d].T
            dx[:, t, base:base + 2 * hidden] = dgates
            dx[:, t, base + 2 * hidden:base + 3 * hidden] = da_c
            dc = dh_prev
    return dx


def gru_bptt(x: torch.Tensor, mask: torch.Tensor, hprev: torch.Tensor,
             gout: torch.Tensor, gfinal: torch.Tensor, wgh: torch.Tensor,
             wch: torch.Tensor, reverse_mask: int) -> torch.Tensor:
    """The BPTT's serial pass: one cooperative launch of ``gru_bptt``,
    laid out by :func:`gru_bptt_plan`, for CUDA tensors; the plain
    version otherwise."""
    n_dirs, hidden, _ = wch.shape
    if not x.is_cuda:
        return gru_bptt_reference(x, mask, hprev, gout, gfinal, wgh, wch,
                                  _directions(reverse_mask, n_dirs))
    if not bptt_fits(hidden):
        raise ValueError(f"gru_bptt: hidden size {hidden} does not fit "
                         "the kernel's shared memory")
    batch, time, _ = x.shape
    gout, gfinal = gout.contiguous(), gfinal.contiguous()
    kernel_config.check_cuda_inputs(
        "gru_bptt", x=x, mask=mask, hprev=hprev, gout=gout,
        gfinal=gfinal, wgh=wgh, wch=wch)
    plan = gru_bptt_plan(batch, hidden, n_dirs,
                         *kernel_config.tensor_device_limits(x))
    dx = torch.empty_like(x)
    # r, u, c and r·h_prev of every step (the prologue's), the partials of
    # dxc·W_chᵀ and of dxg·W_ghᵀ, and the direct part of the carried dh,
    # all written before they are read; the barrier words at 0
    gates = x.new_empty(4, batch, time, n_dirs * hidden)
    partial = x.new_empty(2, n_dirs, plan.blocks_per_dir, batch, hidden)
    carry = x.new_empty(n_dirs, batch, hidden)
    sync = torch.zeros(n_dirs, 2, dtype=torch.int32, device=x.device)
    kernel_config.launch("gru_bptt", x, mask, hprev, gout, gfinal, wgh,
                         wch, dx, gates, partial, carry, sync, batch, time,
                         hidden, n_dirs, reverse_mask, plan.blocks_per_dir,
                         plan.units, plan.rows, plan.k_tile, plan.smem_bytes)
    return dx


def launch_gru_scan(x, mask, wgh, wch, out, final, carries,
                    reverse_mask: int, plan: ColumnSplitPlan) -> None:
    """One cooperative launch of K1 on checked CUDA tensors, laid out by
    ``plan`` (:func:`gru_scan_plan`), with its exchange buffers: (3, D,
    B, H) float32 for the carried h, r⊙h and u, each written before it
    is read, and a barrier counter a direction at 0, each on its own
    128-byte line. A refused launch raises with the plan in the
    message."""
    batch, time, _ = x.shape
    n_dirs, hidden, _ = wch.shape
    scratch = x.new_empty(3, n_dirs, batch, hidden)
    sync = torch.zeros(n_dirs, 32, dtype=torch.int32, device=x.device)
    try:
        kernel_config.launch("gru_scan", x, mask, wgh, wch, out, final,
                             carries, scratch, sync, batch, time, hidden,
                             n_dirs, reverse_mask, plan.blocks_per_dir,
                             plan.units, plan.rows, plan.k_tile,
                             plan.k_split, plan.smem_bytes)
    except RuntimeError as err:
        raise RuntimeError(f"{err}; launch plan {plan}") from err


class _GRUScan(torch.autograd.Function):
    """The scan with its hand-written BPTT (``pallas_rnn.gru_scan``'s
    custom VJP): K1 and ``gru_bptt`` on CUDA tensors, their plain
    versions on the CPU. The forward keeps the per-step carries only
    when a gradient will be asked for (``save_carries``)."""

    @staticmethod
    def forward(ctx, x, mask, wgh, wch, reverse_mask: int):
        batch, time, _ = x.shape
        n_dirs, hidden, _ = wch.shape
        if (x.shape[2] != n_dirs * 3 * hidden
                or mask.shape != (batch, time)
                or wgh.shape != (n_dirs, hidden, 2 * hidden)
                or wch.shape != (n_dirs, hidden, hidden)):
            raise ValueError(
                f"gru_scan: inconsistent shapes x {tuple(x.shape)}, mask "
                f"{tuple(mask.shape)}, wgh {tuple(wgh.shape)}, wch "
                f"{tuple(wch.shape)}")
        save = any(ctx.needs_input_grad)
        if x.is_cuda:
            kernel_config.check_cuda_inputs(
                "gru_scan", x=x, mask=mask, wgh=wgh, wch=wch)
            out = x.new_empty(batch, time, n_dirs * hidden)
            final = x.new_empty(batch, n_dirs * hidden)
            carries = x.new_empty(batch, time, n_dirs * hidden) \
                if save else None
            launch_gru_scan(x, mask, wgh, wch, out, final, carries,
                            reverse_mask, gru_scan_plan(
                                batch, hidden, n_dirs,
                                *kernel_config.tensor_device_limits(x)))
        else:
            out, final, carries = gru_scan_reference(
                x, mask, wgh, wch, _directions(reverse_mask, n_dirs))
        if save:
            ctx.save_for_backward(x, mask, wgh, wch, carries)
            ctx.reverse_mask = reverse_mask
        return out, final

    @staticmethod
    def backward(ctx, gout, gfinal):
        x, mask, wgh, wch, carries = ctx.saved_tensors
        n_dirs, hidden, _ = wch.shape
        reverse = _directions(ctx.reverse_mask, n_dirs)
        hprev = shift_carries(carries, n_dirs, reverse)
        if bptt_fits(hidden):
            dx = gru_bptt(x, mask, hprev, gout, gfinal, wgh, wch,
                          ctx.reverse_mask)
        else:
            kernel_config.log_plain_path("gru_bptt", f"hidden {hidden}")
            dx = gru_bptt_reference(x, mask, hprev, gout.contiguous(),
                                    gfinal.contiguous(), wgh, wch, reverse)
        dwgh, dwch = [], []
        for d in range(n_dirs):
            h = hprev[:, :, d * hidden:(d + 1) * hidden].reshape(-1, hidden)
            xd = x[:, :, 3 * hidden * d:3 * hidden * (d + 1)]
            dxd = dx[:, :, 3 * hidden * d:3 * hidden * (d + 1)]
            dxg = dxd[:, :, :2 * hidden].reshape(-1, 2 * hidden)
            dxc = dxd[:, :, 2 * hidden:].reshape(-1, hidden)
            r = torch.sigmoid(xd[:, :, :hidden].reshape(-1, hidden)
                              + h @ wgh[d, :, :hidden])
            dwgh.append(h.T @ dxg)
            dwch.append((r * h).T @ dxc)
        return dx, None, torch.stack(dwgh), torch.stack(dwch), None


def gru_scan(directions: Sequence[Tuple[Params, bool]],
             inputs: torch.Tensor, mask: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked TF1-GRU over (B, T, E) ``inputs`` for each
    ``(params, reverse)`` direction, directions concatenated on the
    feature axis: outputs (B, T, D·H), final states (B, D·H). Same
    semantics as ``ops.rnn.unidirectional_rnn`` per direction.
    Launches K1 (and ``gru_bptt`` in the backward) for CUDA tensors,
    runs the plain versions otherwise."""
    params = [p for p, _ in directions]
    hidden = params[0]["cand_h"].shape[0]
    batch, time, _ = inputs.shape
    x = hoisted_inputs(params, inputs)
    # the kernels compute in float32 with the recurrent weights as the
    # policy rounded them (widened from bf16); their gradients are rounded
    # back to bf16 through the widening, as ``pallas_rnn.py:420`` does
    wgh = torch.stack([p["gates_h"] for p in params]).to(x.dtype)
    wch = torch.stack([p["cand_h"] for p in params]).to(x.dtype)
    mask = mask.to(x.dtype)
    if not scan_fits(hidden):
        kernel_config.log_plain_path("gru_scan", f"hidden {hidden}")
        out, final, _ = gru_scan_reference(
            x, mask, wgh, wch, [rev for _, rev in directions])
        return out, final
    if x.is_cuda and (batch == 0 or time == 0):
        raise ValueError(f"gru_scan: empty input {tuple(inputs.shape)}")
    reverse_mask = sum(1 << d for d, (_, rev) in enumerate(directions)
                       if rev)
    return _GRUScan.apply(x.contiguous(), mask.contiguous(), wgh, wch,
                          reverse_mask)


# ---------------------------------------------------------------------- #
# LSTM
# ---------------------------------------------------------------------- #
def lstm_hoisted_inputs(directions: Sequence[Params],
                        inputs: torch.Tensor) -> torch.Tensor:
    """(B, T, D·4H) float32: per direction ``x @ kernel_x + bias``, gates
    in i, j, f, o order, from one matmul (bf16 operands under the policy,
    float32 sums and output)."""
    w = torch.cat([p["kernel_x"] for p in directions], dim=1)
    b = torch.cat([p["bias"] for p in directions])
    return nn.dot(inputs, w) + b


def _lstm_gates(z: torch.Tensor, forget_bias: float):
    """σ(i), tanh(j), σ(f + forget_bias), σ(o) of pre-activations
    ``z`` (..., 4H), as ``pallas_rnn._lstm_scan_kernel`` computes them."""
    i, j, f, o = z.chunk(4, dim=-1)
    return (torch.sigmoid(i), torch.tanh(j), torch.sigmoid(f + forget_bias),
            torch.sigmoid(o))


def lstm_scan_reference(xz: torch.Tensor, mask: torch.Tensor,
                        wh: torch.Tensor, forget_bias: float,
                        reverse: Sequence[bool]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Plain version of ``lstm_scan``. ``xz`` (B, T, D·4H) hoisted
    inputs, ``mask`` (B, T), ``wh`` (D, H, 4H). Returns outputs
    (B, T, D·H), zero at padding, the final carried h (B, D·H), and the
    c and h carries after every step (B, T, D·H each), which the BPTT
    reads; direction d fills columns d·H .. (d+1)·H."""
    batch, time, _ = xz.shape
    n_dirs, hidden, _ = wh.shape
    outputs, finals, c_carries, h_carries = [], [], [], []
    for d in range(n_dirs):
        xd = xz[:, :, 4 * hidden * d:4 * hidden * (d + 1)]
        c = xz.new_zeros(batch, hidden)
        h = xz.new_zeros(batch, hidden)
        out = xz.new_zeros(batch, time, hidden)
        c_car = xz.new_zeros(batch, time, hidden)
        h_car = xz.new_zeros(batch, time, hidden)
        steps = range(time - 1, -1, -1) if reverse[d] else range(time)
        for t in steps:
            m = mask[:, t, None]
            si, tj, sf, so = _lstm_gates(xd[:, t] + h @ wh[d], forget_bias)
            new_c = c * sf + si * tj
            new_h = torch.tanh(new_c) * so
            out[:, t] = m * new_h
            c = m * new_c + (1.0 - m) * c
            h = m * new_h + (1.0 - m) * h
            c_car[:, t] = c
            h_car[:, t] = h
        outputs.append(out)
        finals.append(h)
        c_carries.append(c_car)
        h_carries.append(h_car)
    return (torch.cat(outputs, dim=-1), torch.cat(finals, dim=-1),
            torch.cat(c_carries, dim=-1), torch.cat(h_carries, dim=-1))


def lstm_bptt_reference(xz: torch.Tensor, mask: torch.Tensor,
                        cprev: torch.Tensor, hprev: torch.Tensor,
                        gout: torch.Tensor, gfinal: torch.Tensor,
                        wh: torch.Tensor, forget_bias: float,
                        reverse: Sequence[bool]) -> torch.Tensor:
    """Plain version of ``lstm_bptt``, step for step the arithmetic of
    ``pallas_rnn._lstm_bwd_kernel``: the reverse-time pass from
    ``dc = 0``, ``dh = gfinal``, recomputing each step's gates from the
    saved pre-step ``cprev`` and ``hprev``. Returns the pre-activation
    gradients ``dz`` (B, T, D·4H) laid out as ``xz``."""
    batch, time, _ = xz.shape
    n_dirs, hidden, _ = wh.shape
    dxz = torch.zeros_like(xz)
    for d in range(n_dirs):
        cols = slice(d * hidden, (d + 1) * hidden)
        zcols = slice(4 * hidden * d, 4 * hidden * (d + 1))
        dc = xz.new_zeros(batch, hidden)
        dh = gfinal[:, cols]
        steps = range(time) if reverse[d] else range(time - 1, -1, -1)
        for t in steps:
            m = mask[:, t, None]
            c_prev = cprev[:, t, cols]
            si, tj, sf, so = _lstm_gates(
                xz[:, t, zcols] + hprev[:, t, cols] @ wh[d], forget_bias)
            tc = torch.tanh(c_prev * sf + si * tj)
            dh_new = m * (dh + gout[:, t, cols])
            dc_new = m * dc + dh_new * so * (1.0 - tc * tc)
            dz = torch.cat([dc_new * tj * si * (1.0 - si),
                            dc_new * si * (1.0 - tj * tj),
                            dc_new * c_prev * sf * (1.0 - sf),
                            dh_new * tc * so * (1.0 - so)], dim=-1)
            dxz[:, t, zcols] = dz
            dc = (1.0 - m) * dc + dc_new * sf
            dh = (1.0 - m) * dh + dz @ wh[d].T
    return dxz


def lstm_bptt(xz: torch.Tensor, mask: torch.Tensor, cprev: torch.Tensor,
              hprev: torch.Tensor, gout: torch.Tensor, gfinal: torch.Tensor,
              wh: torch.Tensor, forget_bias: float,
              reverse_mask: int) -> torch.Tensor:
    """The LSTM BPTT's serial pass: one cooperative launch of
    ``lstm_bptt``, laid out by :func:`lstm_bptt_plan`, for CUDA tensors;
    the plain version otherwise."""
    n_dirs, hidden, _ = wh.shape
    if not xz.is_cuda:
        return lstm_bptt_reference(xz, mask, cprev, hprev, gout, gfinal, wh,
                                   forget_bias,
                                   _directions(reverse_mask, n_dirs))
    if not lstm_scan_fits(hidden):
        raise ValueError(f"lstm_bptt: hidden size {hidden} does not fit "
                         "the kernel's shared memory")
    batch, time, _ = xz.shape
    gout, gfinal = gout.contiguous(), gfinal.contiguous()
    kernel_config.check_cuda_inputs(
        "lstm_bptt", xz=xz, mask=mask, cprev=cprev, hprev=hprev, gout=gout,
        gfinal=gfinal, wh=wh)
    plan = lstm_bptt_plan(batch, hidden, n_dirs,
                          *kernel_config.tensor_device_limits(xz))
    dxz = torch.empty_like(xz)
    # the partials of dz·W_hᵀ, two steps' worth, and the carried dc and
    # direct dh, all written before they are read; the barrier words at 0
    partial = xz.new_empty(2, n_dirs, plan.blocks_per_dir, batch, hidden)
    carry = xz.new_empty(2, n_dirs, batch, hidden)
    sync = torch.zeros(n_dirs, 2, dtype=torch.int32, device=xz.device)
    kernel_config.launch("lstm_bptt", xz, mask, cprev, hprev, gout, gfinal,
                         wh, dxz, partial, carry, sync, batch, time, hidden,
                         n_dirs, reverse_mask, plan.blocks_per_dir,
                         plan.units, plan.rows, plan.k_tile, plan.k_split,
                         plan.smem_bytes, float(forget_bias))
    return dxz


def lstm_scan_forward(xz: torch.Tensor, mask: torch.Tensor,
                      wh: torch.Tensor, forget_bias: float,
                      reverse_mask: int, save_carries: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """The LSTM scan's serial pass: launches ``lstm_scan`` for CUDA
    tensors, runs the plain version otherwise. Returns outputs, final h
    and, with ``save_carries``, the c and h carries (else ``None``)."""
    batch, time, _ = xz.shape
    n_dirs, hidden, _ = wh.shape
    if (xz.shape[2] != n_dirs * 4 * hidden
            or mask.shape != (batch, time)
            or wh.shape != (n_dirs, hidden, 4 * hidden)):
        raise ValueError(
            f"lstm_scan: inconsistent shapes xz {tuple(xz.shape)}, mask "
            f"{tuple(mask.shape)}, wh {tuple(wh.shape)}")
    if not xz.is_cuda:
        out, final, c_car, h_car = lstm_scan_reference(
            xz, mask, wh, forget_bias, _directions(reverse_mask, n_dirs))
        return (out, final, *((c_car, h_car) if save_carries
                               else (None, None)))
    if not lstm_scan_fits(hidden):
        raise ValueError(f"lstm_scan: hidden size {hidden} does not fit "
                         "the kernel's shared memory")
    if batch == 0 or time == 0:
        raise ValueError(f"lstm_scan: empty input {tuple(xz.shape)}")
    kernel_config.check_cuda_inputs("lstm_scan", xz=xz, mask=mask, wh=wh)
    out = xz.new_empty(batch, time, n_dirs * hidden)
    final = xz.new_empty(batch, n_dirs * hidden)
    c_car, h_car = ((xz.new_empty(batch, time, n_dirs * hidden)
                     for _ in range(2)) if save_carries else (None, None))
    scratch, sync = lstm_scan_scratch(xz, n_dirs, hidden)
    launch_lstm_scan(xz, mask, wh, out, final, c_car, h_car, scratch, sync,
                     forget_bias, reverse_mask)
    return out, final, c_car, h_car


def lstm_scan_scratch(xz: torch.Tensor, n_dirs: int, hidden: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's exchange buffers: (3, D, B, H) float32 for h (twice)
    and c, which it writes before it reads, and the (D, 2) barrier words,
    which must start at 0 (each barrier leaves them so)."""
    return (xz.new_empty(3, n_dirs, xz.shape[0], hidden),
            torch.zeros(n_dirs, 2, dtype=torch.int32, device=xz.device))


def launch_lstm_scan(xz, mask, wh, out, final, c_car, h_car, scratch, sync,
                     forget_bias: float, reverse_mask: int) -> ColumnSplitPlan:
    """One cooperative launch of ``lstm_scan`` on checked CUDA tensors,
    laid out by :func:`lstm_scan_plan` for their device; returns the
    plan."""
    batch, time, _ = xz.shape
    n_dirs, hidden, _ = wh.shape
    plan = lstm_scan_plan(batch, hidden, n_dirs,
                          *kernel_config.tensor_device_limits(xz))
    kernel_config.launch("lstm_scan", xz, mask, wh, out, final, c_car, h_car,
                         scratch, sync, batch, time, hidden, n_dirs,
                         reverse_mask, plan.blocks_per_dir, plan.units,
                         plan.rows, plan.k_tile, plan.k_split,
                         plan.smem_bytes, float(forget_bias))
    return plan


class _LSTMScan(torch.autograd.Function):
    """The LSTM scan with its hand-written BPTT (``pallas_rnn.lstm_scan``'s
    custom VJP): ``lstm_scan`` and ``lstm_bptt`` on CUDA tensors, their
    plain versions on the CPU. The forward keeps the c and h carries
    only when a gradient will be asked for."""

    @staticmethod
    def forward(ctx, xz, mask, wh, forget_bias: float, reverse_mask: int):
        save = any(ctx.needs_input_grad)
        out, final, c_car, h_car = lstm_scan_forward(
            xz, mask, wh, forget_bias, reverse_mask, save)
        if save:
            ctx.save_for_backward(xz, mask, wh, c_car, h_car)
            ctx.forget_bias = forget_bias
            ctx.reverse_mask = reverse_mask
        return out, final

    @staticmethod
    def backward(ctx, gout, gfinal):
        xz, mask, wh, c_car, h_car = ctx.saved_tensors
        n_dirs, hidden, _ = wh.shape
        reverse = _directions(ctx.reverse_mask, n_dirs)
        cprev = shift_carries(c_car, n_dirs, reverse)
        hprev = shift_carries(h_car, n_dirs, reverse)
        dxz = lstm_bptt(xz, mask, cprev, hprev, gout, gfinal, wh,
                        ctx.forget_bias, ctx.reverse_mask)
        dwh = torch.stack([
            hprev[:, :, d * hidden:(d + 1) * hidden].reshape(-1, hidden).T
            @ dxz[:, :, 4 * hidden * d:4 * hidden * (d + 1)].reshape(
                -1, 4 * hidden)
            for d in range(n_dirs)])
        return dxz, None, dwh, None, None


def lstm_scan(directions: Sequence[Tuple[Params, bool]],
              inputs: torch.Tensor, mask: torch.Tensor,
              forget_bias: float = 1.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked TF1-LSTM over (B, T, E) ``inputs`` for each
    ``(params, reverse)`` direction, directions concatenated on the
    feature axis: outputs (B, T, D·H), final h (B, D·H). Same semantics
    as ``ops.rnn.unidirectional_rnn`` per direction. Launches
    ``lstm_scan`` (and ``lstm_bptt`` in the backward) for CUDA tensors,
    runs the plain versions otherwise."""
    params = [p for p, _ in directions]
    xz = lstm_hoisted_inputs(params, inputs)
    # float32 kernels on the policy's rounded weights (see gru_scan)
    wh = torch.stack([p["kernel_h"] for p in params]).to(xz.dtype)
    mask = mask.to(xz.dtype)
    hidden = wh.shape[1]
    if not lstm_scan_fits(hidden):
        kernel_config.log_plain_path("lstm_scan", f"hidden {hidden}")
        out, final, _, _ = lstm_scan_reference(
            xz, mask, wh, forget_bias, [rev for _, rev in directions])
        return out, final
    reverse_mask = sum(1 << d for d, (_, rev) in enumerate(directions)
                       if rev)
    return _LSTMScan.apply(xz.contiguous(), mask.contiguous(), wh,
                           forget_bias, reverse_mask)
