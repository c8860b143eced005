"""Fused masked GRU scan and its BPTT: kernels K1 and B1-backward with
their plain PyTorch versions.

Counterpart of ``neuralmonkey_tpu/ops/pallas_rnn.py``. The input-side
products ``x @ gates_x`` and ``x @ cand_x`` are hoisted out of the time
loop into one matmul over every direction (``pallas_rnn.py``
``_hoisted_inputs_tm``); the serial part runs in one launch for all
directions: the forward in ``csrc/gru_scan.cu`` (K1), the reverse-time
pass of the backward in ``csrc/gru_bptt.cu`` (``gru_bptt``), or in
their plain versions for tensors on the CPU.

:class:`_GRUScan` is the autograd Function around both, as
``pallas_rnn.gru_scan``'s custom VJP is. Its gradient with respect to
the hoisted inputs is exactly the per-step pre-activation gradients the
BPTT pass emits, so autograd carries it through the hoisted matmul into
``gates_x``/``cand_x``/the biases/the inputs; the recurrent weights'
gradients are two large products over B·T (``torch.matmul``, where the
JAX package leaves them to XLA, ``_gru_scan_bwd``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import kernel_config
from .nn import Params

# batch rows per block in csrc/gru_scan.cu; its shared memory holds three
# (rows, H rounded up to 4) f32 tiles, up to an H100 SM's 227 KiB
_KERNEL_ROWS = 1
_SHARED_BYTES = 227 * 1024
# csrc/gru_bptt.cu keeps eight H-wide f32 vectors of one row in shared memory
_BPTT_VECTORS = 8


def scan_fits(hidden: int) -> bool:
    """Whether the kernels take this hidden size: any size whose state
    tiles fit one SM's shared memory (H <= 19368)."""
    return 3 * _KERNEL_ROWS * -(-hidden // 4) * 4 * 4 <= _SHARED_BYTES


def bptt_fits(hidden: int) -> bool:
    """The same for the BPTT kernel (H <= 7264)."""
    return _BPTT_VECTORS * -(-hidden // 4) * 4 * 4 <= _SHARED_BYTES


def hoisted_inputs(directions: Sequence[Params],
                   inputs: torch.Tensor) -> torch.Tensor:
    """(B, T, D·3H): per direction ``[x @ gates_x + gates_b |
    x @ cand_x + cand_b]``, from one matmul."""
    w = torch.cat([torch.cat([p["gates_x"], p["cand_x"]], dim=1)
                   for p in directions], dim=1)
    b = torch.cat([torch.cat([p["gates_b"], p["cand_b"]])
                   for p in directions])
    return torch.matmul(inputs, w) + b


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
    """The BPTT's serial pass: launches ``gru_bptt`` for CUDA tensors,
    runs the plain version otherwise."""
    n_dirs, hidden, _ = wch.shape
    if not x.is_cuda:
        return gru_bptt_reference(x, mask, hprev, gout, gfinal, wgh, wch,
                                  _directions(reverse_mask, n_dirs))
    if not bptt_fits(hidden):
        raise ValueError(f"gru_bptt: hidden size {hidden} does not fit "
                         "the kernel's shared memory")
    batch, time, _ = x.shape
    gout, gfinal = gout.contiguous(), gfinal.contiguous()
    wght = wgh.transpose(1, 2).contiguous()
    wcht = wch.transpose(1, 2).contiguous()
    kernel_config.check_cuda_inputs(
        "gru_bptt", x=x, mask=mask, hprev=hprev, gout=gout,
        gfinal=gfinal, wgh=wgh, wch=wch, wght=wght, wcht=wcht)
    dx = torch.empty_like(x)
    kernel_config.launch("gru_bptt", x, mask, hprev, gout, gfinal, wgh,
                         wch, wght, wcht, dx, batch, time, hidden, n_dirs,
                         reverse_mask)
    return dx


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
            kernel_config.launch("gru_scan", x, mask, wgh, wch, out, final,
                                 carries, batch, time, hidden, n_dirs,
                                 reverse_mask)
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
        dx = gru_bptt(x, mask, hprev, gout, gfinal, wgh, wch,
                      ctx.reverse_mask)
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
    wgh = torch.stack([p["gates_h"] for p in params])
    wch = torch.stack([p["cand_h"] for p in params])
    mask = mask.to(x.dtype)
    if x.is_cuda:
        if not scan_fits(hidden):
            raise ValueError(f"gru_scan: hidden size {hidden} does not "
                             "fit the kernel's shared memory")
        if batch == 0 or time == 0:
            raise ValueError(
                f"gru_scan: empty input {tuple(inputs.shape)}")
    reverse_mask = sum(1 << d for d, (_, rev) in enumerate(directions)
                       if rev)
    return _GRUScan.apply(x.contiguous(), mask.contiguous(), wgh, wch,
                          reverse_mask)
