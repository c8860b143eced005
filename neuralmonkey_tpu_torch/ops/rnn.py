"""Masked recurrent scans over time.

Counterpart of ``neuralmonkey_tpu/ops/rnn.py``. Padding positions leave
the hidden state untouched, so the final state is the state at each
sequence's last real token, and outputs are zero there. The scan is
chosen by the cell's exact type, as ``rnn._pallas_cell_kind`` chooses:
a plain GRU (``GRUCell``/``OrthoGRUCell``, which differ only in
initialisation) runs ``gru_scan`` (kernel K1), an ``LSTMCell`` runs
``lstm_scan``; each launches its kernel for CUDA tensors and runs its
plain version for tensors on the CPU. Every other cell (the
layer-normalized and the noisy-activation GRU, subclasses of
``GRUCell`` with other equations) runs :func:`step_scan`, one cell call
a step, as the JAX package runs them through ``lax.scan``: no kernel
computes them there either.
"""

from __future__ import annotations

import functools
from typing import Callable, Hashable, List, Optional, Tuple

import torch

from .cuda_rnn import gru_scan, lstm_scan
from .nn import GRUCell, LSTMCell, OrthoGRUCell, widened


def step_scan(cell, directions: List[Tuple[dict, bool]],
              inputs: torch.Tensor, mask: torch.Tensor,
              noise: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked scan of ``cell`` for each (params, reverse) of
    ``directions``, one cell call a step: outputs (B, T, D·H) and final
    states (B, D·H), directions concatenated in order. With ``noise``
    (a noisy-activation cell in training) each direction draws its
    steps' noise from it in turn, every step fresh noise."""
    batch, time = inputs.shape[:2]
    step_mask = mask.to(widened(inputs.dtype))[..., None]
    outputs, finals = [], []
    for params, reverse in directions:
        draws = (None if noise is None else
                 cell.draw_noise(time, batch, noise, inputs.device))
        # states accumulate in float32 under the bf16 policy too
        state = inputs.new_zeros((batch, cell.hidden_dim),
                                 dtype=widened(inputs.dtype))
        out: List[Optional[torch.Tensor]] = [None] * time
        order = range(time - 1, -1, -1) if reverse else range(time)
        for i, t in enumerate(order):
            kwargs = {} if draws is None else {"noise": draws[i]}
            new_state, step_out = cell(params, state, inputs[:, t],
                                       **kwargs)
            m = step_mask[:, t]
            state = m * new_state + (1.0 - m) * state
            out[t] = m * step_out
        outputs.append(torch.stack(out, dim=1))
        finals.append(state)
    return torch.cat(outputs, dim=-1), torch.cat(finals, dim=-1)


def _scan(cell, noise: Optional[torch.Generator] = None
          ) -> Tuple[Callable, Hashable]:
    """The scan that implements ``cell``, and a key that is equal for
    cells one launch can run together."""
    if type(cell) is LSTMCell:
        return (functools.partial(lstm_scan, forget_bias=cell.forget_bias),
                ("lstm", cell.hidden_dim, cell.forget_bias))
    if type(cell) in (GRUCell, OrthoGRUCell):
        return gru_scan, ("gru", cell.hidden_dim)
    return (functools.partial(step_scan, cell, noise=noise),
            ("step", id(cell)))


def unidirectional_rnn(cell, params, inputs: torch.Tensor,
                       mask: torch.Tensor, reverse: bool = False,
                       noise: Optional[torch.Generator] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``cell`` over ``inputs`` (B, T, D) with ``mask`` (B, T).

    Returns ``(outputs (B, T, H), final (B, H))``, the final output
    being ``h`` for an LSTM. With ``reverse=True`` the sequence runs
    right to left (trailing padding is skipped by the state gating) and
    the outputs keep the original time order. ``noise`` (a generator)
    feeds a noisy-activation cell's training noise."""
    scan, _ = _scan(cell, noise)
    return scan([(params, reverse)], inputs, mask)


def bidirectional_rnn(fw_cell, fw_params, bw_cell, bw_params,
                      inputs: torch.Tensor, mask: torch.Tensor,
                      noise: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions, concatenated on the feature axis: outputs
    (B, T, Hf+Hb), final (B, Hf+Hb). Kernel cells of one kind and size
    share one kernel launch; other pairs take one scan each, the
    forward direction drawing its ``noise`` before the backward one."""
    fw_scan, fw_key = _scan(fw_cell, noise)
    bw_scan, bw_key = _scan(bw_cell, noise)
    if fw_key == bw_key:
        return fw_scan([(fw_params, False), (bw_params, True)], inputs, mask)
    fw_out, fw_final = fw_scan([(fw_params, False)], inputs, mask)
    bw_out, bw_final = bw_scan([(bw_params, True)], inputs, mask)
    return (torch.cat([fw_out, bw_out], dim=-1),
            torch.cat([fw_final, bw_final], dim=-1))
