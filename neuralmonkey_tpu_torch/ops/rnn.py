"""Masked recurrent scans over time.

Counterpart of ``neuralmonkey_tpu/ops/rnn.py``. Padding positions leave
the hidden state untouched, so the final state is the state at each
sequence's last real token, and outputs are zero there. Every ported
cell has a fused scan in ``ops/cuda_rnn.py``, chosen by the cell as
``rnn._pallas_cell_kind`` chooses: a plain GRU (``GRUCell``/
``OrthoGRUCell``, which differ only in initialisation) runs ``gru_scan``
(kernel K1), an ``LSTMCell`` runs ``lstm_scan``; each launches its
kernel for CUDA tensors and runs its plain version for tensors on the
CPU.
"""

from __future__ import annotations

import functools
from typing import Callable, Hashable, Tuple

import torch

from .cuda_rnn import gru_scan, lstm_scan
from .nn import GRUCell, LSTMCell


def _scan(cell) -> Tuple[Callable, Hashable]:
    """The fused scan that implements ``cell``, and a key that is equal
    for cells one launch can run together."""
    if isinstance(cell, LSTMCell):
        return (functools.partial(lstm_scan, forget_bias=cell.forget_bias),
                ("lstm", cell.hidden_dim, cell.forget_bias))
    if isinstance(cell, GRUCell):
        return gru_scan, ("gru", cell.hidden_dim)
    raise NotImplementedError(
        f"{type(cell).__name__}: only GRU and LSTM scans are ported to "
        "neuralmonkey_tpu_torch")


def unidirectional_rnn(cell, params, inputs: torch.Tensor,
                       mask: torch.Tensor, reverse: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``cell`` over ``inputs`` (B, T, D) with ``mask`` (B, T).

    Returns ``(outputs (B, T, H), final (B, H))``, the final output
    being ``h`` for an LSTM. With ``reverse=True`` the sequence runs
    right to left (trailing padding is skipped by the state gating) and
    the outputs keep the original time order."""
    scan, _ = _scan(cell)
    return scan([(params, reverse)], inputs, mask)


def bidirectional_rnn(fw_cell, fw_params, bw_cell, bw_params,
                      inputs: torch.Tensor, mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions, concatenated on the feature axis: outputs
    (B, T, Hf+Hb), final (B, Hf+Hb). Cells of one kind and size share
    one kernel launch; other pairs take one launch each."""
    fw_scan, fw_key = _scan(fw_cell)
    bw_scan, bw_key = _scan(bw_cell)
    if fw_key == bw_key:
        return fw_scan([(fw_params, False), (bw_params, True)], inputs, mask)
    fw_out, fw_final = fw_scan([(fw_params, False)], inputs, mask)
    bw_out, bw_final = bw_scan([(bw_params, True)], inputs, mask)
    return (torch.cat([fw_out, bw_out], dim=-1),
            torch.cat([fw_final, bw_final], dim=-1))
