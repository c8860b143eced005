"""The noisy-activation GRU cell (reference nm/nn/noisy_gru_cell.py);
implemented in ``ops/nn.py``."""

from ..ops.nn import NoisyGRUCell

__all__ = ["NoisyGRUCell"]
