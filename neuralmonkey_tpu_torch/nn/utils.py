"""Dropout (reference nm/nn/utils.py); implemented in ``ops/nn.py``."""

from ..ops.nn import dropout, maybe_dropout

__all__ = ["dropout", "maybe_dropout"]
