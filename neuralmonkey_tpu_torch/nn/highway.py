"""Highway layers (reference nm/nn/highway.py); implemented in
``ops/nn.py``."""

from ..ops.nn import highway, highway_init

__all__ = ["highway", "highway_init"]
