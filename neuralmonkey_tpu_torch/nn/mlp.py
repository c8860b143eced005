"""The multilayer perceptron (reference nm/nn/mlp.py): the multilayer
projection of ``ops/nn.py``."""

from ..ops.nn import multilayer_projection, multilayer_projection_init

__all__ = ["multilayer_projection", "multilayer_projection_init"]
