"""Projections (reference nm/nn/projection.py); implemented in
``ops/nn.py``."""

from ..ops.nn import (linear, linear_init, maxout, maxout_init,
                      multilayer_projection, multilayer_projection_init,
                      nonlinear)

__all__ = ["linear", "linear_init", "maxout", "maxout_init",
           "multilayer_projection", "multilayer_projection_init",
           "nonlinear"]
