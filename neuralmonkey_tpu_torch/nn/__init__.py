"""NN-primitive parity package (counterpart of ``neuralmonkey_tpu/nn/``).

The implementations live in ``ops/nn.py``; this package keeps the
reference's per-file module layout, so dotted symbols in existing INI
files (``nn.ortho_gru_cell.OrthoGRUCell`` and so on) resolve through
``config/builder.py``'s ``MODULE_ALIASES``.
"""

from ..ops.nn import (GRUCell, LayerNormGRUCell, LSTMCell, NoisyGRUCell,
                      OrthoGRUCell, dropout, highway, linear, maxout,
                      multilayer_projection, nonlinear)

__all__ = ["GRUCell", "LayerNormGRUCell", "LSTMCell", "NoisyGRUCell",
           "OrthoGRUCell", "dropout", "highway", "linear", "maxout",
           "multilayer_projection", "nonlinear"]
