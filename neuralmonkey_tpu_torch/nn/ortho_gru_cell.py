"""The orthogonally initialized GRU cell (reference
nm/nn/ortho_gru_cell.py) and the layer-normalized GRU; implemented in
``ops/nn.py``."""

from ..ops.nn import LayerNormGRUCell, OrthoGRUCell

__all__ = ["OrthoGRUCell", "LayerNormGRUCell"]
