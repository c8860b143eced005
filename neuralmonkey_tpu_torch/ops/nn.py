"""NN primitives: initializers, projections, dropout, GRU cells.

Counterpart of ``neuralmonkey_tpu/ops/nn.py`` for the parts the RNN
translation path uses. Parameters are plain dicts of tensors with the
JAX package's names and layouts (a linear ``w`` is ``(in, out)``), so
a JAX checkpoint loads without transposes. Initializers draw from an
explicit ``torch.Generator`` on the CPU.

The GRU follows TF1 (``tf.nn.rnn_cell.GRUCell``): the reset gate
multiplies ``h`` *before* the candidate's recurrent product, and the
gate bias starts at 1.0. ``torch.nn.GRU`` and cuDNN apply the reset
gate after that product, so they cannot stand in for it.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------- #
# initializers
# ---------------------------------------------------------------------- #
def glorot_uniform(gen: torch.Generator,
                   shape: Sequence[int]) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(tuple(shape)).uniform_(-limit, limit, generator=gen)


def orthogonal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Orthogonal init (OrthoGRUCell's recurrent weights)."""
    if len(shape) < 2:
        raise ValueError("Orthogonal init needs >= 2 dims")
    rows = shape[0]
    cols = math.prod(shape[1:])
    size = max(rows, cols)
    q, r = torch.linalg.qr(torch.randn(size, size, generator=gen))
    q = q * torch.sign(torch.diagonal(r))
    return q[:rows, :cols].reshape(tuple(shape)).contiguous()


# ---------------------------------------------------------------------- #
# projections
# ---------------------------------------------------------------------- #
def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                use_bias: bool = True,
                init: Callable = glorot_uniform) -> Params:
    params = {"w": init(gen, (in_dim, out_dim))}
    if use_bias:
        params["b"] = torch.zeros(out_dim)
    return params


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


def maxout_init(gen: torch.Generator, in_dim: int, out_dim: int,
                pool_size: int = 2) -> Params:
    return linear_init(gen, in_dim, out_dim * pool_size)


def maxout(params: Params, x: torch.Tensor,
           pool_size: int = 2) -> torch.Tensor:
    """Maxout projection: the maximum over each run of ``pool_size``
    adjacent outputs of a linear layer."""
    y = linear(params, x)
    y = y.reshape(y.shape[:-1] + (y.shape[-1] // pool_size, pool_size))
    return y.amax(dim=-1)


def dropout(x: torch.Tensor, keep_prob: float,
            generator: torch.Generator, train: bool) -> torch.Tensor:
    """Inverted dropout: keeps each entry with probability
    ``keep_prob`` and scales it by ``1 / keep_prob``; the identity when
    not training or when ``keep_prob >= 1``. The keep draws come from
    ``generator``, which must live on ``x``'s device."""
    if not train or keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


# ---------------------------------------------------------------------- #
# recurrent cells
# ---------------------------------------------------------------------- #
class GRUCell:
    """TF1-convention GRU. State: h (B, H)."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 recurrent_init: Callable = glorot_uniform) -> None:
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.recurrent_init = recurrent_init

    def init(self, gen: torch.Generator) -> Params:
        h = self.hidden_dim
        return {
            "gates_x": glorot_uniform(gen, (self.input_dim, 2 * h)),
            "gates_h": self.recurrent_init(gen, (h, 2 * h)),
            # gate bias 1.0 -> start remembering (TF1 GRUCell convention)
            "gates_b": torch.ones(2 * h),
            "cand_x": glorot_uniform(gen, (self.input_dim, h)),
            "cand_h": self.recurrent_init(gen, (h, h)),
            "cand_b": torch.zeros(h),
        }

    def __call__(self, params: Params, h: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        gates = torch.sigmoid(x @ params["gates_x"] + h @ params["gates_h"]
                              + params["gates_b"])
        r, u = gates.chunk(2, dim=-1)
        cand = torch.tanh(x @ params["cand_x"] + (r * h) @ params["cand_h"]
                          + params["cand_b"])
        new_h = u * h + (1.0 - u) * cand
        return new_h, new_h  # (new_state, output)


class OrthoGRUCell(GRUCell):
    """GRU with orthogonally initialized recurrent weights."""

    def __init__(self, input_dim: int, hidden_dim: int) -> None:
        super().__init__(input_dim, hidden_dim, recurrent_init=orthogonal)


CELL_TYPES = {"GRU": GRUCell, "OrthoGRU": OrthoGRUCell}


def make_cell(cell_type: str, input_dim: int, hidden_dim: int) -> GRUCell:
    if cell_type not in CELL_TYPES:
        raise ValueError(
            f"rnn_cell '{cell_type}' is not ported to neuralmonkey_tpu_torch "
            f"(ported: {sorted(CELL_TYPES)})")
    return CELL_TYPES[cell_type](input_dim, hidden_dim)
