"""NN primitives: initializers, projections, dropout, recurrent cells.

Counterpart of ``neuralmonkey_tpu/ops/nn.py``. Parameters are plain dicts of tensors with the
JAX package's names and layouts (a linear ``w`` is ``(in, out)``), so
a JAX checkpoint loads without transposes. Initializers draw from an
explicit ``torch.Generator`` on the CPU.

The GRU follows TF1 (``tf.nn.rnn_cell.GRUCell``): the reset gate
multiplies ``h`` *before* the candidate's recurrent product, and the
gate bias starts at 1.0. ``torch.nn.GRU`` and cuDNN apply the reset
gate after that product, so they cannot stand in for it. The LSTM
follows TF1 too (``tf.nn.rnn_cell.BasicLSTMCell``): one ``z`` of gates
in i, j, f, o order, with ``forget_bias`` added to f. The layer-normalized
and the noisy-activation GRUs have no kernel; ``ops/rnn.py`` scans them
step by step, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

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


class _Bf16MatmulF32(torch.autograd.Function):
    """``a @ b`` of bf16 ``a`` (..., K) and ``b`` (K, N) on the card:
    cuBLAS's bf16 product with float32 sums and a float32 output
    (``torch.mm(..., out_dtype=torch.float32)``, which has no gradient
    of its own). The backward takes the JAX package's transposes: float32
    products of the float32 cotangent with the widened other operand,
    rounded to bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().T).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.reshape(-1, a.shape[-1]).float().T
                  @ g.reshape(-1, g.shape[-1])).to(b.dtype)
        return ga, gb


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under the JAX package's rules for
    ``jnp.dot(..., preferred_element_type=float32)``: operands of one
    float type multiply as they are; a bf16 operand beside a wider one
    is widened; two bf16 operands give float32 sums and a float32
    output: on the card cuBLAS's bf16 product (a (K, N) ``b``), on the
    CPU both widened (their products are exact in float32, so that
    computes the same function)."""
    if a.dtype == b.dtype and a.dtype != torch.bfloat16:
        return torch.matmul(a, b)
    if (a.dtype == b.dtype == torch.bfloat16 and a.is_cuda
            and b.dim() == 2):
        return _Bf16MatmulF32.apply(a, b)
    dtype = widened(torch.promote_types(a.dtype, b.dtype))
    return torch.matmul(a.to(dtype), b.to(dtype))


def widened(dtype: torch.dtype) -> torch.dtype:
    """The dtype that sums and masks take beside ``dtype``: float32 for
    bf16, ``dtype`` itself otherwise."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def pdot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Parameter product under the compute-precision policy
    (``ops/policy.py``): a bf16 weight takes the activation to bf16 too,
    and the sums and the output stay float32 (``nn.pdot``)."""
    if w.dtype == torch.bfloat16 and x.dtype != torch.bfloat16:
        x = x.to(torch.bfloat16)
    return dot(x, w)


def scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the JAX package's weak-typed
    Python scalars are before they meet a tensor of that dtype; a bf16
    tensor times the result rounds as a bf16 product does."""
    return torch.tensor(value, dtype=dtype).item()


def depth_scale(dim: int, like: torch.Tensor) -> float:
    """``sqrt(dim)`` computed in ``like``'s dtype, as
    ``jnp.sqrt(jnp.asarray(dim, like.dtype))`` (the embeddings' scale)."""
    return torch.tensor(float(dim), dtype=like.dtype).sqrt().item()


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = pdot(x, params["w"])
    if "b" in params:
        y = y + params["b"]
    return y


def nonlinear(params: Params, x: torch.Tensor,
              activation: Callable = torch.tanh) -> torch.Tensor:
    return activation(linear(params, x))


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


def multilayer_projection_init(gen: torch.Generator, in_dim: int,
                               layer_sizes: Sequence[int]) -> List[Params]:
    layers = []
    for size in layer_sizes:
        layers.append(linear_init(gen, in_dim, size))
        in_dim = size
    return layers


def multilayer_projection(layers: List[Params], x: torch.Tensor,
                          activation: Callable = torch.tanh,
                          dropout_fn: Optional[Callable] = None
                          ) -> torch.Tensor:
    """A stack of linear layers, each followed by ``activation`` and,
    when given, ``dropout_fn``."""
    for layer in layers:
        x = activation(linear(layer, x))
        if dropout_fn is not None:
            x = dropout_fn(x)
    return x


def highway_init(gen: torch.Generator, dim: int) -> Dict[str, Params]:
    return {
        "h": linear_init(gen, dim, dim),
        # gate bias -1 leans the layer towards carrying its input
        "t": {"w": glorot_uniform(gen, (dim, dim)),
              "b": torch.full((dim,), -1.0)},
    }


def highway(params: Dict[str, Params], x: torch.Tensor,
            activation: Callable = torch.tanh) -> torch.Tensor:
    """Highway layer: ``h·t + x·(1 - t)`` with the transform gate ``t``."""
    h = activation(linear(params["h"], x))
    t = torch.sigmoid(linear(params["t"], x))
    return h * t + x * (1.0 - t)


def dropout(x: torch.Tensor, keep_prob: float,
            generator: torch.Generator, train: bool) -> torch.Tensor:
    """Inverted dropout: keeps each entry with probability
    ``keep_prob`` and scales it by ``1 / keep_prob``; the identity when
    not training or when ``keep_prob >= 1``. The keep draws come from
    ``generator``, which must live on ``x``'s device."""
    if not train or keep_prob >= 1.0:
        return x
    # a bf16 x draws its keeps as a float32 one does, and takes the scale
    # rounded to bf16 first, as the JAX package's weak-typed scalar is
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=widened(x.dtype)) < keep_prob
    return torch.where(keep, x / scalar(keep_prob, x.dtype), 0.0)


def maybe_dropout(x: torch.Tensor, keep_prob: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout iff the caller drew a generator for this site
    (it draws one exactly when ``Context.dropout`` would apply)."""
    if generator is None:
        return x
    return dropout(x, keep_prob, generator, True)


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
        gates = torch.sigmoid(pdot(x, params["gates_x"])
                              + pdot(h, params["gates_h"])
                              + params["gates_b"])
        r, u = gates.chunk(2, dim=-1)
        cand = torch.tanh(pdot(x, params["cand_x"])
                          + pdot(r * h, params["cand_h"])
                          + params["cand_b"])
        new_h = u * h + (1.0 - u) * cand
        return new_h, new_h  # (new_state, output)


class OrthoGRUCell(GRUCell):
    """GRU with orthogonally initialized recurrent weights."""

    def __init__(self, input_dim: int, hidden_dim: int) -> None:
        super().__init__(input_dim, hidden_dim, recurrent_init=orthogonal)


class LayerNormGRUCell(GRUCell):
    """GRU with layer normalization (eps 1e-6) of the gate and candidate
    pre-activations; ``gates_b`` and ``cand_b`` are the normalizations'
    biases, ``ln_gates_scale`` and ``ln_cand_scale`` their scales."""

    def init(self, gen: torch.Generator) -> Params:
        params = super().init(gen)
        h = self.hidden_dim
        params["ln_gates_scale"] = torch.ones(2 * h)
        params["ln_cand_scale"] = torch.ones(h)
        return params

    @staticmethod
    def _ln(x: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        return (x - mean) * torch.rsqrt(var + 1e-6) * scale + bias

    def __call__(self, params: Params, h: torch.Tensor, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        gates = torch.sigmoid(self._ln(
            pdot(x, params["gates_x"]) + pdot(h, params["gates_h"]),
            params["ln_gates_scale"], params["gates_b"]))
        r, u = gates.chunk(2, dim=-1)
        cand = torch.tanh(self._ln(
            pdot(x, params["cand_x"]) + pdot(r * h, params["cand_h"]),
            params["ln_cand_scale"], params["cand_b"]))
        new_h = u * h + (1.0 - u) * cand
        return new_h, new_h


class NoisyGRUCell(GRUCell):
    """Noisy-activation GRU (Gulcehre et al., 2016): hard sigmoid and
    hard tanh; in training, when the caller passes ``noise`` (standard
    normal draws, see :meth:`draw_noise`), half-normal noise enters the
    saturated regions:

        y = a·h(x) + (1 - a)·u(x) + d(x)·s(x)·|xi|

    with ``h`` the hard function, ``u`` its linearization, ``s(x) =
    C·(sigmoid(h - u) - 1/2)^2`` and ``d(x) = sgn(x)·sgn(a - 1)``.

    The JAX cell stores ``training`` and never reads it (the noise is on
    exactly when a training pass threads it in), so the port refuses
    ``training=True`` rather than ignore it."""

    ALPHA = 1.15
    C = 0.5

    def __init__(self, input_dim: int, hidden_dim: int,
                 training: bool = False) -> None:
        if training:
            raise ValueError(
                "NoisyGRUCell(training=True): the reference stores the "
                "flag and never reads it; noise is drawn in every "
                "training pass and never at inference")
        super().__init__(input_dim, hidden_dim)

    def draw_noise(self, steps: int, batch: int,
                   generator: torch.Generator,
                   device: torch.device) -> torch.Tensor:
        """Standard normal draws for ``steps`` steps of ``batch`` rows,
        (steps, batch, 3H): each step's gates read the first 2H columns
        of its row, the candidate the last H."""
        return torch.randn((steps, batch, 3 * self.hidden_dim),
                           generator=generator, device=device)

    @staticmethod
    def _hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(0.25 * x + 0.5, 0.0, 1.0)

    @staticmethod
    def _hard_tanh(x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, -1.0, 1.0)

    @classmethod
    def _noisy(cls, hard_value: torch.Tensor, linear_value: torch.Tensor,
               x: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        delta = hard_value - linear_value
        sigma = cls.C * torch.square(torch.sigmoid(delta) - 0.5)
        d = torch.sign(x) * math.copysign(1.0, cls.ALPHA - 1.0)
        return (cls.ALPHA * hard_value
                + (1.0 - cls.ALPHA) * linear_value
                + d * sigma * xi.abs())

    def __call__(self, params: Params, h: torch.Tensor, x: torch.Tensor,
                 noise: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        gates_pre = (pdot(x, params["gates_x"]) + pdot(h, params["gates_h"])
                     + params["gates_b"])
        gates = self._hard_sigmoid(gates_pre)
        if noise is not None:
            gates = self._noisy(gates, 0.25 * gates_pre + 0.5, gates_pre,
                                noise[..., :2 * self.hidden_dim])
        r, u = gates.chunk(2, dim=-1)
        cand_pre = (pdot(x, params["cand_x"])
                    + pdot(r * h, params["cand_h"]) + params["cand_b"])
        cand = self._hard_tanh(cand_pre)
        if noise is not None:
            cand = self._noisy(cand, cand_pre, cand_pre,
                               noise[..., 2 * self.hidden_dim:])
        new_h = u * h + (1.0 - u) * cand
        return new_h, new_h


class LSTMCell:
    """TF1-convention LSTM. State: (c, h), each (B, H); output h."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 forget_bias: float = 1.0) -> None:
        self.input_dim = input_dim
        self.hidden_dim = hidden_dim
        self.forget_bias = forget_bias

    def init(self, gen: torch.Generator) -> Params:
        h = self.hidden_dim
        return {
            "kernel_x": glorot_uniform(gen, (self.input_dim, 4 * h)),
            "kernel_h": glorot_uniform(gen, (h, 4 * h)),
            "bias": torch.zeros(4 * h),
        }

    def __call__(self, params: Params,
                 state: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor
                 ) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
        c, h = state
        z = (pdot(x, params["kernel_x"]) + pdot(h, params["kernel_h"])
             + params["bias"])
        i, j, f, o = z.chunk(4, dim=-1)
        new_c = (c * torch.sigmoid(f + self.forget_bias)
                 + torch.sigmoid(i) * torch.tanh(j))
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        return (new_c, new_h), new_h

    @staticmethod
    def output(state: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return state[1]


Cell = Union[GRUCell, LSTMCell]
CELL_TYPES = {
    "GRU": GRUCell,
    "OrthoGRU": OrthoGRUCell,
    "LayerNormGRU": LayerNormGRUCell,
    "NoisyGRU": NoisyGRUCell,
    "LSTM": LSTMCell,
}


def make_cell(cell_type: str, input_dim: int, hidden_dim: int) -> Cell:
    if cell_type not in CELL_TYPES:
        raise ValueError(
            f"Unknown rnn_cell '{cell_type}' "
            f"(choose from {sorted(CELL_TYPES)})")
    return CELL_TYPES[cell_type](input_dim, hidden_dim)
