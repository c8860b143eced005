"""Optimizers with optax's update rules, applied in place.

Counterpart of ``neuralmonkey_tpu/trainers/optimizers.py``. The
reference's configs point ``optimizer=`` sections at TF optimizer
classes (``tf.train.AdamOptimizer`` and so on); the builder's class
aliases map those names here. Each factory's ``make()`` gives a
transform that updates a flat ``{name: tensor}`` parameter dict in
place under ``torch.no_grad``, with the arithmetic of the optax
transformation the JAX package builds: ``optax.adam``, ``optax.sgd``
with and without momentum, ``optax.adadelta``, ``optax.rmsprop``,
``optax.adafactor`` and ``optax.clip_by_global_norm``. These differ
from ``torch.optim``'s (Adam's epsilon placement and bias correction,
RMSProp's epsilon inside the square root and its momentum on the
scaled step, Adafactor's clipping and parameter scale, the clip's
``+1e-6``), so ``torch.optim`` cannot stand in.

``learning_rate`` may be a float or a schedule (``functions.py``),
called with the number of updates applied so far, as optax does.

Adam's and SGD's states keep the port's own flat keys (``count``,
``mu/<param>``, ...). Adadelta's, RMSProp's and Adafactor's take the
flat keys of optax's state trees (``1/e_g/<param>``, ``0/v_row/<param>``,
a schedule's ``<i>/count``, ...; ``optax_keys``), so the ``.opt`` files
of the two packages resume in each other.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

Schedule = Union[float, Callable]
Flat = Dict[str, torch.Tensor]


def global_norm(grads: Flat) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all gradients together."""
    return torch.sqrt(sum(g.square().sum() for g in grads.values()))


def clip_by_global_norm(grads: Flat, max_norm: float,
                        norm: torch.Tensor) -> Flat:
    """``optax.clip_by_global_norm``: unchanged when ``norm < max_norm``,
    else ``g / norm * max_norm``. No epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``."""
    keep = norm < max_norm
    return {k: torch.where(keep, g, g / norm * max_norm)
            for k, g in grads.items()}


def _learning_rate(schedule: Schedule, count: int) -> float:
    return float(schedule(count)) if callable(schedule) else schedule


class Transform:
    """An optimizer's state layout and in-place update. With
    ``optax_keys`` the state's keys are those of the optax
    transformation's flattened state tree. An ``elementwise`` rule
    updates each entry of a parameter from the same entries of its
    gradient and state alone, so ZeRO may divide them in any slices."""

    optax_keys = False
    elementwise = True

    def init(self, params: Flat) -> Flat:
        raise NotImplementedError

    def apply(self, params: Flat, grads: Flat, state: Flat) -> None:
        raise NotImplementedError


class _Adam(Transform):
    def __init__(self, learning_rate: Schedule, b1: float, b2: float,
                 eps: float) -> None:
        self.learning_rate, self.b1, self.b2, self.eps = (
            learning_rate, b1, b2, eps)

    def init(self, params: Flat) -> Flat:
        state = {"count": torch.zeros((), dtype=torch.int64)}
        for name, p in params.items():
            state[f"mu/{name}"] = torch.zeros_like(p)
            state[f"nu/{name}"] = torch.zeros_like(p)
        return state

    def apply(self, params: Flat, grads: Flat, state: Flat) -> None:
        count = int(state["count"])
        lr = _learning_rate(self.learning_rate, count)
        count += 1
        state["count"].fill_(count)
        # the bias corrections in float32, as optax computes them
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        for name, p in params.items():
            g = grads[name]
            mu = (1 - self.b1) * g + self.b1 * state[f"mu/{name}"]
            nu = (1 - self.b2) * g.square() + self.b2 * state[f"nu/{name}"]
            state[f"mu/{name}"].copy_(mu)
            state[f"nu/{name}"].copy_(nu)
            p.add_(-lr * ((mu / c1) / (torch.sqrt(nu / c2) + self.eps)))


class _SGD(Transform):
    def __init__(self, learning_rate: Schedule, momentum: float = None,
                 nesterov: bool = False) -> None:
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params: Flat) -> Flat:
        state = {"count": torch.zeros((), dtype=torch.int64)}
        if self.momentum is not None:
            for name, p in params.items():
                state[f"trace/{name}"] = torch.zeros_like(p)
        return state

    def apply(self, params: Flat, grads: Flat, state: Flat) -> None:
        count = int(state["count"])
        lr = _learning_rate(self.learning_rate, count)
        state["count"].fill_(count + 1)
        for name, p in params.items():
            update = grads[name]
            if self.momentum is not None:
                trace = update + self.momentum * state[f"trace/{name}"]
                state[f"trace/{name}"].copy_(trace)
                update = (update + self.momentum * trace if self.nesterov
                          else trace)
            p.add_(-lr * update)


class _Schedule:
    """The learning rate of an optax chain: a float scales with no
    state; a schedule keeps its own update count under ``<index>/count``
    (``optax.scale_by_schedule``) and is called with it."""

    def __init__(self, learning_rate: Schedule, index: int) -> None:
        self.learning_rate = learning_rate
        self.key = f"{index}/count"

    def init(self, state: Flat) -> None:
        if callable(self.learning_rate):
            state[self.key] = torch.zeros((), dtype=torch.int32)

    def next(self, state: Flat) -> float:
        """This update's rate; advances the schedule's count."""
        if not callable(self.learning_rate):
            return self.learning_rate
        count = int(state[self.key])
        state[self.key].fill_(count + 1)
        return _learning_rate(self.learning_rate, count)


class _Adadelta(Transform):
    """``optax.adadelta``: ``chain(add_decayed_weights(0),
    scale_by_adadelta(rho, eps), scale_by_learning_rate(lr))``."""

    optax_keys = True

    def __init__(self, learning_rate: Schedule, rho: float,
                 eps: float) -> None:
        self.rate = _Schedule(learning_rate, 2)
        self.rho, self.eps = rho, eps

    def init(self, params: Flat) -> Flat:
        state: Flat = {}
        for name, p in params.items():
            state[f"1/e_g/{name}"] = torch.zeros_like(p)
            state[f"1/e_x/{name}"] = torch.zeros_like(p)
        self.rate.init(state)
        return state

    def apply(self, params: Flat, grads: Flat, state: Flat) -> None:
        lr = self.rate.next(state)
        rho = self.rho
        for name, p in params.items():
            g = grads[name]
            e_g = (1 - rho) * g ** 2 + rho * state[f"1/e_g/{name}"]
            e_x = state[f"1/e_x/{name}"]
            update = (torch.sqrt(e_x + self.eps)
                      / torch.sqrt(e_g + self.eps)) * g
            state[f"1/e_g/{name}"].copy_(e_g)
            e_x.copy_((1 - rho) * update ** 2 + rho * e_x)
            p.add_(-lr * update)


class _RMSProp(Transform):
    """``optax.rmsprop``: ``chain(scale_by_rms(decay, eps),
    scale_by_learning_rate(lr), trace(momentum))``; the epsilon sits
    inside the square root, and the momentum (a trace even at 0.0; none
    only for ``None``) runs on the rate-scaled step."""

    optax_keys = True

    def __init__(self, learning_rate: Schedule, decay: float, eps: float,
                 momentum: Optional[float]) -> None:
        self.rate = _Schedule(learning_rate, 1)
        self.decay, self.eps, self.momentum = decay, eps, momentum

    def init(self, params: Flat) -> Flat:
        state: Flat = {}
        for name, p in params.items():
            state[f"0/nu/{name}"] = torch.zeros_like(p)
            if self.momentum is not None:
                state[f"2/trace/{name}"] = torch.zeros_like(p)
        self.rate.init(state)
        return state

    def apply(self, params: Flat, grads: Flat, state: Flat) -> None:
        lr = self.rate.next(state)
        for name, p in params.items():
            g = grads[name]
            nu = (1 - self.decay) * g ** 2 + self.decay * state[
                f"0/nu/{name}"]
            state[f"0/nu/{name}"].copy_(nu)
            update = -lr * (torch.rsqrt(nu + self.eps) * g)
            if self.momentum is not None:
                trace = state[f"2/trace/{name}"]
                update = update + self.momentum * trace
                trace.copy_(update)
            p.add_(update)


def _factored_dims(shape, min_dim_size_to_factor: int):
    """optax's ``_factored_dims``: the (second largest, largest) dims of
    a shape whose second largest dim reaches the threshold, else None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class _Adafactor(Transform):
    """``optax.adafactor(learning_rate)`` at its defaults:
    ``scale_by_factored_rms`` (second moments factored into row and
    column means for parameters whose second largest dim is at least
    128, decay ``1 - (t + 1)^-0.8``, epsilon 1e-30), ``clip_by_block_rms
    (1.0)``, the learning rate when one is given (none for ``None``),
    ``scale_by_param_block_rms`` (1e-3) and ``scale(-1)``. The state
    keeps optax's ``(1,)`` placeholders in ``v_row``/``v_col`` or
    ``v`` for the other layout."""

    optax_keys = True
    # the factored moments, the block-RMS clip and the parameter scale
    # reduce over whole parameters
    elementwise = False
    MIN_DIM_SIZE_TO_FACTOR = 128
    DECAY_RATE = 0.8
    EPS = 1e-30
    CLIPPING_THRESHOLD = 1.0
    MIN_SCALE = 1e-3

    def __init__(self, learning_rate: Optional[Schedule]) -> None:
        self.rate = (None if learning_rate is None
                     else _Schedule(learning_rate, 2))

    def init(self, params: Flat) -> Flat:
        state: Flat = {"0/count": torch.zeros((), dtype=torch.int32)}
        for name, p in params.items():
            dims = _factored_dims(p.shape, self.MIN_DIM_SIZE_TO_FACTOR)
            placeholder = p.new_zeros((1,))
            if dims is None:
                shapes = ((1,), (1,), p.shape)
            else:
                d1, d0 = dims
                shapes = ([n for i, n in enumerate(p.shape) if i != d0],
                          [n for i, n in enumerate(p.shape) if i != d1],
                          (1,))
            for key, shape in zip(("v_row", "v_col", "v"), shapes):
                state[f"0/{key}/{name}"] = placeholder.new_zeros(shape)
        if self.rate is not None:
            self.rate.init(state)
        return state

    def apply(self, params: Flat, grads: Flat, state: Flat) -> None:
        step = int(state["0/count"])
        state["0/count"].fill_(step + 1)
        # optax's _decay_rate_pow, in float32
        decay = float(np.float32(1.0) - np.float32(step + 1)
                      ** np.float32(-self.DECAY_RATE))
        lr = None if self.rate is None else self.rate.next(state)
        for name, p in params.items():
            g = grads[name]
            grad_sqr = g * g + self.EPS
            dims = _factored_dims(p.shape, self.MIN_DIM_SIZE_TO_FACTOR)
            if dims is None:
                v = decay * state[f"0/v/{name}"] + (1.0 - decay) * grad_sqr
                state[f"0/v/{name}"].copy_(v)
                update = g * v ** -0.5
            else:
                d1, d0 = dims
                v_row = (decay * state[f"0/v_row/{name}"]
                         + (1.0 - decay) * grad_sqr.mean(dim=d0))
                v_col = (decay * state[f"0/v_col/{name}"]
                         + (1.0 - decay) * grad_sqr.mean(dim=d1))
                state[f"0/v_row/{name}"].copy_(v_row)
                state[f"0/v_col/{name}"].copy_(v_col)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1,
                                                 keepdim=True)) ** -0.5
                update = (g * row_factor.unsqueeze(d0)
                          * (v_col ** -0.5).unsqueeze(d1))
            update = update / torch.clamp(
                torch.sqrt(torch.mean(update * update))
                / self.CLIPPING_THRESHOLD, min=1.0)
            if lr is not None:
                update = lr * update
            rms = torch.sqrt(torch.mean(p * p))
            update = update * torch.where(rms <= self.MIN_SCALE,
                                          self.MIN_SCALE, rms)
            p.add_(-1 * update)


class Optimizer:
    """Base: subclasses build a :class:`Transform`."""

    def make(self) -> Transform:
        raise NotImplementedError


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate: Schedule = 1e-3,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8,
                 use_locking: bool = False, name: str = None) -> None:
        del use_locking, name
        self.learning_rate = learning_rate
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def make(self) -> Transform:
        return _Adam(self.learning_rate, self.beta1, self.beta2,
                     self.epsilon)


# tf.contrib.opt.LazyAdamOptimizer: dense Adam, as in the JAX package
LazyAdamOptimizer = AdamOptimizer


class GradientDescentOptimizer(Optimizer):
    def __init__(self, learning_rate: Schedule = 0.1,
                 use_locking: bool = False, name: str = None) -> None:
        del use_locking, name
        self.learning_rate = learning_rate

    def make(self) -> Transform:
        return _SGD(self.learning_rate)


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate: Schedule = 0.1,
                 momentum: float = 0.9, use_nesterov: bool = False,
                 use_locking: bool = False, name: str = None) -> None:
        del use_locking, name
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def make(self) -> Transform:
        return _SGD(self.learning_rate, self.momentum, self.use_nesterov)


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate: Schedule = 1.0, rho: float = 0.95,
                 epsilon: float = 1e-8, use_locking: bool = False,
                 name: str = None) -> None:
        del use_locking, name
        self.learning_rate = learning_rate
        self.rho = rho
        self.epsilon = epsilon

    def make(self) -> Transform:
        return _Adadelta(self.learning_rate, self.rho, self.epsilon)


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate: Schedule = 1e-3,
                 decay: float = 0.9, momentum: float = 0.0,
                 epsilon: float = 1e-10, use_locking: bool = False,
                 name: str = None) -> None:
        del use_locking, name
        self.learning_rate = learning_rate
        self.decay = decay
        self.momentum = momentum
        self.epsilon = epsilon

    def make(self) -> Transform:
        return _RMSProp(self.learning_rate, self.decay, self.epsilon,
                        self.momentum)


class AdafactorOptimizer(Optimizer):
    def __init__(self, learning_rate: Schedule = None,
                 name: str = None) -> None:
        del name
        self.learning_rate = learning_rate

    def make(self) -> Transform:
        return _Adafactor(self.learning_rate)


def resolve_optimizer(optimizer: Optional[Any]) -> Transform:
    """An Optimizer factory's transform; ``None`` is Adam at 1e-4, the
    JAX package's default."""
    if optimizer is None:
        return AdamOptimizer(1e-4).make()
    if isinstance(optimizer, Optimizer):
        return optimizer.make()
    raise TypeError(f"Cannot interpret optimizer {optimizer!r}")
