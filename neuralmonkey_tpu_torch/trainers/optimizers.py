"""Optimizers with optax's update rules, applied in place.

Counterpart of ``neuralmonkey_tpu/trainers/optimizers.py``. The
reference's configs point ``optimizer=`` sections at TF optimizer
classes (``tf.train.AdamOptimizer`` and so on); the builder's class
aliases map those names here. Each factory's ``make()`` gives a
transform that updates a flat ``{name: tensor}`` parameter dict in
place under ``torch.no_grad``, with the arithmetic of the optax
transformation the JAX package builds: ``optax.adam``, ``optax.sgd``
with and without momentum, and ``optax.clip_by_global_norm``. These
differ from ``torch.optim``'s (Adam's epsilon placement and bias
correction, the clip's ``+1e-6``), so ``torch.optim`` cannot stand in.

``learning_rate`` may be a float or a schedule (``functions.py``),
called with the number of updates applied so far, as optax does.
Adadelta, RMSProp and Adafactor are not ported yet and raise.
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
    """An optimizer's state layout and in-place update."""

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


class _NotPorted(Optimizer):
    def __init__(self, *args, **kwargs) -> None:
        del args, kwargs
        raise NotImplementedError(
            f"{type(self).__name__} is not ported to neuralmonkey_tpu_torch "
            "yet (ported: AdamOptimizer, GradientDescentOptimizer, "
            "MomentumOptimizer)")


class AdadeltaOptimizer(_NotPorted):
    pass


class RMSPropOptimizer(_NotPorted):
    pass


class AdafactorOptimizer(_NotPorted):
    pass


def resolve_optimizer(optimizer: Optional[Any]) -> Transform:
    """An Optimizer factory's transform; ``None`` is Adam at 1e-4, the
    JAX package's default."""
    if optimizer is None:
        return AdamOptimizer(1e-4).make()
    if isinstance(optimizer, Optimizer):
        return optimizer.make()
    raise TypeError(f"Cannot interpret optimizer {optimizer!r}")
