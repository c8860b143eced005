"""Learning-rate schedules (counterpart of
``neuralmonkey_tpu/functions.py``). A schedule is a callable
``step -> learning rate``; the port's optimizers call it with the
number of updates applied so far, a Python int, as optax calls the JAX
package's schedules with its update count."""

from __future__ import annotations

import math
from typing import Callable, Sequence


def noam_decay(learning_rate: float, model_dimension: int,
               warmup_steps: int = 4000):
    """Transformer LR schedule (Vaswani et al. 2017)."""
    def schedule(step):
        step = max(float(step), 1.0)
        return (learning_rate * model_dimension ** -0.5
                * min(step ** -0.5, step * warmup_steps ** -1.5))
    return schedule


def piecewise_constant(boundaries: Sequence[float],
                       values: Sequence[float]) -> Callable:
    """Step-function schedule: values[i] until boundaries[i]."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("need len(values) == len(boundaries) + 1")

    def schedule(step):
        return values[sum(step >= b for b in boundaries)]
    return schedule


def exponential_decay(learning_rate: float, decay_steps: int,
                      decay_rate: float, staircase: bool = False):
    def schedule(step):
        exponent = float(step) / decay_steps
        if staircase:
            exponent = math.floor(exponent)
        return learning_rate * decay_rate ** exponent
    return schedule


def inverse_sigmoid_decay(param: float, rate: float):
    """k/(k+exp(step/k)) style decay (scheduled sampling)."""
    def schedule(step):
        return param * rate / (rate + math.exp(float(step) / rate))
    return schedule
