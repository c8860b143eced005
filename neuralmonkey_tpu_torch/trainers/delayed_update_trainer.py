"""Gradient-accumulation trainer (counterpart of
``neuralmonkey_tpu/trainers/delayed_update_trainer.py``).

The JAX package wraps its update in ``optax.MultiSteps``: one step per
batch, and the parameters change every ``batches_per_update``-th batch.
:class:`DelayedUpdate` follows that rule: the gradients of the batches
are averaged (Welford's running mean, as ``MultiSteps`` keeps it);
clipping and the optimizer apply to the average on every k-th batch
only, so the optimizer's own step count, and with it a learning-rate
schedule such as noam, advances once per real update.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from .generic_trainer import GenericTrainer, Objective, Update
from .optimizers import Flat, clip_by_global_norm, global_norm


class DelayedUpdate(Update):
    """``optax.MultiSteps(chain(clip_by_global_norm, tx), k)``."""

    def __init__(self, transform, clip_norm: float, every_k: int) -> None:
        super().__init__(transform, clip_norm)
        self.every_k = every_k

    def init(self, params: Flat) -> Flat:
        state = dict(self.transform.init(params))
        state["mini_step"] = torch.zeros((), dtype=torch.int64)
        for name, p in params.items():
            state[f"acc/{name}"] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def apply(self, params: Flat, grads: Flat, state: Flat,
              norm_of: Callable[[Flat], torch.Tensor] = global_norm
              ) -> torch.Tensor:
        """Accumulate ``grads``; on every k-th call update ``params`` in
        place from the average and reset it. Returns the global norm of
        this batch's gradients (``norm_of``, as ``Update.apply``)."""
        norm = norm_of(grads)
        mini = int(state["mini_step"])
        acc = {name: state[f"acc/{name}"] for name in params}
        for name, g in grads.items():
            acc[name].add_((g - acc[name]) / (mini + 1))
        if mini == self.every_k - 1:
            average = dict(acc)
            if self.clip_norm:
                average = clip_by_global_norm(average, self.clip_norm,
                                              norm_of(average))
            self.transform.apply(params, average, state)
            for a in acc.values():
                a.zero_()
        state["mini_step"].fill_((mini + 1) % self.every_k)
        return norm


class DelayedUpdateTrainer(GenericTrainer):

    def __init__(self, batches_per_update: int,
                 objectives: List[Objective] = None,
                 decoders: List = None,
                 l1_weight: float = 0.0,
                 l2_weight: float = 0.0,
                 clip_norm: float = None,
                 optimizer=None,
                 var_scopes: List[str] = None,
                 var_collection: str = None,
                 name: str = None) -> None:
        if objectives is None:
            if decoders is None:
                raise ValueError("Need objectives or decoders")
            from .cross_entropy_trainer import xent_objective
            objectives = [xent_objective(d) for d in decoders]
        super().__init__(
            objectives=objectives, l1_weight=l1_weight,
            l2_weight=l2_weight, clip_norm=clip_norm,
            optimizer=optimizer, var_scopes=var_scopes,
            var_collection=var_collection, name=name)
        if batches_per_update < 1:
            raise ValueError("batches_per_update must be >= 1")
        self.batches_per_update = batches_per_update

    def make_update(self) -> Update:
        base = super().make_update()
        return DelayedUpdate(base.transform, self.clip_norm,
                             self.batches_per_update)
