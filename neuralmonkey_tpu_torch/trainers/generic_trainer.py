"""Generic trainer (counterpart of
``neuralmonkey_tpu/trainers/generic_trainer.py``).

An ``Objective`` binds a decoder's loss into the training objective;
the trainer turns its objectives into one ``total_loss(params, batch,
rng)`` and an optimizer :class:`Update` (clipping by global norm, then
the optimizer's rule). The manager runs the step (``runtime.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from ..model.part import Context
from ..utils.saving import flatten_tree
from .optimizers import (Flat, clip_by_global_norm, global_norm,
                         resolve_optimizer)


class Objective:
    """One weighted loss term (the reference's Objective)."""

    def __init__(self, name: str, decoder,
                 loss: Callable[[Context], torch.Tensor] = None,
                 gradients=None, weight: float = 1.0) -> None:
        self.name = name
        self.decoder = decoder
        self._loss = loss
        self.gradients = gradients  # kept for API parity; unused
        self.weight = weight

    def loss(self, ctx: Context) -> torch.Tensor:
        if self._loss is not None:
            return self._loss(ctx)
        return self.decoder.cost(ctx)


class Update:
    """Clip by global norm (when ``clip_norm`` is set), then apply the
    optimizer's rule in place: ``optax.chain(clip_by_global_norm(c),
    tx)`` of the JAX trainer's ``make_optax``."""

    def __init__(self, transform, clip_norm: float = None) -> None:
        self.transform = transform
        self.clip_norm = clip_norm

    def init(self, params: Flat) -> Flat:
        return self.transform.init(params)

    @torch.no_grad()
    def apply(self, params: Flat, grads: Flat, state: Flat
              ) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; returns the
        gradients' global norm before clipping."""
        norm = global_norm(grads)
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm, norm)
        self.transform.apply(params, grads, state)
        return norm


class GenericTrainer:

    def __init__(self, objectives: List[Objective],
                 l1_weight: float = 0.0,
                 l2_weight: float = 0.0,
                 clip_norm: float = None,
                 optimizer=None,
                 var_scopes: List[str] = None,
                 var_collection: str = None,
                 name: str = None) -> None:
        del var_collection
        self.name = name or "trainer"
        self.objectives = objectives
        self.l1_weight = l1_weight
        self.l2_weight = l2_weight
        self.clip_norm = clip_norm
        self.optimizer = optimizer
        self.var_scopes = var_scopes

    # parts reachable through this trainer (for model collection)
    @property
    def all_parts(self):
        return [o.decoder for o in self.objectives]

    def total_loss(self, params: Any, batch: Dict[str, Any], rng: int):
        """(scalar total, per-objective and auxiliary losses) of one
        train-mode pass; ``rng`` seeds its dropout."""
        ctx = Context(params, batch, train=True, rng=rng)
        losses = {o.name: o.loss(ctx) for o in self.objectives}
        total = sum(o.weight * losses[o.name] for o in self.objectives)
        # auxiliary losses parts registered during the forward pass
        for key, value in ctx.aux_losses.items():
            total = total + value
            losses[f"aux/{key}"] = value
        if self.l1_weight or self.l2_weight:
            leaves = list(flatten_tree(self._trainable(params)).values())
            if self.l1_weight:
                total = total + self.l1_weight * sum(
                    x.abs().sum() for x in leaves)
            if self.l2_weight:
                total = total + self.l2_weight * sum(
                    x.square().sum() for x in leaves)
        return total, losses

    def _trainable(self, params):
        if not self.var_scopes:
            return params
        return {k: v for k, v in params.items() if k in self.var_scopes}

    def is_trainable(self, name: str) -> bool:
        """Whether the flat parameter ``name`` (``part/...``) is
        trained; parts outside ``var_scopes`` get zero gradients."""
        return not self.var_scopes or name.split("/", 1)[0] in \
            self.var_scopes

    def make_update(self) -> Update:
        return Update(resolve_optimizer(self.optimizer), self.clip_norm)
