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
    tx)`` of the JAX trainer's ``make_optax``. A transform with optax's
    state keys finds them under the chain's ``1/`` when clipped, as in
    the JAX package's ``.opt`` files."""

    def __init__(self, transform, clip_norm: float = None) -> None:
        self.transform = transform
        self.clip_norm = clip_norm
        self.prefix = ("1/" if clip_norm and transform.optax_keys
                       else "")

    def init(self, params: Flat) -> Flat:
        return {self.prefix + k: v
                for k, v in self.transform.init(params).items()}

    @torch.no_grad()
    def apply(self, params: Flat, grads: Flat, state: Flat,
              norm_of: Callable[[Flat], torch.Tensor] = global_norm
              ) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; returns the
        gradients' global norm before clipping. ``norm_of`` takes the
        global norm of gradient-shaped tensors (under ZeRO, of each
        rank's parts: ``parallel.zero.sharded_norm``)."""
        norm = norm_of(grads)
        if self.clip_norm:
            grads = clip_by_global_norm(grads, self.clip_norm, norm)
        # the transform updates the state's tensors in place, so a view
        # without the prefix shares them
        self.transform.apply(params, grads, {
            k[len(self.prefix):]: v for k, v in state.items()})
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
        # terms of the parameters alone, over the trainable ones
        if self.l1_weight:
            total = total + self.l1_weight * ctx.param_sum(
                lambda x: x.abs().sum(), self.var_scopes)
        if self.l2_weight:
            total = total + self.l2_weight * ctx.param_sum(
                lambda x: x.square().sum(), self.var_scopes)
        return total, losses

    def is_trainable(self, name: str) -> bool:
        """Whether the flat parameter ``name`` (``part/...``) is
        trained; parts outside ``var_scopes`` get zero gradients."""
        return not self.var_scopes or name.split("/", 1)[0] in \
            self.var_scopes

    def make_update(self) -> Update:
        return Update(resolve_optimizer(self.optimizer), self.clip_norm)
