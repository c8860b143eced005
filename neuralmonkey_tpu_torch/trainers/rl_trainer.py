"""RL trainer (counterpart of ``neuralmonkey_tpu/trainers/rl_trainer.py``,
reference nm/trainers/rl_trainer.py): a GenericTrainer over REINFORCE or
self-critical objectives, optionally with cross-entropy at
``xent_weight``."""

from __future__ import annotations

from typing import Callable, List

from .cross_entropy_trainer import xent_objective
from .generic_trainer import GenericTrainer
from .self_critical_objective import (reinforce_objective,
                                      self_critical_objective,
                                      sentence_gleu)


class ReinforceTrainer(GenericTrainer):

    def __init__(self, decoders: List,
                 reward_function: Callable = sentence_gleu,
                 self_critical: bool = True,
                 xent_weight: float = 0.0,
                 subtract_baseline: bool = True,
                 l1_weight: float = 0.0,
                 l2_weight: float = 0.0,
                 clip_norm: float = None,
                 optimizer=None,
                 var_scopes: List[str] = None,
                 name: str = None) -> None:
        objectives = []
        for decoder in decoders:
            if self_critical:
                objectives.append(self_critical_objective(
                    decoder, reward_function))
            else:
                objectives.append(reinforce_objective(
                    decoder, reward_function,
                    subtract_baseline=subtract_baseline))
            if xent_weight > 0.0:
                objectives.append(xent_objective(decoder, xent_weight))
        super().__init__(
            objectives=objectives, l1_weight=l1_weight,
            l2_weight=l2_weight, clip_norm=clip_norm,
            optimizer=optimizer, var_scopes=var_scopes, name=name)


SelfCriticalTrainer = ReinforceTrainer
