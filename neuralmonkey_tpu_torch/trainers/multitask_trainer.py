"""Round-robin multitask trainer (counterpart of
``neuralmonkey_tpu/trainers/multitask_trainer.py``, reference
nm/trainers/multitask_trainer.py): the child trainers take the steps in
turn (``select``); each keeps its own optimizer state in the manager,
under its own label, and so in the ``.opt`` file."""

from __future__ import annotations

from typing import List

from .generic_trainer import GenericTrainer


class MultitaskTrainer:

    def __init__(self, trainers: List[GenericTrainer],
                 name: str = None) -> None:
        if not trainers:
            raise ValueError("MultitaskTrainer needs at least one trainer")
        self.name = name or "multitask_trainer"
        self.trainers = trainers

    def select(self, step: int) -> GenericTrainer:
        return self.trainers[step % len(self.trainers)]

    @property
    def all_parts(self):
        parts = []
        for trainer in self.trainers:
            parts.extend(trainer.all_parts)
        return parts
