"""Cross-entropy trainer sugar (counterpart of
``neuralmonkey_tpu/trainers/cross_entropy_trainer.py``)."""

from __future__ import annotations

from typing import List

from .generic_trainer import GenericTrainer, Objective


def xent_objective(decoder, weight: float = 1.0) -> Objective:
    return Objective(
        name=f"{decoder.name} - cross-entropy",
        decoder=decoder,
        loss=lambda ctx: decoder.cost(ctx),
        weight=weight)


class CrossEntropyTrainer(GenericTrainer):

    def __init__(self, decoders: List,
                 decoder_weights: List[float] = None,
                 l1_weight: float = 0.0,
                 l2_weight: float = 0.0,
                 clip_norm: float = None,
                 optimizer=None,
                 var_scopes: List[str] = None,
                 var_collection: str = None,
                 name: str = None) -> None:
        if decoder_weights is None:
            decoder_weights = [1.0] * len(decoders)
        if len(decoder_weights) != len(decoders):
            raise ValueError(
                "decoder_weights must have one entry per decoder")
        objectives = [xent_objective(d, w)
                      for d, w in zip(decoders, decoder_weights)]
        super().__init__(
            objectives=objectives, l1_weight=l1_weight,
            l2_weight=l2_weight, clip_norm=clip_norm,
            optimizer=optimizer, var_scopes=var_scopes,
            var_collection=var_collection, name=name)
