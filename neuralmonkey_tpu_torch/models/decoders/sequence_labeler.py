"""Per-token sequence labeler (counterpart of
``neuralmonkey_tpu/models/decoders/sequence_labeler.py``, reference
nm/decoders/sequence_labeler.py): a projection over a TemporalStateful
encoder, one tag per input token."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ...model.part import Context, ModelPart, tensor
from ...model.stateful import TemporalStateful
from ...ops import nn
from ...vocabulary import Vocabulary


class SequenceLabeler(ModelPart):

    def __init__(self, name: str,
                 encoder: TemporalStateful,
                 vocabulary: Vocabulary,
                 data_id: str,
                 hidden_dim: int = None,
                 activation: Optional[Callable] = None,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        self.encoder = encoder
        self.vocabulary = vocabulary
        self.data_id = data_id
        self.hidden_dim = hidden_dim
        self.activation = activation
        self.dropout_keep_prob = dropout_keep_prob

    @property
    def labels_key(self) -> str:
        return f"{self.name}.labels"

    @property
    def mask_key(self) -> str:
        return f"{self.name}.labels_mask"

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        dim = self.encoder.state_dim
        if self.hidden_dim:
            return {"hidden": nn.linear_init(gen, dim, self.hidden_dim),
                    "logit": nn.linear_init(gen, self.hidden_dim,
                                            len(self.vocabulary))}
        return {"logit": nn.linear_init(gen, dim, len(self.vocabulary))}

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}
        ids, mask = self.vocabulary.sentences_to_tensor(
            dataset.get_series(self.data_id), train_mode=train)
        return {self.labels_key: ids, self.mask_key: mask}

    # ------------------------------------------------------------------ #
    @tensor
    def logits(self, ctx: Context):
        params = ctx.get_params(self)
        states = self.encoder.temporal_states(ctx)
        states = ctx.dropout(self, states, self.dropout_keep_prob,
                             "state_dropout")
        if self.hidden_dim:
            # ReLU by default, as the JAX package's jax.nn.relu
            activation = self.activation or torch.relu
            states = activation(nn.linear(params["hidden"], states))
        return nn.linear(params["logit"], states)

    @tensor
    def train_loss(self, ctx: Context):
        """Mean per-token cross-entropy over the labels' mask; the
        logits' bucket-padded time axis is cut to the labels'."""
        logits = self.logits(ctx)
        labels = ctx.batch[self.labels_key]
        mask = ctx.batch[self.mask_key]
        time = min(logits.shape[1], labels.shape[1])
        log_probs = torch.log_softmax(logits[:, :time], dim=-1)
        nll = -log_probs.gather(
            -1, labels[:, :time].long()[..., None])[..., 0]
        nll = nll * mask[:, :time]
        return nll.sum() / mask[:, :time].sum().clamp_min(1.0)

    def cost(self, ctx: Context):
        return self.train_loss(ctx)

    runtime_loss = train_loss

    @tensor
    def decoded(self, ctx: Context):
        return self.logits(ctx).argmax(dim=-1)

    @tensor
    def input_mask(self, ctx: Context):
        return self.encoder.temporal_mask(ctx)
