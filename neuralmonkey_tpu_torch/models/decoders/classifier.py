"""Sequence classifier (counterpart of
``neuralmonkey_tpu/models/decoders/classifier.py``, reference
nm/decoders/classifier.py): an MLP over the concatenated encoder
outputs -> one label per example."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ...model.part import Context, ModelPart, tensor
from ...model.stateful import Stateful
from ...ops import nn
from ...parallel.distributed import global_sum
from ...vocabulary import Vocabulary


class Classifier(ModelPart):

    def __init__(self, name: str,
                 encoders: List[Stateful],
                 vocabulary: Vocabulary,
                 data_id: str,
                 layers: List[int] = None,
                 activation_fn: Callable = torch.relu,
                 dropout_keep_prob: float = 0.5,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if not encoders:
            raise ValueError("Classifier needs at least one encoder")
        self.encoders = encoders
        self.vocabulary = vocabulary
        self.data_id = data_id
        self.layers = layers or []
        self.activation_fn = activation_fn
        self.dropout_keep_prob = dropout_keep_prob
        self.input_dim = sum(e.output_dim for e in encoders)

    @property
    def label_key(self) -> str:
        return f"{self.name}.labels"

    @property
    def label_mask_key(self) -> str:
        return f"{self.name}.label_mask"

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        mlp = []
        dim = self.input_dim
        for size in self.layers:
            mlp.append(nn.linear_init(gen, dim, size))
            dim = size
        return {"mlp": mlp,
                "logit": nn.linear_init(gen, dim, len(self.vocabulary))}

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}
        labels = dataset.get_series(self.data_id)
        ids = np.array(
            [self.vocabulary.get_word_index(
                label[0] if isinstance(label, (list, tuple)) else label)
             for label in labels], np.int32)
        # the rows a padded batch adds get a zero mask: out of the loss
        return {self.label_key: ids,
                self.label_mask_key: np.ones(len(labels), np.float32)}

    # ------------------------------------------------------------------ #
    @tensor
    def logits(self, ctx: Context):
        params = ctx.get_params(self)
        x = torch.cat([e.output(ctx) for e in self.encoders], dim=-1)
        for i, layer in enumerate(params["mlp"]):
            x = self.activation_fn(nn.linear(layer, x))
            x = ctx.dropout(self, x, self.dropout_keep_prob, f"mlp_{i}")
        return nn.linear(params["logit"], x)

    @tensor
    def train_loss(self, ctx: Context):
        logits = self.logits(ctx)
        labels = ctx.batch[self.label_key].long()
        weights = ctx.batch.get(self.label_mask_key)
        if weights is None:
            weights = logits.new_ones(labels.shape)
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, labels[:, None])[:, 0]
        return (global_sum((nll * weights).sum())
                / global_sum(weights.sum()).clamp_min(1.0))

    def cost(self, ctx: Context):
        return self.train_loss(ctx)

    runtime_loss = train_loss

    @tensor
    def decoded(self, ctx: Context):
        return self.logits(ctx).argmax(dim=-1)


# reference import-path compatibility
SequenceClassifier = Classifier
