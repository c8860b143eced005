"""Scalar regressor (counterpart of
``neuralmonkey_tpu/models/decoders/sequence_regressor.py``, reference
nm/decoders/sequence_regressor.py): predicts floats per example from
encoder outputs."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ...model.part import Context, ModelPart, tensor
from ...model.stateful import Stateful
from ...ops import nn
from ...parallel.distributed import global_sum


class SequenceRegressor(ModelPart):

    def __init__(self, name: str,
                 encoders: List[Stateful],
                 data_id: str,
                 layers: List[int] = None,
                 activation_fn: Optional[Callable] = None,
                 dropout_keep_prob: float = 1.0,
                 dimension: int = 1,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if not encoders:
            raise ValueError("SequenceRegressor needs encoders")
        self.encoders = encoders
        self.data_id = data_id
        self.layers = layers or []
        self.activation_fn = activation_fn
        self.dropout_keep_prob = dropout_keep_prob
        self.dimension = dimension
        self.input_dim = sum(e.output_dim for e in encoders)

    @property
    def target_key(self) -> str:
        return f"{self.name}.targets"

    @property
    def weight_key(self) -> str:
        return f"{self.name}.target_mask"

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        params: Dict[str, Any] = {"mlp": []}
        dim = self.input_dim
        for size in self.layers:
            params["mlp"].append(nn.linear_init(gen, dim, size))
            dim = size
        params["out"] = nn.linear_init(gen, dim, self.dimension)
        return params

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}
        values = dataset.get_series(self.data_id)
        targets = np.array([np.asarray(v, np.float32).reshape(-1)
                            for v in values], np.float32)
        return {self.target_key: targets,
                self.weight_key: np.ones(len(values), np.float32)}

    @tensor
    def predictions(self, ctx: Context):
        params = ctx.get_params(self)
        x = torch.cat([e.output(ctx) for e in self.encoders], dim=-1)
        # ReLU by default, as the JAX package's jax.nn.relu
        activation = self.activation_fn or torch.relu
        for i, layer in enumerate(params["mlp"]):
            x = activation(nn.linear(layer, x))
            x = ctx.dropout(self, x, self.dropout_keep_prob, f"mlp_{i}")
        return nn.linear(params["out"], x)

    @tensor
    def train_loss(self, ctx: Context):
        """Mean squared error over the real rows (the padding rows of a
        batch weigh 0)."""
        predictions = self.predictions(ctx)
        targets = ctx.batch[self.target_key]
        weights = ctx.batch[self.weight_key]
        per_example = ((predictions - targets) ** 2).mean(dim=-1)
        return (global_sum((per_example * weights).sum())
                / global_sum(weights.sum()).clamp_min(1.0))

    def cost(self, ctx: Context):
        return self.train_loss(ctx)

    runtime_loss = train_loss

    @tensor
    def decoded(self, ctx: Context):
        return self.predictions(ctx)
