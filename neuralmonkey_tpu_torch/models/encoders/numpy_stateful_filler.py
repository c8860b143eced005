"""Numpy feature fillers (counterpart of
``neuralmonkey_tpu/models/encoders/numpy_stateful_filler.py``, reference
nm/encoders/numpy_stateful_filler.py).

:class:`StatefulFiller` injects a dataset series of precomputed vectors
into the model as a Stateful part, :class:`SpatialFiller` a series of
feature maps as a SpatialStateful part.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ...model.part import Context, ModelPart, tensor
from ...model.stateful import SpatialStatefulWithOutput, Stateful
from ...ops import nn


class StatefulFiller(ModelPart, Stateful):
    """A dataset series of fixed-size vectors as a Stateful part."""

    def __init__(self, name: str,
                 dimension: int,
                 data_id: str,
                 output_shape: int = None,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if dimension <= 0:
            raise ValueError("Input vector dimension must be positive")
        self.data_id = data_id
        self.dimension = dimension
        self.output_shape = output_shape

    @property
    def output_dim(self) -> int:
        return self.output_shape or self.dimension

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        if self.output_shape and self.output_shape != self.dimension:
            return {"project": nn.linear_init(gen, self.dimension,
                                              self.output_shape)}
        return {}

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}
        vectors = np.stack(
            [np.asarray(v, np.float32)
             for v in dataset.get_series(self.data_id)])
        if vectors.shape[-1] != self.dimension:
            raise ValueError(
                f"Series '{self.data_id}' vectors have dim "
                f"{vectors.shape[-1]}, expected {self.dimension}")
        return {f"{self.name}.vector": vectors}

    @tensor
    def output(self, ctx: Context):
        vec = ctx.batch[f"{self.name}.vector"]
        params = ctx.get_params(self)
        if "project" in params:
            vec = nn.linear(params["project"], vec)
        return vec


class SpatialFiller(ModelPart, SpatialStatefulWithOutput):
    """A dataset series of (H, W, C) feature maps (conv maps from an
    offline CNN) as a SpatialStateful part: optionally through a tanh
    feed-forward layer (``ff_hidden_dim``) and a linear projection
    (``projection_dim``); every grid position is valid, and the output
    is the mean over the grid."""

    def __init__(self, name: str,
                 input_shape: List[int],
                 data_id: str,
                 projection_dim: int = None,
                 ff_hidden_dim: int = None,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if len(input_shape) != 3:
            raise ValueError("input_shape must be (height, width, depth)")
        self.data_id = data_id
        self.input_shape = tuple(input_shape)
        self.projection_dim = projection_dim
        self.ff_hidden_dim = ff_hidden_dim

    @property
    def state_dim(self) -> int:
        return self.projection_dim or self.input_shape[2]

    @property
    def output_dim(self) -> int:
        return self.state_dim

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        params = {}
        if self.projection_dim:
            depth = self.input_shape[2]
            if self.ff_hidden_dim:
                params["ff"] = nn.linear_init(gen, depth, self.ff_hidden_dim)
                depth = self.ff_hidden_dim
            params["project"] = nn.linear_init(gen, depth,
                                               self.projection_dim)
        return params

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}
        maps = np.stack([np.asarray(m, np.float32)
                         for m in dataset.get_series(self.data_id)])
        if maps.shape[1:] != self.input_shape:
            raise ValueError(
                f"Series '{self.data_id}' maps have shape "
                f"{maps.shape[1:]}, expected {self.input_shape}")
        return {f"{self.name}.spatial": maps}

    @tensor
    def spatial_states(self, ctx: Context):
        states = ctx.batch[f"{self.name}.spatial"]
        params = ctx.get_params(self)
        if "ff" in params:
            states = torch.tanh(nn.linear(params["ff"], states))
        if "project" in params:
            states = nn.linear(params["project"], states)
        return states

    @tensor
    def spatial_mask(self, ctx: Context):
        states = ctx.batch[f"{self.name}.spatial"]
        return states.new_ones(states.shape[:3])

    @tensor
    def output(self, ctx: Context):
        """The mean over the spatial grid."""
        return self.spatial_states(ctx).mean(dim=(1, 2))
