"""Numpy feature fillers (counterpart of
``neuralmonkey_tpu/models/encoders/numpy_stateful_filler.py``, reference
nm/encoders/numpy_stateful_filler.py).

:class:`StatefulFiller` injects a dataset series of precomputed vectors
into the model as a Stateful part. ``SpatialFiller`` (feature maps as a
SpatialStateful part) comes with the multimodal inputs.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...model.part import Context, ModelPart, tensor
from ...model.stateful import Stateful
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


class SpatialFiller(ModelPart):
    """A dataset series of (H, W, C) feature maps as a SpatialStateful
    part: not ported yet (it comes with the multimodal inputs and the
    spatial attention)."""

    def __init__(self, name: str, *args, **kwargs) -> None:
        del args, kwargs
        raise NotImplementedError(
            f"SpatialFiller ({name}) is not ported to neuralmonkey_tpu_torch "
            "yet (ROADMAP queue A10, multimodal inputs)")
