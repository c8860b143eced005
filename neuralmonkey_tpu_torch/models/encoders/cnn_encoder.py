"""From-scratch CNN image encoder (counterpart of
``neuralmonkey_tpu/models/encoders/cnn_encoder.py``, reference
nm/encoders/cnn_encoder.py).

A configurable convolution stack over raw NHWC images ->
SpatialStateful, with a pooled Stateful output. The layer spec follows
the reference, a list of tuples:

    ("C", kernel_size, stride, n_filters)   convolution + ReLU
    ("M", pool_size, stride)                max-pooling
    ("A", pool_size, stride)                average-pooling
    ("R",)                                  ReLU (explicit)

Convolutions pad as TF's ``"SAME"`` (the odd extra cell on the bottom
and right), pools take ``"VALID"`` windows. The kernels keep the JAX
package's ``(kh, kw, Cin, Cout)`` layout and are permuted at the call.

``CNNTemporalView`` adapts the spatial map to a TemporalStateful
(rows-major flattening) for attention from sequence decoders.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...model.part import Context, ModelPart, tensor
from ...model.stateful import SpatialStatefulWithOutput, TemporalStateful
from ...ops import nn, policy
from .sentence_cnn_encoder import same_padding


def conv2d_same(x: torch.Tensor, kernel: torch.Tensor,
                stride: int) -> torch.Tensor:
    """NHWC ``x`` * (kh, kw, Cin, Cout) ``kernel``, TF ``"SAME"``
    padding -> NHWC."""
    left, right = same_padding(x.shape[2], kernel.shape[1], stride)
    top, bottom = same_padding(x.shape[1], kernel.shape[0], stride)
    x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def pool2d_valid(x: torch.Tensor, kind: str, pool: int,
                 stride: int) -> torch.Tensor:
    """NHWC max- (``"M"``) or average- (``"A"``) pooling over
    ``"VALID"`` windows."""
    x = x.permute(0, 3, 1, 2)
    if kind == "M":
        y = F.max_pool2d(x, pool, stride)
    else:
        y = F.avg_pool2d(x, pool, stride)
    return y.permute(0, 2, 3, 1)


class CNNEncoder(ModelPart, SpatialStatefulWithOutput):

    def __init__(self, name: str,
                 data_id: str,
                 convolutions: List[Tuple],
                 image_height: int,
                 image_width: int,
                 pixel_dim: int = 3,
                 fully_connected: List[int] = None,
                 batch_normalize: bool = False,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        self.data_id = data_id
        self.convolutions = [tuple(c) for c in convolutions]
        self.image_height = image_height
        self.image_width = image_width
        self.pixel_dim = pixel_dim
        self.fully_connected = fully_connected
        self.batch_normalize = batch_normalize
        self.dropout_keep_prob = dropout_keep_prob

        # the shape through the stack
        h, w, c = image_height, image_width, pixel_dim
        for spec in self.convolutions:
            kind = spec[0]
            if kind == "C":
                _, _, stride, filters = spec
                h, w, c = -(-h // stride), -(-w // stride), filters
            elif kind in ("M", "A"):
                _, pool, stride = spec
                h = (h - pool) // stride + 1
                w = (w - pool) // stride + 1
            elif kind != "R":
                raise ValueError(f"Unknown CNN layer spec: {spec}")
        self._out_shape = (h, w, c)

    @property
    def state_dim(self) -> int:
        return self._out_shape[2]

    @property
    def output_dim(self) -> int:
        if self.fully_connected:
            return self.fully_connected[-1]
        return self._out_shape[2]

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        in_c = self.pixel_dim
        for i, spec in enumerate(self.convolutions):
            if spec[0] != "C":
                continue
            _, kernel, _, filters = spec
            params[f"conv_{i}"] = {
                "w": torch.randn(kernel, kernel, in_c, filters,
                                 generator=gen)
                * math.sqrt(2.0 / (kernel * kernel * in_c)),
                "b": torch.zeros(filters)}
            if self.batch_normalize:
                params[f"bn_{i}"] = {"scale": torch.ones(filters),
                                     "bias": torch.zeros(filters)}
            in_c = filters
        if self.fully_connected:
            layers = []
            dim = self._out_shape[2]
            for size in self.fully_connected:
                layers.append(nn.linear_init(gen, dim, size))
                dim = size
            params["fc"] = layers
        return params

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}
        images = np.stack(
            [np.asarray(im, np.float32)
             for im in dataset.get_series(self.data_id)])
        expected = (self.image_height, self.image_width, self.pixel_dim)
        if images.shape[1:] != expected:
            raise ValueError(
                f"Images have shape {images.shape[1:]}, expected "
                f"{expected}")
        return {f"{self.name}.images": images}

    # ------------------------------------------------------------------ #
    @staticmethod
    def _instance_norm(params, x: torch.Tensor) -> torch.Tensor:
        """Normalization over the spatial axes with the biased variance
        (the JAX package's stand-in for batch norm)."""
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = x.var(dim=(1, 2), keepdim=True, correction=0)
        return ((x - mean) * torch.rsqrt(var + 1e-5) * params["scale"]
                + params["bias"])

    @tensor
    def spatial_states(self, ctx: Context):
        if (policy.compute_dtype() == torch.bfloat16
                and any(spec[0] == "C" for spec in self.convolutions)):
            # the JAX package's convolution takes the float32 images beside
            # the bf16 kernels and raises a TypeError: refuse it by name
            raise ValueError(
                f"CNNEncoder '{self.name}' does not run under the bfloat16 "
                "compute policy (compute_dtype / NM_COMPUTE_DTYPE): its "
                "convolutions would take float32 images beside bf16 "
                "kernels, which the reference refuses")
        params = ctx.get_params(self)
        x = ctx.batch[f"{self.name}.images"]
        for i, spec in enumerate(self.convolutions):
            kind = spec[0]
            if kind == "C":
                x = conv2d_same(x, params[f"conv_{i}"]["w"], spec[2]) \
                    + params[f"conv_{i}"]["b"]
                if self.batch_normalize:
                    x = self._instance_norm(params[f"bn_{i}"], x)
                x = torch.relu(x)
            elif kind in ("M", "A"):
                x = pool2d_valid(x, kind, spec[1], spec[2])
            else:
                x = torch.relu(x)
        return ctx.dropout(self, x, self.dropout_keep_prob,
                           "spatial_dropout")

    @tensor
    def spatial_mask(self, ctx: Context):
        states = self.spatial_states(ctx)
        return states.new_ones(states.shape[:3])

    @tensor
    def output(self, ctx: Context):
        pooled = self.spatial_states(ctx).mean(dim=(1, 2))
        params = ctx.get_params(self)
        for j, layer in enumerate(params.get("fc", [])):
            pooled = torch.tanh(nn.linear(layer, pooled))
            pooled = ctx.dropout(self, pooled, self.dropout_keep_prob,
                                 f"fc_{j}")
        return pooled


class CNNTemporalView(ModelPart, TemporalStateful):
    """Spatial -> temporal adapter: (B, H, W, C) -> (B, H·W, C)."""

    def __init__(self, name: str,
                 cnn: CNNEncoder,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        self.cnn = cnn

    @property
    def state_dim(self) -> int:
        return self.cnn.state_dim

    @tensor
    def temporal_states(self, ctx: Context):
        spatial = self.cnn.spatial_states(ctx)
        return spatial.reshape(spatial.shape[0], -1, spatial.shape[3])

    @tensor
    def temporal_mask(self, ctx: Context):
        mask = self.cnn.spatial_mask(ctx)
        return mask.reshape(mask.shape[0], -1)
