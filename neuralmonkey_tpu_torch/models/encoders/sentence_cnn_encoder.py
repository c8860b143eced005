"""Convolution-over-time sentence encoders (counterpart of
``neuralmonkey_tpu/models/encoders/sentence_cnn_encoder.py``).

- :class:`SentenceCNNEncoder` (reference
  nm/encoders/sentence_cnn_encoder.py): multi-width 1-D convolutions,
  highway layers and an optional BiGRU on top -> TemporalStateful. The
  BiGRU runs the fused GRU scan (kernel K1, ``ops/rnn.py``) once a
  pass: its outputs and final states come from one memoized call.
- :class:`SequenceCNNEncoder` (reference
  nm/encoders/sequence_cnn_encoder.py): multi-width convolutions with a
  masked max-pool over time -> a single Stateful vector (Kim 2014).

The kernels keep the JAX package's ``(W, Cin, Cout)`` layout, so a JAX
checkpoint loads as it is; ``conv1d_same`` permutes them at the call.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ...model.part import Context, ModelPart, tensor
from ...model.sequence import EmbeddedSequence
from ...model.stateful import Stateful, TemporalStatefulWithOutput
from ...ops import nn
from ...ops.rnn import bidirectional_rnn
from ...vocabulary import Vocabulary


def same_padding(length: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/XLA ``"SAME"`` padding of one axis: (left, right), the odd
    extra cell on the right."""
    total = max((-(-length // stride) - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def conv1d_same(x: torch.Tensor, kernel: torch.Tensor,
                stride: int = 1) -> torch.Tensor:
    """(B, T, Cin) * (W, Cin, Cout) -> (B, ceil(T / stride), Cout), with
    TF ``"SAME"`` padding."""
    x = F.pad(x.transpose(1, 2),
              same_padding(x.shape[1], kernel.shape[0], stride))
    return F.conv1d(x, kernel.permute(2, 1, 0), stride=stride).transpose(1, 2)


def conv_init(gen: torch.Generator, width: int, in_dim: int,
              channels: int) -> Dict[str, torch.Tensor]:
    """He-normal ``(W, Cin, Cout)`` kernel and a zero bias."""
    return {"w": torch.randn(width, in_dim, channels, generator=gen)
            * math.sqrt(2.0 / (width * in_dim)),
            "b": torch.zeros(channels)}


def relu_convolutions(params, x: torch.Tensor,
                      n_filters: int) -> List[torch.Tensor]:
    """ReLU of each ``conv_i`` over ``x``: (B, T, Cout_i) each."""
    return [torch.relu(conv1d_same(x, params[f"conv_{i}"]["w"])
                       + params[f"conv_{i}"]["b"])
            for i in range(n_filters)]


class SentenceCNNEncoder(ModelPart, TemporalStatefulWithOutput):

    def __init__(self, name: str,
                 input_sequence=None,
                 filters: List[Tuple[int, int]] = None,
                 highway_depth: int = 2,
                 rnn_size: int = None,
                 dropout_keep_prob: float = 1.0,
                 vocabulary: Vocabulary = None,
                 data_id: str = None,
                 embedding_size: int = None,
                 max_input_len: int = None,
                 segment_size: int = None,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        del segment_size
        if input_sequence is None:
            input_sequence = EmbeddedSequence(
                name=f"{name}_input", vocabulary=vocabulary,
                data_id=data_id, embedding_size=embedding_size,
                max_length=max_input_len)
        self.input_sequence = input_sequence
        self.filters = [tuple(f) for f in filters or [(3, 64), (5, 64)]]
        self.highway_depth = highway_depth
        self.rnn_size = rnn_size
        self.dropout_keep_prob = dropout_keep_prob
        self._conv_dim = sum(f for _, f in self.filters)
        self._dim = 2 * rnn_size if rnn_size else self._conv_dim
        if rnn_size:
            self._fw = nn.make_cell("GRU", self._conv_dim, rnn_size)
            self._bw = nn.make_cell("GRU", self._conv_dim, rnn_size)

    @property
    def state_dim(self) -> int:
        return self._dim

    @property
    def output_dim(self) -> int:
        return self._dim

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        in_dim = self.input_sequence.state_dim
        params: Dict[str, Any] = {
            f"conv_{i}": conv_init(gen, width, in_dim, channels)
            for i, (width, channels) in enumerate(self.filters)}
        for d in range(self.highway_depth):
            params[f"highway_{d}"] = nn.highway_init(gen, self._conv_dim)
        if self.rnn_size:
            params["rnn_fw"] = self._fw.init(gen)
            params["rnn_bw"] = self._bw.init(gen)
        return params

    @tensor
    def temporal_mask(self, ctx: Context):
        return self.input_sequence.temporal_mask(ctx)

    @tensor
    def _cnn_states(self, ctx: Context):
        params = ctx.get_params(self)
        x = self.input_sequence.temporal_states(ctx)
        x = ctx.dropout(self, x, self.dropout_keep_prob, "input")
        states = torch.cat(relu_convolutions(params, x, len(self.filters)),
                           dim=-1)
        for d in range(self.highway_depth):
            states = nn.highway(params[f"highway_{d}"], states)
        return states * self.temporal_mask(ctx)[..., None]

    @tensor
    def _rnn(self, ctx: Context):
        """(outputs, final states) of the BiGRU over the CNN states."""
        params = ctx.get_params(self)
        return bidirectional_rnn(self._fw, params["rnn_fw"],
                                 self._bw, params["rnn_bw"],
                                 self._cnn_states(ctx),
                                 self.temporal_mask(ctx))

    @tensor
    def temporal_states(self, ctx: Context):
        if not self.rnn_size:
            return self._cnn_states(ctx)
        return self._rnn(ctx)[0]

    @tensor
    def output(self, ctx: Context):
        if self.rnn_size:
            return self._rnn(ctx)[1]
        return self.temporal_states(ctx).amax(dim=1)


class SequenceCNNEncoder(ModelPart, Stateful):
    """Multi-width convolutions and a max-pool over time -> a Stateful
    vector."""

    def __init__(self, name: str,
                 vocabulary: Vocabulary,
                 data_id: str,
                 embedding_size: int,
                 filters: List[Tuple[int, int]] = None,
                 max_input_len: int = None,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        self.input_sequence = EmbeddedSequence(
            name=f"{name}_input", vocabulary=vocabulary,
            data_id=data_id, embedding_size=embedding_size,
            max_length=max_input_len)
        self.filters = [tuple(f) for f in filters or [(2, 32), (3, 32),
                                                      (4, 32)]]
        self.dropout_keep_prob = dropout_keep_prob
        self._dim = sum(f for _, f in self.filters)

    @property
    def output_dim(self) -> int:
        return self._dim

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        in_dim = self.input_sequence.state_dim
        return {f"conv_{i}": conv_init(gen, width, in_dim, channels)
                for i, (width, channels) in enumerate(self.filters)}

    @tensor
    def output(self, ctx: Context):
        params = ctx.get_params(self)
        x = self.input_sequence.temporal_states(ctx)
        valid = (self.input_sequence.temporal_mask(ctx) > 0)[..., None]
        x = ctx.dropout(self, x, self.dropout_keep_prob, "input")
        # ReLU outputs are >= 0, so 0 is the max-pool's identity, also
        # for the all-padding rows of a padded batch
        return torch.cat([(conv * valid).amax(dim=1) for conv in
                          relu_convolutions(params, x, len(self.filters))],
                         dim=-1)
