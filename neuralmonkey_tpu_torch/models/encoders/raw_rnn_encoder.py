"""RNN over a series of raw float vectors (counterpart of
``neuralmonkey_tpu/models/encoders/raw_rnn_encoder.py``, reference
nm/encoders/raw_rnn_encoder.py): the speech features' encoder of the CTC
and audio-classifier paths. Series items are (T, D) float arrays. A GRU
runs the fused GRU scan (kernel K1), an LSTM the fused LSTM scan
(``ops/rnn.py``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ...model.part import Context, ModelPart, tensor
from ...model.stateful import TemporalStatefulWithOutput
from ...ops import nn
from ...ops.rnn import bidirectional_rnn, unidirectional_rnn
from .recurrent import _DIRECTIONS


class RawRNNEncoder(ModelPart, TemporalStatefulWithOutput):

    def __init__(self, name: str,
                 data_id: str,
                 input_size: int,
                 rnn_size: int,
                 rnn_cell: str = "GRU",
                 rnn_direction: str = "bidirectional",
                 max_input_len: int = None,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if rnn_direction not in _DIRECTIONS:
            raise ValueError(
                f"rnn_direction must be one of {_DIRECTIONS}")
        self.data_id = data_id
        self.input_size = input_size
        self.rnn_size = rnn_size
        self.rnn_direction = rnn_direction
        self.max_input_len = max_input_len
        self.dropout_keep_prob = dropout_keep_prob
        self._fw = nn.make_cell(rnn_cell, input_size, rnn_size)
        self._bw = None
        self._dim = rnn_size
        if rnn_direction == "bidirectional":
            self._bw = nn.make_cell(rnn_cell, input_size, rnn_size)
            self._dim = 2 * rnn_size

    @property
    def state_dim(self) -> int:
        return self._dim

    @property
    def output_dim(self) -> int:
        return self._dim

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        params = {"fw": self._fw.init(gen)}
        if self._bw is not None:
            params["bw"] = self._bw.init(gen)
        return params

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}
        items = [np.asarray(v, np.float32)
                 for v in dataset.get_series(self.data_id)]
        if self.max_input_len:
            items = [v[:self.max_input_len] for v in items]
        max_len = max(v.shape[0] for v in items)
        batch = np.zeros((len(items), max_len, self.input_size), np.float32)
        mask = np.zeros((len(items), max_len), np.float32)
        for i, v in enumerate(items):
            if v.shape[1] != self.input_size:
                raise ValueError(
                    f"Series '{self.data_id}' item {i} has feature dim "
                    f"{v.shape[1]}, expected {self.input_size}")
            batch[i, :v.shape[0]] = v
            mask[i, :v.shape[0]] = 1.0
        # the .seq/.seq_mask suffixes get their time axis padded to a
        # length bucket (utils/batching.py)
        return {f"{self.name}.seq": batch, f"{self.name}.seq_mask": mask}

    @tensor
    def temporal_mask(self, ctx: Context):
        return ctx.batch[f"{self.name}.seq_mask"]

    @tensor
    def _rnn(self, ctx: Context):
        params = ctx.get_params(self)
        inputs = ctx.dropout(self, ctx.batch[f"{self.name}.seq"],
                             self.dropout_keep_prob, "input_dropout")
        mask = self.temporal_mask(ctx)
        if self._bw is not None:
            return bidirectional_rnn(self._fw, params["fw"], self._bw,
                                     params["bw"], inputs, mask)
        return unidirectional_rnn(self._fw, params["fw"], inputs, mask,
                                  reverse=self.rnn_direction == "backward")

    @tensor
    def temporal_states(self, ctx: Context):
        return self._rnn(ctx)[0]

    @tensor
    def output(self, ctx: Context):
        return self._rnn(ctx)[1]
