"""Recurrent sentence encoders (counterpart of
``neuralmonkey_tpu/models/encoders/recurrent.py``).

``RecurrentEncoder`` runs a (stacked, optionally bidirectional) RNN over
any TemporalStateful input; ``SentenceEncoder`` owns its own
``EmbeddedSequence``, ``FactoredEncoder`` an ``EmbeddedFactorSequence``,
and ``DeepSentenceEncoder`` stacks layers of equal size. GRU layers run
the fused GRU scan (kernel K1) on the GPU, LSTM layers the fused LSTM
scan, both directions of a layer in one launch; the layer-normalized and
noisy-activation GRUs run the step scan (``ops/rnn.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ...model.part import Context, ModelPart, tensor
from ...model.sequence import EmbeddedFactorSequence, EmbeddedSequence
from ...model.stateful import TemporalStatefulWithOutput
from ...ops import nn
from ...ops.rnn import bidirectional_rnn, unidirectional_rnn
from ...vocabulary import Vocabulary

_DIRECTIONS = ("bidirectional", "forward", "backward")


class RecurrentEncoder(ModelPart, TemporalStatefulWithOutput):

    def __init__(self, name: str,
                 input_sequence,
                 rnn_size: int,
                 rnn_cell: str = "GRU",
                 rnn_direction: str = "bidirectional",
                 num_layers: int = 1,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if rnn_direction not in _DIRECTIONS:
            raise ValueError(
                f"rnn_direction must be one of {_DIRECTIONS}")
        if rnn_size <= 0:
            raise ValueError("RNN size must be positive")
        self.input_sequence = input_sequence
        self.rnn_size = rnn_size
        self.rnn_cell_type = rnn_cell
        self.rnn_direction = rnn_direction
        self.num_layers = num_layers
        self.dropout_keep_prob = dropout_keep_prob

        self._layer_dims: List[int] = []
        in_dim = input_sequence.state_dim
        self._cells = []
        for _ in range(num_layers):
            if rnn_direction == "bidirectional":
                self._cells.append((nn.make_cell(rnn_cell, in_dim, rnn_size),
                                    nn.make_cell(rnn_cell, in_dim, rnn_size)))
                in_dim = 2 * rnn_size
            else:
                self._cells.append(
                    (nn.make_cell(rnn_cell, in_dim, rnn_size), None))
                in_dim = rnn_size
            self._layer_dims.append(in_dim)

    @property
    def state_dim(self) -> int:
        return self._layer_dims[-1]

    @property
    def output_dim(self) -> int:
        return self._layer_dims[-1]

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        params = {}
        for i, (fw, bw) in enumerate(self._cells):
            params[f"layer_{i}_fw"] = fw.init(gen)
            if bw is not None:
                params[f"layer_{i}_bw"] = bw.init(gen)
        return params

    @tensor
    def temporal_mask(self, ctx: Context):
        return self.input_sequence.temporal_mask(ctx)

    @tensor
    def _rnn_outputs(self, ctx: Context):
        params = ctx.get_params(self)
        states = self.input_sequence.temporal_states(ctx)
        mask = self.input_sequence.temporal_mask(ctx)
        states = ctx.dropout(self, states, self.dropout_keep_prob,
                             "input_dropout")
        final = None
        for i, (fw, bw) in enumerate(self._cells):
            # noisy-activation cells draw their noise in training only
            noise = (ctx.make_rng(self, f"cell_noise_{i}", states.device)
                     if ctx.train and isinstance(fw, nn.NoisyGRUCell)
                     else None)
            if bw is not None:
                states, final = bidirectional_rnn(
                    fw, params[f"layer_{i}_fw"],
                    bw, params[f"layer_{i}_bw"], states, mask,
                    noise=noise)
            else:
                states, final = unidirectional_rnn(
                    fw, params[f"layer_{i}_fw"], states, mask,
                    reverse=self.rnn_direction == "backward", noise=noise)
            if i < len(self._cells) - 1:
                states = ctx.dropout(self, states, self.dropout_keep_prob,
                                     f"layer_{i}_dropout")
        return states, final

    @tensor
    def temporal_states(self, ctx: Context):
        states, _ = self._rnn_outputs(ctx)
        return ctx.dropout(self, states, self.dropout_keep_prob,
                           "output_dropout")

    @tensor
    def output(self, ctx: Context):
        _, final = self._rnn_outputs(ctx)
        return ctx.dropout(self, final, self.dropout_keep_prob,
                           "final_dropout")


class SentenceEncoder(RecurrentEncoder):
    """Embedding + recurrent encoder in one part (owns its
    EmbeddedSequence, named ``<name>_input``)."""

    def __init__(self, name: str,
                 vocabulary: Vocabulary,
                 data_id: str,
                 embedding_size: int,
                 rnn_size: int,
                 rnn_cell: str = "GRU",
                 rnn_direction: str = "bidirectional",
                 num_layers: int = 1,
                 max_input_len: int = None,
                 dropout_keep_prob: float = 1.0,
                 embedding_initializer=None,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        input_sequence = EmbeddedSequence(
            name=f"{name}_input",
            vocabulary=vocabulary,
            data_id=data_id,
            embedding_size=embedding_size,
            max_length=max_input_len,
            embeddings_init=embedding_initializer)
        super().__init__(
            name=name, input_sequence=input_sequence, rnn_size=rnn_size,
            rnn_cell=rnn_cell, rnn_direction=rnn_direction,
            num_layers=num_layers, dropout_keep_prob=dropout_keep_prob,
            reuse=reuse, save_checkpoint=save_checkpoint,
            load_checkpoint=load_checkpoint)
        self.vocabulary = vocabulary
        self.data_id = data_id
        self.embedding_size = embedding_size
        self.max_input_len = max_input_len


class FactoredEncoder(RecurrentEncoder):
    """Recurrent encoder over concatenated factor embeddings."""

    def __init__(self, name: str,
                 vocabularies: List[Vocabulary],
                 data_ids: List[str],
                 embedding_sizes: List[int],
                 rnn_size: int,
                 rnn_cell: str = "GRU",
                 rnn_direction: str = "bidirectional",
                 max_input_len: int = None,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        input_sequence = EmbeddedFactorSequence(
            name=f"{name}_input",
            vocabularies=vocabularies,
            data_ids=data_ids,
            embedding_sizes=embedding_sizes,
            max_length=max_input_len)
        super().__init__(
            name=name, input_sequence=input_sequence, rnn_size=rnn_size,
            rnn_cell=rnn_cell, rnn_direction=rnn_direction,
            dropout_keep_prob=dropout_keep_prob,
            reuse=reuse, save_checkpoint=save_checkpoint,
            load_checkpoint=load_checkpoint)
        self.vocabularies = vocabularies
        self.data_ids = data_ids


class DeepSentenceEncoder(SentenceEncoder):
    """Multi-layer sentence encoder (depth from per-layer sizes, which
    must be equal)."""

    def __init__(self, name: str,
                 vocabulary: Vocabulary,
                 data_id: str,
                 embedding_size: int,
                 rnn_sizes: List[int],
                 rnn_cell: str = "GRU",
                 rnn_direction: str = "bidirectional",
                 max_input_len: int = None,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        if len(set(rnn_sizes)) != 1:
            raise ValueError(
                "DeepSentenceEncoder requires equal per-layer sizes")
        super().__init__(
            name=name, vocabulary=vocabulary, data_id=data_id,
            embedding_size=embedding_size, rnn_size=rnn_sizes[0],
            rnn_cell=rnn_cell, rnn_direction=rnn_direction,
            num_layers=len(rnn_sizes), max_input_len=max_input_len,
            dropout_keep_prob=dropout_keep_prob, reuse=reuse,
            save_checkpoint=save_checkpoint,
            load_checkpoint=load_checkpoint)
