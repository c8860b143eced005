"""Scaled dot-product attention in the RNN decoder's interface
(counterpart of ``neuralmonkey_tpu/models/attention/scaled_dot_product.py``,
reference nm/attention/scaled_dot_product.py): ``ScaledDotProdAttention``
(Luong-style) and ``MultiHeadAttention``. The Transformer's attention
lives in ``ops/attention.py``. Both steps are plain PyTorch, as the JAX
package computes them outside any Pallas kernel.

In training, the softmax weights are dropped (inverted dropout, no
renormalization) before the values are summed, with a generator of the
step's own seed that the decoder's teacher-forced pass gives; the
returned weights stay undropped.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ...model.part import Context, ModelPart, tensor
from ...ops import nn
from .base_attention import (AttentionConstants, BaseAttention,
                             get_attention_mask, get_attention_states,
                             masked_softmax)


class ScaledDotProdAttention(BaseAttention):

    def __init__(self, name: str,
                 keys_encoder,
                 values_encoder=None,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        super().__init__(name, reuse, save_checkpoint, load_checkpoint)
        self.keys_encoder = keys_encoder
        self.values_encoder = (values_encoder if values_encoder is not None
                               else keys_encoder)
        self.dropout_keep_prob = dropout_keep_prob

    weights_dropout = True

    @property
    def encoder(self):
        return self.keys_encoder

    @property
    def context_dim(self) -> int:
        return self.values_encoder.state_dim

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        if self.query_dim is None:
            raise ValueError(
                f"Attention '{self.name}' has no registered query dim")
        key_dim = self.keys_encoder.state_dim
        if self.query_dim == key_dim:
            return {}
        return {"query_proj": nn.linear_init(gen, self.query_dim, key_dim,
                                             use_bias=False)}

    @tensor
    def precompute(self, ctx: Context) -> AttentionConstants:
        return AttentionConstants(
            states=get_attention_states(ctx, self.values_encoder),
            keys=get_attention_states(ctx, self.keys_encoder),
            mask=get_attention_mask(ctx, self.keys_encoder))

    def _project(self, params, query):
        if "query_proj" in params:
            query = nn.linear(params["query_proj"], query)
        return query

    def _drop_weights(self, weights: torch.Tensor,
                      dropout_gen: Optional[torch.Generator]
                      ) -> torch.Tensor:
        """The reference's ``dropout_callback``: in training the softmax
        weights are dropped before the values are summed."""
        if dropout_gen is None or self.dropout_keep_prob >= 1.0:
            return weights
        return nn.dropout(weights, self.dropout_keep_prob, dropout_gen, True)

    def step(self, params, constants: AttentionConstants, query,
             dropout_gen: Optional[torch.Generator] = None):
        query = self._project(params, query)
        energies = torch.einsum("bk,btk->bt", query, constants.keys
                                ) / math.sqrt(query.shape[-1])
        weights = masked_softmax(energies, constants.mask)
        context = torch.einsum("bt,btd->bd",
                               self._drop_weights(weights, dropout_gen),
                               constants.states)
        return context, weights

    beam_shared_constants = True

    def step_beamed(self, params, constants: AttentionConstants,
                    query, beam: int):
        """Beam step over one shared copy of keys and values."""
        rows = query.shape[0]
        q = self._project(params, query).reshape(rows // beam, beam, -1)
        energies = torch.einsum("bkd,btd->bkt", q, constants.keys
                                ) / math.sqrt(q.shape[-1])
        weights = masked_softmax(energies, constants.mask[:, None, :])
        context = torch.einsum("bkt,btd->bkd", weights, constants.states)
        return (context.reshape(rows, context.shape[-1]),
                weights.reshape(rows, weights.shape[-1]))

    def attend_sequence(self, params, constants: AttentionConstants,
                        queries):
        queries = self._project(params, queries)
        energies = torch.einsum("bqk,btk->bqt", queries, constants.keys
                                ) / math.sqrt(queries.shape[-1])
        weights = masked_softmax(energies, constants.mask[:, None, :])
        return torch.einsum("bqt,btd->bqd", weights,
                            constants.states), weights


class MultiHeadAttention(ScaledDotProdAttention):
    """Multi-head decoder attention: query, keys and values projected
    into ``n_heads`` subspaces, attended independently, concatenated and
    projected out. Keys and values are projected once per sentence
    (``precompute``); the returned weights are the heads' mean."""

    def __init__(self, name: str,
                 n_heads: int,
                 keys_encoder,
                 values_encoder=None,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        super().__init__(name, keys_encoder, values_encoder,
                         dropout_keep_prob, reuse, save_checkpoint,
                         load_checkpoint)
        if n_heads < 1:
            raise ValueError("n_heads must be >= 1")
        self.n_heads = n_heads

    @property
    def _model_dim(self) -> int:
        dim = self.keys_encoder.state_dim
        if dim % self.n_heads != 0:
            raise ValueError(
                f"Attention '{self.name}': key dim {dim} not divisible "
                f"by n_heads={self.n_heads}")
        return dim

    @property
    def context_dim(self) -> int:
        return self._model_dim

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        if self.query_dim is None:
            raise ValueError(
                f"Attention '{self.name}' has no registered query dim")
        dim = self._model_dim
        return {
            "query_proj": nn.linear_init(gen, self.query_dim, dim,
                                         use_bias=False),
            "keys_proj": nn.linear_init(gen, self.keys_encoder.state_dim,
                                        dim, use_bias=False),
            "values_proj": nn.linear_init(
                gen, self.values_encoder.state_dim, dim, use_bias=False),
            "out_proj": nn.linear_init(gen, dim, dim),
        }

    @tensor
    def precompute(self, ctx: Context) -> AttentionConstants:
        params = ctx.get_params(self)
        return AttentionConstants(
            states=nn.linear(params["values_proj"], get_attention_states(
                ctx, self.values_encoder)),
            keys=nn.linear(params["keys_proj"], get_attention_states(
                ctx, self.keys_encoder)),
            mask=get_attention_mask(ctx, self.keys_encoder))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(..., T, d) -> (..., h, T, d/h)."""
        split = x.reshape(*x.shape[:-1], self.n_heads,
                          x.shape[-1] // self.n_heads)
        return split.movedim(-2, -3)

    def _mh_attend(self, params, constants: AttentionConstants,
                   queries: torch.Tensor,
                   dropout_gen: Optional[torch.Generator] = None):
        """queries (B, Q, query_dim) -> contexts (B, Q, d) and the
        heads' mean weights (B, Q, T)."""
        q = self._heads(nn.linear(params["query_proj"], queries))
        k = self._heads(constants.keys)
        v = self._heads(constants.states)
        energies = torch.einsum("bhqd,bhtd->bhqt", q, k
                                ) / math.sqrt(q.shape[-1])
        weights = masked_softmax(energies, constants.mask[:, None, None, :])
        ctxs = torch.einsum("bhqt,bhtd->bhqd",
                            self._drop_weights(weights, dropout_gen), v)
        merged = ctxs.movedim(-3, -2).reshape(*queries.shape[:-1], -1)
        return nn.linear(params["out_proj"], merged), weights.mean(dim=1)

    def step(self, params, constants: AttentionConstants, query,
             dropout_gen: Optional[torch.Generator] = None):
        context, weights = self._mh_attend(params, constants, query[:, None],
                                           dropout_gen)
        return context[:, 0], weights[:, 0]

    def step_beamed(self, params, constants: AttentionConstants,
                    query, beam: int):
        rows = query.shape[0]
        context, weights = self._mh_attend(
            params, constants, query.reshape(rows // beam, beam, -1))
        return (context.reshape(rows, context.shape[-1]),
                weights.reshape(rows, weights.shape[-1]))

    def attend_sequence(self, params, constants: AttentionConstants,
                        queries):
        return self._mh_attend(params, constants, queries)
