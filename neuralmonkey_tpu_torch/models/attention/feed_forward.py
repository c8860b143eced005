"""Bahdanau (MLP-energy) attention (counterpart of
``neuralmonkey_tpu/models/attention/feed_forward.py``: ``Attention`` and
``CoverageAttention``).

Energies ``e_i = v . tanh(W_q s + W_k h_i + b)``; masked softmax;
context = sum_i a_i h_i. The key projection ``W_k h_i`` is computed once
per sentence in ``precompute``. ``step`` (greedy decoding, and beam
search's physical reorder over constants tiled to B·K rows) runs the
fused step, kernel K2; ``step_beamed`` (lineage beam search) folds the
beam axis into one shared copy of keys and states. The coverage step
stays plain PyTorch, as the JAX package computes it outside any Pallas
kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ...model.part import Context, ModelPart, tensor
from ...ops import nn
from ...ops.cuda_attention import fused_bahdanau_step
from .base_attention import (AttentionConstants, BaseAttention,
                             get_attention_mask, get_attention_states,
                             masked_softmax)


class Attention(BaseAttention):

    def __init__(self, name: str,
                 encoder,
                 dropout_keep_prob: float = 1.0,
                 state_size: int = None,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        super().__init__(name, reuse, save_checkpoint, load_checkpoint)
        self.encoder = encoder
        self.dropout_keep_prob = dropout_keep_prob
        # hidden size of the energy MLP
        self.state_size = state_size if state_size is not None else \
            getattr(encoder, "output_dim", None) or encoder.state_dim

    @property
    def context_dim(self) -> int:
        return self.encoder.state_dim

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        if self.query_dim is None:
            raise ValueError(
                f"Attention '{self.name}' has no registered query dim "
                "(is it attached to a decoder?)")
        return {
            "key_proj": nn.linear_init(gen, self.encoder.state_dim,
                                       self.state_size, use_bias=True),
            "query_proj": nn.linear_init(gen, self.query_dim,
                                         self.state_size, use_bias=False),
            "similarity_v": (torch.randn(self.state_size, generator=gen)
                             / math.sqrt(self.state_size)),
        }

    @tensor
    def precompute(self, ctx: Context) -> AttentionConstants:
        states = get_attention_states(ctx, self.encoder)
        states = ctx.dropout(self, states, self.dropout_keep_prob,
                             "attention_states_dropout")
        mask = get_attention_mask(ctx, self.encoder)
        keys = nn.linear(ctx.get_params(self)["key_proj"], states)
        return AttentionConstants(states=states, keys=keys, mask=mask)

    def step(self, params, constants: AttentionConstants, query,
             dropout_gen: Optional[torch.Generator] = None):
        # dropout_gen unused: this attention drops the attended states
        # (precompute), not the softmax weights
        projected_query = nn.linear(params["query_proj"], query)
        return fused_bahdanau_step(
            constants.keys, constants.states, constants.mask,
            projected_query, params["similarity_v"])

    beam_shared_constants = True

    def step_beamed(self, params, constants: AttentionConstants,
                    query, beam: int):
        """Beam step over ONE shared copy of keys and states: the beam
        axis folds into the query and the key projections broadcast."""
        rows = query.shape[0]
        batch = rows // beam
        pq = nn.linear(params["query_proj"], query)
        pq = pq.reshape(batch, beam, 1, pq.shape[-1])
        energies = torch.einsum(
            "bkta,a->bkt", torch.tanh(constants.keys[:, None] + pq),
            params["similarity_v"])
        weights = masked_softmax(energies, constants.mask[:, None, :])
        context = torch.einsum("bkt,btd->bkd", weights, constants.states)
        return (context.reshape(rows, context.shape[-1]),
                weights.reshape(rows, weights.shape[-1]))


class CoverageAttention(Attention):
    """Coverage attention (reference nm/attention/coverage.py; Tu et al.
    2016): the energies also see the attention mass each source position
    has had so far, over its fertility. Stateful across decoder steps:
    the decoder threads the coverage through its loop state via
    ``step_with_coverage``."""

    def __init__(self, name: str,
                 encoder,
                 dropout_keep_prob: float = 1.0,
                 state_size: int = None,
                 max_fertility: int = 5,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        super().__init__(name, encoder, dropout_keep_prob, state_size,
                         reuse, save_checkpoint, load_checkpoint)
        self.max_fertility = max_fertility

    stateful_attention = True
    # the coverage is per beam, so the constants are tiled per beam too
    beam_shared_constants = False

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        params = super().init_params(gen)
        params["coverage_proj"] = torch.randn(
            1, self.state_size, generator=gen) * 0.001
        params["fertility_proj"] = nn.linear_init(
            gen, self.encoder.state_dim, 1, use_bias=True)
        return params

    def step_with_coverage(self, params, constants: AttentionConstants,
                           query, coverage):
        """coverage: (B, T) summed weights of the steps so far. Returns
        (context, weights, the new coverage)."""
        fertility = self.max_fertility * torch.sigmoid(
            nn.linear(params["fertility_proj"], constants.states)[..., 0])
        cov_term = ((coverage / fertility.clamp_min(1e-6))[..., None]
                    * params["coverage_proj"])
        projected_query = nn.linear(params["query_proj"], query)[:, None]
        energies = torch.einsum(
            "bta,a->bt",
            torch.tanh(constants.keys + projected_query + cov_term),
            params["similarity_v"])
        weights = masked_softmax(energies, constants.mask)
        context = torch.einsum("bt,btd->bd", weights, constants.states)
        return context, weights, coverage + weights

    def step(self, params, constants: AttentionConstants, query,
             dropout_gen: Optional[torch.Generator] = None):
        """The step with no coverage yet (zeros); the decoder calls
        ``step_with_coverage``."""
        context, weights, _ = self.step_with_coverage(
            params, constants, query, torch.zeros_like(constants.mask))
        return context, weights
