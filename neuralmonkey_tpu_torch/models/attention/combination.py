"""Multi-source attention combinators (counterpart of
``neuralmonkey_tpu/models/attention/combination.py``, reference
nm/attention/combination.py; Libovický & Helcl 2017).

- :class:`FlatMultiAttention`: every encoder's states are projected to
  one shared attention space; a single softmax runs over the
  concatenation of all positions of all encoders.
- :class:`HierarchicalMultiAttention`: child attentions produce one
  context each; a second-level Bahdanau-style attention weighs the
  projected child contexts.

Both take Temporal and Spatial encoders (spatial maps flattened). The
flat step and the second level are plain PyTorch, as the JAX package
computes them outside any Pallas kernel; the hierarchical children step
as they do alone (a Bahdanau child through K2).

The reference accepts ``use_sentinels`` and ``dropout_keep_prob`` here
and then ignores them; the port raises a ValueError for a value other
than the default.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch

from ...model.part import Context, ModelPart, tensor
from ...ops import nn
from .base_attention import (AttentionConstants, BaseAttention,
                             get_attention_mask, get_attention_states,
                             masked_softmax)


def _refuse_ignored_knobs(name: str, use_sentinels: bool,
                          dropout_keep_prob: float) -> None:
    """The reference accepts these two and never reads them."""
    if use_sentinels:
        raise ValueError(
            f"{name}: use_sentinels=True is accepted and then ignored by "
            "the reference; the port does not take it")
    if dropout_keep_prob < 1.0:
        raise ValueError(
            f"{name}: dropout_keep_prob < 1 is accepted and then ignored "
            "by the reference; the port does not take it")


def _energy_params(gen: torch.Generator, query_dim: int,
                   size: int) -> Dict[str, Any]:
    return {
        "query_proj": nn.linear_init(gen, query_dim, size, use_bias=False),
        "similarity_v": torch.randn(size, generator=gen) / math.sqrt(size),
    }


class FlatMultiAttention(BaseAttention):

    def __init__(self, name: str,
                 encoders: List,
                 attention_state_size: int,
                 share_attn_projections: bool = False,
                 use_sentinels: bool = False,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        super().__init__(name, reuse, save_checkpoint, load_checkpoint)
        if not encoders:
            raise ValueError("FlatMultiAttention needs encoders")
        _refuse_ignored_knobs(name, use_sentinels, dropout_keep_prob)
        self.encoders = encoders
        self.attention_state_size = attention_state_size
        self.share_attn_projections = share_attn_projections

    @property
    def context_dim(self) -> int:
        return self.attention_state_size

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        if self.query_dim is None:
            raise ValueError(
                f"Attention '{self.name}' has no registered query dim")
        params = _energy_params(gen, self.query_dim,
                                self.attention_state_size)
        if self.share_attn_projections:
            dims = {e.state_dim for e in self.encoders}
            if len(dims) != 1:
                raise ValueError(
                    "share_attn_projections requires encoders with "
                    "equal state dims")
            params["enc_proj_0"] = nn.linear_init(
                gen, dims.pop(), self.attention_state_size)
        else:
            for i, encoder in enumerate(self.encoders):
                params[f"enc_proj_{i}"] = nn.linear_init(
                    gen, encoder.state_dim, self.attention_state_size)
        return params

    def _proj_key(self, i: int) -> str:
        return "enc_proj_0" if self.share_attn_projections \
            else f"enc_proj_{i}"

    @tensor
    def precompute(self, ctx: Context) -> AttentionConstants:
        params = ctx.get_params(self)
        states = torch.cat(
            [nn.linear(params[self._proj_key(i)],
                       get_attention_states(ctx, encoder))
             for i, encoder in enumerate(self.encoders)], dim=1)
        mask = torch.cat([get_attention_mask(ctx, encoder)
                          for encoder in self.encoders], dim=1)
        # the keys are the projected states (the energies add the query)
        return AttentionConstants(states=states, keys=states, mask=mask)

    def step(self, params, constants: AttentionConstants, query,
             dropout_gen: Optional[torch.Generator] = None):
        # no weights-dropout site in the reference's flat attention
        projected_query = nn.linear(params["query_proj"], query)[:, None]
        energies = torch.einsum(
            "bta,a->bt", torch.tanh(constants.keys + projected_query),
            params["similarity_v"])
        weights = masked_softmax(energies, constants.mask)
        context = torch.einsum("bt,btd->bd", weights, constants.states)
        return context, weights


class HierarchicalMultiAttention(BaseAttention):
    """Its constants are a dict: ``children``, each child's constants,
    and ``child_params``, each child's parameters, so that ``step``
    needs nothing else. It does not share its constants across a beam:
    under beam search the children's constants are tiled to B·K rows
    (``tile_constants``) and each child takes its plain step."""

    def __init__(self, name: str,
                 attentions: List[BaseAttention],
                 attention_state_size: int,
                 share_attn_projections: bool = False,
                 use_sentinels: bool = False,
                 dropout_keep_prob: float = 1.0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        super().__init__(name, reuse, save_checkpoint, load_checkpoint)
        if not attentions:
            raise ValueError(
                "HierarchicalMultiAttention needs child attentions")
        _refuse_ignored_knobs(name, use_sentinels, dropout_keep_prob)
        self.attentions = attentions
        self.attention_state_size = attention_state_size
        self.share_attn_projections = share_attn_projections

    @property
    def context_dim(self) -> int:
        return self.attention_state_size

    def register_query_dim(self, query_dim: int) -> None:
        super().register_query_dim(query_dim)
        for child in self.attentions:
            child.register_query_dim(query_dim)

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        if self.query_dim is None:
            raise ValueError(
                f"Attention '{self.name}' has no registered query dim")
        params = _energy_params(gen, self.query_dim,
                                self.attention_state_size)
        if self.share_attn_projections:
            dims = {a.context_dim for a in self.attentions}
            if len(dims) != 1:
                raise ValueError(
                    "share_attn_projections requires children with "
                    "equal context dims")
            params["ctx_proj_0"] = nn.linear_init(
                gen, dims.pop(), self.attention_state_size)
        else:
            for i, child in enumerate(self.attentions):
                params[f"ctx_proj_{i}"] = nn.linear_init(
                    gen, child.context_dim, self.attention_state_size)
        return params

    def _proj_key(self, i: int) -> str:
        return "ctx_proj_0" if self.share_attn_projections \
            else f"ctx_proj_{i}"

    @tensor
    def precompute(self, ctx: Context) -> Dict[str, Any]:
        return {"children": tuple(child.precompute(ctx)
                                  for child in self.attentions),
                "child_params": tuple(ctx.get_params(child)
                                      for child in self.attentions)}

    def tile_constants(self, constants: Dict[str, Any],
                       k: int) -> Dict[str, Any]:
        """Each child tiles its own constants k times; the children's
        parameters stay as they are."""
        return {"children": tuple(
                    child.tile_constants(c, k) for child, c in zip(
                        self.attentions, constants["children"])),
                "child_params": constants["child_params"]}

    def step(self, params, constants: Dict[str, Any], query,
             dropout_gen: Optional[torch.Generator] = None):
        contexts, child_weights = [], []
        for child, child_params, child_constants in zip(
                self.attentions, constants["child_params"],
                constants["children"]):
            context, weights = child.step(child_params, child_constants,
                                          query, dropout_gen=dropout_gen)
            contexts.append(context)
            child_weights.append(weights)
        projected = torch.stack(
            [nn.linear(params[self._proj_key(i)], c)
             for i, c in enumerate(contexts)], dim=1)  # (B, children, a)
        projected_query = nn.linear(params["query_proj"], query)[:, None]
        energies = torch.einsum(
            "bna,a->bn", torch.tanh(projected + projected_query),
            params["similarity_v"])
        beta = masked_softmax(energies, torch.ones_like(energies))
        context = torch.einsum("bn,bna->ba", beta, projected)
        # the children's weights side by side (for visualization)
        return context, torch.cat(child_weights, dim=-1)
