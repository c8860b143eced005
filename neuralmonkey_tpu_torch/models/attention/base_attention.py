"""Attention base (counterpart of
``neuralmonkey_tpu/models/attention/base_attention.py``).

An attention splits into ``precompute(ctx) -> constants`` (everything
derived once per sentence from the attended encoder: states, mask,
projected keys) and ``step(params, constants, query)`` for one decoder
step. Spatial (conv-map) inputs are flattened to a T = H·W temporal
view. The query dimension is registered by the decoder at construction
(``register_query_dim``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ...model.part import Context, ModelPart
from ...model.stateful import SpatialStateful, TemporalStateful


class AttentionConstants(NamedTuple):
    """Per-sentence loop constants for one attention object."""
    states: torch.Tensor   # (B, T, d) attended values
    keys: torch.Tensor     # (B, T, k) projected keys
    mask: torch.Tensor     # (B, T)


def get_attention_states(ctx: Context, encoder) -> torch.Tensor:
    if isinstance(encoder, TemporalStateful):
        return encoder.temporal_states(ctx)
    if isinstance(encoder, SpatialStateful):
        spatial = encoder.spatial_states(ctx)
        b, h, w, d = spatial.shape
        return spatial.reshape(b, h * w, d)
    raise TypeError(
        f"Cannot attend over {encoder!r}: not Temporal/SpatialStateful")


def get_attention_mask(ctx: Context, encoder) -> torch.Tensor:
    if isinstance(encoder, TemporalStateful):
        return encoder.temporal_mask(ctx)
    if isinstance(encoder, SpatialStateful):
        mask = encoder.spatial_mask(ctx)
        return mask.reshape(mask.shape[0], -1)
    raise TypeError(
        f"Cannot attend over {encoder!r}: not Temporal/SpatialStateful")


def masked_softmax(scores: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, ignoring masked-out positions."""
    valid = mask > 0
    scores = torch.where(valid, scores, torch.finfo(scores.dtype).min)
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights * valid
    total = weights.sum(dim=-1, keepdim=True)
    return weights / total.clamp_min(1e-9)


class BaseAttention(ModelPart):

    def __init__(self, name: str,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        self.query_dim: int = None

    def register_query_dim(self, query_dim: int) -> None:
        """Called by the consuming decoder during construction."""
        if self.query_dim is not None and self.query_dim != query_dim:
            raise ValueError(
                f"Attention '{self.name}' already registered with query "
                f"dim {self.query_dim}, got {query_dim}")
        self.query_dim = query_dim

    @property
    def context_dim(self) -> int:
        raise NotImplementedError

    def precompute(self, ctx: Context) -> AttentionConstants:
        raise NotImplementedError

    def tile_constants(self, constants: AttentionConstants,
                       k: int) -> AttentionConstants:
        """Repeat batch-dimensioned constants k times (beam search)."""
        return AttentionConstants(
            *(x.repeat_interleave(k, dim=0) for x in constants))

    # Attentions that drop their softmax weights in training (scaled
    # dot-product) set this: the decoder's teacher-forced pass then gives
    # their ``step`` a generator of each step's own seed.
    weights_dropout = False

    # Attentions whose constants are beam-invariant serve all K beams
    # from one copy under lineage beam decoding (``step_beamed``), so
    # the encoder keys and states are read once per step, not K times.
    beam_shared_constants = False

    def tile_constants_lineage(self, constants: AttentionConstants,
                               k: int) -> AttentionConstants:
        if self.beam_shared_constants:
            return constants
        return self.tile_constants(constants, k)

    def step_beamed(self, params: Dict[str, Any],
                    constants: AttentionConstants,
                    query: torch.Tensor, beam: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step over untiled constants: ``query`` has B·beam rows,
        the constants batch B."""
        raise NotImplementedError

    def step(self, params: Dict[str, Any], constants: AttentionConstants,
             query: torch.Tensor,
             dropout_gen: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(context (B, d), weights (B, T)) for one decoder step.

        ``dropout_gen`` is a generator of this step's own seed, which the
        decoder's teacher-forced pass gives when training with
        ``dropout_keep_prob < 1``; attentions whose reference semantics
        drop the softmax weights (scaled dot-product) draw from it, the
        others ignore it. Inference passes None."""
        raise NotImplementedError
