"""Autoregressive decoder base (counterpart of
``neuralmonkey_tpu/models/decoders/autoregressive.py``).

Subclass contract, used by greedy decoding and beam search:

- ``decode_constants(ctx)`` -> dict of per-sentence constants
  (attention keys, embedding table, parameters);
- ``decode_initial_state(ctx, constants)`` -> loop state;
- ``decode_step(constants, loop_state, prev_ids, step)`` ->
  ``(new_loop_state, logits (B, V), aux dict)``.

The decode loops are Python loops over device tensors. They ask the
device whether every sentence has finished only once every
``FINISHED_CHECK_PERIOD`` steps: a finished sentence is a fixed point
of the step (it emits PAD and keeps its state of the search), so the
steps run past the last finish change nothing, and the loop does not
wait on the device every step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ...model.part import Context, ModelPart, tensor
from ...model.sequence import EmbeddedSequence
from ...ops import fused_xent
from ...ops.beam_select import fused_logits_rowmax_lse
from ...vocabulary import (END_TOKEN_INDEX, PAD_TOKEN_INDEX,
                           START_TOKEN_INDEX, UNK_TOKEN_INDEX, Vocabulary)

FINISHED_CHECK_PERIOD = 8
# the fused logit projection pads the vocabulary to a multiple of this
FUSED_LOGIT_ALIGN = 8 * 128


class AutoregressiveDecoder(ModelPart):

    def __init__(self, name: str,
                 vocabulary: Vocabulary,
                 data_id: str,
                 max_output_len: int,
                 dropout_keep_prob: float = 1.0,
                 embedding_size: int = None,
                 embeddings_source: EmbeddedSequence = None,
                 tie_embeddings: bool = False,
                 label_smoothing: float = None,
                 supress_unk: bool = False,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        self.vocabulary = vocabulary
        self.data_id = data_id
        self.max_output_len = max_output_len
        self.dropout_keep_prob = dropout_keep_prob
        self.label_smoothing = label_smoothing
        self.tie_embeddings = tie_embeddings
        self.supress_unk = supress_unk

        if embeddings_source is not None:
            self.embeddings = embeddings_source
            self.embedding_size = embeddings_source.embedding_size
            if (embedding_size is not None
                    and embedding_size != self.embedding_size):
                raise ValueError(
                    "embedding_size conflicts with embeddings_source")
        else:
            if embedding_size is None:
                raise ValueError(
                    "Provide embedding_size or embeddings_source")
            self.embedding_size = embedding_size
            self.embeddings = EmbeddedSequence(
                name=f"{name}_embeddings",
                vocabulary=vocabulary,
                data_id=data_id,
                embedding_size=embedding_size,
                table_only=True)

        if max_output_len <= 0:
            raise ValueError("max_output_len must be positive")

    # ------------------------------------------------------------------ #
    # featurization: teacher inputs <s> w1..wn, targets w1..wn </s>
    # ------------------------------------------------------------------ #
    @property
    def input_ids_key(self) -> str:
        return f"{self.name}.train_inputs"

    @property
    def target_ids_key(self) -> str:
        return f"{self.name}.train_targets"

    @property
    def target_mask_key(self) -> str:
        return f"{self.name}.train_mask"

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}  # inference dataset without targets
        full, mask = self.vocabulary.sentences_to_tensor(
            dataset.get_series(self.data_id),
            max_len=self.max_output_len, train_mode=train,
            add_start_symbol=True, add_end_symbol=True)
        return {self.input_ids_key: full[:, :-1],
                self.target_ids_key: full[:, 1:],
                self.target_mask_key: mask[:, 1:]}

    @tensor
    def train_inputs(self, ctx: Context):
        return ctx.batch[self.input_ids_key]

    @tensor
    def train_targets(self, ctx: Context):
        return ctx.batch[self.target_ids_key]

    @tensor
    def train_mask(self, ctx: Context):
        return ctx.batch[self.target_mask_key]

    def train_logits(self, ctx: Context):
        """(B, T, V) teacher-forced logits."""
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # losses
    # ------------------------------------------------------------------ #
    def _xent(self, logits: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
        """Per-token masked cross-entropy (B, T), label-smoothed when
        the decoder says so."""
        log_probs = torch.log_softmax(logits, dim=-1)
        target_ll = log_probs.gather(
            -1, targets.long()[..., None])[..., 0]
        if self.label_smoothing:
            eps = self.label_smoothing
            nll = -((1.0 - eps) * target_ll + eps * log_probs.mean(dim=-1))
        else:
            nll = -target_ll
        return nll * mask

    def _fused_token_nll(self, ctx: Context):
        """(B, T) per-token nll through the fused cross-entropy
        (``ops/fused_xent.py``), or ``None`` when the decoder has no
        prelogit seam or the fused path is off or ineligible."""
        proj_fn = getattr(self, "train_logit_projection", None)
        states_fn = getattr(self, "train_prelogit_states", None)
        if proj_fn is None or states_fn is None:
            return None
        states = states_fn(ctx)
        w, b, transposed = proj_fn(ctx)
        if not fused_xent.eligible(states, w):
            return None
        bsz, time, dim = states.shape
        nll = fused_xent.fused_softmax_xent(
            states.reshape(bsz * time, dim), w, b,
            self.train_targets(ctx).reshape(bsz * time),
            eps=self.label_smoothing or 0.0, transposed=transposed)
        return nll.reshape(bsz, time)

    @tensor
    def train_token_nll(self, ctx: Context):
        """(B, T) masked per-token cross-entropy, fused when eligible."""
        mask = self.train_mask(ctx)
        fused = self._fused_token_nll(ctx)
        if fused is not None:
            return fused * mask
        return self._xent(self.train_logits(ctx), self.train_targets(ctx),
                          mask)

    @tensor
    def train_xents(self, ctx: Context):
        """Per-sentence summed cross-entropy (B,)."""
        return self.train_token_nll(ctx).sum(dim=1)

    @tensor
    def train_loss(self, ctx: Context):
        """Mean per-token cross-entropy: the training objective."""
        return (self.train_token_nll(ctx).sum()
                / self.train_mask(ctx).sum().clamp_min(1.0))

    # the reference's name for the decoder's objective value
    def cost(self, ctx: Context):
        return self.train_loss(ctx)

    # ------------------------------------------------------------------ #
    # subclass contract
    # ------------------------------------------------------------------ #
    def decode_constants(self, ctx: Context) -> Dict[str, Any]:
        raise NotImplementedError

    def decode_initial_state(self, ctx: Context, constants):
        raise NotImplementedError

    def decode_step(self, constants: Dict[str, Any], loop_state: Any,
                    prev_ids: torch.Tensor, step: int):
        raise NotImplementedError

    # Decoders that support lineage beam decoding (the only beam search
    # ported) implement these two: beam search then never reorders the
    # loop state after a step; ``decode_step_lineage`` takes the previous
    # step's ``parents`` (B, K), the beam slot each hypothesis came from.
    lineage_decode = False

    def decode_step_lineage(self, constants: Dict[str, Any],
                            loop_state: Any, prev_ids: torch.Tensor,
                            step: int, parents: torch.Tensor, beam: int):
        raise NotImplementedError

    def tile_decode_constants_lineage(self, constants, k: int):
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    # fused logit projection for the hierarchical beam selector
    # ------------------------------------------------------------------ #
    def prepare_selection_fusion(self, constants: Dict[str, Any]
                                 ) -> Dict[str, Any]:
        """Arm decode constants with a (D, Vp) logit matrix and a
        (1, Vp) bias under ``"fused_logit"``, Vp the vocabulary padded
        to a multiple of 1024 with bias -1e9 on the pad, so the decode
        steps emit the logits AND the hierarchical selector's two
        reductions from one kernel (K3). The pad columns are never
        selected, so the selection is the same as from the plain
        logits."""
        params = constants["params"]
        if self.tie_embeddings:
            w = constants["embed_table"].T
            b = params["logit_bias"]
        else:
            w = params["logit"]["w"]
            b = params["logit"].get("b")
            if b is None:
                b = w.new_zeros(w.shape[1])
        pad = (-w.shape[1]) % FUSED_LOGIT_ALIGN
        w = torch.nn.functional.pad(w.float(), (0, pad)).contiguous()
        b = torch.cat([b.float(), b.new_full((pad,), -1e9)])
        constants = dict(constants)
        constants["fused_logit"] = (w, b[None, :])
        return constants

    def _step_logits(self, constants: Dict[str, Any],
                     prelogit: torch.Tensor,
                     plain: Callable[[], torch.Tensor]
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Decode-step logits. When ``prepare_selection_fusion`` armed
        the constants, returns the fused kernel's (N, Vp) logits and its
        reductions as aux entries for the beam selector; otherwise the
        decoder's plain projection and no aux."""
        fused = constants.get("fused_logit")
        if fused is None:
            return plain(), {}
        w, b = fused
        logits, rowmax, lse = fused_logits_rowmax_lse(
            prelogit.float().contiguous(), w, b)
        return logits, {"sel_rowmax": rowmax, "sel_lse": lse}

    # ------------------------------------------------------------------ #
    # greedy decoding
    # ------------------------------------------------------------------ #
    def _mask_unk(self, logits: torch.Tensor) -> torch.Tensor:
        if not self.supress_unk:
            return logits
        logits = logits.clone()
        logits[..., UNK_TOKEN_INDEX] = torch.finfo(logits.dtype).min
        return logits

    @tensor
    def greedy_ids(self, ctx: Context) -> torch.Tensor:
        """Greedy decode, ids only: (B, max_output_len) int32, PAD
        after a sentence's </s>; stops early once every sentence has
        finished (checked every FINISHED_CHECK_PERIOD steps)."""
        constants = self.decode_constants(ctx)
        state = self.decode_initial_state(ctx, constants)
        batch = self._batch_size(ctx)
        device = self._device(ctx)
        prev_ids = torch.full((batch,), START_TOKEN_INDEX,
                              dtype=torch.int32, device=device)
        finished = torch.zeros(batch, dtype=torch.bool, device=device)
        decoded = torch.full((batch, self.max_output_len),
                             PAD_TOKEN_INDEX, dtype=torch.int32,
                             device=device)
        for step in range(self.max_output_len):
            if step and step % FINISHED_CHECK_PERIOD == 0 \
                    and bool(finished.all()):
                break
            state, logits, _ = self.decode_step(constants, state,
                                                prev_ids, step)
            new_ids = self._mask_unk(logits).argmax(dim=-1).to(torch.int32)
            new_ids = torch.where(finished, PAD_TOKEN_INDEX, new_ids)
            decoded[:, step] = new_ids
            finished = finished | (new_ids == END_TOKEN_INDEX)
            prev_ids = new_ids
        return decoded

    @tensor
    def decoded(self, ctx: Context):
        return self.greedy_ids(ctx)

    @staticmethod
    def _batch_size(ctx: Context) -> int:
        for value in ctx.batch.values():
            return value.shape[0]
        raise ValueError("Empty batch")

    @staticmethod
    def _device(ctx: Context) -> torch.device:
        for value in ctx.batch.values():
            return value.device
        raise ValueError("Empty batch")
