"""Autoregressive decoder base (counterpart of
``neuralmonkey_tpu/models/decoders/autoregressive.py``).

Subclass contract, used by greedy decoding and beam search:

- ``decode_constants(ctx)`` -> dict of per-sentence constants
  (attention keys, embedding table, parameters);
- ``decode_initial_state(ctx, constants)`` -> loop state;
- ``decode_step(constants, loop_state, prev_ids, step)`` ->
  ``(new_loop_state, logits (B, V), aux dict)``;
- for beam search: ``tile_decode_constants(constants, k)`` -> the
  constants for B·K rows (``b·K + j``), where the batch-dimensioned
  ones are repeated K times and parameters and tables stay as they
  are; ``tile_decode_state(state, k, lineage)`` -> the loop state for
  B·K rows. The physical reorder steps ``decode_step`` over those rows
  and gathers every tensor of the state by the chosen parents after
  each step. Decoders with lineage decoding also implement
  ``decode_step_lineage`` and ``tile_decode_constants_lineage`` (below).

The decode loops are Python loops over device tensors. They ask the
device whether every sentence has finished only once every
``FINISHED_CHECK_PERIOD`` steps: a finished sentence is a fixed point
of the step (it emits PAD and keeps its state of the search), so the
steps run past the last finish change nothing, and the loop does not
wait on the device every step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...model.part import Context, ModelPart, tensor
from ...model.sequence import EmbeddedSequence
from ...ops import fused_xent, kernel_config, sharding
from ...ops.beam_select import fused_logits_rowmax_lse
from ...parallel import tensor as tp
from ...parallel.distributed import global_sum
from ...parallel.fsdp import replace_items
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

    def param_partition_specs(self) -> Dict[str, tuple]:
        # the vocabulary-sized output projection splits its columns over
        # the model axis (a tied table's own declaration covers it)
        return {"logit/w": (None, "model"),
                "logit/b": ("model",),
                "logit_bias": ("model",)}

    def train_split_logits(self, ctx: Context):
        """(B, T, V) teacher-forced logits, this rank's part of them: of
        the vocabulary where the output projection is split
        (``vocab_split``), of the time axis where ``train_time_axis``
        says so."""
        raise NotImplementedError

    def train_time_axis(self, ctx: Context) -> Optional[str]:
        """The axis the teacher-forced pass splits its time axis over
        (context parallelism), or None."""
        del ctx
        return None

    def vocab_split(self, params: Dict[str, Any],
                    table: torch.Tensor) -> bool:
        """Whether the logits' vocabulary is split over the model axis:
        the output projection's columns (or the tied table's rows)
        are."""
        if self.tie_embeddings:
            return tp.split_dim(table) == 0
        return tp.split_dim(params["logit"]["w"]) == 1

    def _vocab_split_ctx(self, ctx: Context) -> bool:
        return self.vocab_split(
            ctx.get_params(self),
            ctx.get_params(self.embeddings)["embeddings"])

    @tensor
    def train_logits(self, ctx: Context):
        """(B, T, V) teacher-forced logits, whole."""
        logits = self.train_split_logits(ctx)
        if self._vocab_split_ctx(ctx):
            logits = tp.gather_from(logits, -1)
        return sharding.gather_sequence(logits, self.train_time_axis(ctx))

    def _train_slice(self, ctx: Context, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a (B, T) target tensor."""
        axis = self.train_time_axis(ctx)
        if axis is None:
            return x
        return x[:, sharding.time_slice(x.shape[1], axis)]

    # ------------------------------------------------------------------ #
    # losses
    # ------------------------------------------------------------------ #
    def _xent(self, logits: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor, vocab_split: bool = False
              ) -> torch.Tensor:
        """Per-token masked cross-entropy (B, T), label-smoothed when
        the decoder says so; of logits whose vocabulary is split over
        the model axis when ``vocab_split``."""
        if vocab_split:
            return tp.vocab_parallel_nll(
                logits, targets, self.label_smoothing or 0.0) * mask
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
            self._train_slice(ctx, self.train_targets(ctx)).reshape(
                bsz * time),
            eps=self.label_smoothing or 0.0, transposed=transposed)
        return nll.reshape(bsz, time)

    @tensor
    def train_token_nll(self, ctx: Context):
        """(B, T) masked per-token cross-entropy, fused when eligible;
        this rank's slice of the time axis where it is split."""
        mask = self._train_slice(ctx, self.train_mask(ctx))
        fused = self._fused_token_nll(ctx)
        if fused is not None:
            return fused * mask
        return self._xent(self.train_split_logits(ctx),
                          self._train_slice(ctx, self.train_targets(ctx)),
                          mask, self._vocab_split_ctx(ctx))

    def _time_sum(self, ctx: Context, x: torch.Tensor) -> torch.Tensor:
        """A sum over this rank's slice of the time axis, summed over the
        slices."""
        axis = self.train_time_axis(ctx)
        return tp.reduce_from(x, axis) if axis else x

    @tensor
    def train_xents(self, ctx: Context):
        """Per-sentence summed cross-entropy (B,)."""
        return self._time_sum(ctx, self.train_token_nll(ctx).sum(dim=1))

    @tensor
    def train_loss(self, ctx: Context):
        """Mean per-token cross-entropy over the global batch: the
        training objective."""
        mask = self._train_slice(ctx, self.train_mask(ctx))
        return (global_sum(self._time_sum(
            ctx, self.train_token_nll(ctx).sum()))
            / global_sum(self._time_sum(ctx, mask.sum())).clamp_min(1.0))

    # the reference's name for the decoder's objective value
    def cost(self, ctx: Context):
        return self.train_loss(ctx)

    @tensor
    def runtime_loss(self, ctx: Context):
        """Cross-entropy of the greedy path's logits against the
        reference targets (the batch must carry them)."""
        logits, _, _ = self.greedy_outputs(ctx)
        targets = self.train_targets(ctx)
        time = min(logits.shape[1], targets.shape[1])
        mask = self.train_mask(ctx)[:, :time]
        nll = self._xent(logits[:, :time], targets[:, :time], mask)
        return global_sum(nll.sum()) / global_sum(mask.sum()).clamp_min(1.0)

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

    # True where a decode step's aux can carry "attention_weights" (beam
    # search records histories of them only where the parent declares
    # it); ``with_attention_maps`` returns the constants of steps that
    # do: a decoder that computes its map only on request (the
    # Transformer) marks the request there, the others emit it anyway
    emits_attention = False

    def with_attention_maps(self, constants: Dict[str, Any]
                            ) -> Dict[str, Any]:
        return constants

    # Decoders that support lineage beam decoding implement these two:
    # beam search then never reorders the loop state after a step.
    # ``decode_step_lineage`` takes the composed ancestry ``anc`` (B, K,
    # max_output_len): ``anc[b, k, t]`` is the slot whose step t lies on
    # hypothesis k's lineage (its own slot for positions not written
    # yet), so ``anc[:, :, step - 1]`` are the previous step's parents;
    # ``window`` bounds the positions a cache read needs (``step + 1`` is
    # exact). A decoder that reads no more of ``anc`` than column
    # ``step - 1`` sets ``reads_ancestry`` False: the search then writes
    # each step's parents into that column instead of composing the
    # whole ancestry every step. Without lineage decoding (or with it
    # switched off) beam search takes the physical reorder.
    lineage_decode = False
    reads_ancestry = True

    def decode_step_lineage(self, constants: Dict[str, Any],
                            loop_state: Any, prev_ids: torch.Tensor,
                            step: int, anc: torch.Tensor, beam: int,
                            window: int = None):
        raise NotImplementedError

    def tile_decode_constants_lineage(self, constants, k: int):
        raise NotImplementedError

    def tile_decode_constants(self, constants: Dict[str, Any],
                              k: int) -> Dict[str, Any]:
        raise NotImplementedError

    def tile_decode_state(self, state: Any, beam: int,
                          lineage: bool = True) -> Any:
        """The loop state for B·K beam rows (row ``b·K + k``) from a
        (B, ...) tensor, for either form of the search (``lineage``);
        decoders whose state has another layout override this."""
        del lineage
        return state.repeat_interleave(beam, dim=0)

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
        logits. Returns the constants unchanged under
        ``NM_FUSED_LOGITS=0`` (``kernel_config.use_fused_logits``): the
        selector then reduces the plain logits with ``rowmax_lse``."""
        if not kernel_config.use_fused_logits():
            return constants
        params = constants["params"]
        split = self.vocab_split(params, constants["embed_table"])
        if self.tie_embeddings:
            w = constants["embed_table"].T
            b = params["logit_bias"]
        else:
            w = params["logit"]["w"]
            b = params["logit"].get("b")
            if b is None:
                b = w.new_zeros(w.shape[1])
        if split:
            # the vocabulary's parts gathered whole: K3's shape gate
            # then takes its plain path (the model axis is on)
            w = tp.all_gather(w, 1, "model")
            b = tp.all_gather(b, 0, "model")
        pad = (-w.shape[1]) % FUSED_LOGIT_ALIGN
        w = torch.nn.functional.pad(w.float(), (0, pad)).contiguous()
        b = torch.cat([b.float(), b.new_full((pad,), -1e9)])
        constants = dict(constants)
        constants["fused_logit"] = (w, b[None, :])
        return constants

    def align_logits_for_selection(self, constants: Dict[str, Any],
                                   lane: int = 128) -> Dict[str, Any]:
        """Decode constants whose logit projection is padded to a
        multiple of ``lane`` columns (the tied embedding table's rows
        and ``logit_bias``, or the output projection's ``w`` and ``b``),
        the pad at bias -1e9, so the decode steps emit lane-aligned
        logits and the hierarchical selector has no pad pass to make.
        The pad columns are never selected (and the search clamps the
        emitted ids). Unchanged when the vocabulary is aligned, or split
        over the model axis (its logits are gathered whole, unpadded)."""
        vocab = len(self.vocabulary)
        pad = (-vocab) % lane
        if pad == 0 or self.vocab_split(constants["params"],
                                        constants["embed_table"]):
            return constants
        constants = dict(constants)
        params = constants["params"]
        if self.tie_embeddings:
            constants["embed_table"] = torch.nn.functional.pad(
                constants["embed_table"], (0, 0, 0, pad))
            bias = params["logit_bias"]
            replaced = {"logit_bias": torch.cat(
                [bias, bias.new_full((pad,), -1e9)])}
        else:
            logit = dict(params["logit"])
            w = logit["w"]
            logit["w"] = torch.nn.functional.pad(w, (0, pad))
            bias = logit.get("b")
            if bias is None:
                bias = w.new_zeros(vocab, dtype=torch.float32)
            logit["b"] = torch.cat([bias, bias.new_full((pad,), -1e9)])
            replaced = {"logit": logit}
        # (under FSDP a copy of the part's view that gathers no layer)
        constants["params"] = replace_items(params, replaced)
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
            logits = plain()
            if self.vocab_split(constants["params"],
                                constants["embed_table"]):
                logits = tp.gather_from(logits, -1)
            return logits, {}
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

    def _stepper(self, ctx: Context, with_attention: bool = False
                 ) -> Callable:
        """``step(prev_ids, step)`` -> (logits, aux): one model's decode
        steps, its loop state kept between calls; ``with_attention``
        requests the steps' attention maps (``with_attention_maps``)."""
        constants = self.decode_constants(ctx)
        if with_attention:
            constants = self.with_attention_maps(constants)
        state = self.decode_initial_state(ctx, constants)

        def step_fn(prev_ids, step):
            nonlocal state
            state, logits, aux = self.decode_step(constants, state,
                                                  prev_ids, step)
            return logits, aux
        return step_fn

    def _ensemble_stepper(self, contexts: List[Context]) -> Callable:
        """Like ``_stepper`` for the models of ``contexts`` (one a
        parameter set): each step's float32 log-probs averaged as
        probabilities, ``logsumexp`` over the models minus ``log n``,
        and no aux."""
        steppers = [self._stepper(c) for c in contexts]
        log_n = torch.tensor(float(len(contexts))).log().to(
            self._device(contexts[0]))

        def step_fn(prev_ids, step):
            log_probs = torch.stack([
                torch.log_softmax(s(prev_ids, step)[0].float(), dim=-1)
                for s in steppers])
            return torch.logsumexp(log_probs, dim=0) - log_n, {}
        return step_fn

    def _decode_loop(self, ctx: Context, pick: Callable, early_exit: bool,
                     step_fn: Callable = None):
        """The decode loop of greedy decoding and sampling: ``pick(logits,
        aux)`` -> (ids, kept) chooses each step's ids from its logits
        (UNK masked) and what to keep of the step. A finished sentence
        emits PAD. Returns (ids (B, steps), what each step kept, the
        finished-before-each-step masks); with ``early_exit`` the loop
        stops once every sentence has finished (checked every
        FINISHED_CHECK_PERIOD steps). ``step_fn`` makes each step's
        logits (default: this model's ``_stepper``)."""
        if step_fn is None:
            step_fn = self._stepper(ctx)
        batch = self._batch_size(ctx)
        device = self._device(ctx)
        prev_ids = torch.full((batch,), START_TOKEN_INDEX,
                              dtype=torch.int32, device=device)
        finished = torch.zeros(batch, dtype=torch.bool, device=device)
        ids, kept, finished_before = [], [], []
        for step in range(self.max_output_len):
            if early_exit and step and step % FINISHED_CHECK_PERIOD == 0 \
                    and ctx.all_finished(finished):
                break
            logits, aux = step_fn(prev_ids, step)
            new_ids, step_kept = pick(self._mask_unk(logits), aux)
            new_ids = torch.where(finished, PAD_TOKEN_INDEX, new_ids)
            ids.append(new_ids)
            kept.append(step_kept)
            finished_before.append(finished)
            finished = finished | (new_ids == END_TOKEN_INDEX)
            prev_ids = new_ids
        return torch.stack(ids, dim=1), kept, finished_before

    def _pad_steps(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, steps) ids padded with PAD to (B, max_output_len)."""
        return torch.nn.functional.pad(
            ids, (0, self.max_output_len - ids.shape[1]),
            value=PAD_TOKEN_INDEX)

    @tensor
    def greedy_ids(self, ctx: Context) -> torch.Tensor:
        """Greedy decode, ids only: (B, max_output_len) int32, PAD
        after a sentence's </s>; stops early once every sentence has
        finished."""
        ids, _, _ = self._decode_loop(
            ctx, lambda logits, aux: (logits.argmax(dim=-1).to(torch.int32),
                                      None), early_exit=True)
        return self._pad_steps(ids)

    def greedy_outputs(self, ctx: Context, with_attention: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
        """Greedy decode over all ``max_output_len`` steps: (logits (B,
        L, V), ids (B, L), aux with each step's entries stacked on a
        leading time axis, as the JAX scan stacks them). With
        ``with_attention`` the steps are asked for their attention maps
        (``with_attention_maps``). Memoized per Context: a call without
        the request takes a decode that made the maps, where there is
        one."""
        if with_attention or ctx.is_cached(self, "greedy_outputs_maps"):
            return ctx.cached(self, "greedy_outputs_maps",
                              lambda part, c: part._greedy_outputs(c, True))
        return ctx.cached(self, "greedy_outputs",
                          lambda part, c: part._greedy_outputs(c, False))

    def _greedy_outputs(self, ctx: Context, with_attention: bool):
        def pick(logits, aux):
            return logits.argmax(dim=-1).to(torch.int32), (logits, aux)

        def stack(steps):
            if isinstance(steps[0], (tuple, list)):
                return tuple(stack(list(s)) for s in zip(*steps))
            return torch.stack(steps, dim=0)
        ids, kept, _ = self._decode_loop(
            ctx, pick, early_exit=False,
            step_fn=self._stepper(ctx, with_attention))
        auxes = [aux for _, aux in kept]
        return (torch.stack([logits for logits, _ in kept], dim=1), ids,
                {key: stack([aux[key] for aux in auxes])
                 for key in auxes[0]})

    def ensemble_greedy_outputs(self, contexts: List[Context]
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decode of the models of ``contexts`` over all
        ``max_output_len`` steps, their distributions averaged at every
        step (``_ensemble_stepper``), UNK masked after the average:
        (averaged log-probs (B, L, V), ids (B, L))."""
        ids, kept, _ = self._decode_loop(
            contexts[0], lambda avg, aux: (
                avg.argmax(dim=-1).to(torch.int32), avg),
            early_exit=False, step_fn=self._ensemble_stepper(contexts))
        return torch.stack(kept, dim=1), ids

    def ensemble_greedy_ids(self, contexts: List[Context]) -> torch.Tensor:
        """The ids of ``ensemble_greedy_outputs``, (B, max_output_len),
        from a loop that stops early and keeps no log-probs."""
        ids, _, _ = self._decode_loop(
            contexts[0], lambda avg, aux: (
                avg.argmax(dim=-1).to(torch.int32), None),
            early_exit=True, step_fn=self._ensemble_stepper(contexts))
        return self._pad_steps(ids)

    def draw_samples(self, log_probs: torch.Tensor,
                     generator: torch.Generator) -> torch.Tensor:
        """One id per row drawn from ``exp(log_probs)`` (B, V), int32."""
        return torch.multinomial(log_probs.detach().exp(), 1,
                                 generator=generator)[:, 0].to(torch.int32)

    @tensor
    def sample_outputs(self, ctx: Context
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ancestral sampling decode, the self-critical and REINFORCE
        path: (sampled ids (B, L), summed log-probs of the sampled
        tokens (B,), differentiable). Each step draws from the full
        ``log_softmax`` of its logits (``draw_samples``) with a
        generator seeded from the pass's (decoder, "sampling") seed;
        after END a sentence emits PAD and its log-prob terms are 0.
        Stops early once every sentence has finished, which changes
        neither output."""
        generator = ctx.make_rng(self, "sampling", self._device(ctx))

        def pick(logits, aux):
            del aux
            log_probs = torch.log_softmax(logits, dim=-1)
            new_ids = self.draw_samples(log_probs, generator)
            return new_ids, log_probs.gather(-1, new_ids.long()[:, None])
        ids, chosen, finished = self._decode_loop(ctx, pick,
                                                  early_exit=True)
        log_prob = sum(torch.where(done, 0.0, lp[:, 0])
                       for lp, done in zip(chosen, finished))
        return self._pad_steps(ids), log_prob

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
