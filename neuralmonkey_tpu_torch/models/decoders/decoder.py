"""Attentive RNN decoder (counterpart of
``neuralmonkey_tpu/models/decoders/decoder.py``).

Supports the RNNsearch step (attention queried with the previous state,
the cell fed ``[prev_emb, context]``) and the Nematus-style conditional
GRU (cell1 -> attention -> cell2), the output projections maxout / mlp
/ linear, the initial state projected from the encoder outputs, and any
number of attentions, the multi-source combinators among them.

The loop state is the (B, H) recurrent state; with a stateful attention
(coverage) it is ``(state, attention states)``, one (B, T) coverage for
each stateful attention and None for the others.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ...model.part import Context, ModelPart, fold_seed, tensor
from ...model.stateful import Stateful
from ...ops import nn
from ...parallel import tensor as tp
from .autoregressive import AutoregressiveDecoder

_OUTPUT_PROJECTIONS = ("maxout", "mlp", "nonlinear", "linear")


class Decoder(AutoregressiveDecoder):

    def __init__(self, name: str,
                 vocabulary,
                 data_id: str,
                 max_output_len: int,
                 rnn_size: int = None,
                 encoders: List[Stateful] = None,
                 attentions: List = None,
                 embedding_size: int = None,
                 embeddings_source=None,
                 tie_embeddings: bool = False,
                 label_smoothing: float = None,
                 rnn_cell: str = "GRU",
                 conditional_gru: bool = False,
                 output_projection: str = "maxout",
                 maxout_size: int = None,
                 dropout_keep_prob: float = 1.0,
                 supress_unk: bool = False,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        super().__init__(
            name=name, vocabulary=vocabulary, data_id=data_id,
            max_output_len=max_output_len,
            dropout_keep_prob=dropout_keep_prob,
            embedding_size=embedding_size,
            embeddings_source=embeddings_source,
            tie_embeddings=tie_embeddings,
            label_smoothing=label_smoothing, supress_unk=supress_unk,
            reuse=reuse, save_checkpoint=save_checkpoint,
            load_checkpoint=load_checkpoint)
        self.encoders = encoders or []
        self.attentions = attentions or []
        if output_projection not in _OUTPUT_PROJECTIONS:
            raise ValueError(
                f"output_projection must be one of {_OUTPUT_PROJECTIONS}")
        self.output_projection = output_projection
        self.rnn_cell_type = rnn_cell
        self.conditional_gru = conditional_gru
        if rnn_cell == "LSTM":
            # the JAX Decoder fails for it too: its state is one (B, H)
            # array, which LSTMCell unpacks as (c, h)
            raise ValueError(
                "Decoder: rnn_cell 'LSTM' is not supported (the decoder "
                "state is a single (B, H) tensor); LSTM cells serve the "
                "encoders")
        if conditional_gru and rnn_cell not in ("GRU", "OrthoGRU"):
            raise ValueError("conditional_gru requires a GRU cell")
        self._stateful = any(getattr(att, "stateful_attention", False)
                             for att in self.attentions)

        if rnn_size is None:
            if not self.encoders:
                raise ValueError("Need rnn_size or encoders")
            rnn_size = sum(e.output_dim for e in self.encoders)
        self.rnn_size = rnn_size

        for att in self.attentions:
            att.register_query_dim(rnn_size)
        self.context_dim = sum(a.context_dim for a in self.attentions)

        if conditional_gru:
            self._cell1 = nn.make_cell(rnn_cell, self.embedding_size,
                                       rnn_size)
            self._cell2 = (nn.make_cell(rnn_cell, self.context_dim,
                                        rnn_size)
                           if self.attentions else None)
        else:
            self._cell1 = nn.make_cell(
                rnn_cell, self.embedding_size + self.context_dim, rnn_size)
            self._cell2 = None

        # pre-logit projection input: [state, prev_emb, contexts]
        self._prelogit_in = (rnn_size + self.embedding_size
                             + self.context_dim)
        self.maxout_size = (maxout_size if maxout_size is not None
                            else self.embedding_size)
        if output_projection == "maxout":
            self._prelogit_dim = self.maxout_size
        elif output_projection in ("mlp", "nonlinear"):
            self._prelogit_dim = self.embedding_size
        else:
            self._prelogit_dim = self._prelogit_in
        if tie_embeddings and self._prelogit_dim != self.embedding_size:
            raise ValueError(
                "tie_embeddings requires pre-logit dim == embedding size")

    @property
    def output_dim(self) -> int:
        return self.rnn_size

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        params: Dict[str, Any] = {"cell1": self._cell1.init(gen)}
        if self._cell2 is not None:
            params["cell2"] = self._cell2.init(gen)
        if self.encoders:
            enc_dim = sum(e.output_dim for e in self.encoders)
            params["initial_state"] = nn.linear_init(gen, enc_dim,
                                                     self.rnn_size)
        if self.output_projection == "maxout":
            params["prelogit"] = nn.maxout_init(gen, self._prelogit_in,
                                                self.maxout_size)
        elif self.output_projection in ("mlp", "nonlinear"):
            params["prelogit"] = nn.linear_init(gen, self._prelogit_in,
                                                self.embedding_size)
        if self.tie_embeddings:
            params["logit_bias"] = torch.zeros(len(self.vocabulary))
        else:
            params["logit"] = nn.linear_init(gen, self._prelogit_dim,
                                             len(self.vocabulary))
        return params

    # ------------------------------------------------------------------ #
    # shared step machinery
    # ------------------------------------------------------------------ #
    def _make_constants(self, ctx: Context) -> Dict[str, Any]:
        return {
            "params": ctx.get_params(self),
            "att_params": tuple(ctx.get_params(a) for a in self.attentions),
            "att_constants": tuple(a.precompute(ctx)
                                   for a in self.attentions),
            # per attention that drops its softmax weights in training,
            # the seed its teacher-forced steps fold their step into
            "att_dropout_seeds": tuple(
                ctx.site_seed(a, "attention_dropout")
                if ctx.train and getattr(a, "weights_dropout", False)
                and a.dropout_keep_prob < 1.0 else None
                for a in self.attentions),
            "embed_table": ctx.get_params(self.embeddings)["embeddings"],
        }

    def _att_initial_states(self, constants) -> Tuple:
        """Zero coverage for each stateful attention, None for others."""
        return tuple(
            torch.zeros_like(c.mask)
            if getattr(att, "stateful_attention", False) else None
            for att, c in zip(self.attentions, constants["att_constants"]))

    def _attend_all(self, constants, query, att_states, beam=None,
                    dropout_gens=None):
        """Every attention for one step: (contexts, weights, new
        attention states). With ``beam`` set (lineage beam decoding),
        beam-sharing attentions get their untiled constants and fold the
        beam axis in. ``dropout_gens`` (teacher-forced training only)
        holds this step's generator for each attention, or None."""
        contexts, weights, new_states = [], [], []
        for i, (att, p, c) in enumerate(zip(
                self.attentions, constants["att_params"],
                constants["att_constants"])):
            new_state = None
            if getattr(att, "stateful_attention", False):
                context, w, new_state = att.step_with_coverage(
                    p, c, query, att_states[i])
            elif beam is not None and att.beam_shared_constants:
                context, w = att.step_beamed(p, c, query, beam)
            else:
                context, w = att.step(
                    p, c, query,
                    dropout_gen=dropout_gens[i] if dropout_gens else None)
            contexts.append(context)
            weights.append(w)
            new_states.append(new_state)
        return contexts, weights, tuple(new_states)

    def _cell_step(self, constants, state, att_states, embedded_prev,
                   beam=None, dropout_gens=None, noise=None):
        """One decoder cell step: (new_state, prelogit_input, weights,
        new attention states). ``noise`` (teacher-forced training of a
        noisy-activation cell, which a conditional GRU never has) is this
        step's noise draw."""
        params = constants["params"]
        weights: List[torch.Tensor] = []
        context_cat = None
        if self.conditional_gru:
            new_state, _ = self._cell1(params["cell1"], state,
                                       embedded_prev)
            if self.attentions:
                contexts, weights, att_states = self._attend_all(
                    constants, new_state, att_states, beam, dropout_gens)
                context_cat = torch.cat(contexts, dim=-1)
                new_state, _ = self._cell2(params["cell2"], new_state,
                                           context_cat)
        else:
            cell_in = embedded_prev
            if self.attentions:
                contexts, weights, att_states = self._attend_all(
                    constants, state, att_states, beam, dropout_gens)
                context_cat = torch.cat(contexts, dim=-1)
                cell_in = torch.cat([embedded_prev, context_cat], dim=-1)
            new_state, _ = self._cell1(
                params["cell1"], state, cell_in,
                **({} if noise is None else {"noise": noise}))

        pieces = [new_state, embedded_prev]
        if context_cat is not None:
            pieces.append(context_cat)
        return new_state, torch.cat(pieces, dim=-1), weights, att_states

    def _prelogit(self, params, prelogit_in):
        if self.output_projection == "maxout":
            return nn.maxout(params["prelogit"], prelogit_in)
        if self.output_projection in ("mlp", "nonlinear"):
            return torch.tanh(nn.linear(params["prelogit"], prelogit_in))
        return prelogit_in

    def _logits(self, constants, prelogit):
        """Logits of ``prelogit``: this rank's part of the vocabulary
        where the projection is split (``vocab_split``)."""
        params = constants["params"]
        if self.vocab_split(params, constants["embed_table"]):
            prelogit = tp.copy_to(prelogit)
        if self.tie_embeddings:
            return nn.dot(prelogit, constants["embed_table"].T) \
                + params["logit_bias"]
        return nn.linear(params["logit"], prelogit)

    @tensor
    def initial_state(self, ctx: Context):
        if not self.encoders:
            return torch.zeros(self._batch_size(ctx), self.rnn_size,
                               device=self._device(ctx))
        enc_out = torch.cat([e.output(ctx) for e in self.encoders], dim=-1)
        s0 = torch.tanh(nn.linear(ctx.get_params(self)["initial_state"],
                                  enc_out))
        return ctx.dropout(self, s0, self.dropout_keep_prob,
                           "initial_state_dropout")

    # ------------------------------------------------------------------ #
    # teacher-forced training
    # ------------------------------------------------------------------ #
    @tensor
    def train_outputs(self, ctx: Context):
        """Teacher-forced pass over the target inputs, a Python loop
        over the steps where JAX scans: (prelogits (B, T, P), attention
        weight histories, one (B, T, T_src) per attention)."""
        constants = self._make_constants(ctx)
        embedded = self.embeddings.embed(ctx, self.train_inputs(ctx))
        embedded = ctx.dropout(self, embedded, self.dropout_keep_prob,
                               "embedding_dropout")
        state = self.initial_state(ctx)
        att_states = self._att_initial_states(constants)
        seeds = constants["att_dropout_seeds"]
        # a noisy-activation cell draws fresh noise every step
        noise = (self._cell1.draw_noise(
            embedded.shape[1], embedded.shape[0],
            ctx.make_rng(self, "cell_noise", embedded.device),
            embedded.device)
            if ctx.train and isinstance(self._cell1, nn.NoisyGRUCell)
            else None)
        prelogit_in, weights = [], []
        for t in range(embedded.shape[1]):
            # a fresh attention-dropout draw every step
            gens = (tuple(None if s is None else torch.Generator(
                device=embedded.device).manual_seed(fold_seed(s, t))
                for s in seeds) if any(s is not None for s in seeds)
                else None)
            state, step_in, step_weights, att_states = self._cell_step(
                constants, state, att_states, embedded[:, t],
                dropout_gens=gens,
                noise=None if noise is None else noise[t])
            prelogit_in.append(step_in)
            weights.append(step_weights)
        prelogit_in = ctx.dropout(self, torch.stack(prelogit_in, dim=1),
                                  self.dropout_keep_prob,
                                  "prelogit_dropout")
        prelogits = self._prelogit(constants["params"], prelogit_in)
        histories = tuple(torch.stack([w[i] for w in weights], dim=1)
                          for i in range(len(self.attentions)))
        return prelogits, histories

    @tensor
    def train_prelogit_states(self, ctx: Context):
        """(B, T, P) prelogit states: the fused cross-entropy's input."""
        prelogits, _ = self.train_outputs(ctx)
        return prelogits

    def train_logit_projection(self, ctx: Context):
        """(w, b, transposed) of the output projection in its own
        layout (tied: the (V, P) embedding table)."""
        params = ctx.get_params(self)
        if self.tie_embeddings:
            table = ctx.get_params(self.embeddings)["embeddings"]
            return table, params["logit_bias"], True
        logit = params["logit"]
        b = logit.get("b")
        if b is None:
            b = logit["w"].new_zeros(logit["w"].shape[1])
        return logit["w"], b, False

    @tensor
    def train_split_logits(self, ctx: Context):
        prelogits, _ = self.train_outputs(ctx)
        return self._logits(self._make_constants(ctx), prelogits)

    @tensor
    def train_attention_weights(self, ctx: Context):
        """The teacher-forced pass's attention weight histories, one
        (B, T, T_src) per attention."""
        _, weights = self.train_outputs(ctx)
        return weights

    def _finish_step(self, constants, loop_state, prev_ids, beam=None):
        state, att_states = self._split_state(loop_state, constants)
        embedded_prev = tp.embedding(prev_ids, constants["embed_table"])
        new_state, prelogit_in, weights, att_states = self._cell_step(
            constants, state, att_states, embedded_prev, beam=beam)
        prelogit = self._prelogit(constants["params"], prelogit_in)
        logits, sel_aux = self._step_logits(
            constants, prelogit, lambda: self._logits(constants, prelogit))
        return (self._join_state(new_state, att_states), logits,
                {"attention_weights": tuple(weights), **sel_aux})

    def _split_state(self, loop_state, constants):
        if self._stateful:
            return loop_state
        return loop_state, (None,) * len(constants["att_constants"])

    def _join_state(self, state, att_states):
        return (state, att_states) if self._stateful else state

    # ------------------------------------------------------------------ #
    # decode contract
    # ------------------------------------------------------------------ #
    def decode_constants(self, ctx: Context):
        return self._make_constants(ctx)

    def decode_initial_state(self, ctx: Context, constants):
        return self._join_state(self.initial_state(ctx),
                                self._att_initial_states(constants))

    def decode_step(self, constants: Dict[str, Any],
                    loop_state: Any, prev_ids: torch.Tensor,
                    step: int):
        """One step of every row: greedy decoding's, and the physical
        beam search's over B·K rows, where each attention takes its
        plain ``step`` on tiled constants (Bahdanau's through K2)."""
        del step
        return self._finish_step(constants, loop_state, prev_ids)

    def tile_decode_constants(self, constants, k: int):
        """Constants for B·K rows: each attention repeats its
        batch-dimensioned constants k times (``tile_constants``); the
        parameters and the embedding table stay as they are."""
        tiled = dict(constants)
        tiled["att_constants"] = tuple(
            att.tile_constants(c, k)
            for att, c in zip(self.attentions, constants["att_constants"]))
        return tiled

    # ------------------------------------------------------------------ #
    # lineage decoding: the RNN state is one small vector per beam; the
    # gain is that attention constants stay shared across the beam
    # ------------------------------------------------------------------ #
    lineage_decode = True
    reads_ancestry = False
    emits_attention = True

    def tile_decode_constants_lineage(self, constants, k: int):
        """Constants for K beams: parameters, the embedding table and
        beam-sharing attention constants stay as they are."""
        tiled = dict(constants)
        tiled["att_constants"] = tuple(
            att.tile_constants_lineage(c, k)
            for att, c in zip(self.attentions, constants["att_constants"]))
        return tiled

    def decode_step_lineage(self, constants, loop_state, prev_ids, step,
                            anc, beam: int, window: int = None):
        """The recurrent state is gathered here by the previous
        selection's parents, ``anc[:, :, step - 1]`` (the identity at
        step 0); an RNN state is one vector per beam, so the parents are
        all of the lineage it reads. ``window`` bounds cache reads; the
        RNN has no position-indexed cache."""
        del window
        batch = prev_ids.shape[0] // beam
        parents = anc[:, :, max(step - 1, 0)].long()
        rows = (torch.arange(batch, device=parents.device)[:, None] * beam
                + parents).reshape(-1)
        return self._finish_step(
            constants, self._map_state(
                loop_state, lambda x: x.index_select(0, rows)),
            prev_ids, beam=beam)

    def tile_decode_state(self, state: Any, beam: int,
                          lineage: bool = True) -> Any:
        """Both forms of the search start from the state's rows, the
        coverage too, each repeated ``beam`` times."""
        del lineage
        return self._map_state(
            state, lambda x: x.repeat_interleave(beam, dim=0))

    def _map_state(self, loop_state, fn):
        """``fn`` on every tensor of the loop state (the coverage too)."""
        if not self._stateful:
            return fn(loop_state)
        state, att_states = loop_state
        return fn(state), tuple(None if s is None else fn(s)
                                for s in att_states)
