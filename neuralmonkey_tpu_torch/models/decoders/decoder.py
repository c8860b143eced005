"""Attentive RNN decoder (counterpart of
``neuralmonkey_tpu/models/decoders/decoder.py``).

Supports the RNNsearch step (attention queried with the previous state,
the cell fed ``[prev_emb, context]``) and the Nematus-style conditional
GRU (cell1 -> attention -> cell2), the output projections maxout / mlp
/ linear, and the initial state projected from the encoder outputs.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ...model.part import Context, ModelPart, tensor
from ...model.stateful import Stateful
from ...ops import nn
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
        for att in self.attentions:
            if getattr(att, "stateful_attention", False):
                raise NotImplementedError(
                    f"stateful attention ({att.name}) is not ported yet")

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
            "embed_table": ctx.get_params(self.embeddings)["embeddings"],
        }

    def _attend_all(self, constants, query, beam=None):
        """Every attention for one step: (contexts, weights). With
        ``beam`` set (lineage beam decoding), beam-sharing attentions
        get their untiled constants and fold the beam axis in."""
        contexts, weights = [], []
        for att, p, c in zip(self.attentions, constants["att_params"],
                             constants["att_constants"]):
            if beam is not None and att.beam_shared_constants:
                context, w = att.step_beamed(p, c, query, beam)
            else:
                context, w = att.step(p, c, query)
            contexts.append(context)
            weights.append(w)
        return contexts, weights

    def _cell_step(self, constants, state, embedded_prev, beam=None):
        """One decoder cell step: (new_state, prelogit_input, weights)."""
        params = constants["params"]
        weights: List[torch.Tensor] = []
        context_cat = None
        if self.conditional_gru:
            new_state, _ = self._cell1(params["cell1"], state,
                                       embedded_prev)
            if self.attentions:
                contexts, weights = self._attend_all(constants, new_state,
                                                     beam)
                context_cat = torch.cat(contexts, dim=-1)
                new_state, _ = self._cell2(params["cell2"], new_state,
                                           context_cat)
        else:
            cell_in = embedded_prev
            if self.attentions:
                contexts, weights = self._attend_all(constants, state, beam)
                context_cat = torch.cat(contexts, dim=-1)
                cell_in = torch.cat([embedded_prev, context_cat], dim=-1)
            new_state, _ = self._cell1(params["cell1"], state, cell_in)

        pieces = [new_state, embedded_prev]
        if context_cat is not None:
            pieces.append(context_cat)
        return new_state, torch.cat(pieces, dim=-1), weights

    def _prelogit(self, params, prelogit_in):
        if self.output_projection == "maxout":
            return nn.maxout(params["prelogit"], prelogit_in)
        if self.output_projection in ("mlp", "nonlinear"):
            return torch.tanh(nn.linear(params["prelogit"], prelogit_in))
        return prelogit_in

    def _logits(self, constants, prelogit):
        params = constants["params"]
        if self.tie_embeddings:
            return prelogit @ constants["embed_table"].T \
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
        prelogit_in, weights = [], []
        for t in range(embedded.shape[1]):
            state, step_in, step_weights = self._cell_step(
                constants, state, embedded[:, t])
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
    def train_logits(self, ctx: Context):
        prelogits, _ = self.train_outputs(ctx)
        return self._logits(self._make_constants(ctx), prelogits)

    @tensor
    def train_attention_weights(self, ctx: Context):
        """The teacher-forced pass's attention weight histories, one
        (B, T, T_src) per attention."""
        _, weights = self.train_outputs(ctx)
        return weights

    def _finish_step(self, constants, state, prev_ids, beam=None):
        embedded_prev = F.embedding(prev_ids, constants["embed_table"])
        new_state, prelogit_in, weights = self._cell_step(
            constants, state, embedded_prev, beam=beam)
        prelogit = self._prelogit(constants["params"], prelogit_in)
        logits, sel_aux = self._step_logits(
            constants, prelogit, lambda: self._logits(constants, prelogit))
        return new_state, logits, {"attention_weights": tuple(weights),
                                   **sel_aux}

    # ------------------------------------------------------------------ #
    # decode contract
    # ------------------------------------------------------------------ #
    def decode_constants(self, ctx: Context):
        return self._make_constants(ctx)

    def decode_initial_state(self, ctx: Context, constants):
        return self.initial_state(ctx)

    def decode_step(self, constants: Dict[str, Any],
                    loop_state: torch.Tensor, prev_ids: torch.Tensor,
                    step: int):
        del step
        return self._finish_step(constants, loop_state, prev_ids)

    # ------------------------------------------------------------------ #
    # lineage decoding: the RNN state is one small vector per beam; the
    # gain is that attention constants stay shared across the beam
    # ------------------------------------------------------------------ #
    lineage_decode = True
    reads_ancestry = False

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
        return self._finish_step(constants, loop_state.index_select(0, rows),
                                 prev_ids, beam=beam)
