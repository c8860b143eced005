"""Transformer decoder (counterpart of
``neuralmonkey_tpu/models/decoders/transformer.py``).

Teacher-forced training is one causal pass over the whole target: the
self-attention goes through flash attention with an all-ones key mask
and the causal flag, the cross-attention through flash attention with
the source mask (``ops/flash_attention.py``). Incremental decoding
implements the AutoregressiveDecoder contract: per-layer (B, T, D) KV
caches in the loop state, written in place at ``step``, and the
cross-attention keys and values projected once per sentence in
``decode_constants``. Several encoders are attended one after another.

Beam search decodes by lineage: the caches are never reordered, each
slot writes its own rows, and the self-attention resolves the ancestry
``anc`` in score space (``decode_step_lineage``), as einsums by default
or, under ``NM_LINEAGE_KERNEL=1``, through the lineage attention kernel
on caches in its layout (``ops/lineage_attention.py``).

Not ported yet: mixture-of-experts FFNs (A12), pipeline stages (A15),
bf16 lineage caches (``NM_LINEAGE_KERNEL_BF16``, with the bf16 policy)
and the attention map of the decode steps; each raises or is absent.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ...model.part import Context, ModelPart, tensor
from ...ops import nn
from ...ops.attention import (NEG_INF, attention_bias_from_mask,
                              dot_product_attention, ffn, ffn_init,
                              layer_norm, layer_norm_init, merge_heads,
                              mha_init, multi_head_attention,
                              seeded_dropout, sinusoidal_position_encoding,
                              split_heads)
from ...ops.lineage_attention import (lane_window, lineage_attention,
                                      lineage_bias)
from ..encoders.transformer import refuse_unported, run_layer
from .autoregressive import AutoregressiveDecoder


def lineage_kernel_layout() -> bool:
    """Whether beam search keeps the caches in the lineage kernel's
    layout: ``NM_LINEAGE_KERNEL=1`` (opt-in as in the JAX package). The
    kernel takes every shape, so no shape decides."""
    if os.environ.get("NM_LINEAGE_KERNEL_BF16") == "1":
        raise NotImplementedError(
            "NM_LINEAGE_KERNEL_BF16=1: bf16 lineage caches come with the "
            "bf16 policy, which is not ported to neuralmonkey_tpu_torch yet")
    return os.environ.get("NM_LINEAGE_KERNEL") == "1"


class TransformerDecoder(AutoregressiveDecoder):

    def __init__(self, name: str,
                 vocabulary,
                 data_id: str,
                 max_output_len: int,
                 encoders: List = None,
                 encoder=None,
                 ff_hidden_size: int = None,
                 depth: int = 6,
                 n_heads_self: int = 8,
                 n_heads_enc: int = 8,
                 embedding_size: int = None,
                 embeddings_source=None,
                 tie_embeddings: bool = True,
                 label_smoothing: float = None,
                 dropout_keep_prob: float = 0.9,
                 attention_dropout_keep_prob: float = 1.0,
                 supress_unk: bool = False,
                 remat: bool = False,
                 pipeline_stages: int = 0,
                 pipeline_microbatches: int = 0,
                 moe_experts: int = 0,
                 moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.5,
                 moe_aux_weight: float = 0.01,
                 moe_router_noise: float = 0.0,
                 moe_z_loss_weight: float = 0.0,
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
        del (pipeline_microbatches, moe_top_k, moe_capacity_factor,
             moe_aux_weight, moe_router_noise, moe_z_loss_weight)
        refuse_unported(name, moe_experts, pipeline_stages)
        if encoders is None:
            encoders = [encoder] if encoder is not None else []
        self.encoders = encoders
        self.model_dim = self.embedding_size
        self.ff_hidden_size = ff_hidden_size or 4 * self.model_dim
        self.depth = depth
        self.n_heads_self = n_heads_self
        self.n_heads_enc = n_heads_enc
        self.attention_dropout_keep_prob = attention_dropout_keep_prob
        self.remat = remat
        if self.model_dim % n_heads_self or (
                encoders and self.model_dim % n_heads_enc):
            raise ValueError("model dim must divide the head counts")
        # Transformer convention: target embeddings scaled by sqrt(d)
        self.embeddings.scale_embeddings_by_depth = True

    # ------------------------------------------------------------------ #
    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        for i in range(self.depth):
            layer = {
                "ln_self": layer_norm_init(self.model_dim),
                "self_att": mha_init(gen, self.model_dim, self.model_dim,
                                     self.model_dim),
                "ln_ff": layer_norm_init(self.model_dim),
                "ff": ffn_init(gen, self.model_dim, self.ff_hidden_size),
            }
            for e, enc in enumerate(self.encoders):
                layer[f"ln_cross_{e}"] = layer_norm_init(self.model_dim)
                layer[f"cross_att_{e}"] = mha_init(
                    gen, self.model_dim, enc.state_dim, self.model_dim)
            params[f"layer_{i}"] = layer
        params["ln_out"] = layer_norm_init(self.model_dim)
        if self.tie_embeddings:
            params["logit_bias"] = torch.zeros(len(self.vocabulary))
        else:
            params["logit"] = nn.linear_init(gen, self.model_dim,
                                             len(self.vocabulary))
        return params

    def _logits_from_states(self, params, embed_table, states):
        if self.tie_embeddings:
            return states @ embed_table.T + params["logit_bias"]
        return nn.linear(params["logit"], states)

    # ------------------------------------------------------------------ #
    # teacher-forced training
    # ------------------------------------------------------------------ #
    def _train_layer_fn(self, layer, x, all_keys_mask, enc_data, seeds):
        """One decoder layer (self-attention, cross-attentions, FFN);
        ``seeds`` holds the dropout seeds of its sites."""
        keep = self.dropout_keep_prob
        normed = layer_norm(layer["ln_self"], x)
        att = multi_head_attention(
            layer["self_att"], normed, normed, normed, self.n_heads_self,
            dropout_seed=seeds["self_att"],
            dropout_keep_prob=self.attention_dropout_keep_prob,
            key_mask=all_keys_mask, causal=True)
        x = x + seeded_dropout(att, keep, seeds["res_self"])
        for e, (enc_states, enc_mask) in enumerate(enc_data):
            normed = layer_norm(layer[f"ln_cross_{e}"], x)
            cross = multi_head_attention(
                layer[f"cross_att_{e}"], normed, enc_states, enc_states,
                self.n_heads_enc, key_mask=enc_mask)
            x = x + seeded_dropout(cross, keep, seeds["res_cross"][e])
        normed = layer_norm(layer["ln_ff"], x)
        return x + seeded_dropout(ffn(layer["ff"], normed), keep,
                                  seeds["res_ff"])

    def _train_layer_seeds(self, ctx: Context, i: int, n_enc: int):
        """Per-layer dropout seeds at the JAX package's sites
        (``_train_layer_rngs``), drawn outside the layer."""
        res_drop = ctx.train and self.dropout_keep_prob < 1.0
        att_drop = ctx.train and self.attention_dropout_keep_prob < 1.0

        def seed(site, on) -> Optional[int]:
            return ctx.site_seed(self, site) if on else None
        return {"self_att": seed(f"self_att_drop_{i}", att_drop),
                "res_self": seed(f"res_self_{i}", res_drop),
                "res_cross": [seed(f"res_cross_{i}_{e}", res_drop)
                              for e in range(n_enc)],
                "res_ff": seed(f"res_ff_{i}", res_drop)}

    @tensor
    def train_prelogit_states(self, ctx: Context):
        """(B, T, D) teacher-forced states after the output layer norm:
        everything in :meth:`train_logits` but the vocabulary
        projection (the fused cross-entropy's input)."""
        params = ctx.get_params(self)
        x = self.embeddings.embed(ctx, self.train_inputs(ctx))
        batch, time = x.shape[:2]
        x = x + sinusoidal_position_encoding(
            time, self.model_dim, x.dtype, x.device)[None]
        x = ctx.dropout(self, x, self.dropout_keep_prob, "input_dropout")
        all_keys_mask = x.new_ones(batch, time)
        enc_data = [(enc.temporal_states(ctx),
                     enc.temporal_mask(ctx).to(torch.float32))
                    for enc in self.encoders]
        for i in range(self.depth):
            x = run_layer(self._train_layer_fn, self.remat and ctx.train,
                          params[f"layer_{i}"], x, all_keys_mask, enc_data,
                          self._train_layer_seeds(ctx, i, len(enc_data)))
        return layer_norm(params["ln_out"], x)

    @tensor
    def train_logits(self, ctx: Context):
        table = ctx.get_params(self.embeddings)["embeddings"]
        return self._logits_from_states(
            ctx.get_params(self), table, self.train_prelogit_states(ctx))

    def train_logit_projection(self, ctx: Context):
        """(w, b, transposed) of the output projection in its own
        layout (tied: the (V, D) embedding table): the fused-xent
        seam."""
        params = ctx.get_params(self)
        if self.tie_embeddings:
            table = ctx.get_params(self.embeddings)["embeddings"]
            return table, params["logit_bias"], True
        logit = params["logit"]
        b = logit.get("b")
        if b is None:
            b = logit["w"].new_zeros(logit["w"].shape[1])
        return logit["w"], b, False

    # ------------------------------------------------------------------ #
    # incremental decoding (greedy and beam search)
    # ------------------------------------------------------------------ #
    def decode_constants(self, ctx: Context) -> Dict[str, Any]:
        """Parameters, the embedding table, the position table, and per
        encoder and layer the cross-attention keys and values, projected
        once per sentence and split into heads (B, H, S, Dh), with the
        source's additive bias (B, 1, 1, S)."""
        params = ctx.get_params(self)
        table = ctx.get_params(self.embeddings)["embeddings"]
        constants: Dict[str, Any] = {
            "params": params, "embed_table": table,
            "positions": sinusoidal_position_encoding(
                self.max_output_len, self.model_dim, table.dtype,
                table.device),
            "enc_kv": [], "enc_bias": []}
        for e, enc in enumerate(self.encoders):
            states = enc.temporal_states(ctx)
            per_layer = []
            for i in range(self.depth):
                att_p = params[f"layer_{i}"][f"cross_att_{e}"]
                per_layer.append(tuple(
                    split_heads(nn.linear(att_p[p], states),
                                self.n_heads_enc).contiguous()
                    for p in ("k", "v")))
            constants["enc_kv"].append(per_layer)
            constants["enc_bias"].append(
                attention_bias_from_mask(enc.temporal_mask(ctx)))
        return constants

    def tile_decode_constants_lineage(self, constants, k: int):
        """The cross-attention keys, values and masks are the same for
        every beam: one copy per sentence, shared by the K beams."""
        return dict(constants)

    def decode_initial_state(self, ctx: Context, constants):
        """Per layer, zero (B, max_output_len, D) key and value caches."""
        batch = self._batch_size(ctx)
        table = constants["embed_table"]
        return tuple(
            {name: table.new_zeros(batch, self.max_output_len,
                                   self.model_dim)
             for name in ("k", "v")}
            for _ in range(self.depth))

    def tile_decode_state(self, state, beam: int):
        """Caches for B·K beam rows: (B·K, T, D) rows for the einsum
        lineage step, or under ``NM_LINEAGE_KERNEL=1`` the lineage
        kernel's layout, ``kq`` (B, H, Dh, K·T) and ``vq`` (B, H, K·T,
        Dh) with lane ``t·K + j`` (``tile_decode_state`` :579-614)."""
        batch = state[0]["k"].shape[0]
        zeros = state[0]["k"].new_zeros
        heads = self.n_heads_self
        head_dim = self.model_dim // heads
        if not lineage_kernel_layout():
            return tuple({name: zeros(batch * beam, self.max_output_len,
                                      self.model_dim)
                          for name in ("k", "v")}
                         for _ in range(self.depth))
        lanes = beam * self.max_output_len
        return tuple({"kq": zeros(batch, heads, head_dim, lanes),
                      "vq": zeros(batch, heads, lanes, head_dim)}
                     for _ in range(self.depth))

    def _embed_step(self, constants, prev_ids, step: int):
        """(rows, 1, D) embedded previous tokens at position ``step``."""
        x = F.embedding(prev_ids.long(), constants["embed_table"])
        x = x * math.sqrt(self.model_dim) + constants["positions"][step]
        return x[:, None, :]

    def _cross_ffn(self, layer, x, constants, i: int, beam: int = 1):
        """A decode layer's cross-attention(s) and FFN. With ``beam`` the
        rows are (sentence, slot) pairs and the K slots of a sentence
        share its keys: the slots fold into the query axis."""
        heads = self.n_heads_enc
        rows = x.shape[0]
        for e in range(len(self.encoders)):
            att_p = layer[f"cross_att_{e}"]
            q = nn.linear(att_p["q"], layer_norm(layer[f"ln_cross_{e}"], x))
            q = q.reshape(rows // beam, beam, heads, -1).transpose(1, 2)
            k_enc, v_enc = constants["enc_kv"][e][i]
            cross = dot_product_attention(q, k_enc, v_enc,
                                          constants["enc_bias"][e])
            x = x + nn.linear(att_p["o"],
                              merge_heads(cross).reshape(rows, 1, -1))
        return x + ffn(layer["ff"], layer_norm(layer["ln_ff"], x))

    def _finish(self, constants, x):
        x = layer_norm(constants["params"]["ln_out"], x)[:, 0, :]
        return self._step_logits(
            constants, x, lambda: self._logits_from_states(
                constants["params"], constants["embed_table"], x))

    def decode_step(self, constants, loop_state, prev_ids, step: int):
        """One greedy step: the caches are written in place at ``step``
        and attended up to it."""
        params = constants["params"]
        x = self._embed_step(constants, prev_ids, step)
        for i, cache in enumerate(loop_state):
            layer = params[f"layer_{i}"]
            att_p = layer["self_att"]
            normed = layer_norm(layer["ln_self"], x)
            q, k_t, v_t = (nn.linear(att_p[p], normed) for p in "qkv")
            cache["k"][:, step] = k_t[:, 0]
            cache["v"][:, step] = v_t[:, 0]
            heads = self.n_heads_self
            att = dot_product_attention(
                split_heads(q, heads),
                split_heads(cache["k"][:, :step + 1], heads),
                split_heads(cache["v"][:, :step + 1], heads))
            x = x + nn.linear(att_p["o"], merge_heads(att))
            x = self._cross_ffn(layer, x, constants, i)
        logits, sel_aux = self._finish(constants, x)
        return loop_state, logits, sel_aux

    # ------------------------------------------------------------------ #
    # lineage decoding: beam search without reordering the caches
    # ------------------------------------------------------------------ #
    lineage_decode = True

    def decode_step_lineage(self, constants, loop_state, prev_ids,
                            step: int, anc: torch.Tensor, beam: int,
                            window: int = None):
        """Beam-search step with the self-attention's ancestry resolved
        in score space: scores against every slot's cache rows, reduced
        through the one-hot ancestry ``anc`` (B, K, T), so that each
        hypothesis attends to the rows its own lineage wrote. Only the
        first ``window`` positions are read (every later one is still
        unwritten)."""
        params = constants["params"]
        rows = prev_ids.shape[0]
        batch = rows // beam
        length = self.max_output_len
        win = length if window is None else min(window, length)
        heads = self.n_heads_self
        head_dim = self.model_dim // heads
        kernel_layout = "kq" in loop_state[0]
        if kernel_layout:
            lanes = lane_window(win, beam, beam * length)
            # one bias per step, shared by every layer and head
            lin_bias = lineage_bias(anc, step, win, beam, lanes, length)
        else:
            cache_bias = torch.where(
                torch.arange(win, device=anc.device) <= step, 0.0, NEG_INF)
            # one-hot lineage (B, K, J, W), shared by every layer
            lineage = (anc[:, :, None, :win] == torch.arange(
                beam, device=anc.device)[None, None, :, None]).to(
                    constants["embed_table"].dtype)

        x = self._embed_step(constants, prev_ids, step)
        for i, cache in enumerate(loop_state):
            layer = params[f"layer_{i}"]
            att_p = layer["self_att"]
            normed = layer_norm(layer["ln_self"], x)
            q, k_t, v_t = (
                nn.linear(att_p[p], normed).reshape(batch, beam, heads,
                                                    head_dim)
                for p in "qkv")
            if kernel_layout:
                # each step writes K contiguous lanes t·K + j
                cache["kq"][..., step * beam:(step + 1) * beam] = \
                    k_t.permute(0, 2, 3, 1)
                cache["vq"][:, :, step * beam:(step + 1) * beam] = \
                    v_t.transpose(1, 2)
                ctx4 = lineage_attention(q.transpose(1, 2).contiguous(),
                                         cache["kq"], cache["vq"], lin_bias)
                att = ctx4.transpose(1, 2)
            else:
                # each slot writes its own row, never reordered
                cache["k"][:, step] = k_t.reshape(rows, -1)
                cache["v"][:, step] = v_t.reshape(rows, -1)
                kh = cache["k"][:, :win].reshape(batch, beam, win, heads,
                                                 head_dim)
                vh = cache["v"][:, :win].reshape(batch, beam, win, heads,
                                                 head_dim)
                s_full = torch.einsum("bkhd,bjthd->bhkjt", q, kh) \
                    * (1.0 / math.sqrt(head_dim))
                s = torch.einsum("bhkjt,bkjt->bhkt", s_full, lineage)
                weights = torch.softmax(s + cache_bias, dim=-1)
                w_slot = torch.einsum("bhkt,bkjt->bhkjt", weights, lineage)
                att = torch.einsum("bhkjt,bjthd->bkhd", w_slot, vh)
            x = x + nn.linear(att_p["o"], att.reshape(rows, 1, -1))
            x = self._cross_ffn(layer, x, constants, i, beam)
        logits, sel_aux = self._finish(constants, x)
        return loop_state, logits, sel_aux
