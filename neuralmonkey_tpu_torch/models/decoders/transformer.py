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
on caches in its layout (``ops/lineage_attention.py``). With lineage
decoding off (``lineage="off"``, ``NM_LINEAGE=0``) beam search takes the
physical reorder: the cross-attention constants are tiled to B·K rows
(``tile_decode_constants``), each step is ``decode_step`` over plain
(B·K, T, D) caches, whatever ``NM_LINEAGE_KERNEL`` says, and the search
gathers the caches by the chosen parents after each step.

With ``moe_experts > 1`` every FFN is a mixture of experts
(``ops/moe.py``): teacher-forced layers route the target tokens with
their capacity, padding masked out; every decode step (greedy, both
lineage forms and the physical reorder) routes its rows as one group
without dropping a token, the padding rows of a batch masked out
(``row_valid``).

Under the bf16 compute policy (``ops/policy.py``) the decode caches and
the projected cross-attention keys and values are bf16 (``_cache_dtype``);
``NM_LINEAGE_KERNEL_BF16=1`` keeps the lineage kernel's caches in bf16
under either policy, as in the JAX package.

The decode steps emit the attention map of the JAX package's
(``attention_weights``: the last layer's first cross-attention, averaged
over the heads) only on request: the JAX package computes it every step
and leaves XLA to drop it where nothing reads it, which eager PyTorch
cannot, so a step computes it where the decode constants carry the
request (``with_attention_maps``: the greedy runner's and the beam
runner's ``visualize_attention``), and a step without it runs the same
operations as it would without the map.

Under tensor parallelism (``param_partition_specs``) every layer's
attention and FFN weights hold this rank's heads and hidden columns and
the output projection its part of the vocabulary: teacher forcing and
every decode step run on the local heads (the KV caches, in both
lineage forms, hold this rank's heads) and a step's logits are gathered
whole. Under sequence sharding the teacher-forced residual stream
splits its time axis over the model axis between the blocks; under
context parallelism over the context axis, the self-attention through
the causal zigzag ring and the cross-attention through the contiguous
ring where the encoder's stream is split too, and the loss is summed
over the slices. Decode steps (one query) are never split: they run on
the whole time axis, as at one device.

With ``pipeline_stages`` the layers stack on a leading layer axis as in
the encoder (``stacked_partition_specs``): the teacher-forced pass runs
them through the GPipe executor (``parallel/pipeline.py``), the encoder
states and masks travelling with each microbatch, or one after another
where the executor does not apply; the incremental decode reads the
stacked layers one by one, gathered whole over the pipe group once a
decode (``decode_constants``).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional

import torch

from ...model.part import Context, ModelPart, tensor
from ...ops import nn, sharding
from ...ops.attention import (NEG_INF, attend, attention_bias_from_mask,
                              attention_weights, column_projection,
                              dot_product_attention, ffn, layer_norm,
                              layer_norm_init, merge_heads, mha_init,
                              mha_partition_specs, multi_head_attention,
                              row_projection, seeded_dropout,
                              sinusoidal_position_encoding, split_heads)
from ...parallel import pipeline
from ...parallel import tensor as tp
from ...parallel.fsdp import replace_items
from ...ops.lineage_attention import (lane_window, lineage_attention,
                                      lineage_bias)
from ...ops.policy import compute_dtype
from ..encoders.transformer import (MoESettings, check_pipeline,
                                    layer_params_on_slice, run_layer,
                                    stacked_partition_specs)
from .autoregressive import AutoregressiveDecoder


def lineage_kernel_layout() -> bool:
    """Whether beam search keeps the caches in the lineage kernel's
    layout: ``NM_LINEAGE_KERNEL=1`` (opt-in as in the JAX package). The
    kernel takes every shape, so no shape decides."""
    return os.environ.get("NM_LINEAGE_KERNEL") == "1"


def cache_dtype(table: torch.Tensor) -> torch.dtype:
    """The decode caches' dtype (``_cache_dtype``): the compute
    policy's, float32 without one; a float64 model (a reference check on
    the CPU) keeps float64."""
    if table.dtype == torch.float64:
        return torch.float64
    return compute_dtype() or torch.float32


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
        check_pipeline(depth, pipeline_stages, pipeline_microbatches)
        # GPipe for the teacher-forced pass (see TransformerEncoder)
        self.pipeline_stages = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches
        self.moe = MoESettings(moe_experts, moe_top_k, moe_capacity_factor,
                               moe_aux_weight, moe_router_noise,
                               moe_z_loss_weight)
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
        layers = []
        for _ in range(self.depth):
            layer = {
                "ln_self": layer_norm_init(self.model_dim),
                "self_att": mha_init(gen, self.model_dim, self.model_dim,
                                     self.model_dim),
                "ln_ff": layer_norm_init(self.model_dim),
                "ff": self.moe.ffn_init(gen, self.model_dim,
                                        self.ff_hidden_size),
            }
            for e, enc in enumerate(self.encoders):
                layer[f"ln_cross_{e}"] = layer_norm_init(self.model_dim)
                layer[f"cross_att_{e}"] = mha_init(
                    gen, self.model_dim, enc.state_dim, self.model_dim)
            layers.append(layer)
        if self.pipeline_stages > 1:
            params["layers"] = pipeline.stack_layers(layers)
        else:
            for i, layer in enumerate(layers):
                params[f"layer_{i}"] = layer
        params["ln_out"] = layer_norm_init(self.model_dim)
        if self.tie_embeddings:
            params["logit_bias"] = torch.zeros(len(self.vocabulary))
        else:
            params["logit"] = nn.linear_init(gen, self.model_dim,
                                             len(self.vocabulary))
        return params

    def param_partition_specs(self) -> Dict[str, tuple]:
        """The base class's vocabulary specs, and each layer's self- and
        cross-attention and FFN split Megatron-style over the model
        axis (``ops/attention.mha_partition_specs``); with pipeline
        stages the stacked layers' (``stacked_partition_specs``)."""
        specs = dict(super().param_partition_specs())
        if self.pipeline_stages > 1:
            n_enc = len(self.encoders)
            specs.update(stacked_partition_specs(
                ["ln_self", "ln_ff"] + [f"ln_cross_{e}" for e in range(n_enc)],
                ["self_att"] + [f"cross_att_{e}" for e in range(n_enc)],
                self.moe.on))
            return specs
        for i in range(self.depth):
            specs.update(mha_partition_specs(f"layer_{i}/self_att"))
            for e in range(len(self.encoders)):
                specs.update(mha_partition_specs(f"layer_{i}/cross_att_{e}"))
            specs.update(self.moe.partition_specs(f"layer_{i}/ff"))
        return specs

    def _layer_params(self, params, i: int):
        """Layer ``i``'s parameters under either layout (per-layer dicts,
        or the pipeline's stacked leading axis: a decode's constants hold
        them whole)."""
        if self.pipeline_stages > 1:
            return pipeline.layer_params(params["layers"], i)
        return params[f"layer_{i}"]

    def _logits_from_states(self, params, embed_table, states):
        """Logits of ``states``: this rank's part of the vocabulary where
        the projection is split."""
        if self.vocab_split(params, embed_table):
            states = tp.copy_to(states)
        if self.tie_embeddings:
            return nn.dot(states, embed_table.T) + params["logit_bias"]
        return nn.linear(params["logit"], states)

    # ------------------------------------------------------------------ #
    # teacher-forced training
    # ------------------------------------------------------------------ #
    def _train_layer_fn(self, layer, x, all_keys_mask, enc_data, seeds,
                        moe_mask=None, stream=None, stats=False):
        """One decoder layer (self-attention, cross-attentions, FFN);
        ``seeds`` holds the dropout and router noise seeds of its sites,
        ``enc_data`` each encoder's (states, mask, whether they are this
        rank's ring slice), ``stream`` the axis the residual stream is
        split over. With MoE FFNs it also returns the layer's auxiliary
        losses."""
        keep = self.dropout_keep_prob
        layer = layer_params_on_slice(layer, stream, self.moe.on)
        normed = layer_norm(layer["ln_self"], x)
        att = multi_head_attention(
            layer["self_att"], normed, normed, normed, self.n_heads_self,
            dropout_seed=seeds["self_att"],
            dropout_keep_prob=self.attention_dropout_keep_prob,
            key_mask=all_keys_mask, causal=True, stream=stream,
            ring=stream == "context")
        x = x + seeded_dropout(att, keep,
                               sharding.shard_seed(seeds["res_self"],
                                                   (stream,)))
        for e, (enc_states, enc_mask, enc_ring) in enumerate(enc_data):
            normed = layer_norm(layer[f"ln_cross_{e}"], x)
            cross = multi_head_attention(
                layer[f"cross_att_{e}"], normed, enc_states, enc_states,
                self.n_heads_enc, key_mask=enc_mask, stream=stream,
                ring=enc_ring)
            x = x + seeded_dropout(cross, keep, sharding.shard_seed(
                seeds["res_cross"][e], (stream,)))
        normed = layer_norm(layer["ln_ff"], x)
        res_ff = sharding.shard_seed(seeds["res_ff"], (stream,))
        if self.moe.on:
            ff_out, aux = self.moe(layer["ff"], normed, moe_mask, seeds,
                                   stream=stream, stats=stats)
            return x + seeded_dropout(ff_out, keep, res_ff), aux
        return x + seeded_dropout(ffn(layer["ff"], normed, stream=stream),
                                  keep, res_ff)

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
                "res_ff": seed(f"res_ff_{i}", res_drop),
                "moe_noise": seed(f"moe_noise_{i}",
                                  self.moe.noisy(ctx.train))}

    def train_time_axis(self, ctx: Context) -> Optional[str]:
        """``context`` where the teacher-forced stream splits its time
        axis over the context axis (its logits and loss are then this
        rank's slice's)."""
        axis = sharding.stream_axis(self.train_inputs(ctx).shape[1])
        return axis if axis == "context" else None

    def _encoder_data(self, ctx: Context, stream: Optional[str]):
        """Each encoder's (states, float32 mask, ring): under context
        parallelism, where its stream is split too, this rank's slice
        for the ring; else the whole states."""
        data = []
        for enc in self.encoders:
            split = getattr(enc, "split_temporal_states", None)
            if stream == "context" and split is not None:
                states, mask, axis = split(ctx)
                if axis == "context":
                    data.append((states, mask, True))
                    continue
            data.append((enc.temporal_states(ctx),
                         enc.temporal_mask(ctx).to(torch.float32), False))
        return data

    @tensor
    def train_prelogit_states(self, ctx: Context):
        """(B, T, D) teacher-forced states after the output layer norm:
        everything in :meth:`train_logits` but the vocabulary
        projection (the fused cross-entropy's input); this rank's slice
        of the time axis under context parallelism."""
        params = ctx.get_params(self)
        x = self.embeddings.embed(ctx, self.train_inputs(ctx))
        batch, time = x.shape[:2]
        x = x + sinusoidal_position_encoding(
            time, self.model_dim, x.dtype, x.device)[None]
        x = ctx.dropout(self, x, self.dropout_keep_prob, "input_dropout")
        stream = sharding.stream_axis(time)
        x = sharding.constrain_sequence(x, stream)
        all_keys_mask = x.new_ones(
            batch, x.shape[1] if stream == "context" else time,
            dtype=nn.widened(x.dtype))
        enc_data = self._encoder_data(ctx, stream)
        # padding tokens take no expert capacity and stay out of the
        # auxiliary losses
        moe_mask = self.train_mask(ctx) if self.moe.on else None
        remat = self.remat and ctx.train
        if self.pipeline_stages > 1:
            # the encoder states and masks travel with each microbatch
            x = self.moe.run_layers(
                self, ctx, lambda layer, h, aux, seeds, stats: run_layer(
                    self._train_layer_fn, remat, layer, h, aux["mask"],
                    aux["enc"], seeds, aux["moe_mask"], stream, stats),
                params, x,
                lambda i: self._train_layer_seeds(ctx, i, len(enc_data)),
                {"mask": all_keys_mask, "enc": enc_data,
                 "moe_mask": moe_mask},
                self.pipeline_stages, self.pipeline_microbatches)
        else:
            auxes = []
            for i in range(self.depth):
                x = run_layer(self._train_layer_fn, remat,
                              params[f"layer_{i}"], x, all_keys_mask,
                              enc_data,
                              self._train_layer_seeds(ctx, i, len(enc_data)),
                              moe_mask, stream)
                if self.moe.on:
                    x, aux = x
                    auxes.append(aux)
            self.moe.add_losses(self, ctx, auxes)
        if stream == "model":
            x, stream = sharding.gather_sequence(x, stream), None
        return layer_norm(sharding.slice_params(params["ln_out"], stream),
                          x)

    @tensor
    def train_split_logits(self, ctx: Context):
        table = ctx.get_params(self.embeddings)["embeddings"]
        params = ctx.get_params(self)
        axis = self.train_time_axis(ctx)
        if axis:
            # (under FSDP a copy of the part's view that gathers no layer)
            params = replace_items(params, {
                key: sharding.slice_params(params[key], axis)
                for key in ("logit", "logit_bias") if key in params})
            table = sharding.slice_params(table, axis)
        return self._logits_from_states(params, table,
                                        self.train_prelogit_states(ctx))

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
        source's additive bias (B, 1, 1, S), the keys and values in the
        caches' dtype (``cache_dtype``); with MoE FFNs the validity
        of each batch row (``row_valid``, (B,): a padding row has an
        all-zero source mask)."""
        params = ctx.get_params(self)
        if self.pipeline_stages > 1:
            # every layer on every rank for the decode's steps
            params = {**params,
                      "layers": pipeline.whole_stack(params["layers"])}
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
                att_p = self._layer_params(params, i)[f"cross_att_{e}"]
                heads = tp.local_heads(att_p["k"]["w"], self.n_heads_enc)
                enc_in = sharding.enter_block(
                    states, tp.is_split(att_p["k"]["w"]), None)
                per_layer.append(tuple(
                    split_heads(column_projection(
                        att_p[p], enc_in, self.n_heads_enc).to(
                            cache_dtype(table)), heads).contiguous()
                    for p in ("k", "v")))
                del att_p
            constants["enc_kv"].append(per_layer)
            constants["enc_bias"].append(
                attention_bias_from_mask(enc.temporal_mask(ctx)))
        if self.moe.on:
            if self.encoders:
                constants["row_valid"] = self.encoders[0].temporal_mask(
                    ctx).amax(dim=1).to(torch.float32)
            else:  # a language model cannot tell its padding rows
                constants["row_valid"] = table.new_ones(
                    self._batch_size(ctx))
        return constants

    def tile_decode_constants(self, constants, k: int):
        """Constants for B·K rows (the physical reorder): the
        cross-attention keys and values (this rank's heads), the source
        biases and the MoE FFN's ``row_valid`` repeated k times."""
        def rep(x):
            return x.repeat_interleave(k, dim=0)
        tiled = dict(constants)
        tiled["enc_kv"] = [[(rep(key), rep(value)) for key, value in layers]
                           for layers in constants["enc_kv"]]
        tiled["enc_bias"] = [rep(b) for b in constants["enc_bias"]]
        if "row_valid" in constants:
            tiled["row_valid"] = rep(constants["row_valid"])
        return tiled

    def tile_decode_constants_lineage(self, constants, k: int):
        """The cross-attention keys, values and masks are the same for
        every beam: one copy per sentence, shared by the K beams."""
        return dict(constants)

    def _self_heads(self, params) -> int:
        """The self-attention heads this rank holds (all of them unless
        its weights are split and the heads divide the model axis)."""
        return tp.local_heads(
            self._layer_params(params, 0)["self_att"]["k"]["w"],
            self.n_heads_self) if self.depth else self.n_heads_self

    def decode_initial_state(self, ctx: Context, constants):
        """Per layer, zero (B, max_output_len, D) key and value caches in
        the policy's dtype (``cache_dtype``); D is this rank's heads'
        width under tensor parallelism."""
        batch = self._batch_size(ctx)
        table = constants["embed_table"]
        width = (self.model_dim // self.n_heads_self
                 * self._self_heads(ctx.get_params(self)))
        return tuple(
            {name: table.new_zeros(batch, self.max_output_len, width,
                                   dtype=cache_dtype(table))
             for name in ("k", "v")}
            for _ in range(self.depth))

    def tile_decode_state(self, state, beam: int, lineage: bool = True):
        """Caches for B·K beam rows: (B·K, T, D) rows for the physical
        reorder and the einsum lineage step, or, for lineage decoding
        under ``NM_LINEAGE_KERNEL=1``, the lineage kernel's layout,
        ``kq`` (B, H, Dh, K·T) and ``vq`` (B, H, K·T, Dh) with lane
        ``t·K + j`` (``tile_decode_state`` :579-614), in the state's
        dtype, or bf16 under ``NM_LINEAGE_KERNEL_BF16=1``."""
        batch = state[0]["k"].shape[0]
        zeros = state[0]["k"].new_zeros
        head_dim = self.model_dim // self.n_heads_self
        # this rank's heads (the caches' width says how many)
        heads = state[0]["k"].shape[-1] // head_dim
        if not (lineage and lineage_kernel_layout()):
            return tuple({name: zeros(batch * beam, self.max_output_len,
                                      heads * head_dim)
                          for name in ("k", "v")}
                         for _ in range(self.depth))
        lanes = beam * self.max_output_len
        dtype = state[0]["k"].dtype
        if os.environ.get("NM_LINEAGE_KERNEL_BF16") == "1":
            dtype = torch.bfloat16
        return tuple({"kq": zeros(batch, heads, head_dim, lanes,
                                  dtype=dtype),
                      "vq": zeros(batch, heads, lanes, head_dim,
                                  dtype=dtype)}
                     for _ in range(self.depth))

    def _embed_step(self, constants, prev_ids, step: int):
        """(rows, 1, D) embedded previous tokens at position ``step``."""
        x = tp.embedding(prev_ids.long(), constants["embed_table"])
        x = (x * nn.depth_scale(self.model_dim, x)
             + constants["positions"][step])
        return x[:, None, :]

    def with_attention_maps(self, constants: Dict[str, Any]
                            ) -> Dict[str, Any]:
        """The constants of steps that also return their attention map
        (``aux["attention_weights"]``, one (rows, T_src) map)."""
        return {**constants, "attention_maps": True}

    def _cross_ffn(self, layer, x, constants, i: int, beam: int = 1):
        """A decode layer's cross-attention(s) and FFN: (x, the attention
        map or None). With ``beam`` the rows are (sentence, slot) pairs
        and the K slots of a sentence share its keys: the slots fold into
        the query axis, and a MoE FFN takes each sentence's validity for
        its K rows. The map, where the constants request it, is the last
        layer's first cross-attention averaged over the heads, (rows,
        T_src) in float32, from the weights the context is computed
        with."""
        rows = x.shape[0]
        att_map = None
        for e in range(len(self.encoders)):
            att_p = layer[f"cross_att_{e}"]
            heads = tp.local_heads(att_p["q"]["w"], self.n_heads_enc)
            q = column_projection(att_p["q"], sharding.enter_block(
                layer_norm(layer[f"ln_cross_{e}"], x),
                tp.is_split(att_p["q"]["w"]), None), self.n_heads_enc)
            q = q.reshape(rows // beam, beam, heads, -1).transpose(1, 2)
            k_enc, v_enc = constants["enc_kv"][e][i]
            if (e == 0 and i == self.depth - 1
                    and constants.get("attention_maps")):
                weights = attention_weights(q, k_enc,
                                            constants["enc_bias"][e])
                # the mean over every head, this rank's summed with the
                # others'
                att_map = (tp.reduce_from(weights.sum(dim=1))
                           / self.n_heads_enc if heads < self.n_heads_enc
                           else weights.mean(dim=1))
                att_map = att_map.reshape(rows, -1).float()
                cross = attend(weights, v_enc)
            else:
                cross = dot_product_attention(q, k_enc, v_enc,
                                              constants["enc_bias"][e])
            x = x + row_projection(att_p["o"],
                                   merge_heads(cross).reshape(rows, 1, -1))
        normed = layer_norm(layer["ln_ff"], x)
        if self.moe.on:
            row_valid = constants["row_valid"].repeat_interleave(beam)
            return x + self.moe.decode(layer["ff"], normed,
                                       row_valid), att_map
        return x + ffn(layer["ff"], normed), att_map

    def _finish(self, constants, x, att_map):
        x = layer_norm(constants["params"]["ln_out"], x)[:, 0, :]
        logits, sel_aux = self._step_logits(
            constants, x, lambda: self._logits_from_states(
                constants["params"], constants["embed_table"], x))
        if att_map is not None:
            sel_aux = {"attention_weights": (att_map,), **sel_aux}
        return logits, sel_aux

    def decode_step(self, constants, loop_state, prev_ids, step: int):
        """One greedy step: the caches are written in place at ``step``
        and attended up to it."""
        params = constants["params"]
        x = self._embed_step(constants, prev_ids, step)
        for i, cache in enumerate(loop_state):
            layer = self._layer_params(params, i)
            att_p = layer["self_att"]
            normed = sharding.enter_block(
                layer_norm(layer["ln_self"], x),
                tp.is_split(att_p["q"]["w"]), None)
            q, k_t, v_t = (column_projection(att_p[p], normed,
                                             self.n_heads_self)
                           for p in "qkv")
            cache["k"][:, step] = k_t[:, 0]
            cache["v"][:, step] = v_t[:, 0]
            heads = tp.local_heads(att_p["q"]["w"], self.n_heads_self)
            att = dot_product_attention(
                split_heads(q, heads),
                split_heads(cache["k"][:, :step + 1], heads),
                split_heads(cache["v"][:, :step + 1], heads))
            x = x + row_projection(att_p["o"], merge_heads(att))
            x, att_map = self._cross_ffn(layer, x, constants, i)
            # under FSDP a layer's gathered unit goes before the next
            # layer's is gathered (parallel/fsdp.py)
            del layer, att_p
        logits, sel_aux = self._finish(constants, x, att_map)
        return loop_state, logits, sel_aux

    # ------------------------------------------------------------------ #
    # lineage decoding: beam search without reordering the caches
    # ------------------------------------------------------------------ #
    lineage_decode = True
    emits_attention = True

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
        head_dim = self.model_dim // self.n_heads_self
        kernel_layout = "kq" in loop_state[0]
        # this rank's heads, as the caches hold them (``_self_heads``,
        # without reading a layer's parameters)
        heads = (loop_state[0]["kq"].shape[1] if kernel_layout
                 else loop_state[0]["k"].shape[-1] // head_dim)
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
                    nn.widened(constants["embed_table"].dtype))

        x = self._embed_step(constants, prev_ids, step)
        for i, cache in enumerate(loop_state):
            layer = self._layer_params(params, i)
            att_p = layer["self_att"]
            normed = sharding.enter_block(
                layer_norm(layer["ln_self"], x),
                tp.is_split(att_p["q"]["w"]), None)
            q, k_t, v_t = (
                column_projection(att_p[p], normed,
                                  self.n_heads_self).reshape(
                                      batch, beam, heads, head_dim)
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
                # bf16 caches (the policy): q takes their dtype, the
                # scores, softmax and context sums are float32 and the
                # weights are rounded to the values' dtype
                wide = lineage.dtype
                s_full = torch.einsum(
                    "bkhd,bjthd->bhkjt", q.to(kh.dtype).to(wide),
                    kh.to(wide)) * (1.0 / math.sqrt(head_dim))
                s = torch.einsum("bhkjt,bkjt->bhkt", s_full, lineage)
                weights = torch.softmax(s + cache_bias, dim=-1)
                w_slot = torch.einsum("bhkt,bkjt->bhkjt", weights, lineage)
                att = torch.einsum("bhkjt,bjthd->bkhd",
                                   w_slot.to(vh.dtype).to(wide),
                                   vh.to(wide))
            x = x + row_projection(att_p["o"], att.reshape(rows, 1, -1))
            x, att_map = self._cross_ffn(layer, x, constants, i, beam)
            del layer, att_p
        logits, sel_aux = self._finish(constants, x, att_map)
        return loop_state, logits, sel_aux
