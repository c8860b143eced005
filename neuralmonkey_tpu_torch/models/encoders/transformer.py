"""Transformer encoder (counterpart of
``neuralmonkey_tpu/models/encoders/transformer.py``).

Pre-norm residual blocks (LN -> self-attention -> +res, LN -> FFN ->
+res) with a final LN; sinusoidal, learned or no positions. The
self-attention takes the source mask as a key mask, so it runs through
flash attention (``ops/flash_attention.py``). With ``remat=True`` each
layer runs under ``torch.utils.checkpoint`` in training; the layer
takes its dropout seeds as arguments, drawn outside it, so the
recomputation replays the same masks.

With ``moe_experts > 1`` every FFN is a mixture of experts
(``ops/moe.py``); in training the layers' load-balance and router
z-losses, each averaged over the layers, join the objective as
auxiliary losses; on a batch split over data-parallel ranks their
routing sums are the global batch's (``ops/moe.py``).

The model axes (``param_partition_specs``): the attention and FFN
weights split Megatron-style over the model axis, the embedding table
its vocabulary. Under sequence sharding the residual stream's time axis
is split over the model axis between the blocks, under context
parallelism over the context axis, where the self-attention rides the
ring (``ops/sharding.py``); each layer's parameters then sum their
gradients over the slices. The positions are added to the whole stream
before it splits, so each slice carries its global offsets (the ring's
zigzag exchanges and returns its chunks inside the attention).

With ``pipeline_stages = S > 1`` the layers' parameters stack on a
leading layer axis (``layers/...``, declared ``('pipe', ...)`` with the
Megatron ``model`` dims kept) and the layer loop runs through the GPipe
executor (``parallel/pipeline.py``) over the manager's pipe group in
``pipeline_microbatches`` microbatches (S by default). Without a pipe
mesh, or for a batch the microbatches or the data ranks do not divide,
the stacked layers run one after another (the JAX package's fallback),
gathered whole over the pipe group where they are split over it: the
same function.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ...model.part import Context, ModelPart, tensor
from ...model.sequence import EmbeddedSequence
from ...model.stateful import TemporalStatefulWithOutput
from ...ops import sharding
from ...ops.attention import (ffn, ffn_init, ffn_partition_specs, layer_norm,
                              layer_norm_init, mha_init, mha_partition_specs,
                              multi_head_attention, seeded_dropout,
                              sinusoidal_position_encoding)
from ...ops.moe import (moe_combine_stats, moe_ffn, moe_init,
                        moe_partition_specs, moe_stacked_partition_specs)
from ...parallel import pipeline
from ...parallel.distributed import sharded_batch
from ...vocabulary import Vocabulary

_POSITION_TYPES = ("sinusoidal", "learned", "none")


def check_pipeline(depth: int, stages: int, microbatches: int) -> None:
    """The JAX package's checks of a part's pipeline options."""
    if stages > 1 and depth % stages:
        raise ValueError(
            f"depth {depth} not divisible by {stages} pipeline stages")
    if microbatches and microbatches < stages:
        raise ValueError(
            f"pipeline_microbatches={microbatches} must be >= "
            f"pipeline_stages={stages}")


def stacked_partition_specs(norms, attentions, moe: bool
                            ) -> Dict[str, tuple]:
    """The specs of a pipelined part's stacked layers: the leading layer
    axis over ``pipe``, the trailing dims in the Megatron ``model``
    pattern (the layer norms whole), a MoE FFN's experts over
    ``expert`` (the JAX package's stacked specs)."""
    specs: Dict[str, tuple] = {}
    for norm in norms:
        for leaf in ("scale", "bias"):
            specs[f"layers/{norm}/{leaf}"] = ("pipe", None)
    subs = [(att, ("q", "k", "v"), ("o",)) for att in attentions]
    if not moe:
        subs.append(("ff", ("in",), ("out",)))
    for sub, cols, rows in subs:
        for p in cols:
            specs[f"layers/{sub}/{p}/w"] = ("pipe", None, "model")
            specs[f"layers/{sub}/{p}/b"] = ("pipe", "model")
        for p in rows:
            specs[f"layers/{sub}/{p}/w"] = ("pipe", "model", None)
            specs[f"layers/{sub}/{p}/b"] = ("pipe", None)
    if moe:
        specs.update(moe_stacked_partition_specs("layers/ff"))
    return specs


def layer_params_on_slice(layer: Dict[str, Any], stream: Optional[str],
                          moe: bool = False) -> Dict[str, Any]:
    """A layer's parameters as a rank uses them on its slice of a split
    stream, their gradients summed over the slices: under context
    parallelism all of them (but a MoE FFN's, which runs on the whole
    stream), under sequence sharding the layer norms (the output
    biases in ``ops/attention.row_projection``)."""
    if stream == "context":
        return {name: (value if moe and name == "ff" else
                       sharding.slice_params(value, stream))
                for name, value in layer.items()}
    if stream == "model":
        return {name: (sharding.slice_params(value, stream)
                       if name.startswith("ln_") else value)
                for name, value in layer.items()}
    return layer


def run_layer(layer_fn, remat: bool, *args):
    """``layer_fn(*args)``, recomputed in the backward pass when
    ``remat`` is set and a gradient is wanted."""
    if remat and torch.is_grad_enabled():
        return checkpoint(layer_fn, *args, use_reentrant=False)
    return layer_fn(*args)


class MoESettings:
    """The ``moe_*`` options of a Transformer part: with ``experts > 1``
    every FFN of the part is a mixture of experts (``ops/moe.py``), whose
    losses the part's layer loops fold (``run_layers`` for the stacked
    layers of pipeline stages)."""

    def __init__(self, experts: int, top_k: int, capacity_factor: float,
                 aux_weight: float, router_noise: float,
                 z_loss_weight: float) -> None:
        self.experts = experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        self.router_noise = router_noise
        self.z_loss_weight = z_loss_weight

    @property
    def on(self) -> bool:
        return self.experts > 1

    def noisy(self, train: bool) -> bool:
        """Whether a training pass draws router noise."""
        return train and self.on and self.router_noise > 0.0

    def ffn_init(self, gen: torch.Generator, model_dim: int,
                 hidden_dim: int) -> Dict[str, Any]:
        if self.on:
            return moe_init(gen, model_dim, hidden_dim, self.experts)
        return ffn_init(gen, model_dim, hidden_dim)

    def partition_specs(self, prefix: str) -> Dict[str, tuple]:
        if self.on:
            return moe_partition_specs(prefix)
        return ffn_partition_specs(prefix)

    def __call__(self, params: Dict[str, Any], x: torch.Tensor,
                 mask: Optional[torch.Tensor], seeds: Dict[str, Any],
                 dropout_keep_prob: float = 1.0,
                 stream: Optional[str] = None, stats: bool = False):
        """A training layer's mixture-of-experts FFN: (output, losses;
        with ``stats`` the routing sums behind them). Its token groups
        are whole sentences, so a stream split over time is gathered for
        it and split again after it."""
        x = sharding.gather_sequence(x, stream)
        out, aux = moe_ffn(params, x, mask=mask, top_k=self.top_k,
                           capacity_factor=self.capacity_factor,
                           dropout_seed=seeds.get("ff"),
                           dropout_keep_prob=dropout_keep_prob,
                           router_noise=self.router_noise,
                           noise_seed=seeds["moe_noise"],
                           return_stats=stats)
        return sharding.constrain_sequence(out, stream), aux

    def decode(self, params: Dict[str, Any], normed: torch.Tensor,
               row_valid: torch.Tensor) -> torch.Tensor:
        """An incremental decode step's FFN over (rows, 1, D): one group
        of all rows routed without dropping a token (capacity = rows), so
        that a sentence's output does not depend on the other rows of
        its batch; ``row_valid`` (rows,) keeps the padding rows out."""
        k = min(self.top_k, self.experts)
        # the step's routing sums are dropped, and the ranks' decode
        # loops may end at different steps: no collective here
        with sharded_batch(False):
            out, _ = moe_ffn(params, normed.transpose(0, 1),
                             mask=row_valid[None, :], top_k=self.top_k,
                             capacity_factor=self.experts / k)
        return out.transpose(0, 1)

    def add_losses(self, part: ModelPart, ctx: Context, auxes) -> None:
        """The layers' balance and z-losses, each averaged over the
        layers and weighted, as the auxiliary losses of a training
        pass."""
        if auxes:
            self.add_totals(part, ctx, {
                key: sum(a[key] for a in auxes) for key in ("balance", "z")},
                len(auxes))

    def add_totals(self, part: ModelPart, ctx: Context,
                   totals: Dict[str, torch.Tensor], depth: int) -> None:
        """``add_losses`` from the layers' balance and z-losses summed
        (the pipeline's totals)."""
        if not (self.on and ctx.train):
            return
        ctx.add_aux_loss(part, "moe_balance",
                         self.aux_weight * totals["balance"] / depth)
        if self.z_loss_weight > 0.0:
            ctx.add_aux_loss(part, "moe_z",
                             self.z_loss_weight * totals["z"] / depth)

    def run_layers(self, part: ModelPart, ctx: Context, layer_fn, params,
                   x: torch.Tensor, seeds, mb_aux: Dict[str, Any],
                   stages: int, microbatches: int) -> torch.Tensor:
        """A pipelined part's stacked layers ``params["layers"]`` on
        ``x``: through the GPipe executor, or one after another where it
        does not apply (logged once). ``layer_fn(layer, x, aux, seeds,
        stats)`` is one layer (with MoE FFNs, ``(x, losses)``, or with
        ``stats`` ``(x, routing sums)``); ``seeds`` gives layer i's;
        ``mb_aux`` the tensors each microbatch takes its rows of."""
        depth = pipeline.stacked_depth(params["layers"])
        # M: the part's own, else the pipe axis's size (the part's stage
        # count without a pipe mesh)
        grid = pipeline.pipeline_mesh()
        n_micro = microbatches or (grid.size("pipe") if grid is not None
                                   else stages)
        reason = pipeline.takes(x.shape[0], n_micro)
        if reason is not None:
            if pipeline.pipeline_mesh() is not None:
                pipeline.log_fallback(part.name, reason)
            stack = pipeline.whole_stack(params["layers"])
            auxes = []
            for i in range(depth):
                x = layer_fn(pipeline.layer_params(stack, i), x, mb_aux,
                             seeds(i), False)
                if self.on:
                    x, aux = x
                    auxes.append(aux)
            self.add_losses(part, ctx, auxes)
            return x
        out = pipeline.gpipe_apply(
            lambda layer, layer_seeds, h, aux: layer_fn(
                layer, h, aux, layer_seeds, self.on),
            params["layers"], [seeds(i) for i in range(depth)], x, mb_aux,
            n_microbatches=n_micro,
            aux_fn=moe_combine_stats if self.on else None)
        if self.on:
            out, totals = out
            self.add_totals(part, ctx, totals, depth)
        return out


class TransformerEncoder(ModelPart, TemporalStatefulWithOutput):

    def __init__(self, name: str,
                 input_sequence=None,
                 ff_hidden_size: int = None,
                 depth: int = 6,
                 n_heads: int = 8,
                 dropout_keep_prob: float = 0.9,
                 attention_dropout_keep_prob: float = 1.0,
                 position_encoding: str = "sinusoidal",
                 max_position: int = 512,
                 remat: bool = False,
                 pipeline_stages: int = 0,
                 pipeline_microbatches: int = 0,
                 moe_experts: int = 0,
                 moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.5,
                 moe_aux_weight: float = 0.01,
                 moe_router_noise: float = 0.0,
                 moe_z_loss_weight: float = 0.0,
                 vocabulary: Vocabulary = None,
                 data_id: str = None,
                 embedding_size: int = None,
                 max_input_len: int = None,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        check_pipeline(depth, pipeline_stages, pipeline_microbatches)
        # GPipe over the pipe axis (parallel/pipeline.py): the layers'
        # parameters stack on a leading axis declared ('pipe', ...)
        self.pipeline_stages = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches
        if input_sequence is None:
            if vocabulary is None or data_id is None \
                    or embedding_size is None:
                raise ValueError(
                    "Provide input_sequence or vocabulary+data_id+"
                    "embedding_size")
            input_sequence = EmbeddedSequence(
                name=f"{name}_input", vocabulary=vocabulary,
                data_id=data_id, embedding_size=embedding_size,
                max_length=max_input_len,
                scale_embeddings_by_depth=True)
        if position_encoding not in _POSITION_TYPES:
            raise ValueError(
                f"position_encoding must be one of {_POSITION_TYPES}")
        self.input_sequence = input_sequence
        self.model_dim = input_sequence.state_dim
        self.ff_hidden_size = ff_hidden_size or 4 * self.model_dim
        self.depth = depth
        self.n_heads = n_heads
        if self.model_dim % n_heads:
            raise ValueError(
                f"model dim {self.model_dim} not divisible by "
                f"{n_heads} heads")
        self.dropout_keep_prob = dropout_keep_prob
        self.attention_dropout_keep_prob = attention_dropout_keep_prob
        self.position_encoding = position_encoding
        self.max_position = max_position
        self.remat = remat
        self.moe = MoESettings(moe_experts, moe_top_k, moe_capacity_factor,
                               moe_aux_weight, moe_router_noise,
                               moe_z_loss_weight)

    @property
    def state_dim(self) -> int:
        return self.model_dim

    @property
    def output_dim(self) -> int:
        return self.model_dim

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        params: Dict[str, Any] = {}
        if self.position_encoding == "learned":
            params["position_emb"] = torch.randn(
                self.max_position, self.model_dim, generator=gen) * 0.01
        layers = [{"ln_att": layer_norm_init(self.model_dim),
                   "att": mha_init(gen, self.model_dim, self.model_dim,
                                   self.model_dim),
                   "ln_ff": layer_norm_init(self.model_dim),
                   "ff": self.moe.ffn_init(gen, self.model_dim,
                                           self.ff_hidden_size)}
                  for _ in range(self.depth)]
        if self.pipeline_stages > 1:
            params["layers"] = pipeline.stack_layers(layers)
        else:
            for i, layer in enumerate(layers):
                params[f"layer_{i}"] = layer
        params["ln_out"] = layer_norm_init(self.model_dim)
        return params

    def param_partition_specs(self) -> Dict[str, tuple]:
        """Tensor-parallel layer specs (the input sequence's table
        declares its own); with pipeline stages the stacked layers'
        (``stacked_partition_specs``)."""
        if self.pipeline_stages > 1:
            return stacked_partition_specs(("ln_att", "ln_ff"), ("att",),
                                           self.moe.on)
        specs: Dict[str, tuple] = {}
        for i in range(self.depth):
            specs.update(mha_partition_specs(f"layer_{i}/att"))
            specs.update(self.moe.partition_specs(f"layer_{i}/ff"))
        return specs

    # ------------------------------------------------------------------ #
    @tensor
    def temporal_mask(self, ctx: Context):
        return self.input_sequence.temporal_mask(ctx)

    def _add_positions(self, params, states):
        time = states.shape[1]
        if self.position_encoding == "sinusoidal":
            return states + sinusoidal_position_encoding(
                time, self.model_dim, states.dtype, states.device)[None]
        if self.position_encoding == "learned":
            return states + params["position_emb"][None, :time]
        return states

    def _layer_fn(self, layer, states, mask, seeds, stream=None,
                  att_mask=None, stats=False):
        """One encoder layer; ``seeds`` holds the dropout and router
        noise seeds of its sites (None outside training), ``stream`` the
        axis its residual stream is split over and ``att_mask`` the
        attention's key mask (the keys' slice of ``mask`` under context
        parallelism). Returns the states, and with MoE FFNs also the
        layer's auxiliary losses (with ``stats`` their routing sums)."""
        att_mask = mask if att_mask is None else att_mask
        keep = self.dropout_keep_prob
        layer = layer_params_on_slice(layer, stream, self.moe.on)
        normed = layer_norm(layer["ln_att"], states)
        att_out = multi_head_attention(
            layer["att"], normed, normed, normed, self.n_heads,
            dropout_seed=seeds["att"],
            dropout_keep_prob=self.attention_dropout_keep_prob,
            key_mask=att_mask, stream=stream, ring=stream == "context")
        states = states + seeded_dropout(
            att_out, keep, sharding.shard_seed(seeds["res_att"], (stream,)))
        normed = layer_norm(layer["ln_ff"], states)
        res_ff = sharding.shard_seed(seeds["res_ff"], (stream,))
        if self.moe.on:
            ff_out, aux = self.moe(layer["ff"], normed, mask, seeds,
                                   dropout_keep_prob=keep, stream=stream,
                                   stats=stats)
            return states + seeded_dropout(ff_out, keep, res_ff), aux
        ff_out = ffn(layer["ff"], normed, dropout_seed=seeds["ff"],
                     dropout_keep_prob=keep, stream=stream)
        return states + seeded_dropout(ff_out, keep, res_ff)

    def _layer_seeds(self, ctx: Context, i: int) -> Dict[str, Optional[int]]:
        """Per-layer dropout seeds at the JAX package's sites
        (``_layer_rngs``), drawn outside the layer."""
        res_drop = ctx.train and self.dropout_keep_prob < 1.0
        att_drop = ctx.train and self.attention_dropout_keep_prob < 1.0

        def seed(site, on):
            return ctx.site_seed(self, site) if on else None
        return {"att": seed(f"att_drop_{i}", att_drop),
                "ff": seed(f"ff_drop_{i}", res_drop),
                "res_att": seed(f"res_drop_att_{i}", res_drop),
                "res_ff": seed(f"res_drop_ff_{i}", res_drop),
                "moe_noise": seed(f"moe_noise_{i}",
                                  self.moe.noisy(ctx.train))}

    @tensor
    def split_temporal_states(self, ctx: Context):
        """(states, mask, axis): the final states and source mask of this
        rank's slice of the time axis, and the axis the stream is split
        over (the states whole and ``axis`` None where it is not, or
        where it is split over the model axis, which gathers it before
        the output layer norm)."""
        params = ctx.get_params(self)
        states = self.input_sequence.temporal_states(ctx)
        mask = self.input_sequence.temporal_mask(ctx).to(torch.float32)
        states = self._add_positions(params, states)
        states = ctx.dropout(self, states, self.dropout_keep_prob,
                             "input_dropout")
        stream = sharding.stream_axis(states.shape[1])
        states = sharding.constrain_sequence(states, stream)
        att_mask = (mask[:, sharding.time_slice(mask.shape[1], stream)]
                    if stream == "context" else mask)
        remat = self.remat and ctx.train
        if self.pipeline_stages > 1:
            states = self.moe.run_layers(
                self, ctx, lambda layer, h, aux, seeds, stats: run_layer(
                    self._layer_fn, remat, layer, h, aux["mask"], seeds,
                    stream, aux["att_mask"], stats),
                params, states, lambda i: self._layer_seeds(ctx, i),
                {"mask": mask, "att_mask": att_mask},
                self.pipeline_stages, self.pipeline_microbatches)
        else:
            auxes = []
            for i in range(self.depth):
                states = run_layer(self._layer_fn, remat,
                                   params[f"layer_{i}"], states, mask,
                                   self._layer_seeds(ctx, i), stream,
                                   att_mask)
                if self.moe.on:
                    states, aux = states
                    auxes.append(aux)
            self.moe.add_losses(self, ctx, auxes)
        if stream == "model":
            states, stream = sharding.gather_sequence(states, stream), None
        states = layer_norm(sharding.slice_params(params["ln_out"], stream),
                            states)
        # padding positions are zero for clean downstream pooling
        return states * att_mask[..., None], att_mask, stream

    @tensor
    def temporal_states(self, ctx: Context):
        states, _, stream = self.split_temporal_states(ctx)
        return sharding.gather_sequence(states, stream)

    @tensor
    def output(self, ctx: Context):
        """Masked mean-pool over time (the reference's encoder
        output)."""
        states = self.temporal_states(ctx)
        mask = self.temporal_mask(ctx)
        count = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        return states.sum(dim=1) / count
