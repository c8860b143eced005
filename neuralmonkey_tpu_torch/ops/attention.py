"""Multi-head attention ops (counterpart of
``neuralmonkey_tpu/ops/attention.py``).

Used by the Transformer encoder and decoder. Parameters keep the JAX
package's names and (in, out) layouts, so its checkpoints load without
transposes. :func:`multi_head_attention` dispatches as the JAX
package does: first the ring (``parallel/ring_attention.py``) when its
queries and keys are this rank's slices of a context-parallel time
axis; else flash attention for a key mask with no additive bias
(``ops/flash_attention.py``: the hand-written kernels on CUDA tensors,
their plain version on the CPU) on this rank's heads; else the dense
path, which also takes attention dropout under ``NM_FLASH_DROPOUT=0``
on CPU tensors (on CUDA tensors the switch raises: attention dropout on
the card rides inside the flash kernels).

Under tensor parallelism (``mha_partition_specs``,
``ffn_partition_specs``) the q, k, v and FFN-in weights hold this
rank's output columns (so its heads) and the o and FFN-out weights the
matching rows: each rank attends over its heads, one all-reduce
follows the output projection and its bias is added after it
(``ops/sharding.enter_block`` and ``exit_block``, which under sequence
sharding gather and reduce-scatter the time axis instead). Where the
heads do not divide the model axis the split columns are gathered and
the attention runs whole, as the JAX package's sharded flash gate sends
such shapes to its dense path.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import torch

from ..parallel import mesh, pipeline, tensor
from . import nn, sharding
from .flash_attention import dropout_key_words, flash_attention

NEG_INF = -1e9


def sinusoidal_position_encoding(length: int, dim: int,
                                 dtype=torch.float32,
                                 device=None) -> torch.Tensor:
    """(length, dim) Transformer position signal (Vaswani et al.),
    computed in ``dtype`` step by step as the JAX package computes it
    (its Python constants rounded to ``dtype`` first): under the bf16
    policy a bf16 signal."""
    positions = torch.arange(length, dtype=dtype, device=device)[:, None]
    half = dim // 2
    freqs = torch.exp(nn.scalar(-math.log(10000.0), dtype)
                      * torch.arange(half, dtype=dtype, device=device)
                      / nn.scalar(half, dtype))
    angles = positions * freqs[None, :]
    encoding = torch.cat([torch.sin(angles), torch.cos(angles)], dim=1)
    if encoding.shape[1] < dim:  # odd dims
        encoding = torch.nn.functional.pad(
            encoding, (0, dim - encoding.shape[1]))
    return encoding


def layer_norm_init(dim: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def layer_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               epsilon: float = 1e-6) -> torch.Tensor:
    """Layer norm with the biased variance and epsilon inside the
    square root, as the JAX package computes it. A bf16 ``x`` (the
    embedded states under the bf16 policy) is normalised in bf16, each
    step computed in float32 and rounded as the JAX package's bf16
    steps are (PyTorch's bf16 ``rsqrt`` is not rounded correctly); the
    float32 scale then makes the output float32."""
    if x.dtype == torch.bfloat16:
        return _layer_norm_bf16(params, x, epsilon)
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return ((x - mean) * torch.rsqrt(var + epsilon) * params["scale"]
            + params["bias"])


def _layer_norm_bf16(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     epsilon: float) -> torch.Tensor:
    bf16 = torch.bfloat16
    wide = x.float()
    mean = wide.mean(dim=-1, keepdim=True).to(bf16)
    var = wide.var(dim=-1, keepdim=True, unbiased=False).to(bf16)
    centered = (wide - mean.float()).to(bf16)
    inv = torch.rsqrt(
        (var.float() + nn.scalar(epsilon, bf16)).to(bf16).float()).to(bf16)
    normed = (centered.float() * inv.float()).to(bf16)
    return normed.float() * params["scale"] + params["bias"]


def mha_init(gen: torch.Generator, query_dim: int, kv_dim: int,
             model_dim: int, out_dim: int = None) -> Dict:
    """Projection parameters of multi-head attention."""
    out_dim = out_dim if out_dim is not None else query_dim
    return {"q": nn.linear_init(gen, query_dim, model_dim),
            "k": nn.linear_init(gen, kv_dim, model_dim),
            "v": nn.linear_init(gen, kv_dim, model_dim),
            "o": nn.linear_init(gen, model_dim, out_dim)}


def mha_partition_specs(prefix: str) -> Dict[str, tuple]:
    """Megatron tensor-parallel specs of an ``mha_init`` subtree: the q,
    k and v projections split their output columns over the model axis
    (whole heads stay on one rank, ``split_heads`` being head-major),
    the output projection its input rows; the ``o`` bias is whole,
    added after the all-reduce."""
    specs: Dict[str, tuple] = {}
    for p in ("q", "k", "v"):
        specs[f"{prefix}/{p}/w"] = (None, "model")
        specs[f"{prefix}/{p}/b"] = ("model",)
    specs[f"{prefix}/o/w"] = ("model", None)
    return specs


def ffn_partition_specs(prefix: str) -> Dict[str, tuple]:
    """Tensor-parallel specs of an ``ffn_init`` subtree: the hidden
    columns split, the output rows split (one all-reduce after
    ``out``)."""
    return {f"{prefix}/in/w": (None, "model"),
            f"{prefix}/in/b": ("model",),
            f"{prefix}/out/w": ("model", None)}


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, D/H)."""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, H*Dh)."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def attention_weights(q: torch.Tensor, k: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The softmax over the keys of (B, H, Tq, Dh) x (B, H, Tk, Dh)
    scaled scores plus an additive bias: (B, H, Tq, Tk), float32 under
    the bf16 policy (q takes the keys' dtype)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = nn.dot(q.to(k.dtype), k.transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias
    return torch.softmax(scores, dim=-1)


def attend(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The context of ``weights`` (B, H, Tq, Tk) over the values (B, H,
    Tk, Dh): the weights take the values' dtype, the sum is float32 and
    the context is returned in the values' dtype."""
    return nn.dot(weights.to(v.dtype), v).to(v.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          dropout_seed: Optional[int] = None,
                          dropout_keep_prob: float = 1.0) -> torch.Tensor:
    """Dense attention (B, H, Tq, Dh) x (B, H, Tk, Dh) -> (B, H, Tq, Dh)
    with an additive bias and dropout after the softmax. Under the bf16
    policy (bf16 decode caches) q takes the keys' dtype, the scores and
    the softmax are float32, the weights take the values' dtype and the
    context, summed in float32, is returned in the values' dtype, as in
    the JAX package."""
    weights = attention_weights(q, k, bias)
    if dropout_seed is not None and dropout_keep_prob < 1.0:
        gen = torch.Generator(device=weights.device).manual_seed(
            dropout_seed)
        weights = nn.dropout(weights, dropout_keep_prob, gen, True)
    return attend(weights, v)


def attention_bias_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, Tk) float mask -> additive bias (B, 1, 1, Tk)."""
    return torch.where(mask > 0, 0.0, NEG_INF).to(
        torch.float32)[:, None, None, :]


def causal_bias(length: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) additive bias for decoder self-attention."""
    allowed = torch.ones(length, length, dtype=torch.bool,
                         device=device).tril()
    return torch.where(allowed, 0.0, NEG_INF)[None, None]


def flash_dropout_enabled(on_cuda: bool) -> bool:
    """Whether attention dropout may ride inside flash attention
    (default on); ``NM_FLASH_DROPOUT=0`` sends such call sites to the
    dense path, as in the JAX package, for CPU tensors only: for CUDA
    tensors it raises."""
    if os.environ.get("NM_FLASH_DROPOUT") not in ("0", "false", "False"):
        return True
    if on_cuda:
        raise NotImplementedError(
            "NM_FLASH_DROPOUT=0: the dense attention-dropout path runs on "
            "CPU tensors only; on the card attention dropout rides inside "
            "the flash kernels (unset the switch)")
    return False


def column_projection(params: Dict, x: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    """A q, k or v projection of a block input: this rank's heads when
    the weights are split and the heads divide the model axis, else
    every head (split columns gathered)."""
    y = nn.linear(params, x)
    if tensor.is_split(params["w"]) and not tensor.heads_split(
            params["w"], n_heads):
        y = tensor.gather_from(y, -1)
    return y


def row_projection(params: Dict, x: torch.Tensor,
                   axis: Optional[str] = None) -> torch.Tensor:
    """The output projection of a block onto the stream: with split rows
    this rank's partial product (of its columns of ``x``, taken here
    when ``x`` is whole), summed over the model axis (reduce-scattered
    over time under sequence sharding), then the bias."""
    w = params["w"]
    if not tensor.is_split(w):
        return sharding.exit_block(nn.linear(params, x), False, axis)
    if x.shape[-1] != w.shape[0]:
        x = tensor.scatter_to(x, -1)
    y = sharding.exit_block(nn.pdot(x, w), True, axis)
    if "b" in params:
        y = y + sharding.slice_params(params["b"],
                                      "model" if axis == "model" else None)
    return y


def attention_dropout_seed(seed: Optional[int]) -> Optional[int]:
    """The attention-dropout seed of this rank's heads: under tensor
    parallelism ``data_index * model + model_index`` folded in, as the
    JAX package folds it into the sharded flash kernel's key, so that
    each shard draws its own mask (the step's seed already differs
    between data ranks); inside a pipelined layer the microbatch's
    ordinal is folded in first."""
    if seed is None:
        return seed
    from ..model.part import fold_seed
    mb = pipeline.current_microbatch()
    if mb is not None:
        # the keep bits hash a position inside one kernel call: a
        # microbatch folds its ordinal in, as the JAX pipeline folds it
        # into the key
        seed = fold_seed(seed, mb.index)
    if mesh.size("model") == 1:
        return seed
    return fold_seed(seed, mesh.index("data") * mesh.size("model")
                     + mesh.index("model"))


def multi_head_attention(params: Dict,
                         queries: torch.Tensor,
                         keys: torch.Tensor,
                         values: torch.Tensor,
                         n_heads: int,
                         bias: Optional[torch.Tensor] = None,
                         dropout_seed: Optional[int] = None,
                         dropout_keep_prob: float = 1.0,
                         key_mask: Optional[torch.Tensor] = None,
                         causal: bool = False,
                         stream: Optional[str] = None,
                         ring: bool = False) -> torch.Tensor:
    """Project, attend, merge, output-project.

    ``dropout_seed`` (an int, or None outside training) seeds attention
    dropout: two key words drawn from it for the flash path's keep
    hash, or a generator on the device for the dense path, or the
    ring's blockwise masks. ``stream`` is the axis the queries' residual
    stream is split over (``ops/sharding.stream_axis``); ``ring`` says
    that the queries, keys and values are this rank's slices of a
    context-parallel time axis (and ``key_mask`` the keys' slice)."""
    split = tensor.is_split(params["q"]["w"])
    q_in = sharding.enter_block(queries, split, stream)
    kv_in = q_in if keys is queries else (
        tensor.copy_to(keys) if split else keys)
    v_in = kv_in if values is keys else (
        tensor.copy_to(values) if split else values)
    heads = tensor.local_heads(params["q"]["w"], n_heads)
    q = split_heads(column_projection(params["q"], q_in, n_heads), heads)
    k = split_heads(column_projection(params["k"], kv_in, n_heads), heads)
    v = split_heads(column_projection(params["v"], v_in, n_heads), heads)
    dropout = dropout_seed is not None and dropout_keep_prob < 1.0
    seed = attention_dropout_seed(dropout_seed) if dropout else None
    if ring and key_mask is not None and bias is None:
        from ..parallel.ring_attention import ring_attention
        out = ring_attention(q, k, v, key_mask, causal, seed,
                             dropout_keep_prob)
    elif key_mask is not None and bias is None \
            and (not dropout or flash_dropout_enabled(q.is_cuda)):
        out = flash_attention(
            q, k, v, key_mask, causal,
            dropout_key_words(seed) if dropout else None,
            dropout_keep_prob if dropout else 1.0)
    else:
        if bias is None and key_mask is not None:
            bias = attention_bias_from_mask(key_mask)
            if causal:
                bias = bias + causal_bias(
                    k.shape[2], keys.device)[:, :, :q.shape[2], :]
        out = dot_product_attention(q, k, v, bias, seed,
                                    dropout_keep_prob)
    return row_projection(params["o"], merge_heads(out), stream)


def ffn_init(gen: torch.Generator, model_dim: int,
             hidden_dim: int) -> Dict:
    return {"in": nn.linear_init(gen, model_dim, hidden_dim),
            "out": nn.linear_init(gen, hidden_dim, model_dim)}


def ffn(params: Dict, x: torch.Tensor, dropout_seed: Optional[int] = None,
        dropout_keep_prob: float = 1.0,
        stream: Optional[str] = None) -> torch.Tensor:
    """ReLU feed-forward block with dropout on the hidden layer; its
    hidden columns split over the model axis where its weights are
    (each part drawing its own dropout mask), ``stream`` as in
    :func:`multi_head_attention`."""
    split = tensor.is_split(params["in"]["w"])
    hidden = torch.relu(nn.linear(params["in"],
                                  sharding.enter_block(x, split, stream)))
    hidden = seeded_dropout(hidden, dropout_keep_prob, sharding.shard_seed(
        dropout_seed, ("model" if split else None,
                       "context" if stream == "context" else None)))
    return row_projection(params["out"], hidden, stream)


def seeded_dropout(x: torch.Tensor, keep_prob: float,
                   seed: Optional[int], batch_dim: int = 0) -> torch.Tensor:
    """Inverted dropout from a generator on ``x``'s device seeded with
    ``seed``; the identity when ``seed`` is None or ``keep_prob >= 1``.
    The seed, not a generator, crosses a recomputed (checkpointed)
    layer's boundary, so the recomputation draws the same mask. Inside
    a pipelined layer the mask is the microbatch's rows (along
    ``batch_dim``) of the whole batch's (``pipeline.batch_rows``)."""
    if seed is None or keep_prob >= 1.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    shape, rows = pipeline.batch_rows(x.shape, batch_dim)
    if shape == tuple(x.shape):
        return nn.dropout(x, keep_prob, gen, True)
    keep = rows(torch.rand(shape, generator=gen, device=x.device,
                           dtype=nn.widened(x.dtype))) < keep_prob
    return torch.where(keep, x / nn.scalar(keep_prob, x.dtype), 0.0)
