"""Multi-head attention ops (counterpart of
``neuralmonkey_tpu/ops/attention.py``).

Used by the Transformer encoder and decoder. Parameters keep the JAX
package's names and (in, out) layouts, so its checkpoints load without
transposes. :func:`multi_head_attention` sends a key mask with no
additive bias to flash attention (``ops/flash_attention.py``: the
hand-written kernels on CUDA tensors, their plain version on the CPU);
an additive bias takes the dense path here, and so does attention
dropout under ``NM_FLASH_DROPOUT=0`` on CPU tensors (on CUDA tensors
the switch raises: attention dropout on the card rides inside the flash
kernels). The JAX package's ring (context-parallel)
and sharded branches need a device mesh, which the port does not have:
``CUDAManager`` raises when an INI asks for context parallelism.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import torch

from . import nn
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


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, D/H)."""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) -> (B, T, H*Dh)."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


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
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = nn.dot(q.to(k.dtype), k.transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias
    weights = torch.softmax(scores, dim=-1)
    if dropout_seed is not None and dropout_keep_prob < 1.0:
        gen = torch.Generator(device=weights.device).manual_seed(
            dropout_seed)
        weights = nn.dropout(weights, dropout_keep_prob, gen, True)
    return nn.dot(weights.to(v.dtype), v).to(v.dtype)


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


def multi_head_attention(params: Dict,
                         queries: torch.Tensor,
                         keys: torch.Tensor,
                         values: torch.Tensor,
                         n_heads: int,
                         bias: Optional[torch.Tensor] = None,
                         dropout_seed: Optional[int] = None,
                         dropout_keep_prob: float = 1.0,
                         key_mask: Optional[torch.Tensor] = None,
                         causal: bool = False) -> torch.Tensor:
    """Project, attend, merge, output-project.

    ``dropout_seed`` (an int, or None outside training) seeds attention
    dropout: two key words drawn from it for the flash path's keep
    hash, or a generator on the device for the dense path."""
    q = split_heads(nn.linear(params["q"], queries), n_heads)
    k = split_heads(nn.linear(params["k"], keys), n_heads)
    v = split_heads(nn.linear(params["v"], values), n_heads)
    dropout = dropout_seed is not None and dropout_keep_prob < 1.0
    if key_mask is not None and bias is None \
            and (not dropout or flash_dropout_enabled(q.is_cuda)):
        out = flash_attention(
            q, k, v, key_mask, causal,
            dropout_key_words(dropout_seed) if dropout else None,
            dropout_keep_prob if dropout else 1.0)
    else:
        if bias is None and key_mask is not None:
            bias = attention_bias_from_mask(key_mask)
            if causal:
                bias = bias + causal_bias(
                    keys.shape[1], keys.device)[:, :, :queries.shape[1], :]
        out = dot_product_attention(q, k, v, bias, dropout_seed,
                                    dropout_keep_prob)
    return nn.linear(params["o"], merge_heads(out))


def ffn_init(gen: torch.Generator, model_dim: int,
             hidden_dim: int) -> Dict:
    return {"in": nn.linear_init(gen, model_dim, hidden_dim),
            "out": nn.linear_init(gen, hidden_dim, model_dim)}


def ffn(params: Dict, x: torch.Tensor, dropout_seed: Optional[int] = None,
        dropout_keep_prob: float = 1.0) -> torch.Tensor:
    """ReLU feed-forward block with dropout on the hidden layer."""
    hidden = torch.relu(nn.linear(params["in"], x))
    hidden = seeded_dropout(hidden, dropout_keep_prob, dropout_seed)
    return nn.linear(params["out"], hidden)


def seeded_dropout(x: torch.Tensor, keep_prob: float,
                   seed: Optional[int]) -> torch.Tensor:
    """Inverted dropout from a generator on ``x``'s device seeded with
    ``seed``; the identity when ``seed`` is None or ``keep_prob >= 1``.
    The seed, not a generator, crosses a recomputed (checkpointed)
    layer's boundary, so the recomputation draws the same mask."""
    if seed is None or keep_prob >= 1.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return nn.dropout(x, keep_prob, gen, True)
