"""The bf16 compute policy of the port against the JAX package's, on the CPU.

Both packages' policies are global; every test that sets one resets both
in a ``finally`` block (the ``policy`` fixture). The JAX side runs its
Pallas kernels in interpret mode (``NM_USE_PALLAS=1``) where the port's
path goes through a kernel, as tests/test_torch_transformer.py runs them,
and is compiled with XLA's ``xla_allow_excess_precision`` off
(``_compiled``): with it on, XLA keeps some bf16 intermediates of a fusion
in float32, so the JAX package's own compiled and op-by-op results differ
by a bf16 ulp of whole layer-norm rows (0.04 in a logit here, enough to
flip greedy ids); with it off the compiled program rounds after every
bf16 operation, as the op-by-op program and the port do.

Tolerances, each where it is asserted:

- exact (or float32 sum order, 1e-6) wherever both packages round at the
  same points: the cast rule, ``pdot``, the embedding, the lineage
  attention's plain version, the fused cross-entropy's float32 outputs;
- a gradient of a bf16 use-site weight is rounded to bf16 in both
  packages, so where a float32 sum sits on a rounding tie the two round
  apart: 2e-5 plus two bf16 ulps (2^-7) of the largest entry of that
  gradient (``_assert_grads``);
- a whole model's loss and gradients: an activation that the two
  packages compute to float32 values a few ulps apart, on either side of
  a bf16 rounding boundary, enters a product one bf16 ulp apart, and
  everything after it moves (in the Transformer at larger weights the
  loss by 9e-4). So the port's distance to the JAX package's bf16 loss
  and gradients is held under a quarter of the distance between the JAX
  package's own bf16 and float32 results (measured: under 0.07 for the
  gradients, 0.24 for the loss with one such boundary crossed; 0.004
  and 0.11 without) (``_assert_tracks_jax_bf16``);
- greedy and beam ids equal, beam scores 1e-4 (the lineage kernel form
  1e-3: a normalised weight on a bf16 rounding tie rounds either way
  with the softmax sums in another order);
- the policy against float32, as tests/test_precision_policy.py: losses
  within 5% and beam scores within 0.05.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.model.sequence import \
    EmbeddedSequence as JaxEmbeddedSequence
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.beam_search_decoder import \
    BeamSearchDecoder as JaxBeamSearch
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.decoders.transformer import \
    TransformerDecoder as JaxTransformerDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.models.encoders.transformer import \
    TransformerEncoder as JaxTransformerEncoder
from neuralmonkey_tpu.ops import beam_select as jax_beam_select
from neuralmonkey_tpu.ops import fused_xent as jax_fused_xent
from neuralmonkey_tpu.ops import kernel_config as jax_kernel_config
from neuralmonkey_tpu.ops import lineage_attention as jax_lineage
from neuralmonkey_tpu.ops import moe as jax_moe
from neuralmonkey_tpu.ops import nn as jax_nn
from neuralmonkey_tpu.ops import policy as jax_policy
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch import run as torch_run
from neuralmonkey_tpu_torch import train as torch_train
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.model.sequence import EmbeddedSequence
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.decoders.transformer import \
    TransformerDecoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.models.encoders.transformer import \
    TransformerEncoder
from neuralmonkey_tpu_torch.ops import (beam_select, fused_xent,
                                        lineage_attention, moe, nn, policy)
from neuralmonkey_tpu_torch.utils.saving import (flatten_tree, load_flat,
                                                 params_from_jax)
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SRC, TGT, VOCAB = 3, 7, 6, 60
EXACT_ROUNDING = {"xla_allow_excess_precision": False}
BF16 = "bfloat16"


@contextlib.contextmanager
def both_policies(name):
    """Both packages' compute policy set to ``name``, reset after."""
    jax_policy.set_compute_dtype(name)
    policy.set_compute_dtype(name)
    try:
        yield
    finally:
        jax_policy.set_compute_dtype(None)
        policy.set_compute_dtype(None)


@pytest.fixture
def bf16():
    with both_policies(BF16):
        yield


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package's Pallas kernels, in interpret mode, on one
    device: a JAX manager built earlier in this process registers its
    8-device CPU mesh, past which a batch of 3 takes the XLA GRU scan,
    whose recurrent products round h to bf16 where the kernel keeps
    float32."""
    monkeypatch.setattr(jax_kernel_config, "_ACTIVE_MESH", None)
    monkeypatch.setenv("NM_USE_PALLAS", "1")
    jax_kernel_config._use_pallas_cached.cache_clear()
    yield monkeypatch
    jax_kernel_config._use_pallas_cached.cache_clear()


def _compiled(fn, *args):
    """``fn(*args)`` compiled with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(EXACT_ROUNDING)(*args)


def _assert_grads(got, ref):
    assert set(got) == set(ref)
    for key, g in got.items():
        r = np.asarray(ref[key], np.float32)
        assert g.dtype == torch.float32, key
        np.testing.assert_allclose(
            g.numpy(), r, rtol=0, atol=2e-5 + 2.0 ** -7 * np.abs(r).max(),
            err_msg=key)


def _jax_ctx(params, batch, train=False):
    return JaxContext(params, {k: jnp.asarray(v) for k, v in batch.items()},
                      train=train, rng=jax.random.PRNGKey(1))


def _port_ctx(params, batch, train=False):
    return Context(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                   train=train, rng=1)


def _jax_params(jax_part, seed=0, scale=0.3):
    template = jax_init(jax_collect_parts([jax_part]), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    flat = {k: (np.asarray(v) + rng.randn(*v.shape) * scale).astype(
        np.float32) for k, v in jax_flatten(template).items()}
    return template, flat


def _port_params(port_part, flat):
    return params_from_jax(flat, init_all_params(collect_parts([port_part]),
                                                 seed=0))


def _batch(rng, targets=True, rows=BATCH):
    mask = np.zeros((rows, SRC), np.float32)
    for i, n in enumerate([7, 4, 2, 5][:rows]):
        mask[i, :n] = 1.0
    batch = {"encoder_input.ids": rng.randint(4, VOCAB, (rows, SRC)).astype(
                 np.int32),
             "encoder_input.mask": mask}
    if targets:
        tmask = np.zeros((rows, TGT), np.float32)
        for i, n in enumerate([6, 3, 1, 4][:rows]):
            tmask[i, :n] = 1.0
        batch.update({
            "decoder.train_inputs": rng.randint(1, VOCAB, (rows, TGT)
                                                ).astype(np.int32),
            "decoder.train_targets": rng.randint(2, VOCAB, (rows, TGT)
                                                 ).astype(np.int32),
            "decoder.train_mask": tmask})
    return batch


# ---------------------------------------------------------------------- #
# the policy's rules
# ---------------------------------------------------------------------- #
def test_cast_rule_matches_jax(bf16):
    """Float32 leaves of two or more dims become bf16 (rounded to
    nearest even, as JAX rounds), vectors and integer leaves stay."""
    rng = np.random.RandomState(0)
    tree = {"vector": rng.randn(5), "matrix": rng.randn(3, 4),
            "stack": {"w": rng.randn(2, 3, 4)},
            "ids": np.arange(12).reshape(3, 4)}
    tree = {"vector": tree["vector"].astype(np.float32),
            "matrix": tree["matrix"].astype(np.float32),
            "stack": {"w": tree["stack"]["w"].astype(np.float32)},
            "ids": tree["ids"].astype(np.int32)}
    ref = jax_flatten(jax_policy.cast_params_for_compute(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    got = flatten_tree(policy.cast_params_for_compute(
        {"vector": torch.from_numpy(tree["vector"]),
         "matrix": torch.from_numpy(tree["matrix"]),
         "stack": {"w": torch.from_numpy(tree["stack"]["w"])},
         "ids": torch.from_numpy(tree["ids"])}))
    assert set(got) == set(ref)
    for key, value in got.items():
        assert str(value.dtype).split(".")[-1] == str(ref[key].dtype), key
        np.testing.assert_array_equal(
            value.float().numpy() if value.is_floating_point()
            else value.numpy(), np.asarray(ref[key]).astype(
                np.float32 if value.is_floating_point() else np.int32))


@pytest.mark.parametrize("explicit,env,expected", [
    (None, None, None), ("bfloat16", None, BF16), (None, "bfloat16", BF16),
    ("float32", "bfloat16", None), (None, "float32", None),
    (None, "float16", ValueError)])
def test_policy_precedence_matches_jax(monkeypatch, explicit, env, expected):
    """The experiment's key before ``NM_COMPUTE_DTYPE`` before float32;
    an unknown name in the variable raises JAX's ValueError."""
    if env is None:
        monkeypatch.delenv("NM_COMPUTE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("NM_COMPUTE_DTYPE", env)
    with both_policies(explicit):
        if expected is ValueError:
            with pytest.raises(ValueError) as ref:
                jax_policy.compute_dtype()
            with pytest.raises(ValueError) as got:
                policy.compute_dtype()
            assert str(got.value) == str(ref.value)
            return
        ref = jax_policy.compute_dtype()
        got = policy.compute_dtype()
        assert (ref is None) == (got is None) == (expected is None)
        if got is not None:
            assert got == torch.bfloat16 and ref == jnp.bfloat16


def test_invalid_compute_dtype_raises_like_jax():
    with pytest.raises(ValueError) as ref:
        jax_policy.set_compute_dtype("float16")
    with pytest.raises(ValueError) as got:
        policy.set_compute_dtype("float16")
    assert str(got.value) == str(ref.value)
    assert policy.compute_dtype() is None


# ---------------------------------------------------------------------- #
# parameter products, embeddings, recurrent encoders
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
    ("float32", "float32")])
def test_pdot_and_linear_match_jax(x_dtype, w_dtype):
    """bf16 x bf16 with float32 sums and output; a float32 activation
    joins a bf16 weight in bf16; forward and both gradients (the bf16
    cotangents rounded, as JAX's cast rounds them): float32 sum order."""
    rng = np.random.RandomState(1)
    x = rng.randn(5, 24).astype(np.float32)
    w = (rng.randn(24, 12) * 0.3).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    r = rng.randn(5, 12).astype(np.float32)

    def jax_fn(x, w, b):
        y = jax_nn.linear({"w": w.astype(w_dtype), "b": b},
                          x.astype(x_dtype))
        return jnp.sum(jnp.tanh(y) * r), y
    (_, ref), ref_grads = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(x, w, b)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = nn.linear({"w": wt.to(getattr(torch, w_dtype)), "b": bt},
                  xt.to(getattr(torch, x_dtype)))
    (torch.tanh(y) * torch.from_numpy(r)).sum().backward()
    assert y.dtype == torch.float32 and str(ref.dtype) == "float32"
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref),
                               atol=1e-6, rtol=1e-6)
    for got, want in zip((xt, wt, bt), ref_grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("scale", [False, True])
def test_embedding_matches_jax(bf16, scale):
    """The gather from the bf16 table and the depth scale in bf16
    (sqrt(d) rounded to bf16 first): exact; the table's gradient, each
    row looked up once, exact."""
    vocab = [f"w{i}" for i in range(VOCAB - 4)]
    jax_seq = JaxEmbeddedSequence(name="seq", vocabulary=JaxVocabulary(vocab),
                                  data_id="source", embedding_size=48,
                                  scale_embeddings_by_depth=scale)
    seq = EmbeddedSequence(name="seq", vocabulary=Vocabulary(vocab),
                           data_id="source", embedding_size=48,
                           scale_embeddings_by_depth=scale)
    _, flat = _jax_params(jax_seq)
    ids = np.random.RandomState(2).permutation(VOCAB)[:12].reshape(3, 4)
    r = np.random.RandomState(3).randn(3, 4, 48).astype(np.float32)

    def jax_fn(table):
        out = jax_seq.embed(JaxContext({"seq": {"embeddings": table}}, {}),
                            jnp.asarray(ids))
        return jnp.sum(out.astype(jnp.float32) * r), out
    (_, ref), ref_grad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(flat["seq/embeddings"]))
    table = torch.from_numpy(flat["seq/embeddings"]).requires_grad_()
    out = seq.embed(Context({"seq": {"embeddings": table}}, {}),
                    torch.from_numpy(ids))
    (out.float() * torch.from_numpy(r)).sum().backward()
    assert out.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    np.testing.assert_array_equal(table.grad.numpy(), np.asarray(ref_grad))


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_bidirectional_encoder_matches_jax(bf16, jax_pallas, cell):
    """A bidirectional GRU (K1's and the GRU BPTT's plain versions) and
    an LSTM (``lstm_scan``'s and ``lstm_bptt``'s) encoder under the
    policy against the JAX Pallas scans: bf16 embeddings and input
    weights into the hoisted product, float32 carries, the recurrent
    weights as the policy rounded them. States within float32 sum order
    (1e-5); gradients by ``_assert_grads``."""
    vocab = [f"w{i}" for i in range(VOCAB - 4)]
    jax_enc = JaxSentenceEncoder(name="encoder", vocabulary=JaxVocabulary(
        vocab), data_id="source", embedding_size=24, rnn_size=16,
        rnn_cell=cell, max_input_len=SRC)
    enc = SentenceEncoder(name="encoder", vocabulary=Vocabulary(vocab),
                          data_id="source", embedding_size=24, rnn_size=16,
                          rnn_cell=cell, max_input_len=SRC)
    template, flat = _jax_params(jax_enc, seed=3)
    batch = _batch(np.random.RandomState(4), targets=False)
    r = np.random.RandomState(5).randn(BATCH, SRC, 32).astype(np.float32)

    def jax_fn(p):
        states = jax_enc.temporal_states(_jax_ctx(p, batch, train=True))
        return jnp.sum(states * r), states
    (_, ref), ref_grads = _compiled(
        jax.value_and_grad(jax_fn, has_aux=True), jax_restore(template, flat))
    params = _port_params(enc, flat)
    leaves = flatten_tree(params)
    for p in leaves.values():
        p.requires_grad_(True)
    states = enc.temporal_states(_port_ctx(params, batch, train=True))
    (states * torch.from_numpy(r)).sum().backward()
    assert states.dtype == torch.float32
    np.testing.assert_allclose(states.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    _assert_grads({k: p.grad for k, p in leaves.items()},
                  jax_flatten(ref_grads))


def test_moe_ffn_matches_jax(bf16):
    """The mixture-of-experts FFN on the policy's parameters (the router
    widened to float32; the bf16 expert weights and biases beside float32
    tokens widened, as ``jnp.einsum`` promotes them): output and the
    gradients of the tokens and of every float32 master parameter, a
    padding token masked out; float32 sum order (1e-5)."""
    rng = np.random.RandomState(6)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jax_moe.moe_init(
        jax.random.PRNGKey(3), 16, 32, 4)).items()}
    x = rng.randn(2, 5, 16).astype(np.float32)
    mask = np.ones((2, 5), np.float32)
    mask[1, 3:] = 0.0
    r = rng.randn(2, 5, 16).astype(np.float32)

    def jax_fn(params, x):
        y, aux = jax_moe.moe_ffn(jax_policy.cast_params_for_compute(params),
                                 x, jnp.asarray(mask), top_k=2,
                                 capacity_factor=1.5)
        return jnp.sum(y * r) + aux["balance"] + aux["z"], y
    template = jax_moe.moe_init(jax.random.PRNGKey(3), 16, 32, 4)
    (_, ref), (ref_grads, ref_dx) = _compiled(
        jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True),
        jax_restore(template, flat), jnp.asarray(x))
    params = {}
    for key, value in flat.items():
        part, leaf = key.split("/")
        params.setdefault(part, {})[leaf] = torch.from_numpy(
            value.copy()).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(policy.cast_params_for_compute(params), xt,
                         torch.from_numpy(mask), top_k=2, capacity_factor=1.5)
    ((y * torch.from_numpy(r)).sum() + aux["balance"] + aux["z"]).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx),
                               atol=1e-5, rtol=1e-5)
    _assert_grads({f"{k}/{n}": p.grad for k, sub in params.items()
                   for n, p in sub.items()}, jax_flatten(ref_grads))


# ---------------------------------------------------------------------- #
# the kernels' plain versions under the policy
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("head_dim", [32, 64])
def test_lineage_attention_bf16_matches_jax(head_dim):
    """bf16 caches: q rounded and then scaled in bf16 (1/sqrt(32) is not
    a power of two, so that rounds again), float32 scores and softmax,
    normalised weights rounded to bf16, a float32 context; against the
    JAX package's plain version and its Pallas kernel (interpret mode):
    float32 sum order (1e-6)."""
    rng = np.random.RandomState(head_dim)
    batch, heads, beam, time, step = 2, 2, 4, 6, 4
    total, lanes = beam * time, (step + 1) * beam
    q = rng.randn(batch, heads, beam, head_dim).astype(np.float32)
    kc = rng.randn(batch, heads, head_dim, total).astype(np.float32)
    vc = rng.randn(batch, heads, total, head_dim).astype(np.float32)
    anc = rng.randint(0, beam, (batch, beam, time)).astype(np.int32)
    bias = lineage_attention.lineage_bias(torch.from_numpy(anc), step,
                                          step + 1, beam, lanes, time)
    kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (kc, vc))

    def jax_ref(q, k, v, b):
        return jax_lineage.lineage_attention_reference(
            q, k[..., :lanes], v[:, :, :lanes], b, beam)
    args = (jnp.asarray(q), kb, vb, jnp.asarray(bias.numpy()))
    ref = _compiled(jax_ref, *args)
    kernel = jax_lineage.lineage_attention(*args, lanes)
    got = lineage_attention.lineage_attention(
        torch.from_numpy(q), torch.from_numpy(kc).to(torch.bfloat16),
        torch.from_numpy(vc).to(torch.bfloat16), bias)
    assert got.dtype == torch.float32
    for want in (ref, kernel):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("transposed", [False, True])
def test_fused_xent_bf16_w_matches_jax(jax_pallas, transposed):
    """The policy's mixed pair (float32 states, bf16 table) through the
    JAX fused kernels (interpret mode: the pair widened to float32) and
    the port's plain path: nll, dx and db within float32 sum order
    (1e-5), dW rounded to bf16 in both (its dtype), within two bf16 ulps
    of its largest entry."""
    jax_pallas.setenv("NM_FUSED_XENT", "1")
    rng = np.random.RandomState(7)
    n, d, v = 16, 128, 300
    x = (rng.randn(n, d) * 0.3).astype(np.float32)
    w = (rng.randn(*((v, d) if transposed else (d, v))) * 0.05).astype(
        np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    targets = rng.randint(0, v, n).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    assert jax_fused_xent.eligible(n, d, jnp.float32, jnp.bfloat16)

    def jax_fn(x, w, b):
        nll = jax_fused_xent.fused_softmax_xent(x, w, b, jnp.asarray(targets),
                                                0.1, transposed)
        return jnp.sum(nll * g), nll
    (_, ref), (rdx, rdw, rdb) = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x), wb,
                                                 jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    assert fused_xent.eligible(xt, wt)
    nll = fused_xent.fused_softmax_xent(xt, wt, bt, torch.from_numpy(targets),
                                        0.1, transposed)
    (nll * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(rdx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(rdb), atol=1e-5,
                               rtol=1e-5)
    assert wt.grad.dtype == torch.bfloat16 and str(rdw.dtype) == "bfloat16"
    rdw = np.asarray(rdw.astype(jnp.float32))
    np.testing.assert_allclose(wt.grad.float().numpy(), rdw, rtol=0,
                               atol=2.0 ** -7 * np.abs(rdw).max())


def test_fused_logits_bf16_w_matches_jax(bf16, jax_pallas):
    """K3 computes in float32: with a bf16 w both packages compute the
    float32 logits of the widened table (the JAX package in its plain
    twin, the port by widening w before K3). Under the policy both arm
    the beam search with the bf16-rounded table widened to float32, so
    K3 itself runs there."""
    rng = np.random.RandomState(8)
    x = rng.randn(16, 128).astype(np.float32)
    w = (rng.randn(128, 1024) * 0.1).astype(np.float32)
    b = rng.randn(1024).astype(np.float32)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    ref = jax_beam_select.fused_logits_rowmax_lse(
        jnp.asarray(x), wb, jnp.asarray(b)[None], force_pallas=True)
    got = beam_select.fused_logits_rowmax_lse(
        torch.from_numpy(x), torch.from_numpy(w).to(torch.bfloat16),
        torch.from_numpy(b))
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-6)
    jax_dec = _build_transformer(JaxTransformerEncoder, JaxTransformerDecoder,
                                 JaxVocabulary)
    dec = _build_transformer(TransformerEncoder, TransformerDecoder,
                             Vocabulary)
    template, flat = _jax_params(jax_dec)
    batch = _batch(np.random.RandomState(9), targets=False)
    jax_const = jax_dec.prepare_selection_fusion(jax_dec.decode_constants(
        _jax_ctx(jax_restore(template, flat), batch)))
    const = dec.prepare_selection_fusion(dec.decode_constants(
        _port_ctx(_port_params(dec, flat), batch)))
    (jw, _), (tw, _) = jax_const["fused_logit"], const["fused_logit"]
    assert tw.dtype == torch.float32 and str(jw.dtype) == "float32"
    np.testing.assert_array_equal(tw.numpy()[:, :VOCAB],
                                  np.asarray(jw)[:, :VOCAB])


# ---------------------------------------------------------------------- #
# the slices under the policy
# ---------------------------------------------------------------------- #
def _build_rnn(enc_cls, att_cls, dec_cls, vocab_cls, max_out=TGT,
               width=16):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=width, rnn_size=width, max_input_len=SRC)
    att = att_cls(name="attention", encoder=enc, state_size=width)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=max_out, rnn_size=width, encoders=[enc],
                   attentions=[att], embedding_size=width,
                   conditional_gru=True, label_smoothing=0.1)


def _build_transformer(enc_cls, dec_cls, vocab_cls, max_out=TGT, width=32):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=width, ff_hidden_size=64, depth=1,
                  n_heads=4, dropout_keep_prob=1.0, max_input_len=SRC)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=max_out, encoders=[enc],
                   embedding_size=width, ff_hidden_size=64, depth=1,
                   n_heads_self=4, n_heads_enc=4, label_smoothing=0.1,
                   dropout_keep_prob=1.0)


MODELS = {
    "rnn": (lambda width=16: _build_rnn(
                JaxSentenceEncoder, JaxAttention, JaxDecoder, JaxVocabulary,
                width=width),
            lambda width=16: _build_rnn(SentenceEncoder, Attention, Decoder,
                                        Vocabulary, width=width)),
    "transformer": (lambda width=32: _build_transformer(
                        JaxTransformerEncoder, JaxTransformerDecoder,
                        JaxVocabulary, width=width),
                    lambda width=32: _build_transformer(
                        TransformerEncoder, TransformerDecoder, Vocabulary,
                        width=width)),
}


def _losses_and_grads(model, batch, width, policies=(BF16, None)):
    """{(package, policy): (loss, flat gradients)} of one teacher-forced
    pass from the same parameters: the JAX package under ``policies``,
    the port under bf16."""
    jax_dec, dec = MODELS[model][0](width), MODELS[model][1](width)
    template, flat = _jax_params(jax_dec)

    def jax_loss(p):
        return jax_dec.train_loss(_jax_ctx(p, batch, train=True))
    results = {}
    for name in policies:
        with both_policies(name):
            loss, grads = _compiled(jax.value_and_grad(jax_loss),
                                    jax_restore(template, flat))
            results[("jax", name)] = (float(loss), {
                k: np.asarray(v) for k, v in jax_flatten(grads).items()})
    params = _port_params(dec, flat)
    leaves = flatten_tree(params)
    for p in leaves.values():
        p.requires_grad_(True)
    with both_policies(BF16):
        loss = dec.train_loss(_port_ctx(params, batch, train=True))
        loss.backward()
    assert all(p.dtype == torch.float32 for p in leaves.values())
    results[("port", BF16)] = (loss.item(), {k: p.grad.numpy()
                                             for k, p in leaves.items()})
    return results


def _tree_distance(a, b):
    assert set(a) == set(b)
    return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in a)))


def _assert_tracks_jax_bf16(results):
    (ref_loss, ref), (loss32, ref32) = results[("jax", BF16)], \
        results[("jax", None)]
    loss, grads = results[("port", BF16)]
    assert abs(loss - ref_loss) <= 0.25 * abs(ref_loss - loss32) + 1e-6
    assert _tree_distance(grads, ref) <= 0.25 * _tree_distance(ref, ref32)


def _assert_rnn_matches(results):
    """The RNN crosses no bf16 rounding boundary apart from the JAX
    package here (its recurrences keep float32 carries): the loss to
    1e-5 and the gradients by ``_assert_grads``."""
    (ref_loss, ref), (loss, grads) = results[("jax", BF16)], \
        results[("port", BF16)]
    assert loss == pytest.approx(ref_loss, abs=1e-5)
    _assert_grads({k: torch.from_numpy(g) for k, g in grads.items()}, ref)


@pytest.mark.parametrize("model", ["rnn", "transformer"])
def test_loss_and_gradients_match_jax(jax_pallas, model):
    """The teacher-forced loss (label smoothing 0.1) and the gradient of
    every float32 master parameter through the cast at use, materialized
    logits: the RNN by ``_assert_rnn_matches``, the Transformer by
    ``_assert_tracks_jax_bf16``."""
    batch = _batch(np.random.RandomState(2))
    if model == "rnn":
        _assert_rnn_matches(_losses_and_grads(model, batch, 16, (BF16,)))
    else:
        _assert_tracks_jax_bf16(_losses_and_grads(model, batch, 32))


@pytest.mark.parametrize("model", ["rnn", "transformer"])
def test_fused_xent_loss_and_gradients_match_jax(jax_pallas, model):
    """``NM_FUSED_XENT=1`` at a width of 128 and 24 tokens, which the JAX
    package's fused gate takes too (d % 128, n % 8): its kernels widen
    the float32 states against the bf16 table, as the port's fused path
    does, where its materialized untied projection would round the
    states to bf16 (``pdot``). The loss and gradients by
    ``_assert_tracks_jax_bf16`` (at this width the RNN's activations
    cross bf16 rounding boundaries apart too)."""
    jax_pallas.setenv("NM_FUSED_XENT", "1")
    batch = _batch(np.random.RandomState(2), rows=4)
    _assert_tracks_jax_bf16(_losses_and_grads(model, batch, 128))


def _decode_both(model, beam, tmp_path, max_out=9):
    """Greedy ids and beam-``beam`` search results of both packages from
    one shared ``.npz``, the JAX side compiled with every rounding."""
    jax_dec = (_build_rnn(JaxSentenceEncoder, JaxAttention, JaxDecoder,
                          JaxVocabulary, max_out) if model == "rnn" else
               _build_transformer(JaxTransformerEncoder,
                                  JaxTransformerDecoder, JaxVocabulary,
                                  max_out))
    dec = (_build_rnn(SentenceEncoder, Attention, Decoder, Vocabulary,
                      max_out) if model == "rnn" else
           _build_transformer(TransformerEncoder, TransformerDecoder,
                              Vocabulary, max_out))
    template, flat = _jax_params(jax_dec, seed=4)
    ckpt = tmp_path / "shared.npz"
    with open(ckpt, "wb") as f:
        np.savez(f, **flat)
    params = params_from_jax(load_flat(str(ckpt)), init_all_params(
        collect_parts([dec]), seed=0))
    batch = _batch(np.random.RandomState(5), targets=False)
    jax_bs = JaxBeamSearch(name="bs", parent_decoder=jax_dec, beam_size=beam,
                           selection_method="hierarchical")
    bs = BeamSearchDecoder(name="bs", parent_decoder=dec, beam_size=beam,
                           selection_method="hierarchical")
    jp = jax_restore(template, flat)
    ref_greedy = _compiled(lambda p: jax_dec.decoded(_jax_ctx(p, batch)), jp)
    ref = _compiled(lambda p: jax_bs.search(_jax_ctx(p, batch)), jp)
    with torch.inference_mode():
        ctx = _port_ctx(params, batch)
        greedy = dec.decoded(ctx)
        got = bs.search(ctx)
    return ((np.asarray(ref_greedy), np.asarray(ref.token_ids),
             np.asarray(ref.lengths), np.asarray(ref.scores)),
            (greedy.numpy(), got.token_ids.numpy(), got.lengths.numpy(),
             got.scores.numpy()))


@pytest.mark.parametrize("model,lineage_kernel", [
    ("rnn", "0"), ("transformer", "0"), ("transformer", "1")])
def test_decoding_matches_jax(bf16, jax_pallas, tmp_path, model,
                              lineage_kernel):
    """Greedy and beam-10 ids under the policy: the RNN (K1's plain scan
    on bf16 inputs, the conditional GRU through ``pdot``), the
    Transformer's einsum lineage form and its kernel layout on bf16
    caches; ids equal, scores 1e-4 (kernel layout 1e-3)."""
    jax_pallas.setenv("NM_LINEAGE_KERNEL", lineage_kernel)
    ref, got = _decode_both(model, 10, tmp_path)
    for name, a, b in zip(("greedy", "beam ids", "lengths"), got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(got[3], ref[3], rtol=0,
                               atol=1e-3 if lineage_kernel == "1" else 1e-4)


@pytest.mark.parametrize("model", ["rnn", "transformer"])
def test_bf16_tracks_float32(tmp_path, model):
    """The port under the policy against itself in float32, as the JAX
    package's tests/test_precision_policy.py holds its own: the loss
    within 5%, beam-10 scores within 0.05 (ids may differ at near ties:
    not compared), and the policy does change the numbers."""
    batch = _batch(np.random.RandomState(2))
    dec = MODELS[model][1]()
    params = init_all_params(collect_parts([dec]), seed=3)
    bs = BeamSearchDecoder(name="bs", parent_decoder=dec, beam_size=10)
    results = {}
    for name in (None, BF16):
        with both_policies(name), torch.inference_mode():
            ctx = _port_ctx(params, batch, train=False)
            results[name] = (dec.train_loss(ctx).item(),
                             bs.search(_port_ctx(params, batch)).scores)
    (loss32, scores32), (loss16, scores16) = results[None], results[BF16]
    assert loss16 == pytest.approx(loss32, rel=0.05)
    assert loss16 != loss32
    np.testing.assert_allclose(scores16.numpy(), scores32.numpy(), atol=0.05,
                               rtol=0)


# ---------------------------------------------------------------------- #
# an INI through the CLIs
# ---------------------------------------------------------------------- #
DATA_INI = """\
[main]
test_datasets=[<val_data>]

[val_data]
class=dataset.load_dataset_from_files
s_source="{repo}/tests/data/val.en"
s_target_out="{out}/decoded.txt"
"""


def test_ini_trains_and_runs_under_bf16(tmp_path, monkeypatch):
    """tests/configs/beamsearch.ini trains one epoch through ``train``
    under ``NM_COMPUTE_DTYPE=bfloat16`` (finite losses; the checkpoints
    and the optimizer state stay float32) and decodes through ``run``
    with ``[main] compute_dtype="bfloat16"`` in the INI."""
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("NM_COMPUTE_DTYPE", BF16)
    out = tmp_path / "out"
    assert torch_train.main([
        os.path.join(REPO, "tests", "configs", "beamsearch.ini"),
        'tf_manager.device="cpu"', f'main.output="{out}"',
        "main.epochs=1"]) == 0
    assert policy.compute_dtype() == torch.bfloat16
    best = load_flat(str(out / "variables.data.best"))
    assert best and all(v.dtype == np.float32 for v in best.values())
    opt = load_flat(str(out / "variables.data.opt"))
    assert all(v.dtype != np.dtype("bfloat16") and v.dtype != np.float16
               for v in opt.values())
    with open(out / "metrics.jsonl", encoding="utf-8") as f:
        losses = [json.loads(line)["loss"] for line in f
                  if '"loss"' in line]
    assert losses and np.isfinite(losses).all()
    monkeypatch.delenv("NM_COMPUTE_DTYPE")
    run_ini = tmp_path / "run.ini"
    run_ini.write_text((out / "experiment.ini").read_text().replace(
        "[main]\n", '[main]\ncompute_dtype="bfloat16"\n', 1))
    data_ini = tmp_path / "data.ini"
    data_ini.write_text(DATA_INI.format(repo=REPO, out=tmp_path))
    try:
        assert torch_run.main([str(run_ini), str(data_ini),
                               str(out / "variables.data.best")]) == 0
        assert policy.compute_dtype() == torch.bfloat16
    finally:
        policy.set_compute_dtype(None)
    decoded = (tmp_path / "decoded.txt").read_text().splitlines()
    with open(os.path.join(REPO, "tests", "data", "val.en"),
              encoding="utf-8") as f:
        assert len(decoded) == len(f.readlines())
