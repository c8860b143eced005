"""Plain versions of the port's Transformer kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_flash_dropout.py and tests/test_lineage_attention.py run
them, from the same numpy inputs.

- The attention-dropout hash (``keep_hash``) on edge counters, batch·head
  indices and key words against ``pallas_attention._keep_hash``: exact.
- The flash forward's plain version (out and lse) against
  ``_flash_attention_pallas``: causal and not, ragged masks, a fully
  masked row, Tq != Tk; tolerance 1e-5 (float32 sums in another order).
- With dropout: the dense keep mask bit-identical to ``_keep_mask_dense``
  for the same key words, and the outputs to 1e-5.
- dq, dk and dv of the plain backward (through the port's autograd
  Function) against ``_flash_backward_pallas``, with and without
  dropout, to 1e-5; and the ``NM_FLASH_BWD=0`` remat path against them.
- ``lineage_bias`` and the lineage plain version against
  ``lineage_bias`` and ``lineage_attention`` at several windows, and
  against the einsum form of the decoder's lineage step; 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.ops import lineage_attention as jax_la
from neuralmonkey_tpu.ops import pallas_attention as pa

from neuralmonkey_tpu_torch.ops import attention, flash_attention as fa
from neuralmonkey_tpu_torch.ops import lineage_attention as la

torch.set_num_threads(1)
KEEP = 0.8
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(rng, batch=2, heads=2, tq=12, tk=12, dim=8):
    return tuple(rng.randn(batch, heads, t, dim).astype(np.float32)
                 for t in (tq, tk, tk))


def _mask(batch, time, lengths):
    mask = np.zeros((batch, time), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return mask


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _key(seed=42):
    words = np.asarray(pa.rng_to_key_words(jax.random.PRNGKey(seed)))
    return int(words[0]), int(words[1])


# ---------------------------------------------------------------------- #
# the hash
# ---------------------------------------------------------------------- #
EDGE_WORDS = [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 0x12345678, -0x2F3A1B7C]


@pytest.mark.parametrize("k0,k1", [(a, b) for a in EDGE_WORDS[:4]
                                   for b in EDGE_WORDS[3:]])
def test_keep_hash_matches_jax_bit_for_bit(k0, k1):
    rng = np.random.RandomState(3)
    pos = np.concatenate([
        np.array([0, 1, 2, 2 ** 16 - 1, 2 ** 16, 2 ** 31 - 1, -2 ** 31, -1],
                 np.int64),
        rng.randint(-2 ** 31, 2 ** 31, 56)]).astype(np.int32)
    bh = np.array([0, 1, 7, 511, 2 ** 20, 2 ** 31 - 1, -1, 12345],
                  np.int32)[:, None]
    ref = np.asarray(pa._keep_hash(jnp.int32(k0), jnp.int32(k1),
                                   jnp.asarray(bh), jnp.asarray(pos)))
    got = fa.keep_hash(k0, k1, torch.from_numpy(bh.astype(np.int64)),
                       torch.from_numpy(pos.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  ref.astype(np.int64).astype(np.uint32))


@pytest.mark.parametrize("keep", [0.1, 0.5, 0.8, 0.9, 0.999, 1.0])
def test_keep_threshold_matches_jax(keep):
    assert fa.keep_threshold(keep) == int(pa._keep_thresh(keep))


# ---------------------------------------------------------------------- #
# the forward
# ---------------------------------------------------------------------- #
FWD_CASES = [
    # (causal, tq, tk, lengths)
    (False, 12, 12, [12, 7]),
    (True, 12, 12, [12, 12]),
    (False, 9, 13, [13, 4]),
    (False, 12, 12, [12, 0]),   # a fully masked row (every key masked)
    (True, 16, 16, [16, 16]),
]


@pytest.mark.parametrize("causal,tq,tk,lengths", FWD_CASES)
@pytest.mark.parametrize("dropout", [False, True])
def test_flash_forward_matches_jax_kernel(causal, tq, tk, lengths, dropout):
    rng = np.random.RandomState(11)
    q, k, v = _qkv(rng, tq=tq, tk=tk)
    mask = _mask(2, tk, lengths)
    key = _key() if dropout else None
    keep = KEEP if dropout else 1.0
    ref_out, ref_lse = pa._flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        causal, 128, 128,
        None if key is None else jnp.asarray(key, jnp.int32), keep)
    out, lse = fa.flash_forward_reference(*_t(q, k, v, mask), causal, key,
                                          keep)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse)[..., 0]
                               if np.ndim(ref_lse) == 4
                               else np.asarray(ref_lse), **TOL)
    # through the autograd Function (the CPU dispatch)
    got = fa.flash_attention(*_t(q, k, v, mask), causal, key, keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_out), **TOL)


def test_fully_masked_row_is_uniform():
    rng = np.random.RandomState(5)
    q, k, v = _qkv(rng, batch=1)
    out, lse = fa.flash_forward_reference(*_t(q, k, v, _mask(1, 12, [0])),
                                          False)
    torch.testing.assert_close(out, torch.from_numpy(v).mean(
        dim=2, keepdim=True).expand_as(out), atol=1e-6, rtol=0)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("shape", [(2, 2, 12, 12), (3, 4, 9, 13),
                                   (1, 8, 48, 48)])
def test_keep_mask_matches_jax_bit_for_bit(shape):
    key = _key(7)
    batch, heads, tq, tk = shape
    ref = np.asarray(pa._keep_mask_dense(jnp.asarray(key, jnp.int32),
                                         batch, heads, tq, tk, 0.9))
    got = fa.keep_mask_dense(key, batch, heads, tq, tk, 0.9)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.85 < float(got.float().mean()) < 0.95


def test_dropout_key_words_follow_the_seed():
    assert fa.dropout_key_words(5) == fa.dropout_key_words(5)
    assert fa.dropout_key_words(5) != fa.dropout_key_words(6)
    assert all(-2 ** 31 <= w < 2 ** 31 for w in fa.dropout_key_words(9))


# ---------------------------------------------------------------------- #
# the backward
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("causal,tq,tk,lengths", FWD_CASES[:3])
@pytest.mark.parametrize("dropout", [False, True])
def test_flash_backward_matches_jax_kernels(monkeypatch, causal, tq, tk,
                                            lengths, dropout):
    rng = np.random.RandomState(13)
    q, k, v = _qkv(rng, tq=tq, tk=tk)
    g = rng.randn(*q.shape).astype(np.float32)
    mask = _mask(2, tk, lengths)
    key = _key(3) if dropout else None
    keep = KEEP if dropout else 1.0
    jkey = None if key is None else jnp.asarray(key, jnp.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, mask)]
    out, lse = pa._flash_attention_pallas(*jargs, causal, 128, 128, jkey,
                                          keep)
    ref = pa._flash_backward_pallas(*jargs, out, lse.reshape(out.shape[:3]),
                                    jnp.asarray(g), causal, jkey, keep)
    for remat in ("1", "0"):
        monkeypatch.setenv("NM_FLASH_BWD", remat)
        tq_, tk_, tv_ = (t.clone().requires_grad_() for t in _t(q, k, v))
        fa.flash_attention(tq_, tk_, tv_, torch.from_numpy(mask), causal,
                           key, keep).backward(torch.from_numpy(g))
        for name, got, want in zip("qkv", (tq_, tk_, tv_), ref):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                       atol=2e-5, rtol=1e-5,
                                       err_msg=f"d{name} remat={remat}")


def test_mha_dispatch_flash_and_dense_agree(monkeypatch):
    """A key mask takes flash attention, a bias or NM_FLASH_DROPOUT=0
    with dropout the dense path; without dropout all agree."""
    gen = torch.Generator().manual_seed(0)
    params = attention.mha_init(gen, 16, 16, 16)
    x = torch.randn(2, 6, 16, generator=gen)
    mask = torch.from_numpy(_mask(2, 6, [6, 3]))
    flash = attention.multi_head_attention(params, x, x, x, 4,
                                           key_mask=mask, causal=True)
    bias = (attention.attention_bias_from_mask(mask)
            + attention.causal_bias(6))
    dense = attention.multi_head_attention(params, x, x, x, 4, bias=bias)
    torch.testing.assert_close(flash, dense, atol=1e-5, rtol=1e-5)
    monkeypatch.setenv("NM_FLASH_DROPOUT", "0")
    dropped = attention.multi_head_attention(
        params, x, x, x, 4, key_mask=mask, dropout_seed=3,
        dropout_keep_prob=0.5)
    assert not torch.allclose(dropped, flash)


# ---------------------------------------------------------------------- #
# lineage attention
# ---------------------------------------------------------------------- #
BATCH, HEADS, BEAM, T, DH = 2, 2, 3, 6, 8


def _lineage_case(step):
    rng = np.random.RandomState(21 + step)
    anc = np.broadcast_to(np.arange(BEAM, dtype=np.int32)[None, :, None],
                          (BATCH, BEAM, T)).copy()
    anc[:, :, :step + 1] = rng.randint(0, BEAM, (BATCH, BEAM, step + 1))
    q = rng.randn(BATCH, HEADS, BEAM, DH).astype(np.float32)
    kq = rng.randn(BATCH, HEADS, DH, BEAM * T).astype(np.float32)
    vq = rng.randn(BATCH, HEADS, BEAM * T, DH).astype(np.float32)
    return anc, q, kq, vq


@pytest.mark.parametrize("step,win", [(0, 1), (2, 3), (4, 6), (5, 6),
                                      (2, 6)])
def test_lineage_matches_jax_kernel(step, win):
    anc, q, kq, vq = _lineage_case(step)
    total = BEAM * T
    lanes = la.lane_window(win, BEAM, total)
    jlanes = jax_la.lane_window(win, BEAM, total)
    ref_bias = np.asarray(jax_la.lineage_bias(jnp.asarray(anc), step, win,
                                              BEAM, jlanes, T))
    bias = la.lineage_bias(torch.from_numpy(anc), step, win, BEAM, lanes, T)
    np.testing.assert_array_equal(bias.numpy(), ref_bias[:, :BEAM, :lanes])
    k16 = ref_bias.shape[1]
    q16 = np.pad(q, ((0, 0), (0, 0), (0, k16 - BEAM), (0, 0)))
    ref = np.asarray(jax_la.lineage_attention(
        jnp.asarray(q16), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(ref_bias), jlanes))[:, :, :BEAM]
    got = la.lineage_attention(*_t(q, kq, vq), bias)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("step", [0, 3, 5])
def test_lineage_plain_version_equals_einsum_form(step):
    """The flat softmax over (slot, time) lanes with the ancestry bias
    equals the decoder's einsum form on the same caches in row layout."""
    anc, q, kq, vq = _lineage_case(step)
    win = step + 1
    bias = la.lineage_bias(torch.from_numpy(anc), step, win, BEAM,
                           la.lane_window(win, BEAM, BEAM * T), T)
    got = la.lineage_attention_reference(*_t(q, kq, vq), bias)
    # rows layout: kh[b, j, t, h, d] = kq[b, h, d, t*K + j]
    kh = torch.from_numpy(kq).reshape(BATCH, HEADS, DH, T, BEAM).permute(
        0, 4, 3, 1, 2)[:, :, :win]
    vh = torch.from_numpy(vq).reshape(BATCH, HEADS, T, BEAM, DH).permute(
        0, 3, 2, 1, 4)[:, :, :win]
    lineage = (torch.from_numpy(anc)[:, :, None, :win]
               == torch.arange(BEAM)[None, None, :, None]).float()
    qh = torch.from_numpy(q).transpose(1, 2)
    s_full = torch.einsum("bkhd,bjthd->bhkjt", qh, kh) * DH ** -0.5
    s = torch.einsum("bhkjt,bkjt->bhkt", s_full, lineage)
    w_slot = torch.einsum("bhkt,bkjt->bhkjt", torch.softmax(s, -1), lineage)
    ref = torch.einsum("bhkjt,bjthd->bkhd", w_slot, vh).transpose(1, 2)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
