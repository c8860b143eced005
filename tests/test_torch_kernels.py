"""Plain versions of the port's kernels against the JAX package's
Pallas kernels, run in interpret mode on the CPU as tests/test_pallas.py
runs them, from the same numpy inputs.

K1 gru_scan, K2 fused_bahdanau_step, K3 fused_logits_rowmax_lse and K4
small_topk at small sizes (batch 3, source 7, width 16, vocabulary 300
padded to 1024, beam 4); tolerance 1e-5, and exact indices for K4 with
ties included. Also the kernel build's host-side behaviour, and the
source text that scripts/grad_rule_faults.py edits to plant its faults.
"""

import importlib.util
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.ops import beam_select as jax_beam_select
from neuralmonkey_tpu.ops.pallas_attention import \
    fused_bahdanau_step as jax_bahdanau
from neuralmonkey_tpu.ops.pallas_rnn import (bidirectional_gru_scan,
                                             gru_scan as jax_gru_scan)

from neuralmonkey_tpu_torch.ops import (beam_select, cuda_attention,
                                        cuda_rnn, kernel_config)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BATCH, TIME, WIDTH, HIDDEN = 3, 7, 16, 16
BEAM, VOCAB = 4, 300
RNG = np.random.RandomState(0)


def _mask(lengths, time=TIME):
    mask = np.zeros((len(lengths), time), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return mask


def _gru_params(rng):
    def u(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return {"gates_x": u(WIDTH, 2 * HIDDEN), "gates_h": u(HIDDEN, 2 * HIDDEN),
            "gates_b": np.ones(2 * HIDDEN, np.float32),
            "cand_x": u(WIDTH, HIDDEN), "cand_h": u(HIDDEN, HIDDEN),
            "cand_b": u(HIDDEN)}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_matches_pallas(reverse):
    params = _gru_params(RNG)
    inputs = RNG.randn(BATCH, TIME, WIDTH).astype(np.float32)
    mask = _mask([7, 4, 2])
    ref_out, ref_final = jax_gru_scan(_jax(params), jnp.asarray(inputs),
                                      jnp.asarray(mask), reverse=reverse)
    out, final = cuda_rnn.gru_scan([(_torch(params), reverse)],
                                   torch.from_numpy(inputs),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(ref_final),
                               atol=1e-5)


def test_bidirectional_gru_scan_matches_pallas():
    fw, bw = _gru_params(RNG), _gru_params(RNG)
    inputs = RNG.randn(BATCH, TIME, WIDTH).astype(np.float32)
    mask = _mask([7, 1, 5])
    ref_out, ref_final = bidirectional_gru_scan(
        _jax(fw), _jax(bw), jnp.asarray(inputs), jnp.asarray(mask))
    out, final = cuda_rnn.gru_scan(
        [(_torch(fw), False), (_torch(bw), True)],
        torch.from_numpy(inputs), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(final.numpy(), np.asarray(ref_final),
                               atol=1e-5)


def test_gru_scan_fits():
    """Any hidden size whose three state tiles fit 227 KiB."""
    assert cuda_rnn.scan_fits(512) and cuda_rnn.scan_fits(4100)
    assert cuda_rnn.scan_fits(18) and cuda_rnn.scan_fits(19368)
    assert not cuda_rnn.scan_fits(19369)


def test_bahdanau_step_matches_pallas():
    """Includes a fully masked row: zero weights and context."""
    keys = RNG.randn(BATCH, TIME, WIDTH).astype(np.float32)
    states = RNG.randn(BATCH, TIME, 2 * WIDTH).astype(np.float32)
    mask = _mask([7, 3, 0])
    pq = RNG.randn(BATCH, WIDTH).astype(np.float32)
    v = RNG.randn(WIDTH).astype(np.float32)
    ref_ctx, ref_w = jax_bahdanau(*map(jnp.asarray,
                                       (keys, states, mask, pq, v)))
    ctx, w = cuda_attention.fused_bahdanau_step(
        *map(torch.from_numpy, (keys, states, mask, pq, v)))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-5)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ref_ctx), atol=1e-5)
    assert not w[2].any() and not ctx[2].any()


def test_fused_logits_matches_pallas():
    """One beam step's projection, padded as the search pads it."""
    n, vp = BATCH * BEAM, 1024
    x = RNG.randn(n, WIDTH).astype(np.float32)
    w = np.zeros((WIDTH, vp), np.float32)
    w[:, :VOCAB] = RNG.randn(WIDTH, VOCAB) * 0.3
    b = np.full((1, vp), -1e9, np.float32)
    b[0, :VOCAB] = RNG.randn(VOCAB) * 0.1
    tiling = jax_beam_select._fused_tiling(n, WIDTH, vp)
    ref = jax_beam_select._fused_pallas(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b), tiling)
    got = beam_select.fused_logits_rowmax_lse(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert got[1].shape == (n, vp // 128)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-6)


def test_rowmax_lse_matches_pallas():
    # the Pallas kernel takes rows in blocks of 8
    x = (RNG.randn(16, 1024) * 4).astype(np.float32)
    ref = jax_beam_select._rowmax_lse_pallas(jnp.asarray(x))
    got = beam_select.rowmax_lse(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("shape,k", [((BATCH, BEAM * 8), BEAM),
                                     ((BATCH, BEAM * 128), BEAM),
                                     ((5, 300), 7)])
def test_small_topk_matches_pallas(shape, k):
    """Exact values and indices; rounding forces ties, which go to the
    lowest index."""
    x = np.round(RNG.randn(*shape) * 3).astype(np.float32)
    ref_v, ref_i = jax_beam_select._topk_pallas(jnp.asarray(x), k)
    got_v, got_i = beam_select.small_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert got_i.dtype == torch.int32


def test_small_topk_rejects_k_beyond_row():
    with pytest.raises(ValueError, match="k=5"):
        beam_select.small_topk(torch.zeros(2, 4), 5)


# ---------------------------------------------------------------------- #
# the kernel build, on the host side
# ---------------------------------------------------------------------- #
def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernel_config, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernel_config, "NVCC_DEFAULT",
                        str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(kernel_config.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_config.build()


def test_library_path_follows_the_sources(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_config.CSRC_DIR, csrc)
    monkeypatch.setattr(kernel_config, "CSRC_DIR", str(csrc))
    first = kernel_config.library_path()
    assert first == kernel_config.library_path()
    assert os.path.basename(first).startswith("libnm_kernels_")
    with open(csrc / "gru_scan.cu", "a") as f:
        f.write("// edited\n")
    assert kernel_config.library_path() != first


def test_every_kernel_has_an_entry_point_in_the_sources():
    sources = "".join(open(p).read() for p in kernel_config.kernel_sources())
    assert set(kernel_config.ENTRY_POINTS) == {
        "gru_scan", "gru_bptt", "fused_bahdanau_step",
        "fused_logits_rowmax_lse", "small_topk", "fused_xent_fwd",
        "fused_xent_bwd_dx", "fused_xent_bwd_dw", "flash_attention_fwd",
        "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
        "lineage_attention", "lstm_scan", "lstm_bptt", "rowmax_lse",
        "flash_attention_fwd_chunked", "flash_attention_bwd_dq_chunked",
        "flash_attention_bwd_dkv_chunked", "lineage_attention_chunked",
        "lineage_attention_bf16", "fused_xent_fwd_bf16w",
        "fused_xent_bwd_dx_bf16w", "fused_xent_bwd_dw_bf16w",
        "fused_xent_bwd_dx_bf16w_widened", "fused_xent_bwd_dw_bf16w_widened",
        "fused_xent_fwd_bf16w_widened", "lineage_attention_bf16_scratch"}
    for entry in kernel_config.ENTRY_POINTS.values():
        assert f"NM_EXPORT int {entry}(" in sources


def test_plain_paths_count_no_launches():
    kernel_config.reset_launch_counts()
    beam_select.small_topk(torch.randn(2, 8), 3)
    cuda_attention.fused_bahdanau_step(
        torch.randn(2, 3, 4), torch.randn(2, 3, 5), torch.ones(2, 3),
        torch.randn(2, 4), torch.randn(4))
    assert kernel_config.launch_counts() == dict.fromkeys(
        kernel_config.ENTRY_POINTS, 0)


def _planted_faults():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "grad_rule_faults.py")
    spec = importlib.util.spec_from_file_location("grad_rule_faults", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.FAULTS


@pytest.mark.parametrize("fault", ["dq_scale_dropped", "dv_undropped_p",
                                   "dk_dropped_p", "dq_hash_shifted"])
def test_grad_rule_faults_find_their_text_once(fault):
    """scripts/grad_rule_faults.py plants each fault by replacing one
    piece of the flash backward's source: that text must occur exactly
    once, and the replacement must change it."""
    old, new = _planted_faults()[fault]
    with open(os.path.join(kernel_config.CSRC_DIR,
                           "flash_attention.cu")) as f:
        assert f.read().count(old) == 1
    assert new != old
