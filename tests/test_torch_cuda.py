"""The port's CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA GPU of compute capability >= 9.0 and
nvcc; the ``cuda_device`` fixture skips it elsewhere. This file imports
no JAX, so it runs on the GPU machine, where JAX is not installed,
without the JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at the serving shapes.
"""

import pytest
import torch

from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.ops import (beam_select, cuda_attention,
                                        cuda_rnn, fused_xent, kernel_config,
                                        nn, rnn)
from neuralmonkey_tpu_torch.utils.saving import flatten_tree
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0 (sm_90a kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(device, *shape, scale=1.0, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=gen) * scale).to(device)


def _mask(device, lengths, time):
    mask = torch.zeros(len(lengths), time)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return mask.to(device)


@pytest.mark.parametrize("hidden,reverse", [(16, (False,)),
                                            (64, (False, True)),
                                            (1024, (True, False)),
                                            (6, (False, True)),
                                            (4099, (True,))])
def test_gru_scan_kernel(cuda_device, hidden, reverse):
    batch, time = 6, 5
    n_dirs = len(reverse)
    x = _randn(cuda_device, batch, time, n_dirs * 3 * hidden, scale=0.5)
    mask = _mask(cuda_device, [5, 4, 1, 0, 3, 5], time)
    wgh = _randn(cuda_device, n_dirs, hidden, 2 * hidden,
                 scale=hidden ** -0.5, seed=1)
    wch = _randn(cuda_device, n_dirs, hidden, hidden, scale=hidden ** -0.5,
                 seed=2)
    reverse_mask = sum(1 << d for d, rev in enumerate(reverse) if rev)
    kernel_config.reset_launch_counts()
    got = cuda_rnn._GRUScan.apply(x, mask, wgh, wch, reverse_mask)
    ref = cuda_rnn.gru_scan_reference(x, mask, wgh, wch, reverse)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["gru_scan"] == 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


def _gru_params(device, input_dim, hidden, seed):
    cell = nn.GRUCell(input_dim, hidden)
    params = cell.init(torch.Generator().manual_seed(seed))
    return cell, {k: v.to(device) for k, v in params.items()}


@pytest.mark.parametrize("hidden", [6, 64])
def test_gru_scan_wrapper_matches_cpu(cuda_device, hidden):
    """The wrapper the encoder calls (input projection, weight stacking,
    direction encoding) against the same call on CPU copies."""
    batch, time, width = 5, 7, 24
    (_, fw), (_, bw) = (_gru_params(cuda_device, width, hidden, s)
                        for s in (1, 2))
    inputs = _randn(cuda_device, batch, time, width)
    mask = _mask(cuda_device, [7, 5, 3, 1, 6], time)
    kernel_config.reset_launch_counts()
    got = cuda_rnn.gru_scan([(fw, False), (bw, True)], inputs, mask)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["gru_scan"] == 1

    def cpu(p):
        return {k: v.cpu() for k, v in p.items()}
    ref = cuda_rnn.gru_scan([(cpu(fw), False), (cpu(bw), True)],
                            inputs.cpu(), mask.cpu())
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, atol=1e-4, rtol=0)


def test_bidirectional_rnn_of_two_sizes_launches_the_kernel(cuda_device):
    batch, time, width = 4, 6, 12
    fw_cell, fw = _gru_params(cuda_device, width, 8, 1)
    bw_cell, bw = _gru_params(cuda_device, width, 20, 2)
    inputs = _randn(cuda_device, batch, time, width)
    mask = _mask(cuda_device, [6, 2, 5, 0], time)
    kernel_config.reset_launch_counts()
    got = rnn.bidirectional_rnn(fw_cell, fw, bw_cell, bw, inputs, mask)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["gru_scan"] == 2

    def cpu(p):
        return {k: v.cpu() for k, v in p.items()}
    ref = rnn.bidirectional_rnn(fw_cell, cpu(fw), bw_cell, cpu(bw),
                                inputs.cpu(), mask.cpu())
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, atol=1e-4, rtol=0)


@pytest.mark.parametrize("hidden,reverse", [(16, (False,)),
                                            (64, (False, True)),
                                            (6, (True, False)),
                                            (517, (False, True))])
def test_gru_bptt_kernel(cuda_device, hidden, reverse):
    """The BPTT pass against its plain version on the same CUDA
    inputs, ragged mask included."""
    batch, time = 6, 5
    n_dirs = len(reverse)
    x = _randn(cuda_device, batch, time, n_dirs * 3 * hidden, scale=0.5)
    mask = _mask(cuda_device, [5, 4, 1, 0, 3, 5], time)
    hprev = _randn(cuda_device, batch, time, n_dirs * hidden, seed=1)
    gout = _randn(cuda_device, batch, time, n_dirs * hidden, seed=2)
    gfinal = _randn(cuda_device, batch, n_dirs * hidden, seed=3)
    wgh = _randn(cuda_device, n_dirs, hidden, 2 * hidden,
                 scale=hidden ** -0.5, seed=4)
    wch = _randn(cuda_device, n_dirs, hidden, hidden, scale=hidden ** -0.5,
                 seed=5)
    reverse_mask = sum(1 << d for d, rev in enumerate(reverse) if rev)
    kernel_config.reset_launch_counts()
    got = cuda_rnn.gru_bptt(x, mask, hprev, gout, gfinal, wgh, wch,
                            reverse_mask)
    ref = cuda_rnn.gru_bptt_reference(x, mask, hprev, gout, gfinal, wgh,
                                      wch, reverse)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["gru_bptt"] == 1
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hidden", [6, 64])
def test_gru_scan_gradients_match_cpu(cuda_device, hidden):
    """Gradients through the wrapper the encoder calls: K1 saving its
    carries and the BPTT kernel, against the plain versions on CPU
    copies."""
    batch, time, width = 5, 7, 24
    lengths = [7, 5, 3, 1, 6]
    grads = []
    for device in (cuda_device, torch.device("cpu")):
        (_, fw), (_, bw) = (_gru_params(device, width, hidden, s)
                            for s in (1, 2))
        leaves = list(fw.values()) + list(bw.values())
        for p in leaves:
            p.requires_grad_(True)
        inputs = _randn(device, batch, time, width).requires_grad_()
        kernel_config.reset_launch_counts()
        out, final = cuda_rnn.gru_scan([(fw, False), (bw, True)], inputs,
                                       _mask(device, lengths, time))
        ((out * _randn(device, *out.shape, seed=8)).sum()
         + (final * _randn(device, *final.shape, seed=9)).sum()).backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            counts = kernel_config.launch_counts()
            assert counts["gru_scan"] == 1 and counts["gru_bptt"] == 1
        grads.append([p.grad.cpu() for p in leaves + [inputs]])
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


def test_bahdanau_kernel(cuda_device):
    batch, time, att, dim = 5, 9, 48, 80
    keys = _randn(cuda_device, batch, time, att)
    states = _randn(cuda_device, batch, time, dim, seed=1)
    mask = _mask(cuda_device, [9, 4, 1, 0, 7], time)
    pq = _randn(cuda_device, batch, att, seed=2)
    v = _randn(cuda_device, att, seed=3)
    got = cuda_attention.fused_bahdanau_step(keys, states, mask, pq, v)
    ref = cuda_attention.bahdanau_reference(keys, states, mask, pq, v)
    torch.testing.assert_close(got[1], ref[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0)


def test_bahdanau_step_gradients_match_cpu(cuda_device):
    """K2's Function on the card: the kernel forward, the backward
    recomputed through the plain version, against the CPU."""
    batch, time, att, dim = 5, 9, 48, 80
    grads = []
    for device in (cuda_device, torch.device("cpu")):
        leaves = [_randn(device, batch, time, att).requires_grad_(),
                  _randn(device, batch, time, dim, seed=1).requires_grad_(),
                  _randn(device, batch, att, seed=2).requires_grad_(),
                  _randn(device, att, seed=3).requires_grad_()]
        kernel_config.reset_launch_counts()
        context, weights = cuda_attention.fused_bahdanau_step(
            leaves[0], leaves[1], _mask(device, [9, 4, 1, 0, 7], time),
            leaves[2], leaves[3])
        ((context * _randn(device, batch, dim, seed=4)).sum()
         + (weights * _randn(device, batch, time, seed=5)).sum()).backward()
        if device.type == "cuda":
            assert kernel_config.launch_counts()["fused_bahdanau_step"] == 1
        grads.append([p.grad.cpu() for p in leaves])
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def test_fused_logits_kernel(cuda_device):
    n, d, vp = 70, 40, 1024
    x = _randn(cuda_device, n, d)
    w = _randn(cuda_device, d, vp, scale=0.2, seed=1)
    b = _randn(cuda_device, vp, seed=2)
    got = beam_select.fused_logits_rowmax_lse(x, w, b)
    ref = beam_select.fused_logits_reference(x, w, b)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d,v", [(70, 40, 300), (256, 128, 1024),
                                   (33, 130, 129)])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_xent_kernels(cuda_device, n, d, v, transposed, eps):
    """The three B7 kernels against their plain versions, ragged N, D
    and V included."""
    x = _randn(cuda_device, n, d, scale=0.3)
    w = _randn(cuda_device, *((v, d) if transposed else (d, v)),
               scale=0.05, seed=1)
    b = _randn(cuda_device, v, scale=0.1, seed=2)
    gen = torch.Generator().manual_seed(3)
    targets = torch.randint(0, v, (n,), generator=gen,
                            dtype=torch.int32).to(cuda_device)
    g = _randn(cuda_device, n, seed=4)
    kernel_config.reset_launch_counts()
    nll, lse = fused_xent.xent_fwd(x, w, b, targets, eps, transposed)
    dx = fused_xent.xent_bwd_dx(x, w, b, targets, lse, g, eps, transposed)
    dw, db = fused_xent.xent_bwd_dw(x, w, b, targets, lse, g, eps,
                                    transposed)
    torch.cuda.synchronize()
    assert all(kernel_config.launch_counts()[k] == 1 for k in (
        "fused_xent_fwd", "fused_xent_bwd_dx", "fused_xent_bwd_dw"))
    ref_nll, ref_lse = fused_xent.fwd_reference(x, w, b, targets, eps,
                                                transposed)
    torch.testing.assert_close(nll, ref_nll, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dx, fused_xent.bwd_dx_reference(
        x, w, b, targets, lse, g, eps, transposed), atol=1e-5, rtol=1e-5)
    ref_dw, ref_db = fused_xent.bwd_dw_reference(x, w, b, targets, lse, g,
                                                 eps, transposed)
    torch.testing.assert_close(dw, ref_dw, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(db, ref_db, atol=1e-5, rtol=1e-5)


def _train_pass(device):
    """Loss and flat gradients of one train-mode pass of a small
    flagship model (conditional GRU), dropout off, from fixed
    parameters."""
    vocab = Vocabulary([f"w{i}" for i in range(296)])
    enc = SentenceEncoder(name="encoder", vocabulary=vocab, data_id="source",
                          embedding_size=16, rnn_size=24, max_input_len=7)
    att = Attention(name="attention", encoder=enc, state_size=20)
    dec = Decoder(name="decoder", vocabulary=vocab, data_id="target",
                  max_output_len=6, rnn_size=24, encoders=[enc],
                  attentions=[att], embedding_size=16, conditional_gru=True)
    params = init_all_params(collect_parts([dec]), seed=3)
    params = {part: {k: (v.to(device).requires_grad_()
                         if isinstance(v, torch.Tensor)
                         else {kk: vv.to(device).requires_grad_()
                               for kk, vv in v.items()})
                     for k, v in tree.items()}
              for part, tree in params.items()}
    gen = torch.Generator().manual_seed(0)
    mask = torch.ones(4, 7)
    mask[1, 5:] = 0
    mask[2, 2:] = 0
    tmask = torch.ones(4, 6)
    tmask[1, 3:] = 0
    tmask[3, 1:] = 0
    batch = {"encoder_input.ids": torch.randint(4, 300, (4, 7), generator=gen,
                                                dtype=torch.int32),
             "encoder_input.mask": mask,
             "decoder.train_inputs": torch.randint(
                 1, 300, (4, 6), generator=gen, dtype=torch.int32),
             "decoder.train_targets": torch.randint(
                 2, 300, (4, 6), generator=gen, dtype=torch.int32),
             "decoder.train_mask": tmask}
    batch = {k: v.to(device) for k, v in batch.items()}
    loss = dec.train_loss(Context(params, batch, train=True, rng=0))
    loss.backward()
    return loss.detach().cpu(), {k: p.grad.cpu() for k, p in
                                 flatten_tree(params).items()}


@pytest.mark.parametrize("fused", [False, True])
def test_training_step_on_card_matches_cpu(cuda_device, monkeypatch, fused):
    """The loss and every parameter gradient of one train-mode pass on
    the card, through the kernels, against the CPU's plain versions."""
    if fused:
        monkeypatch.setenv("NM_FUSED_XENT", "1")
    else:
        monkeypatch.delenv("NM_FUSED_XENT", raising=False)
    kernel_config.reset_launch_counts()
    loss, grads = _train_pass(cuda_device)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    for name in ("gru_scan", "gru_bptt", "fused_bahdanau_step"):
        assert counts[name] > 0, counts
    for name in ("fused_xent_fwd", "fused_xent_bwd_dx", "fused_xent_bwd_dw"):
        assert (counts[name] > 0) == fused, counts
    ref_loss, ref_grads = _train_pass(torch.device("cpu"))
    torch.testing.assert_close(loss, ref_loss, atol=1e-5, rtol=1e-5)
    for key, g in grads.items():
        torch.testing.assert_close(g, ref_grads[key], atol=1e-5, rtol=1e-4,
                                   msg=key)


@pytest.mark.parametrize("batch,n,k", [(3, 32, 4), (64, 2400, 10),
                                       (2, beam_select.MAX_TOPK_ROW, 1)])
def test_small_topk_kernel_ties_to_lowest_index(cuda_device, batch, n, k):
    x = torch.round(_randn(cuda_device, batch, n, scale=2.0))
    got = beam_select.small_topk(x, k)
    ref = beam_select.topk_reference(x, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_small_topk_rejects_rows_beyond_shared_memory(cuda_device):
    with pytest.raises(ValueError, match="rows up to"):
        beam_select.small_topk(
            torch.zeros(1, beam_select.MAX_TOPK_ROW + 1, device=cuda_device),
            1)


def test_rowmax_lse_raises_on_cuda(cuda_device):
    with pytest.raises(NotImplementedError, match="_rowmax_lse_pallas"):
        beam_select.rowmax_lse(torch.zeros(8, 128, device=cuda_device))


def test_wrappers_reject_bad_inputs(cuda_device):
    with pytest.raises(ValueError, match="gru_scan: inconsistent shapes"):
        cuda_rnn._GRUScan.apply(
            _randn(cuda_device, 2, 3, 3 * 8),
            torch.ones(2, 4, device=cuda_device),
            _randn(cuda_device, 1, 8, 16), _randn(cuda_device, 1, 8, 8), 0)
    keys = _randn(cuda_device, 2, 6, 8)
    with pytest.raises(ValueError, match="not contiguous"):
        cuda_attention.fused_bahdanau_step(
            keys[:, ::2], _randn(cuda_device, 2, 3, 4),
            torch.ones(2, 3, device=cuda_device), _randn(cuda_device, 2, 8),
            _randn(cuda_device, 8))
    x = _randn(cuda_device, 4, 256)
    with pytest.raises(ValueError, match="float32"):
        beam_select.small_topk(x.double(), 3)
    w = torch.zeros(256, 128)  # on the CPU
    with pytest.raises(ValueError, match="'w' is on cpu"):
        beam_select.fused_logits_rowmax_lse(x, w, torch.zeros(128))
