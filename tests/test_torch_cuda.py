"""The port's CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA GPU of compute capability >= 9.0 and
nvcc; the ``cuda_device`` fixture skips it elsewhere. This file imports
no JAX, so it runs on the GPU machine, where JAX is not installed,
without the JAX-configuring conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at the serving shapes.
"""

from typing import Tuple

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


def _gru_bptt_args(device, batch, time, hidden, reverse, lengths):
    n_dirs = len(reverse)
    x = _randn(device, batch, time, n_dirs * 3 * hidden, scale=0.5)
    mask = _mask(device, lengths, time)
    hprev = _randn(device, batch, time, n_dirs * hidden, scale=0.5, seed=1)
    gout = _randn(device, batch, time, n_dirs * hidden, seed=2)
    gfinal = _randn(device, batch, n_dirs * hidden, seed=3)
    wgh = _randn(device, n_dirs, hidden, 2 * hidden, scale=hidden ** -0.5,
                 seed=4)
    wch = _randn(device, n_dirs, hidden, hidden, scale=hidden ** -0.5,
                 seed=5)
    return x, mask, hprev, gout, gfinal, wgh, wch


@pytest.mark.parametrize("batch,time,hidden,reverse,resident", [
    (64, 32, 512, (False, True), True),    # the encoder's shape
    (160, 6, 512, (False, True), True),    # a wide batch
    (64, 5, 2048, (False, True), False),   # streamed in k tiles, 4 row tiles
    (5, 4, 4099, (True,), False),          # streamed, H % 4 != 0
    (3, 3, 7264, (True,), False)])         # the largest H bptt_fits takes
def test_gru_bptt_persistent_plans(cuda_device, batch, time, hidden,
                                   reverse, resident):
    """The persistent GRU BPTT in each of its layouts against the plain
    version, ragged lengths; the pre-activation gradients grow through
    the reverse steps, so the tolerance scales with their largest
    entry."""
    gen = torch.Generator().manual_seed(batch)
    lengths = torch.randint(1, time + 1, (batch,), generator=gen).tolist()
    args = _gru_bptt_args(cuda_device, batch, time, hidden, reverse,
                          lengths)
    reverse_mask = sum(1 << d for d, rev in enumerate(reverse) if rev)
    plan = cuda_rnn.gru_bptt_plan(batch, hidden, len(reverse),
                                  *kernel_config.device_limits(0))
    assert plan.resident == resident
    kernel_config.reset_launch_counts()
    got = cuda_rnn.gru_bptt(*args, reverse_mask)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["gru_bptt"] == 1
    ref = cuda_rnn.gru_bptt_reference(*args, reverse)
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)


def test_gru_bptt_is_deterministic(cuda_device):
    """Two calls at the encoder's shape give the same bits: the partials
    of dxc·W_chᵀ and dxg·W_ghᵀ are summed in one fixed block order."""
    gen = torch.Generator().manual_seed(7)
    lengths = torch.randint(1, 33, (64,), generator=gen).tolist()
    args = _gru_bptt_args(cuda_device, 64, 32, 512, (False, True), lengths)
    first = cuda_rnn.gru_bptt(*args, 2)
    second = cuda_rnn.gru_bptt(*args, 2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_gru_bptt_refuses_a_grid_that_cannot_be_resident(cuda_device):
    """A plan for twice the card's SMs, each block asking for all of an
    SM's shared memory, wants more blocks than can be resident at once:
    the cooperative launch is refused and raises, without counting a
    launch or writing anything."""
    batch, time, hidden = 8, 3, 512
    x, mask, hprev, gout, gfinal, wgh, wch = _gru_bptt_args(
        cuda_device, batch, time, hidden, (False, True), [3] * batch)
    sms, smem = kernel_config.device_limits(0)
    plan = cuda_rnn.gru_bptt_plan(batch, hidden, 2, 2 * sms, smem)
    assert plan.blocks_per_dir * 2 > sms
    dx = torch.full_like(x, float("nan"))
    gates = x.new_empty(4, batch, time, 2 * hidden)
    partial = x.new_empty(2, 2, plan.blocks_per_dir, batch, hidden)
    carry = x.new_empty(2, batch, hidden)
    sync = torch.zeros(2, 2, dtype=torch.int32, device=cuda_device)
    kernel_config.reset_launch_counts()
    with pytest.raises(RuntimeError, match="gru_bptt: launch failed"):
        kernel_config.launch(
            "gru_bptt", x, mask, hprev, gout, gfinal, wgh, wch, dx, gates,
            partial, carry, sync, batch, time, hidden, 2, 2,
            plan.blocks_per_dir, plan.units, plan.rows, plan.k_tile, smem)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["gru_bptt"] == 0
    assert torch.isnan(dx).all()


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


def _gru_scan_args(device, batch, time, hidden, reverse, lengths):
    n_dirs = len(reverse)
    x = _randn(device, batch, time, n_dirs * 3 * hidden, scale=0.5)
    mask = _mask(device, lengths, time)
    wgh = _randn(device, n_dirs, hidden, 2 * hidden, scale=hidden ** -0.5,
                 seed=1)
    wch = _randn(device, n_dirs, hidden, hidden, scale=hidden ** -0.5,
                 seed=2)
    return x, mask, wgh, wch


@pytest.mark.parametrize("batch,time,hidden,reverse,resident,save", [
    (64, 32, 512, (False, True), True, False),   # the encoder's shape
    (64, 32, 512, (False, True), True, True),    # ... saving carries
    (160, 6, 512, (False, True), True, True),    # a wide batch: row tiles
    (64, 5, 2048, (False, True), False, True),   # streamed, 4 row tiles
    (5, 4, 4099, (True,), False, True),          # streamed, H % 4 != 0
    (3, 3, 19368, (True,), False, False)])       # the largest H scan_fits
def test_gru_scan_persistent_plans(cuda_device, batch, time, hidden,
                                   reverse, resident, save):
    """The persistent K1 in each of its layouts against the plain version
    on the same inputs, ragged lengths: outputs, final states and, when
    saved, the carries the BPTT reads."""
    gen = torch.Generator().manual_seed(batch)
    lengths = torch.randint(1, time + 1, (batch,), generator=gen).tolist()
    x, mask, wgh, wch = _gru_scan_args(cuda_device, batch, time, hidden,
                                       reverse, lengths)
    n_dirs = len(reverse)
    reverse_mask = sum(1 << d for d, rev in enumerate(reverse) if rev)
    plan = cuda_rnn.gru_scan_plan(batch, hidden, n_dirs,
                                  *kernel_config.device_limits(0))
    assert plan.resident == resident
    out = x.new_empty(batch, time, n_dirs * hidden)
    final = x.new_empty(batch, n_dirs * hidden)
    carries = x.new_empty(batch, time, n_dirs * hidden) if save else None
    kernel_config.reset_launch_counts()
    cuda_rnn.launch_gru_scan(x, mask, wgh, wch, out, final, carries,
                             reverse_mask, plan)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["gru_scan"] == 1
    ref = cuda_rnn.gru_scan_reference(x, mask, wgh, wch, reverse)
    got = (out, final, carries) if save else (out, final)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


def test_gru_scan_is_deterministic(cuda_device):
    """Two calls at the encoder's shape give the same bits: every sum is
    taken in one fixed order, with no atomics."""
    gen = torch.Generator().manual_seed(11)
    lengths = torch.randint(1, 33, (64,), generator=gen).tolist()
    args = _gru_scan_args(cuda_device, 64, 32, 512, (False, True), lengths)
    first = cuda_rnn._GRUScan.apply(*args, 2)
    second = cuda_rnn._GRUScan.apply(*args, 2)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_gru_scan_refuses_a_grid_that_cannot_be_resident(cuda_device):
    """A plan for twice the card's SMs, each block asking for all of an
    SM's shared memory, wants more blocks than can be resident at once:
    the cooperative launch is refused and raises with the plan, without
    counting a launch or writing anything; the next launch runs."""
    batch, time, hidden = 8, 3, 512
    x, mask, wgh, wch = _gru_scan_args(cuda_device, batch, time, hidden,
                                       (False, True), [3] * batch)
    sms, smem = kernel_config.device_limits(0)
    plan = cuda_rnn.gru_scan_plan(batch, hidden, 2, 2 * sms, smem)
    assert plan.blocks_per_dir * 2 > sms
    plan = plan._replace(smem_bytes=smem)
    out = x.new_full((batch, time, 2 * hidden), float("nan"))
    final = x.new_full((batch, 2 * hidden), float("nan"))
    kernel_config.reset_launch_counts()
    with pytest.raises(RuntimeError,
                       match="gru_scan: launch failed.*launch plan"):
        cuda_rnn.launch_gru_scan(x, mask, wgh, wch, out, final, None, 2,
                                 plan)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["gru_scan"] == 0
    assert torch.isnan(out).all() and torch.isnan(final).all()
    got = cuda_rnn._GRUScan.apply(x, mask, wgh, wch, 2)
    ref = cuda_rnn.gru_scan_reference(x, mask, wgh, wch, (False, True))
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("batch,time,hidden", [
    (64, 32, 512),    # the encoder's shape, the slice resident
    (64, 5, 2048)])   # both kernels streamed, in row tiles
def test_gru_bptt_on_the_scans_carries(cuda_device, batch, time, hidden):
    """Gradients through _GRUScan on the card (K1 saving its carries, then
    gru_bptt restarting from them) against autograd through the plain
    scan on the same CUDA inputs; the gradients grow through the reverse
    steps, so the tolerance scales with their largest entry."""
    assert cuda_rnn.bptt_fits(hidden)
    gen = torch.Generator().manual_seed(hidden)
    lengths = torch.randint(1, time + 1, (batch,), generator=gen).tolist()
    args = _gru_scan_args(cuda_device, batch, time, hidden, (False, True),
                          lengths)
    gout = _randn(cuda_device, batch, time, 2 * hidden, seed=3)
    gfinal = _randn(cuda_device, batch, 2 * hidden, seed=4)
    grads = []
    for kernel in (True, False):
        x, mask, wgh, wch = (a.clone() for a in args)
        for leaf in (x, wgh, wch):
            leaf.requires_grad_()
        kernel_config.reset_launch_counts()
        if kernel:
            out, final = cuda_rnn._GRUScan.apply(x, mask, wgh, wch, 2)
        else:
            out, final, _ = cuda_rnn.gru_scan_reference(x, mask, wgh, wch,
                                                        (False, True))
        grads.append(torch.autograd.grad((out, final), (x, wgh, wch),
                                         (gout, gfinal)))
        torch.cuda.synchronize()
        counts = kernel_config.launch_counts()
        assert (counts["gru_scan"], counts["gru_bptt"]) == (
            (1, 1) if kernel else (0, 0))
    for g, r in zip(*grads):
        scale = max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, atol=1e-4 * scale, rtol=1e-4)


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


def _bahdanau_args(device, batch, time, att, dim, lengths):
    return (_randn(device, batch, time, att),
            _randn(device, batch, time, dim, seed=1),
            _mask(device, lengths, time),
            _randn(device, batch, att, seed=2),
            _randn(device, att, scale=att ** -0.5, seed=3))


@pytest.mark.parametrize("batch,time,att,dim,lengths,staged,resident", [
    (64, 32, 512, 1024, [32, 31, 17, 1] * 16, True, True),  # the bench shape
    (7, 13, 48, 88, [13, 0, 5, 1, 12, 13, 7], True, True),  # a masked row
    (7, 13, 50, 83, [13, 0, 5, 1, 12, 13, 7], True, False),  # D % 4 = 3
    (5, 9, 47, 81, [9, 4, 1, 0, 7], True, False),  # 4-byte copies, scalar
    (1, 32, 512, 1024, [20], True, True),         # B 1: a cluster of 8
    (64, 1, 512, 1024, [1] * 63 + [0], True, True),  # T 1: no cluster
    (2, 1000, 64, 1024, [1000, 613], True, False),   # streamed states
    (3, 3000, 37, 1023, [3000, 0, 2999], True, False),  # streamed, scalar
    (3, 7, 40000, 6, [7, 3, 0], False, False),  # operands read in place
    # a 14 x 14 image map: greedy over B 64, and the hierarchical
    # attention's children tiled to B·K rows under beam 10
    (64, 196, 512, 512, [196] * 64, True, False),
    (640, 196, 512, 512, [196] * 640, False, False)])
def test_bahdanau_cluster_plans(cuda_device, batch, time, att, dim, lengths,
                                staged, resident):
    """K2's clusters against the plain version: one launch, the plan the
    test names (operands staged or read in place, the states slice in
    registers or streamed), weights and context within 1e-5, a fully
    masked row all zeros."""
    args = _bahdanau_args(cuda_device, batch, time, att, dim, lengths)
    plan = cuda_attention.bahdanau_plan(
        batch, time, att, dim, *kernel_config.device_limits(0))
    assert (plan.staged, plan.resident) == (staged, resident)
    kernel_config.reset_launch_counts()
    got = cuda_attention.fused_bahdanau_step(*args)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["fused_bahdanau_step"] == 1
    ref = cuda_attention.bahdanau_reference(*args)
    torch.testing.assert_close(got[1], ref[1], atol=1e-5, rtol=0)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=0)
    for row, n in enumerate(lengths):
        if n == 0:
            assert not got[0][row].any() and not got[1][row].any()


def test_bahdanau_fills_the_card_at_the_bench_shape(cuda_device):
    """B 64 rows in clusters of 4 cover the card's SMs."""
    sms, smem = kernel_config.device_limits(0)
    plan = cuda_attention.bahdanau_plan(64, 32, 512, 1024, sms, smem)
    assert plan.cluster == 4 and plan.grid >= sms and plan.resident


def test_bahdanau_is_deterministic(cuda_device):
    """Two calls at the bench shape give the same bits: the warp sums,
    the softmax's block reductions and the context run in fixed
    orders."""
    args = _bahdanau_args(cuda_device, 64, 32, 512, 1024, [32, 9] * 32)
    first = cuda_attention.fused_bahdanau_step(*args)
    second = cuda_attention.fused_bahdanau_step(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_fused_logits_kernel(cuda_device):
    n, d, vp = 70, 40, 1024
    x = _randn(cuda_device, n, d)
    w = _randn(cuda_device, d, vp, scale=0.2, seed=1)
    b = _randn(cuda_device, vp, seed=2)
    got = beam_select.fused_logits_rowmax_lse(x, w, b)
    ref = beam_select.fused_logits_reference(x, w, b)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


def _fused_logits_args(device, n, d, vp):
    """A beam step's projection as the search arms it: the vocabulary
    padded to vp columns with bias -1e9 on the pad (all of the last
    group's columns but 28 real when vp is 128)."""
    v_real = {128: 100, 1024: 1000, 30720: 30000}[vp]
    x = _randn(device, n, d)
    w = _randn(device, d, vp, scale=d ** -0.5, seed=1)
    b = torch.cat([_randn("cpu", v_real, scale=0.1, seed=2),
                   torch.full((vp - v_real,), -1e9)]).to(device)
    return (x, w, b), v_real


@pytest.mark.parametrize("n", [1, 37, 70, 640])
@pytest.mark.parametrize("d,vp", [(40, 128), (100, 1024), (130, 1024),
                                  (512, 30720)])
def test_fused_logits_ragged(cuda_device, n, d, vp):
    """K3 on the tensor cores at ragged rows (a partial row tile), depths
    (a partial 32-deep stage; D 130 has rows that are not 16-byte
    aligned, so 4-byte copies) and vocabularies, against the plain
    version: logits and group maxima where the vocabulary is real (at
    -1e9 the float32 spacing is 64; the pad only has to stay far below),
    lse everywhere."""
    args, v_real = _fused_logits_args(cuda_device, n, d, vp)
    kernel_config.reset_launch_counts()
    got = beam_select.fused_logits_rowmax_lse(*args)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["fused_logits_rowmax_lse"] == 1
    ref = beam_select.fused_logits_reference(*args)
    groups = -(-v_real // 128)
    for g, r in ((got[0][:, :v_real], ref[0][:, :v_real]),
                 (got[1][:, :groups], ref[1][:, :groups]), (got[2], ref[2])):
        scale = max(1.0, float(r.abs().max()))
        torch.testing.assert_close(g, r, atol=1e-5 * scale, rtol=1e-5)
    assert float(got[0][:, v_real:].max()) < -1e8
    # each rowmax entry is the largest of the logits the kernel wrote
    torch.testing.assert_close(
        got[1], got[0].reshape(n, vp // 128, 128).amax(dim=2), atol=0,
        rtol=0)


def test_fused_logits_is_deterministic(cuda_device):
    """Two calls at the serving shape give the same bits: the block sums
    and the fold of their partials run in one fixed order."""
    args, _ = _fused_logits_args(cuda_device, 640, 512, 30720)
    first = beam_select.fused_logits_rowmax_lse(*args)
    second = beam_select.fused_logits_rowmax_lse(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def _xent_fwd_args(device, n, d, v, transposed):
    x = _randn(device, n, d, scale=0.5)
    w = _randn(device, *((v, d) if transposed else (d, v)), scale=d ** -0.5,
               seed=1)
    b = _randn(device, v, scale=0.1, seed=2)
    gen = torch.Generator().manual_seed(3)
    targets = torch.randint(0, v, (n,), generator=gen,
                            dtype=torch.int32).to(device)
    return x, w, b, targets


@pytest.mark.parametrize("n,d,v", [(3072, 512, 30000), (333, 130, 1000)])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_xent_fwd_tensor_cores(cuda_device, n, d, v, transposed, eps):
    """The forward's logit tiles on the tensor cores (3xTF32) at the
    decoder's loss tail (N 3072, D 512, V 30000: a last vocabulary tile
    of 48 columns) and a ragged shape (4-byte copies at D 130), both
    layouts, against the plain version: nll within 1e-5 of its largest
    entry, as in the smoke, and lse within 1e-5 of its own."""
    x, w, b, targets = _xent_fwd_args(cuda_device, n, d, v, transposed)
    kernel_config.reset_launch_counts()
    nll, lse = fused_xent.xent_fwd(x, w, b, targets, eps, transposed)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["fused_xent_fwd"] == 1
    ref_nll, ref_lse = fused_xent.fwd_reference(x, w, b, targets, eps,
                                                transposed)
    for got, ref in ((nll, ref_nll), (lse, ref_lse)):
        scale = max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) / scale <= 1e-5


def test_fused_xent_fwd_is_deterministic(cuda_device):
    """Two calls at the bench shape give the same bits: each block's
    column warps meet in a fixed order, and the fold adds the partials
    of a row in a fixed order, with no atomics."""
    args = _xent_fwd_args(cuda_device, 3072, 512, 30000, False)
    first = fused_xent.xent_fwd(*args, 0.1, False)
    second = fused_xent.xent_fwd(*args, 0.1, False)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,d,v,splits", [
    (3072, 512, 30000, 11),  # the decoder's loss tail, bench widths
    (333, 130, 1000, 8),     # ragged N, D and V
    (40, 600, 200, 2)])      # D past one 128-column pass, a partial tile
@pytest.mark.parametrize("transposed", [False, True])
def test_fused_xent_bwd_dx_plans(cuda_device, n, d, v, splits, transposed):
    """dx through the vocabulary split into S chunks and folded, against
    the plain version (1e-4 of its largest entry, the smoke's rule), and
    bitwise equal across two calls: the S partials are folded in one
    fixed order."""
    plan = fused_xent.dx_plan(n, d, v, *kernel_config.device_limits(0))
    assert plan.splits == splits
    x = _randn(cuda_device, n, d, scale=0.5)
    w = _randn(cuda_device, *((v, d) if transposed else (d, v)),
               scale=d ** -0.5, seed=1)
    b = _randn(cuda_device, v, scale=0.1, seed=2)
    gen = torch.Generator().manual_seed(3)
    targets = torch.randint(0, v, (n,), generator=gen,
                            dtype=torch.int32).to(cuda_device)
    g = torch.rand(n, generator=gen).to(cuda_device)
    _, lse = fused_xent.fwd_reference(x, w, b, targets, 0.1, transposed)
    args = (x, w, b, targets, lse, g, 0.1, transposed)
    kernel_config.reset_launch_counts()
    first = fused_xent.xent_bwd_dx(*args)
    second = fused_xent.xent_bwd_dx(*args)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["fused_xent_bwd_dx"] == 2
    assert torch.equal(first, second)
    ref = fused_xent.bwd_dx_reference(*args)
    assert float((first - ref).abs().max()) <= 1e-4 * float(
        ref.abs().max())


@pytest.mark.parametrize("n,d,v,splits", [
    (3072, 512, 30000, 1),   # the decoder's loss tail, bench widths
    (333, 130, 1000, 3),     # ragged N, D and V, folded
    (256, 128, 1024, 2),     # two row tiles in two chunks
    (40, 600, 200, 1)])      # D past one 128-row pass, a partial tile
@pytest.mark.parametrize("transposed", [False, True])
def test_fused_xent_bwd_dw_plans(cuda_device, n, d, v, splits, transposed):
    """dW and db through the rows cut into S chunks and folded, against
    the plain version (1e-4 of the largest entry, the smoke's rule), and
    bitwise equal across two calls: each block sums its rows in one
    fixed order and the S partials are folded in one fixed order."""
    plan = fused_xent.dw_plan(n, d, v, *kernel_config.device_limits(0))
    assert plan.splits == splits
    x = _randn(cuda_device, n, d, scale=0.5)
    w = _randn(cuda_device, *((v, d) if transposed else (d, v)),
               scale=d ** -0.5, seed=1)
    b = _randn(cuda_device, v, scale=0.1, seed=2)
    gen = torch.Generator().manual_seed(3)
    targets = torch.randint(0, v, (n,), generator=gen,
                            dtype=torch.int32).to(cuda_device)
    g = torch.rand(n, generator=gen).to(cuda_device)
    _, lse = fused_xent.fwd_reference(x, w, b, targets, 0.1, transposed)
    args = (x, w, b, targets, lse, g, 0.1, transposed)
    kernel_config.reset_launch_counts()
    first = fused_xent.xent_bwd_dw(*args)
    second = fused_xent.xent_bwd_dw(*args)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["fused_xent_bwd_dw"] == 2
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)
    for got, ref in zip(first, fused_xent.bwd_dw_reference(*args)):
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max())


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


def test_sampled_decode_on_the_card_scores_as_on_the_cpu(cuda_device,
                                                         monkeypatch):
    """``sample_outputs`` on the card (K1, K2 each step, the draws from
    a generator on the card): valid ids, PAD after END; the same ids
    forced through the CPU's plain steps give the same summed log-probs
    (1e-4) and the same ids back."""
    from neuralmonkey_tpu_torch.vocabulary import (END_TOKEN_INDEX,
                                                   PAD_TOKEN_INDEX)
    vocab = Vocabulary([f"w{i}" for i in range(60)])
    enc = SentenceEncoder(name="encoder", vocabulary=vocab, data_id="source",
                          embedding_size=16, rnn_size=24, max_input_len=7)
    att = Attention(name="attention", encoder=enc, state_size=20)
    dec = Decoder(name="decoder", vocabulary=vocab, data_id="target",
                  max_output_len=12, rnn_size=24, encoders=[enc],
                  attentions=[att], embedding_size=16, conditional_gru=True)
    params = init_all_params(collect_parts([dec]), seed=3)
    params["decoder"]["logit"]["b"][END_TOKEN_INDEX] = 2.0
    gen = torch.Generator().manual_seed(0)
    mask = torch.ones(8, 7)
    mask[1, 5:] = 0
    batch = {"encoder_input.ids": torch.randint(4, 64, (8, 7), generator=gen,
                                                dtype=torch.int32),
             "encoder_input.mask": mask}

    def on(device, tree):
        if isinstance(tree, dict):
            return {k: on(device, v) for k, v in tree.items()}
        return tree.to(device)
    kernel_config.reset_launch_counts()
    ids, logprob = dec.sample_outputs(Context(
        on(cuda_device, params), on(cuda_device, batch), rng=1))
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    assert counts["gru_scan"] == 1 and counts["fused_bahdanau_step"] > 0
    ids, logprob = ids.cpu(), logprob.cpu()
    assert bool(((ids >= 0) & (ids < len(vocab))).all())
    ended = (ids == END_TOKEN_INDEX).int().cumsum(1)
    after = torch.cat([torch.zeros(8, 1, dtype=torch.int32),
                       ended[:, :-1]], dim=1) > 0
    assert bool((ids[after] == PAD_TOKEN_INDEX).all())
    columns = iter(ids.unbind(1))
    monkeypatch.setattr(dec, "draw_samples", lambda lp, g: next(columns))
    ref_ids, ref_logprob = dec.sample_outputs(Context(params, batch, rng=1))
    assert torch.equal(ref_ids, ids)
    torch.testing.assert_close(logprob, ref_logprob, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("batch,n,k", [(3, 32, 4), (64, 2400, 10),
                                       (2, 12000, 1)])
def test_small_topk_kernel_ties_to_lowest_index(cuda_device, batch, n, k):
    x = torch.round(_randn(cuda_device, batch, n, scale=2.0))
    got = beam_select.small_topk(x, k)
    ref = beam_select.topk_reference(x, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_small_topk_takes_a_long_row_in_one_launch(cuda_device):
    """The first design held a row in shared memory and refused rows of
    more than 12000 entries; the one-pass design takes any row."""
    x = torch.round(_randn(cuda_device, 3, 12001, scale=2.0))
    kernel_config.reset_launch_counts()
    got = beam_select.small_topk(x, 10)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["small_topk"] == 1
    ref = beam_select.topk_reference(x, 10)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _topk_rows(device, batch, n, kind, seed):
    """Rows that stress the order: rounded values (ties everywhere),
    rounded values with -inf entries and one row all -inf, or -1e9
    entries (the selector's masked hypotheses) among ties."""
    x = torch.round(_randn(device, batch, n, scale=2.0, seed=seed))
    gen = torch.Generator().manual_seed(seed + 1)
    spots = (torch.rand(batch, n, generator=gen) < 0.3).to(device)
    if kind == "-inf":
        x = torch.where(spots, float("-inf"), x)
        x[-1] = float("-inf")
    elif kind == "-1e9":
        x = torch.where(spots, -1e9, x)
        x[0] = -1e9
    return x


@pytest.mark.parametrize("n,k", [
    (n, k) for n in (1, 31, 300, 1280, 2400, 12001, 30720)
    for k in (1, 10, 16, 17, 64, 65) if k <= n])
def test_small_topk_one_pass_kernel(cuda_device, n, k):
    """K4 against the plain version bit for bit at the selector's shapes
    and past them, on 16-byte aligned rows and on rows one float off
    (the 4-byte path); k > 64 takes the plain version on the card."""
    batch = 5
    for kind in ("ties", "-inf", "-1e9"):
        base = _topk_rows(cuda_device, batch, n, kind, seed=n + k)
        flat = torch.empty(batch * n + 1, device=cuda_device)
        flat[1:] = base.reshape(-1)
        for x in (base, flat[1:].view(batch, n)):
            kernel_config.reset_launch_counts()
            got = beam_select.small_topk(x, k)
            torch.cuda.synchronize()
            assert kernel_config.launch_counts()["small_topk"] == (k <= 64)
            ref = beam_select.topk_reference(x, k)
            assert torch.equal(got[1], ref[1]), (kind, x.data_ptr() % 16)
            assert torch.equal(got[0], ref[0]), (kind, x.data_ptr() % 16)


@pytest.mark.parametrize("n,vocab,vp", [(640, 30000, 30080), (13, 300, 384),
                                        (1, 128, 128)])
def test_rowmax_lse_kernel(cuda_device, n, vocab, vp):
    """Beam-step logits padded with 4·NEG_INF as the selector pads them:
    the group maxima exactly, the log-sum-exp to 1e-5 relative."""
    x = torch.full((n, vp), -4e9, device=cuda_device)
    x[:, :vocab] = _randn(cuda_device, n, vocab, scale=4.0)
    kernel_config.reset_launch_counts()
    got = beam_select.rowmax_lse(x)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["rowmax_lse"] == 1
    ref = beam_select.rowmax_lse_reference(x)
    assert torch.equal(got[0], ref[0])
    torch.testing.assert_close(got[1], ref[1], atol=0, rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of 128"):
        beam_select.rowmax_lse(x[:, :100].contiguous())


@pytest.mark.parametrize("hidden,reverse", [(16, (False,)),
                                            (64, (False, True)),
                                            (200, (True,)),
                                            (6, (True, False)),
                                            (512, (False, True))])
def test_lstm_scan_kernel(cuda_device, hidden, reverse):
    """Outputs, finals and both carries against the plain version on the
    same CUDA inputs, ragged mask included."""
    batch, time = 6, 5
    n_dirs = len(reverse)
    xz = _randn(cuda_device, batch, time, n_dirs * 4 * hidden, scale=0.5)
    mask = _mask(cuda_device, [5, 4, 1, 0, 3, 5], time)
    wh = _randn(cuda_device, n_dirs, hidden, 4 * hidden, scale=hidden ** -0.5,
                seed=1)
    reverse_mask = sum(1 << d for d, rev in enumerate(reverse) if rev)
    kernel_config.reset_launch_counts()
    got = cuda_rnn.lstm_scan_forward(xz, mask, wh, 0.7, reverse_mask, True)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["lstm_scan"] == 1
    ref = cuda_rnn.lstm_scan_reference(xz, mask, wh, 0.7, reverse)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


@pytest.mark.parametrize("batch,time,hidden,reverse,resident", [
    (64, 32, 512, (False, True), True),    # the encoder's shape
    (1, 9, 512, (True, False), True),
    (160, 6, 512, (False, True), True),    # rows in several tiles
    (64, 5, 1024, (False, True), False),   # W_h streamed in k tiles
    (3, 4, 8300, (True,), False)])         # the largest H lstm_scan_fits
def test_lstm_scan_persistent_plans(cuda_device, batch, time, hidden,
                                    reverse, resident):
    """The persistent scan in each of its layouts against the plain
    version: outputs, finals and both carries, ragged lengths."""
    n_dirs = len(reverse)
    gen = torch.Generator().manual_seed(batch)
    lengths = torch.randint(1, time + 1, (batch,), generator=gen).tolist()
    xz = _randn(cuda_device, batch, time, n_dirs * 4 * hidden, scale=0.5)
    mask = _mask(cuda_device, lengths, time)
    wh = _randn(cuda_device, n_dirs, hidden, 4 * hidden, scale=hidden ** -0.5,
                seed=1)
    reverse_mask = sum(1 << d for d, rev in enumerate(reverse) if rev)
    plan = cuda_rnn.lstm_scan_plan(batch, hidden, n_dirs,
                                   *kernel_config.device_limits(0))
    assert plan.resident == resident
    kernel_config.reset_launch_counts()
    got = cuda_rnn.lstm_scan_forward(xz, mask, wh, 1.0, reverse_mask, True)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["lstm_scan"] == 1
    ref = cuda_rnn.lstm_scan_reference(xz, mask, wh, 1.0, reverse)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=0)


def test_lstm_scan_barrier_resets_between_launches(cuda_device):
    """Two launches on one scratch: the barrier words return to a zero
    count, the generation moves T - 1 barriers a launch, and both
    launches give the plain version's result."""
    batch, time, hidden = 5, 7, 64
    xz = _randn(cuda_device, batch, time, 2 * 4 * hidden, scale=0.5)
    mask = _mask(cuda_device, [7, 5, 3, 1, 6], time)
    wh = _randn(cuda_device, 2, hidden, 4 * hidden, scale=hidden ** -0.5,
                seed=1)
    ref = cuda_rnn.lstm_scan_reference(xz, mask, wh, 1.0, [False, True])
    scratch, sync = cuda_rnn.lstm_scan_scratch(xz, 2, hidden)
    for launch in (1, 2):
        out, final = (torch.full_like(ref[0], float("nan")),
                      torch.full_like(ref[1], float("nan")))
        cuda_rnn.launch_lstm_scan(xz, mask, wh, out, final, None, None,
                                  scratch, sync, 1.0, 2)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref[0], atol=1e-5, rtol=0)
        torch.testing.assert_close(final, ref[1], atol=1e-5, rtol=0)
        assert sync[:, 0].tolist() == [0, 0]
        assert sync[:, 1].tolist() == [launch * (time - 1)] * 2


@pytest.mark.parametrize("hidden,reverse", [(16, (False,)),
                                            (64, (False, True)),
                                            (6, (True, False)),
                                            (517, (False, True))])
def test_lstm_bptt_kernel(cuda_device, hidden, reverse):
    """The LSTM BPTT pass against its plain version on the same CUDA
    inputs, ragged mask included."""
    batch, time = 6, 5
    n_dirs = len(reverse)
    xz = _randn(cuda_device, batch, time, n_dirs * 4 * hidden, scale=0.5)
    mask = _mask(cuda_device, [5, 4, 1, 0, 3, 5], time)
    cprev = _randn(cuda_device, batch, time, n_dirs * hidden, seed=1)
    hprev = _randn(cuda_device, batch, time, n_dirs * hidden, scale=0.5,
                   seed=2)
    gout = _randn(cuda_device, batch, time, n_dirs * hidden, seed=3)
    gfinal = _randn(cuda_device, batch, n_dirs * hidden, seed=4)
    wh = _randn(cuda_device, n_dirs, hidden, 4 * hidden, scale=hidden ** -0.5,
                seed=5)
    reverse_mask = sum(1 << d for d, rev in enumerate(reverse) if rev)
    args = (xz, mask, cprev, hprev, gout, gfinal, wh, 1.0)
    kernel_config.reset_launch_counts()
    got = cuda_rnn.lstm_bptt(*args, reverse_mask)
    ref = cuda_rnn.lstm_bptt_reference(*args, reverse)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["lstm_bptt"] == 1
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def _lstm_bptt_args(device, batch, time, hidden, reverse, lengths):
    n_dirs = len(reverse)
    xz = _randn(device, batch, time, n_dirs * 4 * hidden, scale=0.5)
    mask = _mask(device, lengths, time)
    cprev = _randn(device, batch, time, n_dirs * hidden, seed=1)
    hprev = _randn(device, batch, time, n_dirs * hidden, scale=0.5, seed=2)
    gout = _randn(device, batch, time, n_dirs * hidden, seed=3)
    gfinal = _randn(device, batch, n_dirs * hidden, seed=4)
    wh = _randn(device, n_dirs, hidden, 4 * hidden, scale=hidden ** -0.5,
                seed=5)
    return xz, mask, cprev, hprev, gout, gfinal, wh, 1.0


@pytest.mark.parametrize("batch,time,hidden,reverse,resident", [
    (64, 32, 512, (False, True), True),    # the encoder's shape
    (160, 6, 512, (False, True), True),    # rows in several tiles
    (64, 5, 1024, (False, True), False),   # the slice streamed in k tiles
    (5, 4, 4099, (True,), False)])         # streamed, H % 4 != 0
def test_lstm_bptt_persistent_plans(cuda_device, batch, time, hidden,
                                    reverse, resident):
    """The persistent BPTT in each of its layouts against the plain
    version, ragged lengths; the pre-activation gradients grow through
    the reverse steps, so the tolerance scales with their largest
    entry."""
    gen = torch.Generator().manual_seed(batch)
    lengths = torch.randint(1, time + 1, (batch,), generator=gen).tolist()
    args = _lstm_bptt_args(cuda_device, batch, time, hidden, reverse,
                           lengths)
    reverse_mask = sum(1 << d for d, rev in enumerate(reverse) if rev)
    plan = cuda_rnn.lstm_bptt_plan(batch, hidden, len(reverse),
                                   *kernel_config.device_limits(0))
    assert plan.resident == resident
    kernel_config.reset_launch_counts()
    got = cuda_rnn.lstm_bptt(*args, reverse_mask)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["lstm_bptt"] == 1
    ref = cuda_rnn.lstm_bptt_reference(*args, reverse)
    scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, atol=1e-5 * scale, rtol=1e-5)


def test_lstm_bptt_is_deterministic(cuda_device):
    """Two calls at the encoder's shape give the same bits: the partials
    of dz·W_hᵀ are summed in one fixed block order."""
    gen = torch.Generator().manual_seed(7)
    lengths = torch.randint(1, 33, (64,), generator=gen).tolist()
    args = _lstm_bptt_args(cuda_device, 64, 32, 512, (False, True), lengths)
    first = cuda_rnn.lstm_bptt(*args, 2)
    second = cuda_rnn.lstm_bptt(*args, 2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_lstm_bptt_refuses_a_grid_that_cannot_be_resident(cuda_device):
    """A plan for twice the card's SMs, each block asking for all of an
    SM's shared memory, wants more blocks than can be resident at once:
    the cooperative launch is refused and raises, without counting a
    launch or writing anything."""
    batch, time, hidden = 8, 3, 512
    args = _lstm_bptt_args(cuda_device, batch, time, hidden, (False, True),
                           [3] * batch)
    xz, mask, cprev, hprev, gout, gfinal, wh, _ = args
    sms, smem = kernel_config.device_limits(0)
    plan = cuda_rnn.lstm_bptt_plan(batch, hidden, 2, 2 * sms, smem)
    assert plan.blocks_per_dir * 2 > sms
    dxz = torch.full_like(xz, float("nan"))
    partial = xz.new_empty(2, 2, plan.blocks_per_dir, batch, hidden)
    carry = xz.new_empty(2, 2, batch, hidden)
    sync = torch.zeros(2, 2, dtype=torch.int32, device=cuda_device)
    kernel_config.reset_launch_counts()
    with pytest.raises(RuntimeError, match="lstm_bptt: launch failed"):
        kernel_config.launch(
            "lstm_bptt", xz, mask, cprev, hprev, gout, gfinal, wh, dxz,
            partial, carry, sync, batch, time, hidden, 2, 2,
            plan.blocks_per_dir, plan.units, plan.rows, plan.k_tile,
            plan.k_split, smem, 1.0)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["lstm_bptt"] == 0
    assert torch.isnan(dxz).all()


@pytest.mark.parametrize("hidden", [6, 64])
def test_lstm_scan_gradients_match_cpu(cuda_device, hidden):
    """The encoder's bidirectional LSTM through ``ops.rnn``: one launch of
    each kernel, outputs and every gradient against CPU copies."""
    batch, time, width = 5, 7, 24
    lengths = [7, 5, 3, 1, 6]
    results = []
    for device in (cuda_device, torch.device("cpu")):
        cells, params = [], []
        for seed in (1, 2):
            cell = nn.LSTMCell(width, hidden)
            cells.append(cell)
            params.append({k: v.to(device).requires_grad_()
                           for k, v in cell.init(
                               torch.Generator().manual_seed(seed)).items()})
        inputs = _randn(device, batch, time, width).requires_grad_()
        kernel_config.reset_launch_counts()
        out, final = rnn.bidirectional_rnn(cells[0], params[0], cells[1],
                                           params[1], inputs,
                                           _mask(device, lengths, time))
        ((out * _randn(device, *out.shape, seed=8)).sum()
         + (final * _randn(device, *final.shape, seed=9)).sum()).backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            counts = kernel_config.launch_counts()
            assert counts["lstm_scan"] == 1 and counts["lstm_bptt"] == 1
        leaves = [p for tree in params for p in tree.values()] + [inputs]
        results.append([out.detach().cpu(), final.detach().cpu()]
                       + [p.grad.cpu() for p in leaves])
    for g, r in zip(*results):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)


def test_wrappers_reject_bad_inputs(cuda_device):
    with pytest.raises(ValueError, match="lstm_scan: inconsistent shapes"):
        cuda_rnn.lstm_scan_forward(
            _randn(cuda_device, 2, 3, 4 * 8), torch.ones(2, 3,
                                                         device=cuda_device),
            _randn(cuda_device, 1, 8, 24), 1.0, 0, False)
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


# ---------------------------------------------------------------------- #
# the Transformer's kernels
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("batch,heads,tq,tk,dim,causal,lengths", [
    (3, 2, 32, 32, 64, False, [32, 17, 0]),
    (2, 8, 48, 48, 64, True, [48, 48]),
    (2, 4, 48, 33, 64, False, [33, 5]),
    (2, 3, 70, 70, 32, True, [70, 70]),
    (1, 2, 9, 130, 8, False, [100]),
    (2, 2, 40, 40, 128, False, [40, 31]),
    (2, 2, 33, 70, 192, False, [70, 9]),
    (2, 2, 40, 40, 256, True, [40, 40]),
])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_flash_kernels(cuda_device, batch, heads, tq, tk, dim, causal,
                       lengths, keep):
    """Forward (out, lse) and dq, dk, dv against the plain versions on
    the card, with and without the hash dropout."""
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    q = _randn(cuda_device, batch, heads, tq, dim, seed=1)
    k = _randn(cuda_device, batch, heads, tk, dim, seed=2)
    v = _randn(cuda_device, batch, heads, tk, dim, seed=3)
    g = _randn(cuda_device, batch, heads, tq, dim, seed=4)
    mask = _mask(cuda_device, lengths, tk)
    key = (123456789, -987654321) if keep < 1.0 else None
    kernel_config.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v, mask, causal, key, keep)
    grads = fa.flash_backward(q, k, v, mask, out, lse, g, causal, key, keep)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    assert [counts[f"flash_attention_{n}"] for n in ("fwd", "bwd_dq",
                                                     "bwd_dkv")] == [1, 1, 1]
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, mask, causal, key,
                                                  keep)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    ref = fa.flash_backward_reference(q, k, v, mask, ref_out, ref_lse, g,
                                      causal, key, keep)
    for name, got, want in zip("qkv", grads, ref):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4,
                                   msg=f"d{name}")


@pytest.mark.parametrize("batch,heads,tq,tk,dim,causal", [
    (4, 2, 32, 1, 64, False), (4, 2, 32, 31, 64, False),
    (4, 2, 32, 32, 64, False), (4, 2, 32, 33, 64, False),
    (2, 2, 64, 512, 64, False), (4, 8, 48, 48, 64, True),
    (2, 3, 33, 70, 6, False)])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_flash_forward_tiles(cuda_device, batch, heads, tq, tk, dim, causal,
                             keep):
    """The register-tiled forward at key lengths around its 32-key tile,
    a long source, the causal decoder and an unaligned head dim, with and
    without dropout, against the plain version; off the causal case one
    batch row has every key masked (uniform weights), and the causal case
    sees every key, as the decoder's self-attention does (a row whose
    visible keys were all padding would spread its weight over the
    skipped tiles in the plain version). With one-hot value rows the
    weights the kernel kept are the plain version's, so the hash's."""
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator().manual_seed(tk)
    mask = _mask(cuda_device, torch.randint(1, tk + 1, (batch,),
                                            generator=gen).tolist(), tk)
    mask[0] = 0.0
    if causal:
        mask = torch.ones_like(mask)
    q = _randn(cuda_device, batch, heads, tq, dim, seed=1)
    k = _randn(cuda_device, batch, heads, tk, dim, seed=2)
    v = _randn(cuda_device, batch, heads, tk, dim, seed=3)
    key = (77, -3) if keep < 1.0 else None
    kernel_config.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v, mask, causal, key, keep)
    torch.cuda.synchronize()
    assert kernel_config.launch_counts()["flash_attention_fwd"] == 1
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, mask, causal, key,
                                                  keep)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    if key is not None and tk <= dim:
        onehot = torch.eye(tk, dim, device=cuda_device).expand(
            batch, heads, tk, dim).contiguous()
        small = (q * 0.1, k * 0.1, onehot, mask, causal, key, keep)
        kept, _ = fa.flash_forward(*small)
        want, _ = fa.flash_forward_reference(*small)
        assert torch.equal(kept != 0, want != 0)


@pytest.mark.parametrize("batch,heads,tq,tk,dim,causal", [
    (4, 2, 32, 1, 64, False), (4, 2, 32, 31, 64, False),
    (4, 2, 32, 32, 64, False), (4, 2, 32, 33, 64, False),
    (4, 2, 48, 48, 64, False), (4, 2, 32, 64, 64, False),
    (4, 2, 40, 65, 64, False), (2, 2, 64, 512, 64, False),
    (2, 2, 100, 32, 64, False), (4, 8, 48, 48, 64, True),
    (2, 2, 70, 70, 32, True), (2, 3, 33, 70, 6, False),
    (2, 2, 40, 40, 16, False), (2, 2, 40, 40, 32, False),
    (2, 2, 40, 40, 128, False), (2, 2, 40, 40, 192, False),
    (2, 2, 70, 70, 256, True), (2, 1, 33, 70, 256, False)])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_flash_backward_tiles(cuda_device, batch, heads, tq, tk, dim, causal,
                              keep):
    """The register-tiled dq and dkv kernels at key and query lengths
    around their 32-row tiles, a long source, more queries than keys, the
    causal decoder and every head width, with and without dropout,
    against the plain backward on the same forward outputs: dq, dk and dv
    within 1e-4 of the largest entry (of 1 where the exact gradient is
    0: at Tk 1, dS = P (dP - dcap) cancels to rounding). Off the causal
    cases one batch row has every key masked (uniform weights)."""
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator().manual_seed(tq * 1000 + tk)
    mask = _mask(cuda_device, torch.randint(1, tk + 1, (batch,),
                                            generator=gen).tolist(), tk)
    mask[0] = 0.0
    if causal:
        mask = torch.ones_like(mask)
    q = _randn(cuda_device, batch, heads, tq, dim, seed=1)
    k = _randn(cuda_device, batch, heads, tk, dim, seed=2)
    v = _randn(cuda_device, batch, heads, tk, dim, seed=3)
    g = _randn(cuda_device, batch, heads, tq, dim, seed=4)
    key = (91, -17) if keep < 1.0 else None
    out, lse = fa.flash_forward(q, k, v, mask, causal, key, keep)
    kernel_config.reset_launch_counts()
    grads = fa.flash_backward(q, k, v, mask, out, lse, g, causal, key, keep)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    assert (counts["flash_attention_bwd_dq"],
            counts["flash_attention_bwd_dkv"]) == (1, 1)
    ref = fa.flash_backward_reference(q, k, v, mask, out, lse, g, causal,
                                      key, keep)
    for name, got, want in zip("qkv", grads, ref):
        err = float((got - want).abs().max())
        assert err <= 1e-4 * max(1.0, float(want.abs().max())), (name, err)


def test_flash_dropout_mask_equals_the_hash(cuda_device):
    """With one-hot value rows, the context shows which weights the
    kernel dropped: exactly the plain version's keep mask."""
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    batch, heads, time = 3, 4, 48
    q = _randn(cuda_device, batch, heads, time, 64, scale=0.1)
    k = _randn(cuda_device, batch, heads, time, 64, seed=1, scale=0.1)
    v = torch.eye(time, 64, device=cuda_device).expand(
        batch, heads, time, 64).contiguous()
    mask = torch.ones(batch, time, device=cuda_device)
    key = (-5, 77)
    out, _ = fa.flash_forward(q, k, v, mask, False, key, 0.9)
    kept = out[..., :time] != 0
    want = fa.keep_mask_dense(key, batch, heads, time, time, 0.9,
                              cuda_device)
    assert torch.equal(kept, want)


def test_flash_attention_function_gradients(cuda_device, monkeypatch):
    """The autograd Function through the backward kernels on the card
    against the remat path (NM_FLASH_BWD=0) on CPU copies; on the card
    that switch raises."""
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    args = [_randn(cuda_device, 2, 4, 24, 64, seed=s) for s in range(3)]
    mask = _mask(cuda_device, [24, 10], 24)

    def grads(device):
        leaves = [a.to(device, copy=True).requires_grad_() for a in args]
        fa.flash_attention(*leaves, mask.to(device), True, (3, 4),
                           0.9).square().sum().backward()
        return [t.grad.cpu() for t in leaves]

    kernel_config.reset_launch_counts()
    got = grads(cuda_device)
    assert kernel_config.launch_counts()["flash_attention_bwd_dkv"] == 1
    monkeypatch.setenv("NM_FLASH_BWD", "0")
    for g, want in zip(got, grads("cpu")):
        torch.testing.assert_close(g, want, atol=1e-4, rtol=1e-4)
    with pytest.raises(NotImplementedError, match="NM_FLASH_BWD"):
        grads(cuda_device)


def test_flash_dropout_switch_raises_on_the_card(cuda_device, monkeypatch):
    """NM_FLASH_DROPOUT=0 sends attention dropout to the dense path on
    the CPU only: on the card it raises instead of leaving the
    kernels."""
    from neuralmonkey_tpu_torch.ops import attention
    params = attention.mha_init(torch.Generator().manual_seed(0), 16, 16,
                                16)
    x = _randn("cpu", 2, 6, 16)
    mask = _mask("cpu", [6, 3], 6)
    monkeypatch.setenv("NM_FLASH_DROPOUT", "0")
    attention.multi_head_attention(params, x, x, x, 4, key_mask=mask,
                                   dropout_seed=3, dropout_keep_prob=0.5)
    on_card = {k: {n: t.to(cuda_device) for n, t in v.items()}
               for k, v in params.items()}
    with pytest.raises(NotImplementedError, match="NM_FLASH_DROPOUT"):
        attention.multi_head_attention(
            on_card, x.to(cuda_device), x.to(cuda_device),
            x.to(cuda_device), 4, key_mask=mask.to(cuda_device),
            dropout_seed=3, dropout_keep_prob=0.5)


@pytest.mark.parametrize("batch,heads,beam,time,dim", [
    (4, 8, 10, 48, 64), (2, 2, 20, 7, 32), (3, 2, 3, 5, 8)])
def test_lineage_kernel(cuda_device, batch, heads, beam, time, dim):
    from neuralmonkey_tpu_torch.ops import lineage_attention as la
    gen = torch.Generator().manual_seed(0)
    q = _randn(cuda_device, batch, heads, beam, dim)
    kq = _randn(cuda_device, batch, heads, dim, beam * time, seed=1)
    vq = _randn(cuda_device, batch, heads, beam * time, dim, seed=2)
    for step in sorted({0, time // 4, time // 2, time - 1}):
        anc = torch.randint(0, beam, (batch, beam, time), generator=gen,
                            dtype=torch.int32).to(cuda_device)
        win = step + 1
        bias = la.lineage_bias(anc, step, win, beam,
                               la.lane_window(win, beam, beam * time), time)
        kernel_config.reset_launch_counts()
        got = la.lineage_attention(q, kq, vq, bias)
        torch.cuda.synchronize()
        assert kernel_config.launch_counts()["lineage_attention"] == 1
        ref = la.lineage_attention_reference(q, kq, vq, bias)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5,
                                   msg=f"step {step}")


@pytest.mark.parametrize("batch,heads,beam,time,dim", [
    (1, 8, 10, 48, 64), (64, 8, 10, 48, 64), (2, 4, 1, 48, 64),
    (3, 2, 7, 9, 40), (2, 4, 17, 20, 64), (4, 2, 10, 48, 128),
    (1, 8, 10, 48, 256), (16, 8, 10, 48, 256), (8, 1, 7, 48, 40),
    (2, 2, 10, 48, 384), (1, 8, 10, 48, 512), (8, 1, 7, 9, 512),
    (4, 2, 17, 12, 512), (2, 2, 10, 48, 640), (1, 2, 10, 48, 1024),
    (3, 1, 7, 9, 513), (16, 2, 4, 12, 1000)])
def test_lineage_kernel_streams_every_shape(cuda_device, batch, heads, beam,
                                            time, dim):
    """The pipelined kernel against its plain version within 1e-5: B·H 8
    (lane split) and 512, K 1, 7, 10 and 17, Dh 40 to 256, caches of 63
    lanes (4-byte copies), Dh 384 and 512 (16-lane stages), and the
    chunked instance past 512 (Dh 513, 640, 1000 and 1024, with and
    without the lane split); windows of one lane and of 12, 24 and 48
    positions, and a step whose rows are all -1e9 (uniform weights)."""
    from neuralmonkey_tpu_torch.ops import lineage_attention as la
    gen = torch.Generator().manual_seed(0)
    total = beam * time
    q = _randn(cuda_device, batch, heads, beam, dim)
    kq = _randn(cuda_device, batch, heads, dim, total, seed=1)
    vq = _randn(cuda_device, batch, heads, total, dim, seed=2)
    anc = torch.randint(0, beam, (batch, beam, time), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    cases = [(min(win, time) - 1, win) for win in (12, 24, 48)]
    cases.append((-1, min(12, time)))  # no lane is the slot's own yet
    biases = [la.lineage_bias(anc, step, win, beam,
                              la.lane_window(win, beam, total), time)
              for step, win in cases]
    biases.append(biases[0][..., :1].contiguous())  # one lane
    name = "lineage_attention" + ("_chunked" if dim > 512 else "")
    for bias in biases:
        kernel_config.reset_launch_counts()
        got = la.lineage_attention(q, kq, vq, bias)
        torch.cuda.synchronize()
        assert kernel_config.launch_counts()[name] == 1
        ref = la.lineage_attention_reference(q, kq, vq, bias)
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5,
                                   msg=f"{bias.shape[-1]} lanes")


def test_lineage_kernel_past_512_runs_the_chunked_kernel(cuda_device):
    """Past the single-pass head dims the chunked instance runs (as the
    JAX package runs its kernel at any multiple of 128): a head dim of
    640 on 8 lanes against the plain version."""
    from neuralmonkey_tpu_torch.ops import lineage_attention as la
    q = _randn(cuda_device, 1, 1, 2, 640)
    kq = _randn(cuda_device, 1, 1, 640, 8, seed=1)
    vq = _randn(cuda_device, 1, 1, 8, 640, seed=2)
    bias = torch.zeros(1, 2, 8, device=cuda_device)
    kernel_config.reset_launch_counts()
    got = la.lineage_attention(q, kq, vq, bias)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    assert (counts["lineage_attention_chunked"],
            counts["lineage_attention"]) == (1, 0)
    torch.testing.assert_close(
        got, la.lineage_attention_reference(q, kq, vq, bias), atol=1e-5,
        rtol=1e-5)


def _gru_train_step(device, hidden, inputs, mask, g_out, g_final):
    """Loss and flat gradients of one step of a GRU encoder's scan (one
    direction) on ``device``."""
    cell = nn.GRUCell(inputs.shape[-1], hidden)
    params = {k: v.to(device).requires_grad_()
              for k, v in cell.init(torch.Generator().manual_seed(5)).items()}
    x = inputs.detach().to(device).requires_grad_()
    out, final = rnn.unidirectional_rnn(cell, params, x, mask.to(device))
    loss = (out * g_out.to(device)).sum() + (final * g_final.to(device)).sum()
    loss.backward()
    grads = {k: p.grad.cpu() for k, p in params.items()}
    return loss.detach().cpu(), {**grads, "inputs": x.grad.cpu()}


def _lstm_train_step(device, hidden, inputs, mask, g_out, g_final):
    cell = nn.LSTMCell(inputs.shape[-1], hidden)
    params = {k: v.to(device).requires_grad_()
              for k, v in cell.init(torch.Generator().manual_seed(5)).items()}
    x = inputs.detach().to(device).requires_grad_()
    out, final = rnn.unidirectional_rnn(cell, params, x, mask.to(device))
    loss = (out * g_out.to(device)).sum() + (final * g_final.to(device)).sum()
    loss.backward()
    grads = {k: p.grad.cpu() for k, p in params.items()}
    return loss.detach().cpu(), {**grads, "inputs": x.grad.cpu()}


def _assert_training_rule(got, want):
    """PERF.md's training rule: the loss to 1e-5 relative, each gradient
    to 1e-3 of its largest entry."""
    (loss, grads), (ref_loss, ref_grads) = got, want
    torch.testing.assert_close(loss, ref_loss, atol=0, rtol=1e-5)
    for key, g in grads.items():
        scale = float(ref_grads[key].abs().max())
        assert float((g - ref_grads[key]).abs().max()) <= 1e-3 * scale, key


@pytest.mark.parametrize("cell,hidden,kernels", [
    ("GRU", 8192, {"gru_scan": 1, "gru_bptt": 0}),
    ("LSTM", 8448, {"lstm_scan": 0, "lstm_bptt": 0})])
def test_rnn_past_the_kernels_limits_trains_on_card(cuda_device, cell, hidden,
                                                     kernels):
    """Queue C: a GRU of H 8192 keeps K1 forward and runs the plain BPTT
    (past ``bptt_fits``); an LSTM of H 8448 runs the plain scan whole
    (past ``lstm_scan_fits``); neither raises, and one training step
    matches the CPU's."""
    batch, time, width = 2, 4, 16
    gen = torch.Generator().manual_seed(7)
    inputs = torch.randn(batch, time, width, generator=gen)
    mask = torch.tensor([[1.0, 1, 1, 1], [1, 1, 0, 0]])
    g_out = torch.randn(batch, time, hidden, generator=gen)
    g_final = torch.randn(batch, hidden, generator=gen)
    step = _gru_train_step if cell == "GRU" else _lstm_train_step
    kernel_config.reset_launch_counts()
    got = step(cuda_device, hidden, inputs, mask, g_out, g_final)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    assert {name: counts[name] for name in kernels} == kernels, counts
    _assert_training_rule(got, step(torch.device("cpu"), hidden, inputs,
                                    mask, g_out, g_final))


@pytest.mark.parametrize("model_dim", [384, 512])
def test_flash_attention_at_wide_head_dims_launches_the_kernels(cuda_device,
                                                               model_dim):
    """Queue C: at head dims 192 and 256 (two heads) multi-head attention
    runs the flash kernels on the card, forward and backward, as the JAX
    package runs its flash kernels at any head dim, and matches the CPU's
    within 1e-4 of each tensor's largest entry (of 1 where that is
    smaller), the rule of the flash backward's card tests and of the
    smoke's phase 3b."""
    from neuralmonkey_tpu_torch.ops import attention
    gen = torch.Generator().manual_seed(0)
    params = attention.mha_init(gen, model_dim, model_dim, model_dim)
    x = torch.randn(3, 9, model_dim, generator=gen)
    mask = torch.ones(3, 9)
    mask[1, 5:] = 0

    def run(device):
        p = {k: {n: t.detach().to(device).requires_grad_()
                 for n, t in v.items()} for k, v in params.items()}
        xs = x.detach().to(device).requires_grad_()
        out = attention.multi_head_attention(
            p, xs, xs, xs, 2, key_mask=mask.to(device), causal=True)
        out.square().sum().backward()
        return [out.detach().cpu(), xs.grad.cpu()] + [
            t.grad.cpu() for v in p.values() for t in v.values()]
    kernel_config.reset_launch_counts()
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert [kernel_config.launch_counts()[f"flash_attention_{name}"]
            for name in ("fwd", "bwd_dq", "bwd_dkv")] == [1, 1, 1]
    for i, (g, r) in enumerate(zip(got, run(torch.device("cpu")))):
        err = float((g - r).abs().max())
        assert err <= 1e-4 * max(1.0, float(r.abs().max())), (i, err)


@pytest.mark.parametrize("model_dim", [640, 1024])
def test_flash_attention_past_256_through_multi_head_attention(cuda_device,
                                                               model_dim):
    """At head dims 320 and 512 (two heads) multi-head attention runs the
    chunked flash instances, forward and backward, and matches the CPU's
    within 1e-4 of each tensor's largest entry (of 1 where that is
    smaller); the key bias, whose exact gradient is 0 (it shifts every
    score of a row alike, so its entries are rounding noise), within
    1e-4 of its key weight's, as the smoke's phase 12 holds it."""
    from neuralmonkey_tpu_torch.ops import attention
    gen = torch.Generator().manual_seed(0)
    params = attention.mha_init(gen, model_dim, model_dim, model_dim)
    x = torch.randn(3, 9, model_dim, generator=gen)
    mask = torch.ones(3, 9)
    mask[1, 5:] = 0

    def run(device):
        p = {k: {n: t.detach().to(device).requires_grad_()
                 for n, t in v.items()} for k, v in params.items()}
        xs = x.detach().to(device).requires_grad_()
        out = attention.multi_head_attention(
            p, xs, xs, xs, 2, key_mask=mask.to(device), causal=True)
        out.square().sum().backward()
        return {"out": out.detach().cpu(), "x": xs.grad.cpu(),
                **{f"{k}/{n}": t.grad.cpu() for k, v in p.items()
                   for n, t in v.items()}}
    kernel_config.reset_launch_counts()
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert [kernel_config.launch_counts()[f"flash_attention_{name}_chunked"]
            for name in ("fwd", "bwd_dq", "bwd_dkv")] == [1, 1, 1]
    ref = run(torch.device("cpu"))
    for key, g in got.items():
        scale_key = "k/w" if key == "k/b" else key
        err = float((g - ref[key]).abs().max())
        assert err <= 1e-4 * max(1.0, float(ref[scale_key].abs().max())), (
            key, err)


def test_flash_attention_past_256_runs_the_chunked_kernels(cuda_device):
    """Past the single-pass head dims the chunked instances run, as the
    JAX flash kernels pad any head dim; no plain path runs."""
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    q = _randn(cuda_device, 1, 1, 8, 320)
    mask = torch.ones(1, 8, device=cuda_device)
    kernel_config.reset_launch_counts()
    out, lse = fa.flash_forward(q, q, q, mask, False)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    assert (counts["flash_attention_fwd_chunked"],
            counts["flash_attention_fwd"]) == (1, 0)
    ref_out, ref_lse = fa.flash_forward_reference(q, q, q, mask, False)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("batch,heads,tq,tk,dim,causal,lengths", [
    (2, 2, 40, 40, 320, True, [40, 40]),
    (2, 2, 33, 70, 512, False, [70, 9]),
    (1, 3, 9, 130, 300, False, [100]),
    (2, 1, 37, 37, 322, True, [37, 20]),
    (1, 2, 48, 48, 1024, True, [48]),
])
@pytest.mark.parametrize("keep", [1.0, 0.9])
def test_flash_chunked_kernels(cuda_device, batch, heads, tq, tk, dim,
                               causal, lengths, keep):
    """The chunked instances past head dim 256 (column blocks of 256, the
    scores summed over 256-column chunks; 300 leaves a partial chunk,
    322 takes the loaders' 4-byte path) against the plain versions, with
    and without the hash dropout, to the single-pass tests' tolerances."""
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    q = _randn(cuda_device, batch, heads, tq, dim, seed=1)
    k = _randn(cuda_device, batch, heads, tk, dim, seed=2)
    v = _randn(cuda_device, batch, heads, tk, dim, seed=3)
    g = _randn(cuda_device, batch, heads, tq, dim, seed=4)
    mask = _mask(cuda_device, lengths, tk)
    key = (123456789, -987654321) if keep < 1.0 else None
    kernel_config.reset_launch_counts()
    out, lse = fa.flash_forward(q, k, v, mask, causal, key, keep)
    grads = fa.flash_backward(q, k, v, mask, out, lse, g, causal, key, keep)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    assert [counts[f"flash_attention_{n}_chunked"]
            for n in ("fwd", "bwd_dq", "bwd_dkv")] == [1, 1, 1]
    assert [counts[f"flash_attention_{n}"]
            for n in ("fwd", "bwd_dq", "bwd_dkv")] == [0, 0, 0]
    ref_out, ref_lse = fa.flash_forward_reference(q, k, v, mask, causal, key,
                                                  keep)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    ref = fa.flash_backward_reference(q, k, v, mask, ref_out, ref_lse, g,
                                      causal, key, keep)
    for name, got, want in zip("qkv", grads, ref):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4,
                                   msg=f"d{name}")


def _transformer_pass(device):
    """Loss and flat gradients of one train-mode pass of a small
    Transformer, residual dropout off and attention dropout on (the
    keep hash draws the same mask on both devices)."""
    from neuralmonkey_tpu_torch.models.decoders.transformer import \
        TransformerDecoder
    from neuralmonkey_tpu_torch.models.encoders.transformer import \
        TransformerEncoder
    vocab = Vocabulary([f"w{i}" for i in range(296)])
    enc = TransformerEncoder(name="encoder", vocabulary=vocab,
                             data_id="source", embedding_size=64,
                             ff_hidden_size=128, depth=2, n_heads=2,
                             dropout_keep_prob=1.0,
                             attention_dropout_keep_prob=0.9)
    dec = TransformerDecoder(name="decoder", vocabulary=vocab,
                             data_id="target", max_output_len=6,
                             encoders=[enc], embedding_size=64,
                             ff_hidden_size=128, depth=2, n_heads_self=2,
                             n_heads_enc=2, label_smoothing=0.1,
                             dropout_keep_prob=1.0,
                             attention_dropout_keep_prob=0.9)
    def to_device(tree):
        if isinstance(tree, dict):
            return {k: to_device(v) for k, v in tree.items()}
        return tree.to(device).requires_grad_()
    params = to_device(init_all_params(collect_parts([dec]), seed=3))
    leaves = flatten_tree(params)
    gen = torch.Generator().manual_seed(0)
    mask = torch.ones(4, 7)
    mask[1, 5:] = 0
    tmask = torch.ones(4, 6)
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
    return loss.detach().cpu(), {k: p.grad.cpu() for k, p in leaves.items()}


def test_transformer_training_step_on_card_matches_cpu(cuda_device):
    kernel_config.reset_launch_counts()
    loss, grads = _transformer_pass(cuda_device)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        assert counts[f"flash_attention_{name}"] > 0, counts
    ref_loss, ref_grads = _transformer_pass(torch.device("cpu"))
    torch.testing.assert_close(loss, ref_loss, atol=1e-5, rtol=1e-5)
    for key, g in grads.items():
        torch.testing.assert_close(g, ref_grads[key], atol=1e-5, rtol=1e-4,
                                   msg=key)


# ---------------------------------------------------------------------- #
# the CNN encoders, the mixture-of-experts Transformer and CTC speech
# ---------------------------------------------------------------------- #
def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device).requires_grad_()


def _loss_and_grads(part, loss_fn, batch, device, seed=3):
    """Loss and flat gradients of ``loss_fn(ctx)`` of one train-mode
    pass of ``part`` (dropout off) on ``device``, with the launches of
    that pass."""
    params = _to_device(init_all_params(collect_parts([part]), seed=seed),
                        device)
    leaves = flatten_tree(params)
    kernel_config.reset_launch_counts()
    ctx = Context(params, {k: v.to(device) for k, v in batch.items()},
                  train=True, rng=0)
    loss = loss_fn(ctx)
    loss.backward()
    counts = kernel_config.launch_counts()
    return (loss.detach().cpu(), {k: p.grad.cpu() for k, p in leaves.items()},
            counts)


def _assert_step_matches_cpu(part, loss_fn, batch, device, kernels):
    loss, grads, counts = _loss_and_grads(part, loss_fn, batch, device)
    for name in kernels:
        assert counts[name] > 0, counts
    ref_loss, ref_grads, _ = _loss_and_grads(part, loss_fn, batch,
                                             torch.device("cpu"))
    torch.testing.assert_close(loss, ref_loss, atol=1e-5, rtol=1e-5)
    for key, g in grads.items():
        torch.testing.assert_close(g, ref_grads[key], atol=1e-5, rtol=1e-4,
                                   msg=key)


def test_sentence_cnn_model_step_on_card_matches_cpu(cuda_device):
    """sentence_cnn.ini's model: K1 forward, the GRU BPTT and K2 on the
    card; the convolutions are cuDNN's (TF32 off)."""
    from neuralmonkey_tpu_torch.models.encoders.sentence_cnn_encoder import \
        SentenceCNNEncoder
    vocab = Vocabulary([f"w{i}" for i in range(60)])
    enc = SentenceCNNEncoder(name="encoder", vocabulary=vocab,
                             data_id="source", embedding_size=24,
                             filters=[(2, 16), (3, 16), (4, 8)],
                             highway_depth=2, rnn_size=32)
    att = Attention(name="attention", encoder=enc, state_size=32)
    dec = Decoder(name="decoder", encoders=[enc], attentions=[att],
                  rnn_size=32, embedding_size=24, data_id="target",
                  max_output_len=6, vocabulary=vocab)
    gen = torch.Generator().manual_seed(1)
    batch = {"encoder_input.ids": torch.randint(4, 64, (4, 9), generator=gen,
                                                dtype=torch.int32),
             "encoder_input.mask": _mask("cpu", [9, 6, 2, 0], 9),
             "decoder.train_inputs": torch.randint(1, 64, (4, 6),
                                                   generator=gen,
                                                   dtype=torch.int32),
             "decoder.train_targets": torch.randint(2, 64, (4, 6),
                                                    generator=gen,
                                                    dtype=torch.int32),
             "decoder.train_mask": _mask("cpu", [6, 4, 1, 0], 6)}
    _assert_step_matches_cpu(dec, dec.train_loss, batch, cuda_device,
                             ("gru_scan", "gru_bptt", "fused_bahdanau_step"))


def _moe_transformer(max_out=6):
    from neuralmonkey_tpu_torch.models.decoders.transformer import \
        TransformerDecoder
    from neuralmonkey_tpu_torch.models.encoders.transformer import \
        TransformerEncoder
    vocab = Vocabulary([f"w{i}" for i in range(296)])
    moe_args = dict(moe_experts=4, moe_top_k=2, moe_z_loss_weight=0.001,
                    dropout_keep_prob=1.0)
    enc = TransformerEncoder(name="encoder", vocabulary=vocab,
                             data_id="source", embedding_size=64,
                             ff_hidden_size=128, depth=2, n_heads=2,
                             **moe_args)
    return TransformerDecoder(name="decoder", vocabulary=vocab,
                              data_id="target", max_output_len=max_out,
                              encoders=[enc], embedding_size=64,
                              ff_hidden_size=128, depth=2, n_heads_self=2,
                              n_heads_enc=2, label_smoothing=0.1,
                              **moe_args)


def _transformer_batch():
    gen = torch.Generator().manual_seed(0)
    return {"encoder_input.ids": torch.randint(4, 300, (4, 7), generator=gen,
                                               dtype=torch.int32),
            "encoder_input.mask": _mask("cpu", [7, 5, 2, 0], 7),
            "decoder.train_inputs": torch.randint(1, 300, (4, 6),
                                                  generator=gen,
                                                  dtype=torch.int32),
            "decoder.train_targets": torch.randint(2, 300, (4, 6),
                                                   generator=gen,
                                                   dtype=torch.int32),
            "decoder.train_mask": _mask("cpu", [6, 4, 1, 0], 6)}


def test_moe_transformer_step_on_card_matches_cpu(cuda_device):
    """The loss with both auxiliary losses and every gradient; the MoE
    is einsums, the attention the flash kernels."""
    dec = _moe_transformer()

    def total(ctx):
        return dec.train_loss(ctx) + sum(ctx.aux_losses.values())
    _assert_step_matches_cpu(dec, total, _transformer_batch(), cuda_device,
                             ("flash_attention_fwd", "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv"))


@pytest.mark.parametrize("lineage_kernel", ["0", "1"])
def test_moe_transformer_decodes_on_card_like_cpu(cuda_device, monkeypatch,
                                                  lineage_kernel):
    """Greedy and beam-4 ids of a batch with a padding row; K3 and K4
    launch, and the lineage attention under NM_LINEAGE_KERNEL=1."""
    from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
        BeamSearchDecoder
    monkeypatch.setenv("NM_LINEAGE_KERNEL", lineage_kernel)
    dec = _moe_transformer(max_out=8)
    # hierarchical selection arms K3 at this small vocabulary too
    search = BeamSearchDecoder(name="bs", parent_decoder=dec, beam_size=4,
                               selection_method="hierarchical")
    params = init_all_params(collect_parts([dec]), seed=5)
    batch = {k: v for k, v in _transformer_batch().items()
             if k.startswith("encoder")}

    def decode(device):
        ctx = Context(_to_device(params, device) if device.type == "cuda"
                      else params, {k: v.to(device) for k, v in batch.items()})
        with torch.inference_mode():
            return dec.decoded(ctx).cpu(), search.search(ctx).token_ids.cpu()
    kernel_config.reset_launch_counts()
    greedy, beam = decode(cuda_device)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    expected = ["fused_logits_rowmax_lse", "small_topk"]
    if lineage_kernel == "1":
        expected.append("lineage_attention")
    for name in expected:
        assert counts[name] > 0, counts
    ref_greedy, ref_beam = decode(torch.device("cpu"))
    assert torch.equal(greedy[:3], ref_greedy[:3])
    assert torch.equal(beam[:3], ref_beam[:3])


def _ctc_model(beam):
    from neuralmonkey_tpu_torch.models.decoders.ctc_decoder import CTCDecoder
    from neuralmonkey_tpu_torch.models.encoders.raw_rnn_encoder import \
        RawRNNEncoder
    enc = RawRNNEncoder(name="encoder", data_id="speech", input_size=13,
                        rnn_size=32)
    return CTCDecoder(name="decoder", encoder=enc,
                      vocabulary=Vocabulary(list("abcdefghij")),
                      data_id="text", beam_width=beam)


def _speech_batch():
    gen = torch.Generator().manual_seed(2)
    return {"encoder.seq": torch.randn(4, 40, 13, generator=gen),
            "encoder.seq_mask": _mask("cpu", [40, 31, 9, 0], 40),
            "decoder.labels": torch.randint(4, 14, (4, 6), generator=gen,
                                            dtype=torch.int32),
            "decoder.labels_mask": _mask("cpu", [6, 4, 2, 0], 6)}


def test_ctc_model_step_on_card_matches_cpu(cuda_device):
    """The CTC loss (F.ctc_loss) over a BiGRU: K1 forward and the GRU
    BPTT on the card."""
    dec = _ctc_model(1)
    _assert_step_matches_cpu(dec, dec.train_loss, _speech_batch(),
                             cuda_device, ("gru_scan", "gru_bptt"))


@pytest.mark.parametrize("beam", [1, 8])
def test_ctc_decoding_on_card_matches_cpu(cuda_device, beam):
    """Greedy collapse and the prefix beam search on the card against the
    CPU on the same logits: equal prefixes, scores to 1e-4."""
    from neuralmonkey_tpu_torch.models.decoders import ctc_decoder
    logits = torch.randn(4, 40, 14, generator=torch.Generator().manual_seed(3))
    mask = _mask("cpu", [40, 31, 9, 0], 40)
    if beam == 1:
        got = ctc_decoder.ctc_greedy(logits.to(cuda_device),
                                     mask.to(cuda_device))
        assert torch.equal(got.cpu(), ctc_decoder.ctc_greedy(logits, mask))
        return
    lp = torch.log_softmax(logits, dim=-1)
    prefixes, scores = ctc_decoder.ctc_beam_search(
        lp.to(cuda_device), mask.to(cuda_device) > 0, beam)
    ref_prefixes, ref_scores = ctc_decoder.ctc_beam_search(lp, mask > 0, beam)
    assert torch.equal(prefixes.cpu(), ref_prefixes)
    torch.testing.assert_close(scores.cpu(), ref_scores, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------- #
# the bf16 compute policy: the bf16 kernel instances and the gates
# ---------------------------------------------------------------------- #
def _bf16_weight_tolerance(v: torch.Tensor) -> float:
    """A normalised weight near a bf16 rounding tie may round either way
    when its float32 value differs in the last bits (the scores' and the
    sums' order differ between the kernel and cuBLAS), which moves a
    context entry by at most one bf16 ulp of that weight (2^-8 of it, a
    weight being at most 1) times the value: 2^-8 · max |v|."""
    return 2.0 ** -8 * float(v.float().abs().max())


def _bf16_rows_apart(got: torch.Tensor, ref: torch.Tensor,
                     v: torch.Tensor) -> Tuple[int, int]:
    """(rows apart, rows allowed): a (b, h, slot) row of the context is
    apart when any entry differs by more than 2^-16 · max |v|. Such
    rounding ties are rare, so at most 1% of the rows, and at least 2,
    may be; the plain version with a rounding point left out (float32
    weights, unnormalised weights rounded, q scaled in float32) leaves
    nearly every row apart."""
    apart = ((got - ref).abs()
             > 2.0 ** -16 * float(v.float().abs().max())).any(dim=-1)
    return int(apart.sum()), max(2, apart.numel() // 100)


@pytest.mark.parametrize("batch,heads,beam,time,dim", [
    (4, 8, 10, 48, 64), (64, 8, 10, 48, 64), (1, 8, 10, 48, 64),
    (3, 2, 3, 5, 32), (2, 4, 17, 20, 40), (2, 2, 70, 6, 16),
    (2, 2, 10, 48, 512), (2, 2, 10, 48, 640), (1, 2, 10, 12, 1000),
    (2, 2, 20, 8, 64), (3, 2, 40, 4, 8), (2, 2, 10, 48, 128),
    (2, 2, 10, 48, 256), (16, 8, 10, 48, 32)])
def test_lineage_kernel_bf16_caches(cuda_device, batch, heads, beam, time,
                                    dim):
    """The bf16 instance on bf16 caches against its plain version (q
    rounded and then scaled in bf16, float32 softmax, the normalised
    weights rounded to bf16, a float32 context): the smoke's shape (B 64,
    H 8, beam 10, 48 steps, Dh 64), the lane split (B·H 8, 32 and 128:
    clusters of 8, 4 and 2 blocks), head dims 8 to 1000, beams 3 to 70
    (slot groups of 16); windows of 12, 24 and 48 positions and of one
    lane. Each shape launches the instance the shape gate names: the
    one-pass kernel where it takes the shape
    (``lineage_bf16_pass_plan``), the scratch design past it (odd
    lane counts, head dims past 256). Tolerance: one bf16 ulp of a
    weight times the largest value (``_bf16_weight_tolerance``), and at
    most 1% of the rows more than 2^-16 of it apart
    (``_bf16_rows_apart``)."""
    from neuralmonkey_tpu_torch.ops import lineage_attention as la
    gen = torch.Generator().manual_seed(0)
    total = beam * time
    q = _randn(cuda_device, batch, heads, beam, dim)
    kq = _randn(cuda_device, batch, heads, dim, total, seed=1).to(
        torch.bfloat16)
    vq = _randn(cuda_device, batch, heads, total, dim, seed=2).to(
        torch.bfloat16)
    anc = torch.randint(0, beam, (batch, beam, time), generator=gen,
                        dtype=torch.int32).to(cuda_device)
    biases = [la.lineage_bias(anc, min(win, time) - 1, win, beam,
                              la.lane_window(win, beam, total), time)
              for win in (12, 24, 48)]
    biases.append(biases[0][..., :1].contiguous())
    instances = ("lineage_attention_bf16", "lineage_attention_bf16_scratch")
    for bias in biases:
        lanes = bias.shape[-1]
        plan = la.lineage_bf16_pass_plan(
            batch, heads, beam, dim, total, lanes,
            *kernel_config.device_limits(0))
        assert (plan is not None) == (total % 8 == 0 and dim <= 256)
        name = instances[plan is None]
        kernel_config.reset_launch_counts()
        got = la.lineage_attention(q, kq, vq, bias)
        torch.cuda.synchronize()
        counts = kernel_config.launch_counts()
        assert counts[name] == 1 and counts["lineage_attention"] == 0, counts
        assert sum(counts[k] for k in instances) == 1, counts
        assert got.dtype == torch.float32
        ref = la.lineage_attention_reference(q, kq, vq, bias)
        tol = _bf16_weight_tolerance(vq[:, :, :lanes])
        torch.testing.assert_close(got, ref, atol=tol, rtol=0,
                                   msg=f"{lanes} lanes")
        apart, allowed = _bf16_rows_apart(got, ref, vq[:, :, :lanes])
        assert apart <= allowed, f"{lanes} lanes: {apart} rows apart"


def test_lineage_kernel_refuses_mixed_caches(cuda_device):
    """A bf16 key cache beside a float32 value cache reaches neither
    instance: the dtype check raises."""
    from neuralmonkey_tpu_torch.ops import lineage_attention as la
    q = _randn(cuda_device, 1, 1, 2, 32)
    kq = _randn(cuda_device, 1, 1, 32, 8, seed=1).to(torch.bfloat16)
    vq = _randn(cuda_device, 1, 1, 8, 32, seed=2)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        la.lineage_attention(q, kq, vq, torch.zeros(1, 2, 8,
                                                    device=cuda_device))


@pytest.mark.parametrize("n,d,v", [(70, 40, 300), (256, 128, 1024),
                                   (33, 130, 129), (640, 512, 30000),
                                   (200, 40, 129), (333, 130, 30000),
                                   (100, 600, 520)])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_fused_xent_bf16_w_kernels(cuda_device, n, d, v, transposed, eps):
    """The bf16-W instances of the three B7 kernels against the plain
    versions on the widened W, within 1e-5 as the float32 instances; dW
    comes back float32 from the kernel (the autograd Function rounds it
    to bf16). The three run on warpgroup products where W's bf16 rows
    are 16-byte aligned (D % 8 == 0 tied, V % 8 == 0 untied), else on
    the instances that widen W as they stage it; the shapes cross the
    new kernels' tile edges (N not a multiple of 64 or 128, V 129 and
    520, past one 256-column tile, D past one 512-column pass)."""
    x = _randn(cuda_device, n, d, scale=0.3)
    w = _randn(cuda_device, *((v, d) if transposed else (d, v)),
               scale=0.05, seed=1).to(torch.bfloat16)
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
    counts = kernel_config.launch_counts()
    widened = not fused_xent.wgmma_takes(d, v, transposed)
    assert widened == ((d if transposed else v) % 8 != 0)
    for k in ("fused_xent_fwd", "fused_xent_bwd_dx", "fused_xent_bwd_dw"):
        assert (counts[k + "_bf16w"], counts[k + "_bf16w_widened"],
                counts[k]) == ((0, 1, 0) if widened else (1, 0, 0)), counts
    wide = w.float()
    ref_nll, ref_lse = fused_xent.fwd_reference(x, wide, b, targets, eps,
                                                transposed)
    torch.testing.assert_close(nll, ref_nll, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dx, fused_xent.bwd_dx_reference(
        x, wide, b, targets, lse, g, eps, transposed), atol=1e-5, rtol=1e-5)
    ref_dw, ref_db = fused_xent.bwd_dw_reference(x, wide, b, targets, lse, g,
                                                 eps, transposed)
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw, ref_dw, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(db, ref_db, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d,v,transposed", [(640, 512, 30000, True),
                                               (333, 130, 1000, False),
                                               (100, 600, 520, True)])
def test_fused_xent_bf16_w_backward_is_deterministic(cuda_device, n, d, v,
                                                    transposed):
    """Two calls of the bf16-W backward on warpgroup products give
    bitwise-equal dx, dW and db: the vocabulary and row chunks' partials
    fold in one fixed order, and no atomics."""
    x = _randn(cuda_device, n, d, scale=0.3)
    w = _randn(cuda_device, *((v, d) if transposed else (d, v)),
               scale=0.05, seed=1).to(torch.bfloat16)
    b = _randn(cuda_device, v, scale=0.1, seed=2)
    targets = torch.arange(n, dtype=torch.int32, device=cuda_device) * 7 % v
    g = _randn(cuda_device, n, seed=4)
    assert fused_xent.wgmma_takes(d, v, transposed)
    lse = fused_xent.xent_fwd(x, w, b, targets, 0.1, transposed)[1]
    kernel_config.reset_launch_counts()
    first = (fused_xent.xent_bwd_dx(x, w, b, targets, lse, g, 0.1,
                                    transposed),
             *fused_xent.xent_bwd_dw(x, w, b, targets, lse, g, 0.1,
                                     transposed))
    second = (fused_xent.xent_bwd_dx(x, w, b, targets, lse, g, 0.1,
                                     transposed),
              *fused_xent.xent_bwd_dw(x, w, b, targets, lse, g, 0.1,
                                      transposed))
    counts = kernel_config.launch_counts()
    assert (counts["fused_xent_bwd_dx_bf16w"],
            counts["fused_xent_bwd_dw_bf16w"]) == (2, 2), counts
    for a, c in zip(first, second):
        assert torch.equal(a, c)


@pytest.mark.parametrize("n,d,v,transposed", [(3072, 512, 30000, True),
                                               (333, 130, 1000, False),
                                               (100, 600, 520, True)])
def test_fused_xent_bf16_w_forward_is_deterministic(cuda_device, n, d, v,
                                                   transposed):
    """Two calls of the bf16-W forward on warpgroup products give
    bitwise-equal nll and lse (each row's chunk partials fold in one
    fixed order, no atomics), within 1e-5 of the widened design on the same
    operands."""
    x = _randn(cuda_device, n, d, scale=0.3)
    w = _randn(cuda_device, *((v, d) if transposed else (d, v)),
               scale=0.05, seed=1).to(torch.bfloat16)
    b = _randn(cuda_device, v, scale=0.1, seed=2)
    targets = torch.arange(n, dtype=torch.int32, device=cuda_device) * 7 % v
    assert fused_xent.wgmma_takes(d, v, transposed)
    kernel_config.reset_launch_counts()
    first = fused_xent.xent_fwd(x, w, b, targets, 0.1, transposed)
    second = fused_xent.xent_fwd(x, w, b, targets, 0.1, transposed)
    assert kernel_config.launch_counts()["fused_xent_fwd_bf16w"] == 2
    for a, c in zip(first, second):
        assert torch.equal(a, c)
    old = fused_xent.launch_fwd("fused_xent_fwd_bf16w_widened", x, w, b,
                                targets, 0.1, transposed)
    for a, c in zip(first, old):
        torch.testing.assert_close(a, c, atol=1e-5, rtol=1e-5)


def test_fused_xent_autograd_rounds_dw_to_bf16(cuda_device):
    """Through the autograd Function a bf16 W gets a bf16 dW (the float32
    kernel result rounded once) and a float32 x its float32 dx."""
    x = _randn(cuda_device, 48, 64, scale=0.3).requires_grad_()
    w = _randn(cuda_device, 500, 64, scale=0.05, seed=1).to(
        torch.bfloat16).requires_grad_()
    b = _randn(cuda_device, 500, scale=0.1, seed=2).requires_grad_()
    targets = torch.arange(48, dtype=torch.int32, device=cuda_device) * 7
    fused_xent.fused_softmax_xent(x, w, b, targets, 0.1, True).sum().backward()
    assert (x.grad.dtype, w.grad.dtype, b.grad.dtype) == (
        torch.float32, torch.bfloat16, torch.float32)
    lse = fused_xent.fwd_reference(x.detach(), w.detach().float(), b.detach(),
                                   targets, 0.1, True)[1]
    ref_dw, _ = fused_xent.bwd_dw_reference(
        x.detach(), w.detach().float(), b.detach(), targets, lse,
        torch.ones(48, device=cuda_device), 0.1, True)
    torch.testing.assert_close(w.grad.float(), ref_dw.to(torch.bfloat16).float(),
                               atol=2.0 ** -8 * float(ref_dw.abs().max()),
                               rtol=0)


def test_fused_logits_widens_a_bf16_w(cuda_device):
    """K3 computes in float32: a bf16 w is widened (exactly) and K3
    launches, within 1e-4 of the plain version on the widened table,
    as the float32 K3 check; a float16 w raises."""
    x = _randn(cuda_device, 40, 64)
    w = _randn(cuda_device, 64, 1024, scale=0.1, seed=1).to(torch.bfloat16)
    b = _randn(cuda_device, 1024, seed=2)
    kernel_config.reset_launch_counts()
    got = beam_select.fused_logits_rowmax_lse(x, w, b)
    assert kernel_config.launch_counts()["fused_logits_rowmax_lse"] == 1
    ref = beam_select.fused_logits_reference(x, w.float(), b)
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="expected torch.float32"):
        beam_select.fused_logits_rowmax_lse(x, w.half(), b)


def test_float32_kernels_refuse_bf16_operands(cuda_device):
    """A bf16 operand that reaches a float32-only kernel raises."""
    x = _randn(cuda_device, 8, 32).to(torch.bfloat16)
    with pytest.raises(ValueError, match="expected torch.float32"):
        beam_select.small_topk(x, 2)
    with pytest.raises(ValueError, match="expected torch.float32"):
        fused_xent.xent_fwd(x, _randn(cuda_device, 32, 128), torch.zeros(
            128, device=cuda_device), torch.zeros(8, dtype=torch.int32,
                                                  device=cuda_device),
            0.0, False)


def test_fused_xent_refuses_a_float16_w(cuda_device):
    """The cross-entropy kernels take a float32 or a bf16 W: a float16 W
    raises in each of the three wrappers instead of being read as
    float32."""
    x = _randn(cuda_device, 8, 32)
    w = _randn(cuda_device, 32, 128).half()
    b = torch.zeros(128, device=cuda_device)
    targets = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    ones = torch.ones(8, device=cuda_device)
    kernel_config.reset_launch_counts()
    with pytest.raises(ValueError, match="'w' is torch.float16"):
        fused_xent.xent_fwd(x, w, b, targets, 0.0, False)
    with pytest.raises(ValueError, match="'w' is torch.float16"):
        fused_xent.xent_bwd_dx(x, w, b, targets, ones, ones, 0.0, False)
    with pytest.raises(ValueError, match="'w' is torch.float16"):
        fused_xent.xent_bwd_dw(x, w, b, targets, ones, ones, 0.0, False)
    assert not any(kernel_config.launch_counts().values())


def _bf16_transformer(max_out=6):
    from neuralmonkey_tpu_torch.models.decoders.transformer import \
        TransformerDecoder
    from neuralmonkey_tpu_torch.models.encoders.transformer import \
        TransformerEncoder
    vocab = Vocabulary([f"w{i}" for i in range(296)])
    enc = TransformerEncoder(name="encoder", vocabulary=vocab,
                             data_id="source", embedding_size=64,
                             ff_hidden_size=128, depth=2, n_heads=2,
                             dropout_keep_prob=1.0)
    return TransformerDecoder(name="decoder", vocabulary=vocab,
                              data_id="target", max_output_len=max_out,
                              encoders=[enc], embedding_size=64,
                              ff_hidden_size=128, depth=2, n_heads_self=2,
                              n_heads_enc=2, label_smoothing=0.1,
                              dropout_keep_prob=1.0)


@pytest.fixture
def bf16_policy():
    from neuralmonkey_tpu_torch.ops import policy
    policy.set_compute_dtype("bfloat16")
    try:
        yield
    finally:
        policy.set_compute_dtype(None)


def test_bf16_transformer_step_on_card_matches_cpu(cuda_device, monkeypatch,
                                                   bf16_policy):
    """Under the bf16 policy with NM_FUSED_XENT=1: the loss and every
    gradient on the card against the CPU's (flash kernels, the bf16-W
    fused cross-entropy); the gradients of the bf16 use-site weights are
    rounded to bf16, so one bf16 ulp of the largest entry apart where a
    float32 sum sits on a rounding tie."""
    monkeypatch.setenv("NM_FUSED_XENT", "1")
    dec = _bf16_transformer()
    loss, grads, counts = _loss_and_grads(dec, dec.train_loss,
                                          _transformer_batch(), cuda_device)
    for name in ("flash_attention_fwd", "fused_xent_fwd_bf16w",
                 "fused_xent_bwd_dx_bf16w", "fused_xent_bwd_dw_bf16w"):
        assert counts[name] > 0, counts
    ref_loss, ref_grads, _ = _loss_and_grads(dec, dec.train_loss,
                                             _transformer_batch(),
                                             torch.device("cpu"))
    torch.testing.assert_close(loss, ref_loss, atol=1e-4, rtol=1e-4)
    for key, g in grads.items():
        assert g.dtype == torch.float32, key
        torch.testing.assert_close(
            g, ref_grads[key], rtol=0,
            atol=1e-5 + 2.0 ** -7 * float(ref_grads[key].abs().max()),
            msg=key)


@pytest.mark.parametrize("lineage_kernel", ["0", "1"])
def test_bf16_transformer_decodes_on_card_like_cpu(cuda_device, monkeypatch,
                                                   bf16_policy,
                                                   lineage_kernel):
    """Greedy and beam-4 ids under the bf16 policy: bf16 caches, the
    lineage attention's bf16 instance under NM_LINEAGE_KERNEL=1, K3 on
    the widened table and K4."""
    from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
        BeamSearchDecoder
    monkeypatch.setenv("NM_LINEAGE_KERNEL", lineage_kernel)
    dec = _bf16_transformer(max_out=8)
    search = BeamSearchDecoder(name="bs", parent_decoder=dec, beam_size=4,
                               selection_method="hierarchical")
    params = init_all_params(collect_parts([dec]), seed=5)
    batch = {k: v for k, v in _transformer_batch().items()
             if k.startswith("encoder")}

    def decode(device):
        ctx = Context(_to_device(params, device) if device.type == "cuda"
                      else params, {k: v.to(device) for k, v in batch.items()})
        with torch.inference_mode():
            return dec.decoded(ctx).cpu(), search.search(ctx).token_ids.cpu()
    kernel_config.reset_launch_counts()
    greedy, beam = decode(cuda_device)
    torch.cuda.synchronize()
    counts = kernel_config.launch_counts()
    expected = ["fused_logits_rowmax_lse", "small_topk"]
    if lineage_kernel == "1":
        expected.append("lineage_attention_bf16")
    for name in expected:
        assert counts[name] > 0, counts
    assert counts["lineage_attention"] == 0, counts
    ref_greedy, ref_beam = decode(torch.device("cpu"))
    assert torch.equal(greedy[:3], ref_greedy[:3])
    assert torch.equal(beam[:3], ref_beam[:3])
