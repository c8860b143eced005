#!/usr/bin/env python3
"""Smoke test of the PyTorch port (neuralmonkey_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA card of compute capability >= 9.0; prints its name and
   power limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from csrc/ with nvcc;
3. kernels: each hand-written kernel (K1 GRU scan, K2 Bahdanau step,
   K3 fused logits + selection reductions, K4 small top-k, the GRU BPTT
   and the three fused cross-entropy kernels) against its plain
   PyTorch version on the card, at the shapes the serving and training
   paths give it and at one ragged shape, with median times from CUDA
   events, the bound of the same work on this card and, where one
   PyTorch call computes the same function, that call's time;
4. slice: the flagship RNN model (bench.py widths: vocabulary 30000,
   embeddings 512, BiGRU 512, attention 512, conditional-GRU decoder)
   with random seeded weights decodes 128 synthetic sentences greedily
   and with beam 10 through ``neuralmonkey_tpu_torch.run``; every kernel
   must have been launched by that run;
5. parity: 8 of those sentences decoded on the CPU (plain versions) and
   on the card (kernels) give the same greedy ids, or first differ at a
   step where the CPU's top-two logit margin is below 1e-3; and each
   beam search picks the same candidates on both, or first picks
   differently at a step and slot where the CPU's gap to its next
   candidate is below 1e-3;
6. training: ``python -m neuralmonkey_tpu_torch.train`` trains the same
   model (batch 64, source 32, target 48, Adam, clip 1.0, keep-prob
   0.8) on synthetic pairs whose target is a fixed map of the source
   for one epoch of 20 steps, with one validation (greedy and beam 10)
   and one checkpoint, and ``run`` decodes from that checkpoint; twice,
   without and with ``NM_FUSED_XENT=1``. The loss must fall; K1, the
   BPTT and K2 must launch in both runs, the cross-entropy kernels in
   the second only;
7. training parity: from that checkpoint, dropout off, 8 sentences:
   the loss and every parameter gradient of one step on the card
   (kernels, with and without the fused cross-entropy) against the CPU
   (plain versions): loss to 1e-5 relative, each parameter's gradient
   to 1e-3 of its largest entry (float32 sums in another order through
   80 recurrent steps; TF32 off).

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
VOCAB, EMB, RNN, ATT = 30000, 512, 512, 512
BATCH, SRC_LEN, BEAM, MAX_OUT = 64, 32, 10, 48
N_SENTENCES, N_PARITY = 128, 8
MARGIN = 1e-3

SERVING_KERNELS = ("gru_scan", "fused_bahdanau_step",
                   "fused_logits_rowmax_lse", "small_topk")
TGT_LEN, N_TRAIN, N_VAL, KEEP_PROB = 48, 20 * BATCH, BATCH, 0.8
SOURCE_WORDS = 2000  # synthetic sources draw from the first 2000 words
XENT_N, XENT_D = BATCH * TGT_LEN, EMB
# the H100's published peaks (SXM, 700 W): float32 on the CUDA cores,
# and HBM3
F32_PEAK, HBM_RATE = 67e12, 3.35e12

KERNELS = {
    "gru_scan": ("neuralmonkey_tpu_torch/csrc/gru_scan.cu",
                 "neuralmonkey_tpu/ops/pallas_rnn.py:86"),
    "gru_bptt": ("neuralmonkey_tpu_torch/csrc/gru_bptt.cu",
                 "neuralmonkey_tpu/ops/pallas_rnn.py:130"),
    "fused_bahdanau_step": ("neuralmonkey_tpu_torch/csrc/bahdanau.cu",
                            "neuralmonkey_tpu/ops/pallas_attention.py:885"),
    "fused_logits_rowmax_lse": ("neuralmonkey_tpu_torch/csrc/beam_select.cu",
                                "neuralmonkey_tpu/ops/beam_select.py:216"),
    "small_topk": ("neuralmonkey_tpu_torch/csrc/beam_select.cu",
                   "neuralmonkey_tpu/ops/beam_select.py:102"),
    "fused_xent_fwd": ("neuralmonkey_tpu_torch/csrc/fused_xent.cu",
                       "neuralmonkey_tpu/ops/fused_xent.py:166"),
    "fused_xent_bwd_dx": ("neuralmonkey_tpu_torch/csrc/fused_xent.cu",
                          "neuralmonkey_tpu/ops/fused_xent.py:290"),
    "fused_xent_bwd_dw": ("neuralmonkey_tpu_torch/csrc/fused_xent.cu",
                          "neuralmonkey_tpu/ops/fused_xent.py:316"),
}


def import_everything() -> None:
    """Import every module the phases below import (the tests check
    that none of them reaches JAX or the JAX package)."""
    import torch  # noqa: F401

    from neuralmonkey_tpu_torch import experiment, run, train  # noqa: F401
    from neuralmonkey_tpu_torch.model import part  # noqa: F401
    from neuralmonkey_tpu_torch.models.decoders import \
        beam_search_decoder  # noqa: F401
    from neuralmonkey_tpu_torch.ops import (  # noqa: F401
        beam_select, cuda_attention, cuda_rnn, fused_xent, kernel_config,
        nn)
    from neuralmonkey_tpu_torch.utils import saving  # noqa: F401


def log(message: str) -> None:
    print(f"[chip_smoke] {message}", file=sys.stderr, flush=True)


def time_ms(fn, runs: int = 25) -> float:
    """Median milliseconds of ``fn`` on the card, from CUDA events."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bound(flops: float, nbytes: float):
    """(ms, what bounds it): the least time this card could take for
    ``flops`` float32 operations and ``nbytes`` bytes of memory traffic
    (each input read once, each output written once)."""
    ops_ms, bytes_ms = flops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


# ---------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------- #
def check_kernels(device):
    import torch

    from neuralmonkey_tpu_torch.ops import (beam_select, cuda_attention,
                                            cuda_rnn, nn)

    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    def lengths_mask(lengths, time):
        mask = torch.zeros(len(lengths), time)
        for i, n in enumerate(lengths):
            mask[i, :n] = 1.0
        return mask.to(device)

    results = {}

    def record(name, err, tol, shape, ms=None, plain_ms=None, work=None,
               library_ms=None):
        """Check ``err <= tol``; for the timed shape keep the times and
        the bound of ``work`` = (flops, bytes)."""
        log(f"{name} {shape}: max_abs_err {err:.3g} (tol {tol:g})"
            + ("" if ms is None else f", kernel {ms:.4f} ms, plain "
               f"{plain_ms:.4f} ms"))
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: error {err} > {tol}")
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if ms is not None:
            entry.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
            entry["bound_ms"], entry["bound_by"] = bound(*work)

    # K1: the encoder's BiGRU through the wrapper it calls (input
    # projection, weight stacking, direction encoding), against the same
    # call on CPU copies; error compounds over T
    def cpu(tree):
        return {k: v.cpu() for k, v in tree.items()}

    for batch, time_, width, hidden, lengths, timed in (
            (BATCH, SRC_LEN, EMB, RNN, [SRC_LEN] * BATCH, True),
            (5, 7, 24, 50, [7, 5, 3, 1, 6], False)):
        fw, bw = ({k: v.to(device) for k, v in
                   nn.GRUCell(width, hidden).init(gen).items()}
                  for _ in range(2))
        inputs = randn(batch, time_, width)
        mask = lengths_mask(lengths, time_)
        got = cuda_rnn.gru_scan([(fw, False), (bw, True)], inputs, mask)
        ref = cuda_rnn.gru_scan([(cpu(fw), False), (cpu(bw), True)],
                                inputs.cpu(), mask.cpu())
        err = max(max_err(got[0].cpu(), ref[0]),
                  max_err(got[1].cpu(), ref[1]))
        timing = ()
        if timed:
            wgh = torch.stack([fw["gates_h"], bw["gates_h"]])
            wch = torch.stack([fw["cand_h"], bw["cand_h"]])
            timing = (
                time_ms(lambda: cuda_rnn.gru_scan(
                    [(fw, False), (bw, True)], inputs, mask)),
                time_ms(lambda: cuda_rnn.gru_scan_reference(
                    cuda_rnn.hoisted_inputs([fw, bw], inputs), mask, wgh,
                    wch, [False, True])))
        # the wrapper's work: the hoisted input product and the scan
        work = (2 * batch * time_ * width * 6 * hidden
                + time_ * batch * 12 * hidden * hidden,
                4 * (batch * time_ * width + 2 * width * 3 * hidden
                     + 2 * 3 * hidden + 2 * 3 * hidden * hidden
                     + batch * time_ + batch * time_ * 2 * hidden
                     + batch * 2 * hidden))
        record("gru_scan", err, 1e-4, (batch, time_, hidden), *timing,
               work=work)

    # K2: greedy attention step; exact masked-softmax constants
    for batch, time_, lengths, timed in (
            (BATCH, SRC_LEN, [SRC_LEN] * BATCH, True),
            (5, 9, [9, 4, 1, 0, 7], False)):
        keys = randn(batch, time_, ATT)
        states = randn(batch, time_, 2 * RNN)
        mask = lengths_mask(lengths, time_)
        pq = randn(batch, ATT)
        v = randn(ATT, scale=ATT ** -0.5)
        got = cuda_attention.fused_bahdanau_step(keys, states, mask, pq, v)
        ref = cuda_attention.bahdanau_reference(keys, states, mask, pq, v)
        record("fused_bahdanau_step", max_err(got[1], ref[1]), 1e-5,
               (batch, time_, "weights"))
        timing = ((time_ms(lambda: cuda_attention.fused_bahdanau_step(
            keys, states, mask, pq, v)),
            time_ms(lambda: cuda_attention.bahdanau_reference(
                keys, states, mask, pq, v))) if timed else ())
        dim = 2 * RNN
        work = (batch * time_ * (4 * ATT + 2 * dim),
                4 * (batch * time_ * (ATT + dim + 2) + batch * ATT + ATT
                     + batch * dim))
        record("fused_bahdanau_step", max_err(got[0], ref[0]), 1e-4,
               (batch, time_, "context"), *timing, work=work)

    # K3: one beam step's logit projection, vocabulary padded as in the
    # search (multiple of 1024 columns, bias -1e9 on the pad)
    vp = -(-VOCAB // 1024) * 1024
    for n, d, v_real, vp_, timed in ((BATCH * BEAM, EMB, VOCAB, vp, True),
                                     (37, 100, 1000, 1024, False)):
        x = randn(n, d)
        w = randn(d, vp_, scale=d ** -0.5)
        b = torch.cat([torch.randn(v_real, generator=gen) * 0.1,
                       torch.full((vp_ - v_real,), -1e9)]).to(device)
        got = beam_select.fused_logits_rowmax_lse(x, w, b)
        ref = beam_select.fused_logits_reference(x, w, b)
        # compared where the vocabulary is real: at -1e9 the f32 spacing
        # is 64, and the pad only has to stay far below every real logit
        real_groups = -(-v_real // 128)
        for part, g, r in (("logits", got[0][:, :v_real],
                            ref[0][:, :v_real]),
                           ("rowmax", got[1][:, :real_groups],
                            ref[1][:, :real_groups])):
            scale = max(1.0, float(r.abs().max()))
            record("fused_logits_rowmax_lse", max_err(g, r) / scale, 1e-4,
                   (n, d, vp_, part))
        if not float(got[0][:, v_real:].max()) < -1e8:
            raise AssertionError("fused_logits_rowmax_lse: pad columns "
                                 "are not far below the real logits")
        timing = ((time_ms(lambda: beam_select.fused_logits_rowmax_lse(
            x, w, b)), time_ms(lambda: beam_select.fused_logits_reference(
                x, w, b))) if timed else ())
        work = (2 * n * d * vp_ + 3 * n * vp_,
                4 * (n * d + d * vp_ + vp_ + n * vp_ + n * vp_ // 128 + n))
        record("fused_logits_rowmax_lse", max_err(got[2], ref[2]), 1e-4,
               (n, d, vp_, "lse"), *timing, work=work)

    # K4: both selection stages; rounded inputs force ties, which must
    # go to the lowest index exactly as in the plain version
    for batch, n, k, timed in ((BATCH, BEAM * vp // 128, BEAM, True),
                               (BATCH, BEAM * 128, BEAM, False),
                               (5, 300, 7, False)):
        x = torch.round(randn(batch, n, scale=3.0))
        got = beam_select.small_topk(x, k)
        ref = beam_select.topk_reference(x, k)
        if not torch.equal(got[1], ref[1]) or not torch.equal(got[0],
                                                              ref[0]):
            raise AssertionError(f"small_topk {(batch, n, k)}: values or "
                                 "indices differ from the plain version")
        timing = ((time_ms(lambda: beam_select.small_topk(x, k)),
                   time_ms(lambda: beam_select.topk_reference(x, k)))
                  if timed else ())
        record("small_topk", 0.0, 0.0, (batch, n, k), *timing,
               work=(batch * n * k, 4 * batch * n + 8 * batch * k),
               library_ms=(time_ms(lambda: torch.topk(x, k, dim=1))
                           if timed else None))

    check_train_kernels(device, randn, lengths_mask, record)
    torch.cuda.synchronize()
    return results


def check_train_kernels(device, randn, lengths_mask, record):
    """The training path's kernels against their plain versions."""
    import torch

    from neuralmonkey_tpu_torch.ops import cuda_rnn, fused_xent

    # BPTT: the encoder's BiGRU at bench widths, and a ragged odd shape;
    # the gradients grow through the reverse steps, so the error is
    # held against the largest of them
    for batch, time_, hidden, lengths, timed in (
            (BATCH, SRC_LEN, RNN, [SRC_LEN] * BATCH, True),
            (5, 7, 37, [7, 5, 3, 1, 0], False)):
        x = randn(batch, time_, 6 * hidden, scale=0.5)
        mask = lengths_mask(lengths, time_)
        hprev = randn(batch, time_, 2 * hidden, scale=0.5)
        gout = randn(batch, time_, 2 * hidden)
        gfinal = randn(batch, 2 * hidden)
        wgh = randn(2, hidden, 2 * hidden, scale=hidden ** -0.5)
        wch = randn(2, hidden, hidden, scale=hidden ** -0.5)
        args = (x, mask, hprev, gout, gfinal, wgh, wch)
        got = cuda_rnn.gru_bptt(*args, 2)
        ref = cuda_rnn.gru_bptt_reference(*args, [False, True])
        scale = max(1.0, float(ref.abs().max()))
        timing = ((time_ms(lambda: cuda_rnn.gru_bptt(*args, 2)),
                   time_ms(lambda: cuda_rnn.gru_bptt_reference(
                       *args, [False, True]))) if timed else ())
        work = (2 * batch * time_ * (12 * hidden * hidden + 20 * hidden),
                4 * (2 * batch * time_ * 6 * hidden + batch * time_
                     + 2 * batch * time_ * 2 * hidden + batch * 2 * hidden
                     + 2 * 3 * hidden * hidden))
        record("gru_bptt", max_err(got, ref) / scale, 1e-4,
               (batch, time_, hidden), *timing, work=work)

    # fused cross-entropy: the decoder's loss tail at bench widths (one
    # batch of 64 x 48 target tokens), both layouts and both label
    # smoothings, and a ragged shape; timed in the layout and smoothing
    # the training phase uses, (D, V) and eps 0
    gen = torch.Generator().manual_seed(SEED + 1)
    for n, d, v in ((XENT_N, XENT_D, VOCAB), (333, 130, 1000)):
        for transposed in (False, True):
            for eps in (0.0, 0.1):
                timed = (n, transposed, eps) == (XENT_N, False, 0.0)
                x = randn(n, d, scale=0.5)
                w = randn(*((v, d) if transposed else (d, v)),
                          scale=d ** -0.5)
                b = randn(v, scale=0.1)
                targets = torch.randint(0, v, (n,), generator=gen,
                                        dtype=torch.int32).to(device)
                g = torch.rand(n, generator=gen).to(device)
                case = (n, d, v, "tied" if transposed else "plain", eps)
                nll, lse = fused_xent.xent_fwd(x, w, b, targets, eps,
                                               transposed)
                ref_nll, _ = fused_xent.fwd_reference(x, w, b, targets, eps,
                                                      transposed)
                fwd_args = (x, w, b, targets, eps, transposed)
                timing = ((time_ms(lambda: fused_xent.xent_fwd(*fwd_args)),
                           time_ms(lambda: fused_xent.fwd_reference(
                               *fwd_args))) if timed else ())
                read = 4 * (n * d + d * v + v + n)
                record("fused_xent_fwd", max_err(nll, ref_nll) / max(
                    1.0, float(ref_nll.abs().max())), 1e-5, case, *timing,
                    work=(2 * n * d * v + 5 * n * v, read + 8 * n))
                bwd_args = (x, w, b, targets, lse, g, eps, transposed)
                dx = fused_xent.xent_bwd_dx(*bwd_args)
                ref_dx = fused_xent.bwd_dx_reference(*bwd_args)
                timing = ((time_ms(lambda: fused_xent.xent_bwd_dx(
                    *bwd_args)), time_ms(lambda: fused_xent.bwd_dx_reference(
                        *bwd_args))) if timed else ())
                record("fused_xent_bwd_dx", max_err(dx, ref_dx) / max(
                    1e-6, float(ref_dx.abs().max())), 1e-4, case, *timing,
                    work=(4 * n * d * v + 6 * n * v,
                          read + 8 * n + 4 * n * d))
                dw, db = fused_xent.xent_bwd_dw(*bwd_args)
                ref_dw, ref_db = fused_xent.bwd_dw_reference(*bwd_args)
                timing = ((time_ms(lambda: fused_xent.xent_bwd_dw(
                    *bwd_args)), time_ms(lambda: fused_xent.bwd_dw_reference(
                        *bwd_args))) if timed else ())
                err = max(max_err(dw, ref_dw) / max(
                    1e-6, float(ref_dw.abs().max())),
                    max_err(db, ref_db) / max(
                        1e-6, float(ref_db.abs().max())))
                record("fused_xent_bwd_dw", err, 1e-4, case, *timing,
                       work=(4 * n * d * v + 6 * n * v,
                             read + 8 * n + 4 * (d * v + v)))


# ---------------------------------------------------------------------- #
# phase 4: the full-width slice through the run CLI
# ---------------------------------------------------------------------- #
EXPERIMENT_INI = """\
[main]
name="chip smoke"
tf_manager=<tf_manager>
output="{tmp}/output"
batch_size={batch}
runners=[<runner>, <bs_runner>]
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/words.txt"

[encoder]
class=encoders.recurrent.SentenceEncoder
name="sentence_encoder"
rnn_size={rnn}
max_input_len={src_len}
embedding_size={emb}
data_id="source"
vocabulary=<vocabulary>

[attention]
class=attention.feed_forward.Attention
name="attention"
encoder=<encoder>
state_size={att}

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size={rnn}
embedding_size={emb}
conditional_gru=True
data_id="target"
max_output_len={max_out}
vocabulary=<vocabulary>

[bs_decoder]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="bs_decoder"
parent_decoder=<decoder>
beam_size={beam}
length_normalization=0.6

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="target"

[bs_runner]
class=runners.beam_search_runner.BeamSearchRunner
decoder=<bs_decoder>
output_series="target_beam"
"""

DATA_INI = """\
[main]
test_datasets=[<test_data>]

[test_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/source.txt"
s_target_out="{tmp}/greedy.txt"
s_target_beam_out="{tmp}/beam.txt"
"""


def write_inputs(tmp: str):
    import numpy as np
    words = [f"w{i}" for i in range(VOCAB - 4)]
    with open(os.path.join(tmp, "words.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    rng = np.random.RandomState(SEED)
    with open(os.path.join(tmp, "source.txt"), "w") as f:
        for _ in range(N_SENTENCES):
            f.write(" ".join(words[i] for i in rng.randint(
                0, len(words), SRC_LEN)) + "\n")
    exp_ini = os.path.join(tmp, "exp.ini")
    with open(exp_ini, "w") as f:
        f.write(EXPERIMENT_INI.format(
            tmp=tmp, batch=BATCH, seed=SEED, rnn=RNN, src_len=SRC_LEN,
            emb=EMB, att=ATT, max_out=MAX_OUT, beam=BEAM))
    data_ini = os.path.join(tmp, "data.ini")
    with open(data_ini, "w") as f:
        f.write(DATA_INI.format(tmp=tmp))
    return exp_ini, data_ini


def run_slice(tmp: str):
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.ops import kernel_config

    exp_ini, data_ini = write_inputs(tmp)
    exp = Experiment(exp_ini)
    exp.build_model()
    ckpt = exp.tf_manager.save(os.path.join(tmp, "params"))

    kernel_config.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    if run.main([exp_ini, data_ini, ckpt]) != 0:
        raise AssertionError("neuralmonkey_tpu_torch.run failed")
    torch.cuda.synchronize()
    run_seconds = time.perf_counter() - start
    launches = kernel_config.launch_counts()
    log(f"run CLI: {run_seconds:.2f} s, launches {launches}")
    missing = [k for k in SERVING_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the run: "
                             f"{missing}")
    lengths = {}
    for name in ("greedy.txt", "beam.txt"):
        with open(os.path.join(tmp, name)) as f:
            lines = f.read().splitlines()
        if len(lines) != N_SENTENCES:
            raise AssertionError(f"{name}: {len(lines)} lines, expected "
                                 f"{N_SENTENCES}")
        lengths[name] = statistics.mean(len(x.split()) for x in lines)

    # throughput per runner on the same model, steady state
    exp.tf_manager.restore(ckpt)
    dataset = run.load_data_config(data_ini)[0]
    speed = {}
    for runner in exp.model.runners:
        exp.tf_manager.execute(dataset, [runner], BATCH)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        exp.tf_manager.execute(dataset, [runner], BATCH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        speed[runner.output_series] = {
            "sentences_per_s": N_SENTENCES / seconds,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    log(f"slice: mean output tokens {lengths}, {speed}")
    return launches, lengths, speed, exp, ckpt, data_ini


# ---------------------------------------------------------------------- #
# phase 5: CPU (plain versions) against the card (kernels)
# ---------------------------------------------------------------------- #
def check_parity(tmp: str, data_ini: str, gpu_exp, ckpt: str):
    import torch

    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.model.part import Context
    from neuralmonkey_tpu_torch.models.decoders import beam_search_decoder

    dataset = run.load_data_config(data_ini)[0].subset(0, N_PARITY)
    cpu_exp = Experiment(os.path.join(tmp, "exp.ini"),
                         config_changes=['tf_manager.device="cpu"'])
    cpu_exp.build_model()
    cpu_exp.tf_manager.restore(ckpt)

    # per step, on the CPU: greedy's top-two logit gap per row, and the
    # beam's gaps between neighbours among the top K+1 exact candidate
    # scores, (rows, K); on both devices: the beam's (parent, token)
    # picks, (rows, K, 2)
    greedy_margins, beam_gaps = [], []
    picks = {"cpu": [], "gpu": []}
    decoder = cpu_exp.model.runners[0].decoder
    plain_step = decoder.decode_step

    def recording_step(constants, state, prev_ids, step):
        out = plain_step(constants, state, prev_ids, step)
        top2 = out[1].topk(2, dim=-1).values
        greedy_margins.append(top2[:, 0] - top2[:, 1])
        return out

    plain_topk = beam_search_decoder.small_topk

    def recording_topk(x, k):
        if x.shape[1] == k * beam_search_decoder.LANE:  # stage 2
            top = torch.sort(x, dim=1, descending=True).values[:, :k + 1]
            beam_gaps.append(top[:, :-1] - top[:, 1:])
        return plain_topk(x, k)

    def record_picks(exp, log):
        search = exp.model.runners[1].decoder
        plain_select = search._select_hier

        def select(x, state, batch, precomputed=None):
            out = plain_select(x, state, batch, precomputed=precomputed)
            log.append(torch.stack(out[:2], dim=-1).cpu())
            return out
        search._select_hier = select

    def decode(exp):
        # three padding rows (all-zero masks) ride along, as in the last
        # batch of a dataset
        batch, _ = exp.tf_manager.build_batch(dataset, N_PARITY + 3)
        greedy_runner, beam_runner = exp.model.runners
        with torch.inference_mode():
            ctx = Context(exp.tf_manager.params, batch)
            greedy = greedy_runner.fetches(ctx)["decoded"]
            beam = beam_runner.fetches(ctx)["token_ids"][:, 0]
        return greedy[:N_PARITY].cpu(), beam[:N_PARITY].cpu()

    decoder.decode_step = recording_step
    beam_search_decoder.small_topk = recording_topk
    record_picks(cpu_exp, picks["cpu"])
    record_picks(gpu_exp, picks["gpu"])
    try:
        cpu_greedy, cpu_beam = decode(cpu_exp)
        gpu_greedy, gpu_beam = decode(gpu_exp)
    finally:
        beam_search_decoder.small_topk = plain_topk
        del decoder.decode_step
        for exp in (cpu_exp, gpu_exp):
            del exp.model.runners[1].decoder._select_hier

    report = {}
    same = 0
    for row in range(N_PARITY):
        diff = (cpu_greedy[row] != gpu_greedy[row]).nonzero()
        if len(diff) == 0:
            same += 1
            continue
        # greedy diverges exactly where its ids do
        step = int(diff[0])
        margin = float(greedy_margins[step][row])
        log(f"parity greedy: sentence {row} first differs at step {step}; "
            f"CPU top-two margin {margin:.3g}")
        if not margin < MARGIN:
            raise AssertionError(
                f"greedy ids of sentence {row} differ at step {step}, "
                f"where the CPU's top-two margin is {margin} >= {MARGIN}")
    report["greedy"] = f"{same}/{N_PARITY} identical"

    # a beam search diverges at the first step where the two devices
    # pick a different (parent, token) in some slot j; that must be a
    # near-tie on the CPU between its candidates j and j + 1
    def first_divergence(row):
        for step, (c, g) in enumerate(zip(picks["cpu"], picks["gpu"])):
            slots = (c[row] != g[row]).any(-1).nonzero()
            if len(slots):
                return step, int(slots[0, 0])
        return None

    same = diverged = 0
    for row in range(N_PARITY):
        first = first_divergence(row)
        ids_same = torch.equal(cpu_beam[row], gpu_beam[row])
        same += ids_same
        if first is None:
            if not ids_same:
                raise AssertionError(
                    f"beam ids of sentence {row} differ though every "
                    "step picked the same candidates")
            continue
        diverged += 1
        step, slot = first
        gap = float(beam_gaps[step][row, slot])
        log(f"parity beam: sentence {row}: the searches first pick "
            f"differently at step {step}, slot {slot}; CPU gap to the "
            f"next candidate {gap:.3g}; best ids "
            f"{'identical' if ids_same else 'differ'}")
        if not gap < MARGIN:
            raise AssertionError(
                f"beam search of sentence {row} diverges at step {step}, "
                f"slot {slot}, where the CPU's gap is {gap} >= {MARGIN}")
    report["beam"] = (f"{same}/{N_PARITY} identical, {diverged} searches "
                      "diverged at a near-tie")
    log(f"parity: {report}")
    return report


# ---------------------------------------------------------------------- #
# phase 6: training through the train CLI
# ---------------------------------------------------------------------- #
TRAIN_INI = """\
[main]
name="chip smoke training"
tf_manager=<tf_manager>
output="{out}"
overwrite_output_dir=True
batch_size={batch}
epochs=1
train_dataset=<train_data>
val_dataset=<val_data>
trainer=<trainer>
runners=[<runner>, <bs_runner>]
evaluation=[("target", evaluators.bleu.BLEU)]
logging_period=5
validation_period=1000
random_seed={seed}

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1

[vocabulary]
class=vocabulary.from_wordlist
path="{tmp}/words.txt"

[train_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/train.src"
s_target="{tmp}/train.tgt"
lazy=False

[val_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/val.src"
s_target="{tmp}/val.tgt"

[encoder]
class=encoders.recurrent.SentenceEncoder
name="sentence_encoder"
rnn_size={rnn}
max_input_len={src_len}
embedding_size={emb}
dropout_keep_prob={keep}
data_id="source"
vocabulary=<vocabulary>

[attention]
class=attention.feed_forward.Attention
name="attention"
encoder=<encoder>
state_size={att}
dropout_keep_prob={keep}

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size={rnn}
embedding_size={emb}
maxout_size={emb}
conditional_gru=True
dropout_keep_prob={keep}
data_id="target"
max_output_len={tgt_len}
vocabulary=<vocabulary>

[bs_decoder]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="bs_decoder"
parent_decoder=<decoder>
beam_size={beam}
length_normalization=0.6

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>]
clip_norm=1.0
optimizer=<adam>

[adam]
class=tf.train.AdamOptimizer
learning_rate=0.001

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="target"

[bs_runner]
class=runners.beam_search_runner.BeamSearchRunner
decoder=<bs_decoder>
output_series="target_beam"
"""

TRAIN_DATA_INI = """\
[main]
test_datasets=[<test_data>]

[test_data]
class=dataset.load_dataset_from_files
s_source="{tmp}/val.src"
s_target_out="{out}/greedy.txt"
s_target_beam_out="{out}/beam.txt"
"""


def write_training_inputs(tmp: str) -> str:
    """Synthetic pairs (the words of ``write_inputs``): a source of 32
    words from the first 2000, and as its target the source and its
    first 15 words again, each through a fixed map onto the whole
    vocabulary, so 47 words and </s> fill the 48 decoder steps."""
    import numpy as np
    n_words = VOCAB - 4
    rng = np.random.RandomState(SEED + 2)
    for split, count in (("train", N_TRAIN), ("val", N_VAL)):
        src = rng.randint(0, SOURCE_WORDS, (count, SRC_LEN))
        tgt = (np.concatenate([src, src[:, :TGT_LEN - SRC_LEN - 1]], axis=1)
               * 7919 + 13) % n_words
        for name, ids in (("src", src), ("tgt", tgt)):
            with open(os.path.join(tmp, f"{split}.{name}"), "w") as f:
                f.writelines(" ".join(f"w{i}" for i in row) + "\n"
                             for row in ids)
    path = os.path.join(tmp, "train.ini")
    with open(path, "w") as f:
        f.write(TRAIN_INI.format(
            tmp=tmp, out=os.path.join(tmp, "train_out"), batch=BATCH,
            seed=SEED, rnn=RNN, src_len=SRC_LEN, emb=EMB, att=ATT,
            tgt_len=TGT_LEN, beam=BEAM, keep=KEEP_PROB))
    return path


def run_training(tmp: str, train_ini: str, fused: bool):
    """One epoch through the train CLI, then ``run`` from its best
    checkpoint; returns the launch counts of the training run, its
    record and the checkpoint."""
    import torch

    from neuralmonkey_tpu_torch import run, train
    from neuralmonkey_tpu_torch.ops import kernel_config

    out = os.path.join(tmp, "train_fused" if fused else "train_plain")
    if fused:
        os.environ["NM_FUSED_XENT"] = "1"
    try:
        kernel_config.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        if train.main([train_ini, f'main.output="{out}"']) != 0:
            raise AssertionError("neuralmonkey_tpu_torch.train failed")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = kernel_config.launch_counts()
    finally:
        os.environ.pop("NM_FUSED_XENT", None)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    windows = [r for r in records if r["kind"] == "train"]
    losses = [r["loss"] for r in windows]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    expected = ("gru_scan", "gru_bptt", "fused_bahdanau_step")
    xent = ("fused_xent_fwd", "fused_xent_bwd_dx", "fused_xent_bwd_dw")
    missing = [k for k in expected if launches[k] == 0]
    wrong = [k for k in xent if (launches[k] > 0) != fused]
    if missing or wrong:
        raise AssertionError(f"training launches {launches}: never "
                             f"launched {missing}, cross-entropy kernels "
                             f"wrong for fused={fused}: {wrong}")
    best = os.path.join(out, "variables.data.best")
    data_ini = os.path.join(tmp, "train_data.ini")
    with open(data_ini, "w") as f:
        f.write(TRAIN_DATA_INI.format(tmp=tmp, out=out))
    if run.main([train_ini, data_ini, best]) != 0:
        raise AssertionError("neuralmonkey_tpu_torch.run failed")
    for name in ("greedy.txt", "beam.txt"):
        with open(os.path.join(out, name)) as f:
            if len(f.read().splitlines()) != N_VAL:
                raise AssertionError(f"run from {best}: {name} is short")
    # tokens/s of the logging windows after the first (the first holds
    # the warm-up)
    rates = [r["tokens_per_sec"] for r in windows]
    record = {"fused_xent": fused, "steps": windows[-1]["step"],
              "seconds": seconds, "losses": losses,
              "tokens_per_sec_windows": rates,
              "train_tokens_per_sec": statistics.mean(rates[1:]),
              "val": {k: v for r in records if r["kind"] == "val"
                      for k, v in r.items() if k not in ("kind", "time")},
              "launches": launches}
    log(f"training (fused xent {fused}): {record}")
    return launches, record, best


# ---------------------------------------------------------------------- #
# phase 7: one training step on the card against the CPU
# ---------------------------------------------------------------------- #
def check_train_parity(train_ini: str, ckpt: str):
    """Loss and every parameter gradient of one step, dropout off, from
    ``ckpt`` on 8 sentences: card (kernels) against CPU (plain)."""
    import torch

    from neuralmonkey_tpu_torch.dataset import BatchingScheme
    from neuralmonkey_tpu_torch.experiment import Experiment
    from neuralmonkey_tpu_torch.utils.saving import flatten_tree

    changes = [f"{part}.dropout_keep_prob=1.0"
               for part in ("encoder", "attention", "decoder")]

    def loss_and_grads(device_change, fused):
        exp = Experiment(train_ini, train_mode=True,
                         config_changes=changes + device_change)
        exp.build_model()
        manager = exp.tf_manager
        manager.restore(ckpt)
        dataset = next(exp.model.train_dataset.batches(
            BatchingScheme(batch_size=N_PARITY), shuffled=False))
        batch, _ = manager.build_batch(dataset, N_PARITY, train=True)
        flat = flatten_tree(manager.params)
        for p in flat.values():
            p.requires_grad_(True)
        if fused:
            os.environ["NM_FUSED_XENT"] = "1"
        try:
            total, _ = exp.model.trainer.total_loss(manager.params, batch,
                                                    rng=0)
            total.backward()
        finally:
            os.environ.pop("NM_FUSED_XENT", None)
        return (total.item(), {k: p.grad.detach().cpu()
                               for k, p in flat.items()})

    ref_loss, ref_grads = loss_and_grads(['tf_manager.device="cpu"'], False)
    report = {}
    for fused in (False, True):
        loss, grads = loss_and_grads([], fused)
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        worst_key, worst = max(
            ((k, max_err(g, ref_grads[k])
              / max(float(ref_grads[k].abs().max()), 1e-30))
             for k, g in grads.items()), key=lambda kv: kv[1])
        log(f"training parity (fused xent {fused}): loss {loss:.6f} vs "
            f"CPU {ref_loss:.6f} (relative {loss_err:.3g}); largest "
            f"gradient deviation {worst:.3g} of the largest entry, at "
            f"{worst_key}")
        if not (loss_err <= 1e-5 and worst <= 1e-3):
            raise AssertionError(
                f"training step on the card differs from the CPU: loss "
                f"{loss_err}, gradient {worst} at {worst_key}")
        report["fused" if fused else "plain"] = {
            "loss": loss, "cpu_loss": ref_loss, "loss_rel_err": loss_err,
            "grad_rel_err": worst, "grad_rel_err_at": worst_key}
    return report


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "neuralmonkey_tpu_torch")):
        log("neuralmonkey_tpu_torch not found beside chip_smoke.py: run "
            "it from the root of a checkout of the repository")
        return 1
    try:
        import torch
    except ImportError:
        log("PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke test needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    capability = torch.cuda.get_device_capability(device)
    if capability < (9, 0):
        log(f"compute capability {capability}; the kernels need >= 9.0")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"capability {capability}")

    from neuralmonkey_tpu_torch.ops import kernel_config
    start = time.perf_counter()
    kernel_config.library()
    log(f"build: {time.perf_counter() - start:.1f} s "
        f"({kernel_config.library_path()})")

    kernels = check_kernels(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches, lengths, speed, gpu_exp, ckpt, data_ini = run_slice(tmp)
        parity = check_parity(tmp, data_ini, gpu_exp, ckpt)
        del gpu_exp
        train_ini = write_training_inputs(tmp)
        training = []
        for fused in (False, True):
            train_launches, record, best = run_training(tmp, train_ini,
                                                        fused)
            training.append(record)
            launches = {k: n + train_launches[k]
                        for k, n in launches.items()}
            if not fused:
                train_parity = check_train_parity(train_ini, best)

    print(smi)
    print(json.dumps({
        "device": smi,
        "slice": {"sentences": N_SENTENCES, "batch": BATCH, "beam": BEAM,
                  "mean_output_tokens": lengths, "speed": speed,
                  "parity": parity},
        "training": {"batch": BATCH, "source": SRC_LEN, "target": TGT_LEN,
                     "runs": training, "parity": train_parity},
    }))
    # launches: the run CLI's serving pass plus both training runs
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name],
         **{key: kernels[name][key] for key in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
