#!/usr/bin/env python3
"""Where a redesigned kernel's time goes: device times of variants of its
source, each a text edit that removes or swaps one part, beside the
source itself, in turns on one card (GPU):

    python3 scripts/kernel_ablation.py [--turns 2]

K1 (``csrc/gru_scan.cu``) at the GRU encoder's B 64, T 32, H 512, two
directions, full sources, launched with the wrapper's plan: without the
barriers, with the barrier of the other persistent kernels
(``direction_barrier``), with the two directions' barrier counters in
neighbouring words, without the products' multiply-adds, without
the staging's reads from L2 (the copies zero-fill), and with each
thread's four rows of a product adjacent instead of strided. K3
(``csrc/beam_select.cu``) at 640 x 512 x 30720: one block an SM instead
of two (launch bounds), and without the logits store.
``fused_xent_fwd`` (``csrc/fused_xent.cu``) at N 3072, D 512, V 30000,
(D, V), eps 0: one block an SM instead of two. K2
(``csrc/bahdanau.cu``) at B 64, T 32, A 512, D 1024, full sources: by
its plan alone, one block a row (clusters of 1) instead of the plan's
clusters, the states read from device memory after the softmax instead
of loaded into registers first, and the energies' operands read in
place instead of staged; by edits, the launch alone (every block
returns at once; under each plan, and without the cluster attribute),
tanh from the fast exp and reciprocal instead of CUDA's tanhf, without the
energies' products, and without the context pass; each
also with the L2 cache flushed before each call
(``chip_smoke.flushed_ms``). A variant that
removes a part computes wrong values; only its time is read. Each
variant is compiled by nvcc into its own library under
``build/kernel_ablation/`` and launched through the kernel's C entry
point on the inputs of the source's own launch. Prints one JSON line
with the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "kernel_ablation")

K1_VARIANTS = {
    "source": [],
    "no barriers": [("nm::counting_barrier(sync + kSyncStride * dir, NB);",
                     "__syncthreads();")],
    "direction_barrier": [
        ("nm::counting_barrier(sync + kSyncStride * dir, NB);",
         "nm::direction_barrier(sync + kSyncStride * dir, NB);")],
    "neighbouring counters": [("kSyncStride = 32;", "kSyncStride = 1;")],
    "no products": [("for (int k = ka; k < kb; k += 4) {",
                     "for (int k = ka; k < ka; k += 4) {")],
    "no staging reads": [("zero ? 0 : 16);", "0);")],
    "adjacent rows": [
        ("G = (nr + 3) / 4;", "G = 1;"),
        ("const int tasks = groups * G;",
         "const int tasks = groups * ((nr + 3) / 4);"),
        ("min(rg + G * r, nr - 1)", "min(4 * rg + r, nr - 1)"),
        ("if (rg + G * r >= nr) break;", "if (4 * rg + r >= nr) break;"),
        ("(ks * R + rg + G * r)", "(ks * R + 4 * rg + r)")],
}
XENT_FWD_VARIANTS = {
    "source": [],
    "one block an SM": [("__launch_bounds__(tc::kThreads, 2)\nxent_fwd_kernel",
                         "__launch_bounds__(tc::kThreads, 1)\nxent_fwd_kernel")],
}
K2_VARIANTS = {
    "source": [],
    "launch only": [("  const int A4 = round4(A);\n",
                     "  if (T > 0) return;\n  const int A4 = round4(A);\n")],
    "launch only, no cluster attribute": [
        ("  const int A4 = round4(A);\n",
         "  if (T > 0) return;\n  const int A4 = round4(A);\n"),
        ("config.numAttrs = 1;", "config.numAttrs = 0;")],
    # tanh(x) = 1 - 2 / (exp(2x) + 1) from the fast exp and reciprocal
    "exp-based tanh": [(
        '#include "common.cuh"\n',
        '#include "common.cuh"\n#define tanhf(x) (1.f - __fdividef(2.f, '
        '__expf(2.f * fminf(fmaxf((x), -15.f), 15.f)) + 1.f))\n')],
    "no energy products": [("for (int a = 4 * lane; a < A; a += 128) {",
                            "for (int a = 4 * lane; a < 0; a += 128) {")],
    "no context": [("  if (nc > 0) {\n    float* out",
                    "  if (nc < 0) {\n    float* out")],
}
K3_VARIANTS = {
    "source": [],
    "one block an SM": [("__launch_bounds__(tc::kThreads, 2)",
                         "__launch_bounds__(tc::kThreads, 1)")],
    "no logits store": [("if (gm < N) {\n        float* out = logits",
                         "if (gm < 0) {\n        float* out = logits")],
}


def build(kernel_config, source, variants):
    """One library per variant of ``source``, all compiled at once."""
    os.makedirs(OUT, exist_ok=True)
    csrc = kernel_config.CSRC_DIR
    text = open(os.path.join(csrc, source)).read()
    jobs = {}
    for name, edits in variants.items():
        edited = text
        for old, new in edits:
            if edited.count(old) < 1:
                raise ValueError(f"{source} {name}: no '{old}'")
            edited = edited.replace(old, new)
        tag = f"{source[:-3]}_" + "".join(
            c if c.isalnum() else "_" for c in name)
        path = os.path.join(OUT, f"{tag}.cu")
        with open(path, "w") as f:
            f.write(edited)
        jobs[name] = ([kernel_config._nvcc(), *kernel_config.NVCC_FLAGS,
                       "-I", csrc, "-shared", "-o",
                       os.path.join(OUT, f"lib{tag}.so"), path],
                      os.path.join(OUT, f"lib{tag}.so"))
    kernel_config._run_nvcc([cmd for cmd, _ in jobs.values()])
    libs = {}
    for name, (_, lib) in jobs.items():
        libs[name] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--turns", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
    from neuralmonkey_tpu_torch.ops import (cuda_attention, cuda_rnn,
                                            kernel_config)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    def entry(lib, name):
        fn = getattr(lib, name)
        fn.argtypes = kernel_config._ARGTYPES[name]
        fn.restype = ctypes.c_int
        return fn

    def stream():
        return torch.cuda.current_stream().cuda_stream

    result = {}
    # K1
    batch, time_, hidden = cs.BATCH, cs.SRC_LEN, cs.RNN
    x = randn(batch, time_, 2 * 3 * hidden, scale=0.5)
    mask = torch.ones(batch, time_, device=device)
    wgh = randn(2, hidden, 2 * hidden, scale=hidden ** -0.5)
    wch = randn(2, hidden, hidden, scale=hidden ** -0.5)
    plan = cuda_rnn.gru_scan_plan(batch, hidden, 2,
                                  *kernel_config.device_limits(0))
    out = x.new_empty(batch, time_, 2 * hidden)
    final = x.new_empty(batch, 2 * hidden)
    scratch = x.new_empty(3, 2, batch, hidden)
    libs = build(kernel_config, "gru_scan.cu", K1_VARIANTS)
    # barrier words of each variant's own: the two barriers leave them in
    # different states
    syncs = {name: torch.zeros(2, 32, dtype=torch.int32, device=device)
             for name in libs}

    def k1(name):
        status = entry(libs[name], "nm_gru_scan")(
            x.data_ptr(), mask.data_ptr(), wgh.data_ptr(), wch.data_ptr(),
            out.data_ptr(), final.data_ptr(), None, scratch.data_ptr(),
            syncs[name].data_ptr(), batch, time_, hidden, 2, 2,
            plan.blocks_per_dir, plan.units, plan.rows, plan.k_tile,
            plan.k_split, plan.smem_bytes, stream())
        if status:
            raise RuntimeError(f"gru_scan {name}: CUDA error {status}")
    ref = cuda_rnn.gru_scan_reference(x, mask, wgh, wch, (False, True))
    k1("source")
    torch.cuda.synchronize()
    result["gru_scan"] = {"source_max_abs_err": float(
        (out - ref[0]).abs().max()), "plan": plan._asdict()}
    for _ in range(args.turns):
        for name in libs:
            result["gru_scan"].setdefault(name, []).append(
                cs.time_ms(lambda: k1(name)))
    # K3
    n, d, vp = cs.BATCH * cs.BEAM, cs.EMB, -(-cs.VOCAB // 1024) * 1024
    xk, wk = randn(n, d), randn(d, vp, scale=d ** -0.5)
    bk = randn(vp, scale=0.1)
    logits, lse = xk.new_empty(n, vp), xk.new_empty(n)
    rowmax, psum = xk.new_empty(n, vp // 128), xk.new_empty(n, vp // 128)
    libs = build(kernel_config, "beam_select.cu", K3_VARIANTS)

    def k3(name):
        status = entry(libs[name], "nm_fused_logits")(
            xk.data_ptr(), wk.data_ptr(), bk.data_ptr(), logits.data_ptr(),
            rowmax.data_ptr(), psum.data_ptr(), lse.data_ptr(), n, d, vp,
            stream())
        if status:
            raise RuntimeError(f"fused_logits {name}: CUDA error {status}")
    result["fused_logits_rowmax_lse"] = {}
    for _ in range(args.turns):
        for name in libs:
            result["fused_logits_rowmax_lse"].setdefault(name, []).append(
                cs.time_ms(lambda: k3(name)))
    # fused_xent_fwd
    n, d, v = cs.XENT_N, cs.XENT_D, cs.VOCAB
    xf, wf = randn(n, d, scale=0.5), randn(d, v, scale=d ** -0.5)
    bf = randn(v, scale=0.1)
    targets = torch.randint(0, v, (n,), generator=gen,
                            dtype=torch.int32).to(device)
    partials = xf.new_empty(4, n, -(-v // 128))
    lse, nll = xf.new_empty(n), xf.new_empty(n)
    libs = build(kernel_config, "fused_xent.cu", XENT_FWD_VARIANTS)

    def xent_fwd(name):
        status = entry(libs[name], "nm_xent_fwd")(
            xf.data_ptr(), wf.data_ptr(), bf.data_ptr(), targets.data_ptr(),
            *(p.data_ptr() for p in partials), lse.data_ptr(), nll.data_ptr(),
            n, d, v, 0, 0.0, stream())
        if status:
            raise RuntimeError(f"xent_fwd {name}: CUDA error {status}")
    result["fused_xent_fwd"] = {}
    for _ in range(args.turns):
        for name in libs:
            result["fused_xent_fwd"].setdefault(name, []).append(
                cs.time_ms(lambda: xent_fwd(name)))
    # K2: plans of the source's own library
    att, dim = cs.ATT, 2 * cs.RNN
    keys, states = randn(batch, time_, att), randn(batch, time_, dim)
    pq, sim_v = randn(batch, att), randn(att, scale=att ** -0.5)
    ctx, weights = keys.new_empty(batch, dim), keys.new_empty(batch, time_)
    sms, smem = kernel_config.device_limits(0)
    plan = cuda_attention.bahdanau_plan(batch, time_, att, dim, sms, smem)
    plans = {
        "source": plan,
        # sm_count = B: one block a row fills it
        "clusters of 1": cuda_attention.bahdanau_plan(batch, time_, att, dim,
                                                      batch, smem),
        "states not prefetched": plan._replace(resident=False),
        "operands not staged": plan._replace(
            staged=False, smem_bytes=cuda_attention._bahdanau_smem(
                time_, att, plan.positions, False))}
    libs = build(kernel_config, "bahdanau.cu", K2_VARIANTS)
    # the source's library under the plans above, each variant's under
    # the source's plan
    runs = {name: (libs["source"], p) for name, p in plans.items()}
    runs.update((name, (lib, plan)) for name, lib in libs.items()
                if name != "source")
    # the launch alone under the other plans' grids and shared memory
    runs.update((f"launch only, {name}", (libs["launch only"], p))
                for name, p in plans.items() if name != "source")

    def k2(lib, p):
        status = entry(lib, "nm_bahdanau_step")(
            keys.data_ptr(), states.data_ptr(), mask.data_ptr(),
            pq.data_ptr(), sim_v.data_ptr(), ctx.data_ptr(),
            weights.data_ptr(), batch, time_, att, dim, p.cluster,
            p.positions, p.columns, int(p.staged), int(p.resident),
            p.smem_bytes, stream())
        if status:
            raise RuntimeError(f"bahdanau_step {p}: CUDA error {status}")
    ref = cuda_attention.bahdanau_reference(keys, states, mask, pq, sim_v)
    result["fused_bahdanau_step"] = {"plan": plan._asdict()}
    for name, run in runs.items():
        k2(*run)
        torch.cuda.synchronize()
        result["fused_bahdanau_step"][f"{name} max_abs_err"] = float(
            (ctx - ref[0]).abs().max())
    for _ in range(args.turns):
        for name, run in runs.items():
            result["fused_bahdanau_step"].setdefault(name, []).append(
                cs.time_ms(lambda: k2(*run)))
            result["fused_bahdanau_step"].setdefault(
                f"{name} l2 flushed", []).append(
                    cs.flushed_ms(lambda: k2(*run)))
    result["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
