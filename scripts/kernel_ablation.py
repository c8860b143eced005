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
of two (launch bounds), and without the logits store. A variant that
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
        tag = f"{source[:-3]}_{name.replace(' ', '_')}"
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
    from neuralmonkey_tpu_torch.ops import cuda_rnn, kernel_config
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
    result["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
