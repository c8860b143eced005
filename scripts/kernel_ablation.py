#!/usr/bin/env python3
"""Where a redesigned kernel's time goes: device times of variants of its
source, each a text edit that removes or swaps one part, beside the
source itself, in turns on one card (GPU):

    python3 scripts/kernel_ablation.py [--turns 2] [--only ROWS]

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
(``chip_smoke.flushed_ms``). The lineage attention
(``csrc/lineage_attention.cu``) at the Transformer's beam step (B 64, H
8, K 10, Dh 64, 480 lanes): by its plan alone, 2, 3 and 4 stages, the
slot rows padded to 32 instead of the beam's 16,
4-byte copies instead of 16-byte ones, and at B 1
without the lane split; by edits, 64-lane tiles (at each stage count
that fits), the launch alone, and without the score or the context
products. K4
(``csrc/beam_select.cu``) at 64 x 2400, k 10: by its plan alone, 1 and
8 rows a block at a warp a row, and 2, 4 and 8 warps a row; by edits,
the launch alone, the path past 256 candidates (the candidates' pass,
then the per-lane lists' pass and merge), and without the places'
counts (the loads, tau and the appends alone). A variant that
removes a part computes wrong values; only its time is read. Each
variant is compiled by nvcc into its own library under
``build/kernel_ablation/`` and launched through the kernel's C entry
point on the inputs of the source's own launch. ``--only`` keeps the
kernels whose names start with one of the comma-separated prefixes
(``gru_scan``, ``fused_logits_rowmax_lse``, ``fused_xent_fwd``,
``fused_bahdanau_step``, ``lineage_attention``, ``small_topk``). Prints
one JSON line with the card's name and power limit.
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

LINEAGE_VARIANTS = {
    "source": [],
    "launch only": [("  const int bh = blockIdx.x, b = bh / a.H;\n",
                     "  if (a.W > 0) return;\n"
                     "  const int bh = blockIdx.x, b = bh / a.H;\n")],
    "no score products": [("const int k_steps = (a.D + 7) / 8",
                           "const int k_steps = 0 * (a.D + 7) / 8")],
    "no context products": [("m_blocks = (a.D + 15) / 16",
                             "m_blocks = 0 * (a.D + 15) / 16")],
    "64-lane tiles": [("return DMAX > 256 ? 16 : 32;",
                       "return DMAX > 256 ? 16 : 64;")],
}
TOPK_VARIANTS = {
    "source": [],
    "launch only": [("  const int n_chunks = ",
                     "  if (n > 0) return;\n  const int n_chunks = ")],
    "past 256 candidates": [("if (count <= kTopkCandidates) {",
                             "if (count < 0) {")],
    "no places": [("for (int j = 0; j < count; ++j) place +=",
                   "for (int j = 0; j < 0; ++j) place +=")],

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
    parser.add_argument("--only", default="")
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
    prefixes = tuple(p for p in args.only.split(",") if p)

    def wanted(row):
        return not prefixes or row.startswith(prefixes)
    batch, time_, hidden = cs.BATCH, cs.SRC_LEN, cs.RNN
    mask = torch.ones(batch, time_, device=device)
    sms, smem = kernel_config.device_limits(0)
    # K1
    if wanted("gru_scan"):
        x = randn(batch, time_, 2 * 3 * hidden, scale=0.5)
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
    if wanted("fused_logits_rowmax_lse"):
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
    if wanted("fused_xent_fwd"):
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
                xf.data_ptr(), wf.data_ptr(), bf.data_ptr(),
                targets.data_ptr(), *(p.data_ptr() for p in partials),
                lse.data_ptr(), nll.data_ptr(),
                n, d, v, 0, 0.0, stream())
            if status:
                raise RuntimeError(f"xent_fwd {name}: CUDA error {status}")
        result["fused_xent_fwd"] = {}
        for _ in range(args.turns):
            for name in libs:
                result["fused_xent_fwd"].setdefault(name, []).append(
                    cs.time_ms(lambda: xent_fwd(name)))
    # K2: plans of the source's own library
    if wanted("fused_bahdanau_step"):
        att, dim = cs.ATT, 2 * cs.RNN
        keys, states = randn(batch, time_, att), randn(batch, time_, dim)
        pq, sim_v = randn(batch, att), randn(att, scale=att ** -0.5)
        ctx, weights = keys.new_empty(batch, dim), keys.new_empty(batch, time_)
        plan = cuda_attention.bahdanau_plan(batch, time_, att, dim, sms, smem)
        plans = {
            "source": plan,
            # sm_count = B: one block a row fills it
            "clusters of 1": cuda_attention.bahdanau_plan(batch, time_, att,
                                                          dim,
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
    # the lineage attention
    if wanted("lineage_attention"):
        from neuralmonkey_tpu_torch.ops import beam_select
        from neuralmonkey_tpu_torch.ops import lineage_attention as la
        libs = build(kernel_config, "lineage_attention.cu", LINEAGE_VARIANTS)
        heads, beam = cs.T_HEADS, cs.BEAM
        steps, dim = cs.TGT_LEN, cs.T_HEAD_DIM
        lanes = beam * steps
        result["lineage_attention"] = {}
        for b in (cs.BATCH, 1):
            q = randn(b, heads, beam, dim)
            kq, vq = randn(b, heads, dim, lanes), randn(b, heads, lanes, dim)
            anc = torch.randint(0, beam, (b, beam, steps), generator=gen,
                                dtype=torch.int32).to(device)
            bias = la.lineage_bias(anc, steps - 1, steps, beam, lanes, steps)
            out = torch.empty_like(q)
            plan = la.lineage_plan(b, heads, beam, dim, lanes, lanes, sms,
                                   smem)
            part_o = q.new_empty(max(plan.splits, 8), b * heads * beam, dim)
            part_ml = q.new_empty(max(plan.splits, 8), b * heads * beam, 2)

            def variant(p, **change):
                p = p._replace(**change)
                return p._replace(smem_bytes=la.lineage_smem_bytes(
                    p.dmax, p.slots, p.tile, p.stages))
            plans = {"source": plan}
            if b == 1:
                plans["no lane split"] = plan._replace(
                    splits=1, chunk=plan.splits * plan.chunk)
            else:
                plans.update({
                    f"{n} stages": variant(plan, stages=n)
                    for n in (2, 3, 4)
                    if la.lineage_smem_bytes(plan.dmax, plan.slots,
                                             plan.tile, n) <= smem})
                plans["slots padded to 32"] = variant(plan, slots=32)
                plans["4-byte copies"] = plan._replace(vec=False)
            runs = {name: (libs["source"], p) for name, p in plans.items()}
            runs.update((name, (lib, plan)) for name, lib in libs.items()
                        if name not in ("source", "64-lane tiles"))
            if b != 1:
                wide = {n: variant(plan, tile=64, stages=n,
                                   threads=2 * plan.threads,
                                   chunk=-(-lanes // 64) * 64)
                        for n in (2, 3, 4)}
                runs.update(
                    (f"64-lane tiles, {n} stages", (libs["64-lane tiles"], p))
                    for n, p in wide.items() if p.smem_bytes <= smem)

            def lineage(lib, p):
                status = entry(lib, "nm_lineage_attention")(
                    q.data_ptr(), kq.data_ptr(), vq.data_ptr(),
                    bias.data_ptr(),
                    out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), b,
                    heads, beam, dim, lanes, lanes, p.dmax, p.tile, p.slots,
                    p.groups,
                    p.splits, p.chunk, p.stages, int(p.vec), p.smem_bytes,
                    dim ** -0.5, stream())
                if status:
                    raise RuntimeError(f"lineage_attention {p}: CUDA error "
                                       f"{status}")
            ref = la.lineage_attention_reference(q, kq, vq, bias)
            row = result["lineage_attention"][f"B{b}"] = {
                "plan": plan._asdict()}
            for name, run in runs.items():
                lineage(*run)
                torch.cuda.synchronize()
                row[f"{name} max_abs_err"] = float((out - ref).abs().max())
            for _ in range(args.turns):
                for name, run in runs.items():
                    row.setdefault(name, []).append(
                        cs.time_ms(lambda: lineage(*run)))
                row.setdefault("source l2 flushed", []).append(
                    cs.flushed_ms(lambda: lineage(*runs["source"])))
    # K4
    if wanted("small_topk"):
        libs = build(kernel_config, "beam_select.cu", TOPK_VARIANTS)
        vp = -(-cs.VOCAB // 1024) * 1024
        n, k = cs.BEAM * vp // 128, cs.BEAM
        scores = torch.round(randn(cs.BATCH, n, scale=3.0))
        vals = scores.new_empty(cs.BATCH, k)
        idx = torch.empty(cs.BATCH, k, dtype=torch.int32, device=device)
        plan = beam_select.topk_plan(cs.BATCH, n, k)

        def with_warps(wpr, rows):
            return plan._replace(warps_per_row=wpr, rows_per_block=rows,
                                 smem_bytes=4 * wpr * rows * 2 * (64 + 256))
        runs = {"source": (libs["source"], plan)}
        runs.update((f"{rows} rows a block",
                     (libs["source"], with_warps(1, rows)))
                    for rows in (1, 8))
        runs.update((f"{wpr} warps a row",
                     (libs["source"], with_warps(wpr, 1)))
                    for wpr in (2, 4, 8))
        runs.update((name, (lib, plan)) for name, lib in libs.items()
                    if name != "source")

        def topk(lib, p):
            status = entry(lib, "nm_small_topk")(
                scores.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                cs.BATCH, n,
                k, p.k_max, p.warps_per_row, p.rows_per_block, int(p.vec),
                p.smem_bytes, stream())
            if status:
                raise RuntimeError(f"small_topk {p}: CUDA error {status}")
        ref = beam_select.topk_reference(scores, k)
        row = result["small_topk"] = {"plan": plan._asdict()}
        for name, run in runs.items():
            topk(*run)
            torch.cuda.synchronize()
            row[f"{name} exact"] = bool(torch.equal(idx, ref[1]))
        for _ in range(args.turns):
            for name, run in runs.items():
                row.setdefault(name, []).append(cs.time_ms(lambda: topk(*run)))
    result["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
