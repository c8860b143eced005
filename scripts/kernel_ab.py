#!/usr/bin/env python3
"""Device times of the redesigned kernels (K1 ``gru_scan``, K2, K3,
``lstm_scan``, ``lstm_bptt``, ``gru_bptt``, the flash forward, the flash
backward's dq and dkv, and the three fused cross-entropy kernels), with
their library or like-for-like yardsticks, and of the kernel that shares
K3's code (``rowmax_lse``), for
the port found under ROOT (by default this checkout), so that two
versions can be compared on one card in one call:

    python3 scripts/kernel_ab.py [--root DIR] [--sweep] [--only ROWS]  (GPU)

Shapes: ``lstm_scan`` through its wrapper (hoisted GEMM and scan) and the
scan alone at the LSTM encoder's B 64, T 32, H 512, two directions,
ragged sources, beside cuDNN's ``nn.LSTM``; ``lstm_bptt`` at the same
shape, with the whole LSTM backward (autograd through the port's scan)
beside the plain scan's and cuDNN's backward
(``chip_smoke.lstm_backward_times``); ``gru_bptt`` at the GRU encoder's
B 64, T 32, H 512, two directions, full sources, with the whole GRU
backward beside the plain scan's (``chip_smoke.gru_backward_times``),
and K1 at that shape through its wrapper, alone (``scan_ms``) and alone
saving the carries a gradient needs (``scan_saved_ms``); the flash
forward at the
Transformer encoder's B 64, H 8, 32 x 32, Dh 64 and at a long source
(B 8, H 8, 512 x 512), both with ragged key masks, beside
``scaled_dot_product_attention``; the flash backward (dq, dkv, and the
whole backward with its dcap row sums) at the encoder, the causal
decoder (48 x 48), the cross attention (48 x 32) and the long source,
beside SDPA's backward (``chip_smoke.flash_backward_times``); K2 at the
greedy decoder's B 64, T 32, A 512, D 1024, ragged sources, back to back
and with the L2 cache flushed before each call
(``chip_smoke.flushed_ms``); the three fused cross-entropy kernels at
N 3072, D 512, V 30000, (D, V), eps 0, with the plain dx and dW, and the
forward also in the tied (V, D) layout; K3 at 640 x 512 x 30720, beside cuBLAS's
``addmm`` of the same shape (a reference for the product alone, not a
library yardstick: no PyTorch call computes K3's whole function);
``rowmax_lse`` at 640 x 30080; the lineage attention at the
Transformer's beam step (B 64, H 8, K 10, 48 steps, Dh 64, the full
window of 480 lanes), back to back and with the L2 cache flushed, and
at B 1 (a server's few sentences); K4 at the selector's group stage
(64 x 2400, k 10) and candidate stage (64 x 1280, k 10), beside
``torch.topk``. The timing code is
this checkout's ``chip_smoke.py`` whatever ROOT is. ``--sweep`` adds the
LSTM scan alone, ``lstm_bptt`` and ``gru_bptt`` at other batches and
lengths, and K1's scan alone at T 8, 16 and 32 (where a step's time
goes);
``--only`` keeps the rows whose names start with one of the
comma-separated prefixes. Prints one JSON line with the card's name and
power limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=REPO)
    parser.add_argument("--sweep", action="store_true")
    parser.add_argument("--only", default="")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from neuralmonkey_tpu_torch.ops import (beam_select, cuda_attention,
                                            cuda_rnn, nn)
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
    from neuralmonkey_tpu_torch.ops import fused_xent as fx
    from neuralmonkey_tpu_torch.ops import kernel_config
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_config.library()
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(cs.SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    def mask_of(lengths, time):
        mask = torch.zeros(len(lengths), time)
        for i, n in enumerate(lengths):
            mask[i, :n] = 1.0
        return mask.to(device)

    result = {"root": os.path.abspath(args.root)}
    prefixes = tuple(p for p in args.only.split(",") if p)

    def wanted(row):
        return not prefixes or row.startswith(prefixes)
    # lstm_scan
    batch, time_, width, hidden = cs.BATCH, cs.SRC_LEN, cs.EMB, cs.RNN
    params = [{k: v.to(device) for k, v in
               nn.LSTMCell(width, hidden).init(gen).items()} for _ in range(2)]
    directions = list(zip(params, (False, True)))
    lengths = torch.randint(1, time_ + 1, (batch,), generator=gen).tolist()
    inputs, mask = randn(batch, time_, width), mask_of(lengths, time_)
    xz = cuda_rnn.lstm_hoisted_inputs(params, inputs)
    wh = torch.stack([p["kernel_h"] for p in params])
    lstm = cs.cudnn_lstm(params, (False, True), 1.0)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        inputs, torch.tensor(lengths), batch_first=True, enforce_sorted=False)

    def cudnn():
        with torch.no_grad():
            return lstm(packed)
    if wanted("lstm_scan"):
        result["lstm_scan"] = {
            "ms": cs.time_ms(lambda: cuda_rnn.lstm_scan(directions, inputs,
                                                        mask)),
            "scan_ms": cs.time_ms(lambda: cuda_rnn.lstm_scan_forward(
                xz, mask, wh, 1.0, 2, False)),
            "library_ms": cs.time_ms(cudnn)}
    if wanted("lstm_bptt"):
        bptt = (xz, mask, randn(batch, time_, 2 * hidden),
                randn(batch, time_, 2 * hidden, scale=0.5),
                randn(batch, time_, 2 * hidden), randn(batch, 2 * hidden),
                wh, 1.0)
        result["lstm_bptt"] = {
            "ms": cs.time_ms(lambda: cuda_rnn.lstm_bptt(*bptt, 2)),
            **cs.lstm_backward_times(cuda_rnn, params, (False, True), inputs,
                                     mask, lengths, lstm, gen)}
    if args.sweep and wanted("lstm_scan"):
        sweep = {}
        for b, t in ((1, 32), (8, 32), (16, 32), (32, 32), (64, 32),
                     (64, 8), (64, 16), (128, 32)):
            x = randn(b, t, 2 * 4 * hidden, scale=0.5)
            m = torch.ones(b, t, device=device)
            sweep[f"B{b} T{t}"] = cs.time_ms(
                lambda: cuda_rnn.lstm_scan_forward(x, m, wh, 1.0, 2, False))
        result["lstm_scan"]["scan_sweep_ms"] = sweep
    if args.sweep and wanted("lstm_bptt"):
        sweep = {}
        for b, t in ((8, 32), (64, 8), (64, 16), (64, 32)):
            bptt = (randn(b, t, 2 * 4 * hidden, scale=0.5),
                    torch.ones(b, t, device=device),
                    *(randn(b, t, 2 * hidden) for _ in range(3)),
                    randn(b, 2 * hidden), wh, 1.0)
            sweep[f"B{b} T{t}"] = cs.time_ms(
                lambda: cuda_rnn.lstm_bptt(*bptt, 2))
        result["lstm_bptt"]["bptt_sweep_ms"] = sweep

    # the GRU BPTT and K1 at the GRU encoder's shape
    def gru_bptt_args(b, t):
        return (randn(b, t, 2 * 3 * hidden, scale=0.5),
                torch.ones(b, t, device=device),
                randn(b, t, 2 * hidden, scale=0.5), randn(b, t, 2 * hidden),
                randn(b, 2 * hidden),
                randn(2, hidden, 2 * hidden, scale=hidden ** -0.5),
                randn(2, hidden, hidden, scale=hidden ** -0.5))
    if wanted("gru_bptt"):
        bptt = gru_bptt_args(batch, time_)
        result["gru_bptt"] = {
            "ms": cs.time_ms(lambda: cuda_rnn.gru_bptt(*bptt, 2)),
            **cs.gru_backward_times(cuda_rnn, nn, device, batch, time_, width,
                                    hidden)}
        if args.sweep:
            sweep = {}
            for b, t in ((8, 32), (64, 8), (64, 16), (64, 32)):
                bptt = gru_bptt_args(b, t)
                sweep[f"B{b} T{t}"] = cs.time_ms(
                    lambda: cuda_rnn.gru_bptt(*bptt, 2))
            result["gru_bptt"]["bptt_sweep_ms"] = sweep
    if wanted("gru_scan"):
        cells = [{k: v.to(device) for k, v in
                  nn.GRUCell(width, hidden).init(gen).items()}
                 for _ in range(2)]
        full = torch.ones(batch, time_, device=device)
        wgh = torch.stack([c["gates_h"] for c in cells])
        wch = torch.stack([c["cand_h"] for c in cells])

        def scan(x, mask, saved):
            # K1 alone on the hoisted inputs: without the carries, or
            # saving them as a training forward does
            if saved:
                return cuda_rnn._GRUScan.apply(x, mask, wgh, wch, 2)
            with torch.no_grad():
                return cuda_rnn._GRUScan.apply(x, mask, wgh, wch, 2)
        x = cuda_rnn.hoisted_inputs(cells, inputs)
        x_grad = x.detach().requires_grad_()
        result["gru_scan"] = {
            "ms": cs.time_ms(lambda: cuda_rnn.gru_scan(
                [(cells[0], False), (cells[1], True)], inputs, full)),
            "scan_ms": cs.time_ms(lambda: scan(x, full, False)),
            "scan_saved_ms": cs.time_ms(lambda: scan(x_grad, full, True))}
        if args.sweep:
            sweep = {}
            for t in (8, 16, 32):
                xt = x[:, :t].contiguous()
                mt = full[:, :t].contiguous()
                sweep[f"B{batch} T{t}"] = cs.time_ms(
                    lambda: scan(xt, mt, False))
            result["gru_scan"]["scan_sweep_ms"] = sweep
    # K2 at the greedy decoder's step, back to back and with L2 flushed
    if wanted("fused_bahdanau_step"):
        att, dim = cs.ATT, 2 * cs.RNN
        step_args = (randn(batch, time_, att), randn(batch, time_, dim),
                     mask_of(torch.randint(1, time_ + 1, (batch,),
                                           generator=gen).tolist(), time_),
                     randn(batch, att), randn(att, scale=att ** -0.5))

        def step():
            return cuda_attention.fused_bahdanau_step(*step_args)
        result["fused_bahdanau_step"] = {
            "ms": cs.time_ms(step), "l2_flushed_ms": cs.flushed_ms(step)}
    # the fused cross-entropy, whose kernels share K3's tensor-core
    # product (tc_product.cuh), and K3
    n, d, v = cs.XENT_N, cs.XENT_D, cs.VOCAB
    x, w, b = randn(n, d, scale=0.5), randn(d, v, scale=d ** -0.5), randn(
        v, scale=0.1)
    w_tied = w.T.contiguous()
    targets = torch.randint(0, v, (n,), generator=gen,
                            dtype=torch.int32).to(device)
    g = torch.rand(n, generator=gen).to(device)
    _, lse = fx.xent_fwd(x, w, b, targets, 0.0, False)
    bwd = (x, w, b, targets, lse, g, 0.0, False)
    for row, fn in (
            ("fused_xent_fwd", lambda: fx.xent_fwd(x, w, b, targets, 0.0,
                                                   False)),
            ("fused_xent_fwd tied", lambda: fx.xent_fwd(
                x, w_tied, b, targets, 0.0, True)),
            ("fused_xent_bwd_dx", lambda: fx.xent_bwd_dx(*bwd)),
            ("fused_xent_bwd_dw", lambda: fx.xent_bwd_dw(*bwd))):
        if wanted(row):
            result[row] = {"ms": cs.time_ms(fn)}
    for row, plain in (("fused_xent_bwd_dx", fx.bwd_dx_reference),
                       ("fused_xent_bwd_dw", fx.bwd_dw_reference)):
        if wanted(row):
            result[row]["plain_ms"] = cs.time_ms(lambda: plain(*bwd))
    if wanted("fused_logits_rowmax_lse"):
        vp = -(-v // 1024) * 1024
        xk, wk = randn(cs.BATCH * cs.BEAM, d), randn(d, vp, scale=d ** -0.5)
        bk = randn(vp, scale=0.1)
        # cuBLAS's float32 product of the same shape: a reference for the
        # product alone, not a yardstick (no PyTorch call computes the
        # logits with both reductions)
        result["fused_logits_rowmax_lse"] = {
            "ms": cs.time_ms(
                lambda: beam_select.fused_logits_rowmax_lse(xk, wk, bk)),
            "product_alone_cublas_addmm_ms": cs.time_ms(
                lambda: torch.addmm(bk, xk, wk))}
    if wanted("rowmax_lse"):
        vp = -(-v // 128) * 128
        logits = torch.full((cs.BATCH * cs.BEAM, vp), -4e9, device=device)
        logits[:, :v] = randn(cs.BATCH * cs.BEAM, v, scale=4.0)
        result["rowmax_lse"] = {"ms": cs.time_ms(
            lambda: beam_select.rowmax_lse(logits))}
    # the lineage attention and K4 at the Transformer's beam step
    if wanted("lineage_attention"):
        from neuralmonkey_tpu_torch.ops import lineage_attention as la
        beam, steps, dim = cs.BEAM, cs.TGT_LEN, cs.T_HEAD_DIM
        for case, b in (("", cs.BATCH), (" B1", 1)):
            q = randn(b, cs.T_HEADS, beam, dim)
            kq = randn(b, cs.T_HEADS, dim, beam * steps)
            vq = randn(b, cs.T_HEADS, beam * steps, dim)
            anc = torch.randint(0, beam, (b, beam, steps), generator=gen,
                                dtype=torch.int32).to(device)
            bias = la.lineage_bias(anc, steps - 1, steps, beam, beam * steps,
                                   steps)

            def lineage():
                return la.lineage_attention(q, kq, vq, bias)
            result[f"lineage_attention{case}"] = {
                "ms": cs.time_ms(lineage),
                "l2_flushed_ms": cs.flushed_ms(lineage)}
    if wanted("small_topk"):
        vp = -(-v // 1024) * 1024
        for case, n in (("", cs.BEAM * vp // 128), (" candidates",
                                                     cs.BEAM * 128)):
            scores = torch.round(randn(cs.BATCH, n, scale=3.0))
            result[f"small_topk{case}"] = {
                "ms": cs.time_ms(lambda: beam_select.small_topk(scores,
                                                                cs.BEAM)),
                "library_ms": cs.time_ms(lambda: torch.topk(scores, cs.BEAM,
                                                            dim=1))}
    # flash forward
    for case, (b, h, t, d) in (("encoder", (cs.BATCH, cs.T_HEADS, cs.SRC_LEN,
                                            cs.T_HEAD_DIM)),
                               ("long source", (8, cs.T_HEADS, 512,
                                                cs.T_HEAD_DIM))):
        q, k, v = (randn(b, h, t, d) for _ in range(3))
        mask = mask_of(torch.randint(1, t + 1, (b,), generator=gen).tolist(),
                       t)
        bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
        if not wanted("flash_attention_fwd"):
            continue
        result[f"flash_attention_fwd {case}"] = {
            "ms": cs.time_ms(lambda: fa.flash_forward(q, k, v, mask, False)),
            "call_ms": cs.call_ms(lambda: fa.flash_forward(q, k, v, mask,
                                                           False)),
            "library_ms": cs.time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias))}
    # flash backward
    for case, (b, h, tq, tk, d, causal) in cs.FLASH_SHAPES.items():
        if not wanted("flash_backward"):
            break
        q, k, v, g = (randn(b, h, t, d) for t in (tq, tk, tk, tq))
        mask = (torch.ones(b, tk, device=device) if causal else mask_of(
            torch.randint(1, tk + 1, (b,), generator=gen).tolist(), tk))
        result[f"flash_backward {case}"] = cs.flash_backward_times(
            fa, q, k, v, g, mask, causal)
    result["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
