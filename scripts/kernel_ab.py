#!/usr/bin/env python3
"""Device times of the redesigned kernels (``lstm_scan``, the flash
forward, and the flash backward's dq and dkv), with their library
yardsticks, for the port found under ROOT (by default this checkout), so
that two versions can be compared on one card in one call:

    python3 scripts/kernel_ab.py [--root DIR] [--sweep]    (GPU)

Shapes: ``lstm_scan`` through its wrapper (hoisted GEMM and scan) and the
scan alone at the LSTM encoder's B 64, T 32, H 512, two directions,
ragged sources, beside cuDNN's ``nn.LSTM``; the flash forward at the
Transformer encoder's B 64, H 8, 32 x 32, Dh 64 and at a long source
(B 8, H 8, 512 x 512), both with ragged key masks, beside
``scaled_dot_product_attention``; the flash backward (dq, dkv, and the
whole backward with its dcap row sums) at the encoder, the causal
decoder (48 x 48), the cross attention (48 x 32) and the long source,
beside SDPA's backward (``chip_smoke.flash_backward_times``). The
timing code is this checkout's ``chip_smoke.py`` whatever ROOT is.
``--sweep`` adds the scan alone at other batches and lengths (where a
step's time goes). Prints one JSON line with the card's name and power
limit.
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
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from neuralmonkey_tpu_torch.ops import cuda_rnn, nn
    from neuralmonkey_tpu_torch.ops import flash_attention as fa
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
    result["lstm_scan"] = {
        "ms": cs.time_ms(lambda: cuda_rnn.lstm_scan(directions, inputs,
                                                    mask)),
        "scan_ms": cs.time_ms(lambda: cuda_rnn.lstm_scan_forward(
            xz, mask, wh, 1.0, 2, False)),
        "library_ms": cs.time_ms(cudnn)}
    if args.sweep:
        sweep = {}
        for b, t in ((1, 32), (8, 32), (16, 32), (32, 32), (64, 32),
                     (64, 8), (64, 16), (128, 32)):
            x = randn(b, t, 2 * 4 * hidden, scale=0.5)
            m = torch.ones(b, t, device=device)
            sweep[f"B{b} T{t}"] = cs.time_ms(
                lambda: cuda_rnn.lstm_scan_forward(x, m, wh, 1.0, 2, False))
        result["lstm_scan"]["scan_sweep_ms"] = sweep
    # flash forward
    for case, (b, h, t, d) in (("encoder", (cs.BATCH, cs.T_HEADS, cs.SRC_LEN,
                                            cs.T_HEAD_DIM)),
                               ("long source", (8, cs.T_HEADS, 512,
                                                cs.T_HEAD_DIM))):
        q, k, v = (randn(b, h, t, d) for _ in range(3))
        mask = mask_of(torch.randint(1, t + 1, (b,), generator=gen).tolist(),
                       t)
        bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
        result[f"flash_attention_fwd {case}"] = {
            "ms": cs.time_ms(lambda: fa.flash_forward(q, k, v, mask, False)),
            "call_ms": cs.call_ms(lambda: fa.flash_forward(q, k, v, mask,
                                                           False)),
            "library_ms": cs.time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias))}
    # flash backward
    for case, (b, h, tq, tk, d, causal) in cs.FLASH_SHAPES.items():
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
