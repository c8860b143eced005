#!/usr/bin/env python3
"""Where a training step, or a decoded batch, of the PyTorch port spends
its time on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 scripts/profile_port_train.py [--model rnn|lstm|transformer]
        [--fused-xent] [--steps N]
        [--decode greedy|beam|beam-lineage|beam-unfused]

It builds the model of ``chip_smoke.py``'s phases: the flagship RNN
(vocabulary 30000, embeddings 512, BiGRU 512, attention 512, conditional
GRU 512, maxout 512, Adam, clip 1.0, keep-prob 0.8), the same with a
bidirectional LSTM encoder of 512 (``lstm``), or bench.py's
Transformer (512 wide, FFN 2048, 6 + 6 layers, 8 heads, tied target
embeddings, delayed updates every 2 batches, Adam on the noam schedule,
label smoothing 0.1, dropout and attention dropout keep 0.9), at batch
64, source 32, target 48, on the same synthetic pairs. Without
``--decode`` it runs three warm-up training steps, then ``N`` steps
(default 6) under ``torch.profiler``. With ``--decode`` it decodes one
batch of 64 of the smoke's random sentences with random seeded weights
(greedy, beam 10, beam 10 under ``NM_LINEAGE_KERNEL=1``, or beam 10
under ``NM_FUSED_LOGITS=0``) twice as a
warm-up, then ``N`` times under the profiler. It prints the card's name
and power limit, the wall time per step (or batch), the target tokens
(or sentences) per second, the share of the window in which the device
ran a kernel, and the kernels with the most device time; the last line
is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for start, stop in sorted(intervals):
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def training_steps(args, tmp):
    """(warm-up steps, profiled steps, units per profiled window): one
    closure per training step."""
    import chip_smoke
    from neuralmonkey_tpu_torch.dataset import BatchingScheme
    from neuralmonkey_tpu_torch.experiment import Experiment

    cell = "LSTM" if args.model == "lstm" else "GRU"
    chip_smoke.write_inputs(tmp)
    train_ini = chip_smoke.write_training_inputs(tmp, cell)
    if args.model == "transformer":
        train_ini = chip_smoke.write_transformer_ini(
            tmp, "t_train.ini", chip_smoke.T_TRAINING_MAIN, 0.9,
            chip_smoke.T_ATT_KEEP)
    exp = Experiment(train_ini, train_mode=True)
    exp.build_model()
    manager, trainer = exp.tf_manager, exp.model.trainer
    batch_size = chip_smoke.BATCH
    prepared = manager.iter_prepared_batches(
        exp.model.train_dataset, BatchingScheme(batch_size=batch_size),
        batch_size, train=True)
    batches = [next(prepared)[0] for _ in range(3 + args.steps)]
    tokens = sum(float(b["decoder.train_mask"].sum()) for b in batches[3:])

    def step(batch):
        return lambda: manager.train_on_prepared(trainer, batch)
    return ([step(b) for b in batches[:3]], [step(b) for b in batches[3:]],
            tokens)


def decode_steps(args, tmp):
    """The same for decoding one batch of the smoke's sentences."""
    import chip_smoke
    from neuralmonkey_tpu_torch import run
    from neuralmonkey_tpu_torch.experiment import Experiment

    exp_ini, data_ini = chip_smoke.write_inputs(
        tmp, "LSTM" if args.model == "lstm" else "GRU")
    if args.model == "transformer":
        exp_ini = chip_smoke.write_transformer_ini(
            tmp, "t_exp.ini", chip_smoke.T_SERVING_MAIN, 1.0, 1.0)
    if args.decode == "beam-lineage":
        os.environ["NM_LINEAGE_KERNEL"] = "1"
    if args.decode == "beam-unfused":
        os.environ["NM_FUSED_LOGITS"] = "0"
    exp = Experiment(exp_ini, train_mode=False)
    exp.build_model()
    runner = exp.model.runners[0 if args.decode == "greedy" else 1]
    dataset = run.load_data_config(data_ini)[0].subset(0, chip_smoke.BATCH)

    def step():
        exp.tf_manager.run_on_batch([runner], dataset, chip_smoke.BATCH)
    return [step] * 2, [step] * args.steps, chip_smoke.BATCH * args.steps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=("rnn", "lstm", "transformer"),
                        default="rnn")
    parser.add_argument("--fused-xent", action="store_true",
                        help="train with NM_FUSED_XENT=1")
    parser.add_argument("--decode", choices=("greedy", "beam",
                                             "beam-lineage", "beam-unfused"),
                        help="profile decoding instead of training")
    parser.add_argument("--steps", type=int, default=6)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this profile needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fused_xent:
        os.environ["NM_FUSED_XENT"] = "1"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    with tempfile.TemporaryDirectory() as tmp:
        warm, profiled, units = (decode_steps if args.decode
                                 else training_steps)(args, tmp)
        for fn in warm:
            fn()
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            start = time.perf_counter()
            for fn in profiled:
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - start

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    launches = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        launches[e.name] += 1
    device_us = sum(by_name.values())
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    steps = len(profiled)
    unit = "sentences" if args.decode else "target_tokens"
    result = {
        "device": smi, "model": args.model, "decode": args.decode,
        "fused_xent": args.fused_xent, "steps": steps,
        "ms_per_step": wall / steps * 1e3,
        f"{unit}_per_sec": units / wall,
        "kernel_launches_per_step": len(kernels) / steps,
        "device_kernel_ms_per_step": device_us / steps / 1e3,
        "device_busy_share": busy / (wall * 1e6),
        "top_kernels": [
            {"name": name[:90], "ms_per_step": us / steps / 1e3,
             "share_of_kernel_time": us / device_us if device_us else 0.0,
             "launches_per_step": launches[name] / steps}
            for name, us in by_name.most_common(15)],
    }
    print(smi)
    print(f"{result['ms_per_step']:.2f} ms per step, "
          f"{result[f'{unit}_per_sec']:.1f} {unit}/s, "
          f"device busy {result['device_busy_share']:.1%}")
    for k in result["top_kernels"]:
        print(f"  {k['ms_per_step']:9.3f} ms  {k['launches_per_step']:7.1f}x"
              f"  {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
