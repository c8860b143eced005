#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 scripts/profile_port_train.py [--fused-xent] [--steps N]

It builds the flagship RNN model of ``chip_smoke.py``'s training phase
(vocabulary 30000, embeddings 512, BiGRU 512, attention 512,
conditional GRU 512, maxout 512, batch 64, source 32, target 48, Adam,
clip 1.0, keep-prob 0.8) on the same synthetic pairs, runs three
warm-up steps, then ``N`` steps (default 5) under ``torch.profiler``.
It prints the card's name and power limit, the wall time per step, the
target tokens per second, the share of the window in which the device
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--fused-xent", action="store_true",
                        help="train with NM_FUSED_XENT=1")
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this profile needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from neuralmonkey_tpu_torch.dataset import BatchingScheme
    from neuralmonkey_tpu_torch.experiment import Experiment

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.fused_xent:
        os.environ["NM_FUSED_XENT"] = "1"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_inputs(tmp)
        exp = Experiment(chip_smoke.write_training_inputs(tmp),
                         train_mode=True)
        exp.build_model()
        manager, trainer = exp.tf_manager, exp.model.trainer
        batch_size = chip_smoke.BATCH
        prepared = manager.iter_prepared_batches(
            exp.model.train_dataset, BatchingScheme(batch_size=batch_size),
            batch_size, train=True)
        batches = [next(prepared)[0] for _ in range(3 + args.steps)]
        for batch in batches[:3]:
            manager.train_on_prepared(trainer, batch)
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            start = time.perf_counter()
            for batch in batches[3:]:
                manager.train_on_prepared(trainer, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        tokens = sum(float(b["decoder.train_mask"].sum())
                     for b in batches[3:])

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.Counter()
    launches = collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        launches[e.name] += 1
    device_us = sum(by_name.values())
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    result = {
        "device": smi, "fused_xent": args.fused_xent, "steps": args.steps,
        "ms_per_step": wall / args.steps * 1e3,
        "target_tokens_per_sec": tokens / wall,
        "kernel_launches_per_step": len(kernels) / args.steps,
        "device_kernel_ms_per_step": device_us / args.steps / 1e3,
        "device_busy_share": busy / (wall * 1e6),
        "top_kernels": [
            {"name": name[:90], "ms_per_step": us / args.steps / 1e3,
             "share_of_kernel_time": us / device_us if device_us else 0.0,
             "launches_per_step": launches[name] / args.steps}
            for name, us in by_name.most_common(15)],
    }
    print(smi)
    print(f"{result['ms_per_step']:.2f} ms per step, "
          f"{result['target_tokens_per_sec']:.1f} target tokens/s, "
          f"device busy {result['device_busy_share']:.1%}")
    for k in result["top_kernels"]:
        print(f"  {k['ms_per_step']:9.3f} ms  {k['launches_per_step']:7.1f}x"
              f"  {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
