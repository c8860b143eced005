"""Training CLI (counterpart of ``neuralmonkey_tpu/train.py``).

Usage: python -m neuralmonkey_tpu_torch.train exp.ini [section.key=value ...] [-f]

Trains on the CUDA card through the hand-written kernels, or on the CPU
through their plain versions when the INI asks for it
(``[tf_manager] device="cpu"``). ``--profile DIR`` writes a
``torch.profiler`` trace of the run to ``DIR/trace.json``.

Parallel training: one process per device, each started with
``NM_COORDINATOR_ADDRESS=host:port NM_NUM_PROCESSES=N NM_PROCESS_ID=i``
(or under ``torchrun`` with ``NM_DISTRIBUTED=auto``); see
``parallel/distributed.py``. The INI's ``[tf_manager]`` lays the
processes out: ``num_model_shards`` (tensor parallelism, with
``sequence_sharding``), ``num_context_shards`` (the ring attention),
the rest data replicas (``shard_optimizer_state``, ``fsdp``).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import torch

from .experiment import Experiment
from .logging import log
from .parallel import distributed


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="neuralmonkey_tpu_torch.train",
        description="Train a model from an INI experiment file.")
    parser.add_argument("config", help="experiment INI file")
    parser.add_argument("overrides", nargs="*",
                        help="section.key=value config overrides")
    parser.add_argument("--overwrite", "-f", action="store_true",
                        help="overwrite the output directory")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler trace (Chrome/"
                             "Perfetto JSON) to DIR/trace.json")
    args = parser.parse_args(argv)

    # a process of a data-parallel run joins its group before anything
    # touches a device (a no-op without NM_COORDINATOR_ADDRESS or
    # NM_DISTRIBUTED)
    distributed.maybe_initialize()
    exp = Experiment(args.config, train_mode=True,
                     overwrite_output_dir=args.overwrite,
                     config_changes=args.overrides)
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            exp.train()
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        log(f"Profiler trace written to {trace}")
    else:
        exp.train()
    log("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
