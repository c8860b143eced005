"""Smoke phase 28 (b)'s training alone, and phase 29 (d)'s, with each
rank's peak device memory split by stage.

Two ranks share one CUDA card over gloo and train phase 6's model
(``chip_smoke.py``: vocabulary 30000, BiGRU 512, batch 64, dropout off)
for a few steps under each of the replicated, ZeRO-1 and FSDP layouts,
then phase 11's Transformer (6 + 6 layers, width 512, FFN 2048,
vocabulary 30000, tied target embeddings, dropout off) under ZeRO-1 and
FSDP; one process trains the same steps of each model. Each rank's peak
is reset at every stage boundary and kept per stage: the forward and
backward (``fwd_bwd``), the gradients' reduction (``reduce``: ZeRO-1's
after the backward, each FSDP unit's within it), the update
(``update``), every gather (``gather``: a ZeRO-1 update's, a
checkpoint's; ``gather <unit>``: each FSDP unit's at use, in the
forward and again in the backward) and the rest (``other``:
featurizing, logging). Prints one JSON line: the card, then per mode
and rank the losses, train tokens/s (``chip_smoke.dp_train``'s), the
bytes allocated before the run, the stage peaks, and each step's loss
distance from the one process's; for the Transformer also the
parameters' largest distance from one process's after step 1.

    python3 scripts/dp_memory_stages.py [--steps N] [--package-root DIR]

``--package-root`` runs the ``neuralmonkey_tpu_torch`` of another
checkout (say a parent commit unpacked with ``git archive``) under this
checkout's ``chip_smoke.py``. Needs one CUDA card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arguments(known_only: bool = False):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=4,
                        help="training steps a run (smoke phase 28: 4)")
    parser.add_argument("--package-root", default=REPO,
                        help="the checkout whose neuralmonkey_tpu_torch "
                        "runs")
    if known_only:
        return parser.parse_known_args()[0]
    return parser.parse_args()


# the package from --package-root, the helpers from this checkout (also
# in the ranks, which run this module again under spawn)
sys.path.insert(0, os.path.abspath(
    _arguments(known_only=True).package_root))
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_SPEC)
sys.modules["chip_smoke"] = chip_smoke
_SPEC.loader.exec_module(chip_smoke)


def rank_main(rank: int, tmp: str, dp_ini: str, t_ini: str, steps: int,
              port: int, result: str) -> None:
    """One of two ranks on ``cuda:0``: every mode's run of both models,
    its stage peaks written to ``result``."""
    import torch

    from neuralmonkey_tpu_torch import runtime
    from neuralmonkey_tpu_torch.parallel import distributed, zero
    try:
        from neuralmonkey_tpu_torch.parallel import fsdp
    except ImportError:  # a package root whose FSDP gathers the tree whole
        fsdp = None

    chip_smoke.card_settings()
    distributed.maybe_initialize(f"127.0.0.1:{port}", 2, rank,
                                 backend="gloo")
    peaks = {}
    stages = ["other"]

    def close_stage(name: str) -> None:
        peaks[name] = max(peaks.get(name, 0),
                          torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def staged(owner, attr: str, name) -> None:
        """``owner.attr`` as a stage named ``name`` (or ``name(*args)``)."""
        plain = getattr(owner, attr)

        def run(*args, **kwargs):
            close_stage(stages[-1])
            stages.append(name(*args) if callable(name) else name)
            try:
                return plain(*args, **kwargs)
            finally:
                close_stage(stages.pop())
        setattr(owner, attr, run)

    staged(runtime.CUDAManager, "train_on_prepared", "fwd_bwd")
    staged(runtime.CUDAManager, "_update", "update")
    staged(runtime.CUDAManager, "_reduce_gradients", "reduce")
    if fsdp is not None:
        staged(runtime.CUDAManager, "_update_parts", "update")
        staged(fsdp.AtUse, "_reduce", "reduce")
        staged(fsdp.AtUse, "_gather_leaves",
               lambda at_use, unit, kind: f"gather {unit}")
    staged(zero, "gather_into", "gather")
    report = {}
    for mode, extra in chip_smoke.DP_MODES.items():
        peaks.clear()
        record = chip_smoke.dp_train(
            dp_ini, os.path.join(tmp, f"{mode}_r{rank}"),
            ['tf_manager.device="cuda:0"', *extra])
        close_stage("other")
        report[mode] = {key: record[key] for key in (
            "losses", "train_tokens_per_sec", "allocated_before")}
        report[mode]["stage_peaks"] = dict(peaks)
    report["transformer"] = {}
    for mode, extra in chip_smoke.MA_ZERO_MODES.items():
        peaks.clear()
        record, exp = chip_smoke.ma_train(
            t_ini, ['tf_manager.device="cuda:0"', extra],
            chip_smoke.ref_path(t_ini), steps=steps)
        del exp
        chip_smoke.gc_card()
        close_stage("other")
        # (the stages reset the peak, so the record's own step peaks are
        # not kept)
        report["transformer"][mode] = {key: record[key] for key in (
            "losses", "train_tokens_per_sec", "param_gap_after_step_1")}
        report["transformer"][mode]["stage_peaks"] = dict(peaks)
    torch.distributed.destroy_process_group()
    with open(result, "w") as f:
        json.dump(report, f)


def main() -> None:
    args = _arguments()
    from neuralmonkey_tpu_torch.ops import kernel_config

    chip_smoke.card_settings()
    chip_smoke.DP_STEPS = args.steps
    kernel_config.library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_inputs(tmp)
        chip_smoke.write_training_inputs(tmp)
        dp_ini, _ = chip_smoke.write_dp_inputs(tmp)
        t_ini = chip_smoke.write_transformer_ini(
            tmp, "ma_train.ini", chip_smoke.MA_MAIN, 1.0, 1.0)
        # one process's Transformer run (its parameters after step 1 kept
        # for the ranks' comparison)
        t_one, exp = chip_smoke.ma_train(
            t_ini, ['tf_manager.device="cuda:0"'], steps=args.steps)
        del exp
        chip_smoke.gc_card()
        port = chip_smoke.free_port()
        results = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        chip_smoke.run_ranks(
            [(rank_main, (r, tmp, dp_ini, t_ini, args.steps, port,
                          results[r])) for r in range(2)],
            chip_smoke.DP_TIMEOUT + chip_smoke.MA_TIMEOUT)
        ranks = []
        for path in results:
            with open(path) as f:
                ranks.append(json.load(f))
        one = chip_smoke.dp_train(dp_ini, os.path.join(tmp, "one"), ())
    for result in ranks:
        for mode, record in result.items():
            want = t_one if mode == "transformer" else one
            for run in (record.values() if mode == "transformer"
                        else [record]):
                run["distance_from_one_process"] = [
                    abs(a - b) for a, b in zip(run["losses"],
                                               want["losses"])]
    print(json.dumps({
        "device": smi, "package_root": os.path.abspath(args.package_root),
        "steps": args.steps, "one_process": {
            key: one[key] for key in ("losses", "train_tokens_per_sec",
                                      "max_memory_allocated")},
        "transformer_one_process": {
            key: t_one[key] for key in ("losses", "peak_bytes",
                                        "train_tokens_per_sec")},
        "two_ranks_on_one_card": ranks}))


if __name__ == "__main__":
    main()
