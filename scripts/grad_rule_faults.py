#!/usr/bin/env python3
"""Planted faults in the flash backward kernels, read against the
Transformer training-parity rule of ``chip_smoke.py`` (its phase 12).

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 scripts/grad_rule_faults.py

It trains bench.py's Transformer for the smoke's 20 steps (phase 11),
then takes phase 12's step from that checkpoint (card against a float64
CPU step, residual dropout off, attention dropout on) once with the
kernels as they are and once for each fault in ``FAULTS``. Each pass
runs in a fresh process on a copy of the package, made in a temporary
directory, whose ``csrc/flash_attention.cu`` carries that one edit (none
for the sound pass), built there. For every pass it prints the least
``GRAD_SPREAD`` under which the pass would hold (``spread_needed``): the
rule is sound when ``chip_smoke.GRAD_SPREAD`` lies above the sound
pass's and below every fault's, and the script exits 1 otherwise. The
last line is one JSON object with the readings.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (text in csrc/flash_attention.cu, its replacement)
FAULTS = {
    "sound": None,
    # dq without its final 1/sqrt(head dim)
    "dq_scale_dropped": ("acc[i], scale,", "acc[i], 1.f,"),
    # dV from the undropped probabilities
    "dv_undropped_p": ("pd = keep ? p * drop.inv_keep : 0.f;", "pd = p;"),
    # dS, and so dK, from the dropped probabilities
    "dk_dropped_p": ("ds = p * (g - sdcap[r]);",
                     "ds = pd * (g - sdcap[r]);"),
    # dq's keep bits read one hash counter further on
    "dq_hash_shifted": (
        "g = keep_bit(drop, bh, static_cast<uint32_t>(qi) * Tk + key)",
        "g = keep_bit(drop, bh, static_cast<uint32_t>(qi) * Tk + key + 1)"),
}


def planted_copy(tmp: str, name: str) -> str:
    """A copy of the package under ``tmp/name`` with fault ``name``'s
    edit; returns the directory to put first on ``sys.path``."""
    root = os.path.join(tmp, name)
    package = os.path.join(root, "neuralmonkey_tpu_torch")
    shutil.copytree(os.path.join(REPO, "neuralmonkey_tpu_torch"), package,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if FAULTS[name] is not None:
        source = os.path.join(package, "csrc", "flash_attention.cu")
        with open(source) as f:
            text = f.read()
        old, new = FAULTS[name]
        if text.count(old) != 1:
            raise AssertionError(f"{name}: {old!r} occurs {text.count(old)} "
                                 "times in flash_attention.cu, not once")
        with open(source, "w") as f:
            f.write(text.replace(old, new))
    return root


def child(root: str, train_ini: str, ckpt: str) -> int:
    """One parity pass with the package under ``root``."""
    sys.path[:0] = [root, REPO]
    import torch

    import chip_smoke
    import neuralmonkey_tpu_torch
    from neuralmonkey_tpu_torch.ops import kernel_config
    if not neuralmonkey_tpu_torch.__file__.startswith(root):
        raise AssertionError(f"imported {neuralmonkey_tpu_torch.__file__}, "
                             f"not the copy under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_config.reset_launch_counts()
    report = chip_smoke.check_train_parity(
        train_ini, ckpt, ("encoder", "decoder"), True, check=False)
    counts = kernel_config.launch_counts()
    if not all(counts[k] > 0 for k in chip_smoke.FLASH_KERNELS):
        raise AssertionError(f"the flash kernels did not launch: {counts}")
    print(json.dumps(report))
    return 0


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--child":
        return child(*sys.argv[2:])
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    readings = {}
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_inputs(tmp)
        chip_smoke.write_training_inputs(tmp)
        train_ini = chip_smoke.write_transformer_ini(
            tmp, "t_train.ini", chip_smoke.T_TRAINING_MAIN, 0.9,
            chip_smoke.T_ATT_KEEP)
        _, _, ckpt = chip_smoke.run_training(
            tmp, train_ini, False, "t_train", chip_smoke.FLASH_KERNELS)
        for name in FAULTS:
            root = planted_copy(tmp, name)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", root,
                 train_ini, ckpt], capture_output=True, text=True,
                timeout=900)
            sys.stderr.write(proc.stderr[-3000:])
            if proc.returncode != 0:
                raise AssertionError(f"{name}: the pass failed "
                                     f"({proc.returncode})")
            report = json.loads(proc.stdout.strip().splitlines()[-1])
            readings[name] = {form: {k: report[form][k] for k in (
                "spread_needed", "spread_needed_at", "grad_rel_err_max",
                "grad_rel_err_max_at")} for form in ("plain", "fused")}
            print(f"{name}: " + ", ".join(
                f"{form} needs spread {r['spread_needed']:.4g} (at "
                f"{r['spread_needed_at']}), largest deviation "
                f"{r['grad_rel_err_max']:.4g}"
                for form, r in readings[name].items()), flush=True)

    spread = chip_smoke.GRAD_SPREAD
    sound = max(r["spread_needed"] for r in readings["sound"].values())
    faults = min(r["spread_needed"] for name, forms in readings.items()
                 if name != "sound" for r in forms.values())
    ok = sound <= spread < faults
    print(smi)
    print(json.dumps({"device": smi, "grad_spread": spread,
                      "sound_needs": sound, "least_fault_needs": faults,
                      "rule_separates": ok, "readings": readings}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
