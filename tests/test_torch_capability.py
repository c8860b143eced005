"""The task-head INIs through the port on the CPU, each held to its gate
in tests/test_capability_inis.py: each trains to its end with a falling
loss and a validation metric past the JAX package's limit.

| INI | metric | gate |
|---|---|---|
| labeler.ini | tags/Accuracy | > 0.5 |
| language_model.ini | xents | > 0 |
| post_edit.ini | edits_out/BLEU-4 | > 10 |
| regressor.ini | score/MSE | < 0.01 |
| alignment.ini | target/BLEU-4 | > 20 |
| str.ini | target/MSE | < 2.0 |
"""

import json
import os
import operator

import pytest
import torch

from neuralmonkey_tpu_torch.experiment import Experiment

torch.set_num_threads(2)
CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

GATES = [
    ("labeler.ini", "tags/Accuracy", operator.gt, 0.5),
    ("language_model.ini", "xents", operator.gt, 0.0),
    ("post_edit.ini", "edits_out/BLEU-4", operator.gt, 10.0),
    ("regressor.ini", "score/MSE", operator.lt, 0.01),
    ("alignment.ini", "target/BLEU-4", operator.gt, 20.0),
    ("str.ini", "target/MSE", operator.lt, 2.0),
]


@pytest.mark.parametrize("config,metric,compare,limit", GATES,
                         ids=[g[0] for g in GATES])
def test_capability_ini_clears_its_gate(tmp_path, config, metric, compare,
                                        limit):
    out = str(tmp_path / "out")
    exp = Experiment(os.path.join(CONFIG_DIR, config), train_mode=True,
                     config_changes=['tf_manager.device="cpu"',
                                     f'main.output="{out}"',
                                     "main.logging_period=10"])
    exp.train()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["kind"] == "train"]
    val = [r for r in records if r["kind"] == "val"]
    assert train[-1]["loss"] < train[0]["loss"], "loss did not decrease"
    assert val and compare(val[-1][metric], limit), val[-1]
