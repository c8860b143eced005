"""The Transformer quality gate of tests/test_quality_gates.py through
the port: tests/configs/transformer.ini trained on the synthesized digit
corpus with the gate's overrides must decode >90 BLEU on a training
sample and >90 on the checked-in validation set.

The training starts from the JAX package's initial parameters for this
INI and seed, so that the gate holds the port's training (delayed
updates, noam, label smoothing, flash attention's plain version), not
one draw of its initializer.
"""

import os

import torch

import bench
from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten

from neuralmonkey_tpu_torch.dataset import load_dataset_from_files
from neuralmonkey_tpu_torch.evaluators.bleu import BLEU
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.processors.bpe import BPEPreprocessor
from neuralmonkey_tpu_torch.utils.saving import params_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
CONFIG = os.path.join(REPO, "tests", "configs", "transformer.ini")


def _bleu(exp, src, ref, limit=None):
    bpe = BPEPreprocessor(merge_file=os.path.join(DATA, "merges.bpe"))
    dataset = load_dataset_from_files(
        name="q", s_source=src, s_target=ref,
        preprocessors=[("source", "source_bpe", bpe),
                       ("target", "target_bpe", bpe)])
    _, outputs = exp.run_model(dataset)
    refs = list(dataset.get_series("target"))
    n = limit or len(refs)
    return BLEU(outputs["target"][:n], refs[:n])


def test_port_transformer_quality_gate(tmp_path):
    src, tgt = bench.synthesize_digit_corpus(str(tmp_path))
    changes = [f'main.output="{tmp_path / "out"}"', "main.epochs=14",
               "main.validation_period=50000", "main.logging_period=400",
               f'train_data.s_source="{src}"', f'train_data.s_target="{tgt}"',
               "encoder.dropout_keep_prob=1.0",
               "decoder.dropout_keep_prob=1.0"]
    jax_exp = JaxExperiment(CONFIG, train_mode=True, config_changes=changes)
    jax_exp.build_model()
    exp = Experiment(CONFIG, train_mode=True,
                     config_changes=changes + ['tf_manager.device="cpu"'])
    exp.build_model()
    exp.tf_manager.params = params_from_jax(
        jax_flatten(jax_exp.tf_manager.params), exp.tf_manager.params)
    exp.train()
    scores = {"train": _bleu(exp, src, tgt, limit=100),
              "val": _bleu(exp, os.path.join(DATA, "val.en"),
                           os.path.join(DATA, "val.de"))}
    assert scores["train"] > 90.0, scores
    assert scores["val"] > 90.0, scores
