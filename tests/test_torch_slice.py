"""The PyTorch port's serving path end to end against the JAX package.

One inference-only copy of tests/configs/beamsearch.ini (greedy and
hierarchical beam search, small widths) is built by both packages; the
port loads the JAX parameters and must decode the same ids with the
same beam scores, through the runners' fetches and through the ``run``
CLI. The port's copy of the INI asks for the CPU
(``[tf_manager] device="cpu"``), which the JAX manager does not take.
Subprocesses check that neither the port nor ``chip_smoke.py`` imports
JAX or the JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten

from neuralmonkey_tpu_torch import run as torch_run
from neuralmonkey_tpu_torch import runtime
from neuralmonkey_tpu_torch.config.exceptions import ConfigBuildException
from neuralmonkey_tpu_torch.dataset import Dataset
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import Context
from neuralmonkey_tpu_torch.utils.saving import params_from_jax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
BATCH = 3

EXPERIMENT_INI = """\
; inference-only copy of tests/configs/beamsearch.ini at small widths
[main]
name="beam search test"
tf_manager=<tf_manager>
output="{out}"
batch_size={batch}
runners=[<runner>, <bs_runner>]
postprocess=None
evaluation=[("target_beam", "target", evaluators.bleu.BLEU), ("target", evaluators.bleu.BLEU)]
random_seed=1234

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1
{manager_extra}

[train_data]
class=dataset.load_dataset_from_files
s_source="{data}/train.en"
s_target="{data}/train.de"

[encoder_vocabulary]
class=vocabulary.from_dataset
datasets=[<train_data>]
series_ids=["source"]
max_size=300

[decoder_vocabulary]
class=vocabulary.from_dataset
datasets=[<train_data>]
series_ids=["target"]
max_size=300

[encoder]
class=encoders.recurrent.SentenceEncoder
name="sentence_encoder"
rnn_size=16
max_input_len=7
embedding_size=16
dropout_keep_prob=0.8
data_id="source"
vocabulary=<encoder_vocabulary>

[attention]
class=attention.feed_forward.Attention
name="attention_sentence_encoder"
encoder=<encoder>
state_size=16

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size=16
embedding_size=16
dropout_keep_prob=0.8
data_id="target"
max_output_len=6
vocabulary=<decoder_vocabulary>
{decoder_extra}

[bs_decoder]
class=decoders.beam_search_decoder.BeamSearchDecoder
name="bs_decoder"
parent_decoder=<decoder>
beam_size=4
length_normalization=0.6
selection_method="{selection}"

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="target"

[bs_runner]
class=runners.beam_search_runner.BeamSearchRunner
decoder=<bs_decoder>
output_series="target_beam"
rank=1
"""

DATA_INI = """\
[main]
test_datasets=[<val_data>]

[val_data]
class=dataset.load_dataset_from_files
s_source="{data}/val.en"
s_target_out="{out}/greedy.txt"
s_target_beam_out="{out}/beam.txt"
"""


def _write_experiment(tmp_path, selection="hierarchical", decoder_extra="",
                      port=False):
    """The INI for the JAX package, or with ``port`` the port's copy,
    which asks for the CPU."""
    path = tmp_path / f"exp_{selection}{'_port' if port else ''}.ini"
    path.write_text(EXPERIMENT_INI.format(
        out=tmp_path / "out", batch=BATCH, data=DATA, selection=selection,
        decoder_extra=decoder_extra,
        manager_extra='device="cpu"' if port else ""))
    return str(path)


def _source_dataset(n):
    with open(os.path.join(DATA, "val.en"), encoding="utf-8") as f:
        sentences = [line.split() for line in f][:n]
    return Dataset("val", {"source": sentences})


def _both_models(ini):
    jax_exp = JaxExperiment(ini, train_mode=False)
    jax_exp.build_model()
    torch_exp = Experiment(ini, config_changes=['tf_manager.device="cpu"'])
    torch_exp.build_model()
    manager = torch_exp.tf_manager
    manager.params = params_from_jax(
        jax_flatten(jax_exp.tf_manager.params), manager.params)
    return jax_exp, torch_exp


def _fetch_both(jax_exp, torch_exp, dataset):
    jax_batch, _ = jax_exp.tf_manager.build_batch(dataset, BATCH)
    jax_ctx = JaxContext(jax_exp.tf_manager.params, jax_batch)
    torch_batch, _ = torch_exp.tf_manager.build_batch(dataset, BATCH)
    with torch.inference_mode():
        torch_ctx = Context(torch_exp.tf_manager.params, torch_batch)
        fetched = []
        for jax_runner, torch_runner in zip(jax_exp.model.runners,
                                            torch_exp.model.runners):
            jax_out = {k: np.asarray(v)
                       for k, v in jax_runner.fetches(jax_ctx).items()}
            torch_out = {k: v.numpy()
                         for k, v in torch_runner.fetches(torch_ctx).items()}
            fetched.append((jax_out, torch_out))
    return fetched


@pytest.mark.parametrize("selection,decoder_extra", [
    ("hierarchical", ""),
    ("hierarchical", "conditional_gru=True"),
    ("flat", ""),
])
def test_slice_decodes_like_jax(tmp_path, selection, decoder_extra):
    """Greedy ids, beam ids and beam scores of the port equal the JAX
    package's on one batch, from the same parameters (scores to 1e-4)."""
    ini = _write_experiment(tmp_path, selection, decoder_extra)
    jax_exp, torch_exp = _both_models(ini)
    (jg, tg), (jb, tb) = _fetch_both(jax_exp, torch_exp,
                                     _source_dataset(BATCH))
    np.testing.assert_array_equal(tg["decoded"], jg["decoded"])
    np.testing.assert_array_equal(tb["token_ids"], jb["token_ids"])
    np.testing.assert_array_equal(tb["lengths"], jb["lengths"])
    np.testing.assert_allclose(tb["scores"], jb["scores"], atol=1e-4)


def test_run_cli_writes_jax_outputs(tmp_path):
    """``python -m neuralmonkey_tpu_torch.run exp.ini data.ini ckpt`` on
    a JAX checkpoint writes the sentences the JAX package decodes."""
    ini = _write_experiment(tmp_path)
    jax_exp = JaxExperiment(ini, train_mode=False)
    jax_exp.build_model()
    port_ini = _write_experiment(tmp_path, port=True)
    ckpt = tmp_path / "jax_params.npz"
    with open(ckpt, "wb") as f:
        np.savez(f, **jax_flatten(jax_exp.tf_manager.params))
    data_ini = tmp_path / "data.ini"
    data_ini.write_text(DATA_INI.format(data=DATA, out=tmp_path / "out"))

    assert torch_run.main([port_ini, str(data_ini), str(ckpt)]) == 0

    dataset = _source_dataset(None)
    _, jax_outputs = jax_exp.run_model(dataset)
    for series, name in (("target", "greedy.txt"),
                         ("target_beam", "beam.txt")):
        with open(tmp_path / "out" / name, encoding="utf-8") as f:
            written = [line.rstrip("\n") for line in f]
        assert len(written) == len(dataset)
        assert written == [" ".join(s) for s in jax_outputs[series]]


def test_unported_section_names_itself(tmp_path):
    """A config section whose class the port lacks (here an optimizer
    not ported yet) raises a ConfigBuildException naming that
    section."""
    ini = _write_experiment(tmp_path, port=True)
    text = open(ini).read().replace(
        "random_seed=1234",
        "random_seed=1234\ntrainer=<trainer>") + (
        "\n[trainer]\nclass=trainers.cross_entropy_trainer."
        "CrossEntropyTrainer\ndecoders=[<decoder>]\noptimizer=<rmsprop>\n"
        "\n[rmsprop]\nclass=tf.train.RMSPropOptimizer\n")
    with open(ini, "w") as f:
        f.write(text)
    with pytest.raises(ConfigBuildException, match="rmsprop"):
        Experiment(ini).build_model()


def test_compute_dtype_raises(tmp_path):
    ini = _write_experiment(tmp_path, port=True)
    with pytest.raises(ValueError, match="bf16 policy not yet ported"):
        Experiment(ini, config_changes=['main.compute_dtype="bfloat16"']
                   ).build_model()


_NO_JAX_CHECK = (
    "import sys\n"
    "bad = sorted(k for k in sys.modules if k == 'jax'\n"
    "             or k.startswith('jax.') or k == 'neuralmonkey_tpu'\n"
    "             or k.startswith('neuralmonkey_tpu.'))\n"
    "assert not bad, bad[:5]\n"
    "print('ok')\n")


@pytest.mark.parametrize("imports", [
    # every module of the port
    "import importlib, pkgutil\n"
    "import neuralmonkey_tpu_torch as p\n"
    "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
    "    importlib.import_module(m.name)\n",
    # chip_smoke.py, with everything its phases import
    "import chip_smoke\n"
    "chip_smoke.import_everything()\n",
], ids=["port", "chip_smoke"])
def test_port_imports_no_jax(imports):
    """Importing every module of the port, or ``chip_smoke.py`` and all
    it imports, leaves JAX and the JAX package unimported."""
    proc = subprocess.run([sys.executable, "-c", imports + _NO_JAX_CHECK],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def test_manager_without_a_card_raises(monkeypatch):
    """With no visible card and no ``device``, the manager raises and
    names the way to ask for the CPU; nothing falls back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        runtime.CUDAManager()
    assert runtime.CUDAManager(device="cpu").device.type == "cpu"
