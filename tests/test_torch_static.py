"""Static checks and an INI sweep for the port, on the CPU.

- The lint tier (``tests/lint_run.py``: every module compiles, no unused
  import) over each file of ``neuralmonkey_tpu_torch/`` and
  ``chip_smoke.py``.
- The type tier's three checks (``tests/typecheck_run.py``: annotations
  resolve, overrides keep their base's parameters, every public
  function annotates a parameter) with its ``PACKAGE`` set to the port.
- Every INI in ``tests/configs/`` built through the port on the CPU:
  the experiment INIs that the port runs build; each other one raises a
  ``ConfigBuildException`` that names the section whose symbol the port
  lacks; the data INI builds its datasets as ``run`` reads them.
"""

import importlib.util
import os

import pytest

from neuralmonkey_tpu_torch.config.exceptions import ConfigBuildException
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.run import load_data_config

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
PORT = os.path.join(REPO, "neuralmonkey_tpu_torch")
CONFIG_DIR = os.path.join(TESTS, "configs")

BUILDS = ["alignment.ini", "beamsearch.ini", "factored.ini", "labeler.ini",
          "language_model.ini", "post_edit.ini", "regressor.ini",
          "small.ini", "str.ini", "transformer.ini", "vocab.ini"]
# INI -> the section whose class (or option) the port does not have yet
NOT_YET = {"audio_classifier.ini": "audio_reader",
           "captioning.ini": "train_data",
           "classifier.ini": "classifier",
           "ctc.ini": "audio_reader",
           "flat_multiattention.ini": "train_data",
           "hier_multimodal.ini": "train_data",
           "moe.ini": "encoder",
           "self_critical.ini": "trainer",
           "sentence_cnn.ini": "encoder"}
DATA_INIS = ["small_data.ini"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TESTS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port_files():
    files = [os.path.relpath(os.path.join(root, name), REPO)
             for root, _, names in os.walk(PORT) for name in names
             if name.endswith(".py")]
    return sorted(files) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files())
def test_lint_clean(path):
    assert _load("lint_run").check_file(os.path.join(REPO, path)) == []


@pytest.mark.parametrize("check", ["check_annotations_resolve",
                                   "check_override_compat",
                                   "check_annotation_coverage"])
def test_typecheck_clean(monkeypatch, check):
    typecheck = _load("typecheck_run")
    monkeypatch.setattr(typecheck, "PACKAGE", "neuralmonkey_tpu_torch")
    problems = []
    getattr(typecheck, check)(problems)
    assert sorted(set(problems)) == []


def test_sweep_covers_every_ini():
    assert sorted(BUILDS + list(NOT_YET) + DATA_INIS) == sorted(
        name for name in os.listdir(CONFIG_DIR) if name.endswith(".ini"))


def _experiment(name, tmp_path):
    return Experiment(os.path.join(CONFIG_DIR, name), config_changes=[
        'tf_manager.device="cpu"', f'main.output="{tmp_path / "out"}"'])


@pytest.mark.parametrize("name", BUILDS)
def test_ini_builds_through_the_port(name, tmp_path):
    exp = _experiment(name, tmp_path)
    exp.build_model()
    assert exp.tf_manager.device.type == "cpu"
    assert exp.tf_manager.parts


@pytest.mark.parametrize("name", sorted(NOT_YET))
def test_ini_names_the_section_the_port_lacks(name, tmp_path):
    with pytest.raises(ConfigBuildException) as err:
        _experiment(name, tmp_path).build_model()
    assert err.value.object_name == NOT_YET[name]
    assert f"'{NOT_YET[name]}'" in str(err.value)


@pytest.mark.parametrize("name", DATA_INIS)
def test_data_ini_builds_its_datasets(name):
    datasets = load_data_config(os.path.join(CONFIG_DIR, name))
    assert datasets and all(d.has_series("source") for d in datasets)
