"""Three faults of the port against the JAX package, on the CPU.

- ``Experiment`` defaults to train mode, as the JAX ``Experiment`` does:
  every INI the port builds builds so, ``Experiment(ini).train()``
  trains, and the ``run`` CLI (which asks for inference mode) decodes
  from what it wrote.
- ``BeamSearchDecoder`` takes the JAX package's ``lineage`` switch:
  "auto" and "on" decode the JAX package's beam ids by lineage; "off"
  and ``NM_LINEAGE=0`` (read at each search) decode with the physical
  per-step reorder, the JAX package's ids too; the default resolves as
  the JAX package's ``test_lineage_default_resolution`` pins it ("on"
  over a decoder without lineage decoding raises its ValueError, "auto"
  over one decodes physically); any other value raises the JAX
  package's ValueError. ``tests/test_torch_beam_physical.py`` holds the
  physical search case by case.
- ``CUDAManager`` takes every keyword of the JAX ``TPUManager``: the
  mesh options build at their defaults and raise for any other value.
- Shapes past a kernel's limit take the plain path, as the JAX package
  takes its plain path past its gates: each gate is a function of
  shapes (K1, ``gru_bptt``, the LSTM kernels, K4's k), the shape just
  inside a limit keeps the kernel, the plain path gives the kernel
  path's numbers, and each (kernel, reason) is logged once. Flash
  attention and the lineage kernel take every positive head dim (their
  chunked instances past the single-pass widths), so the lineage
  layout follows ``NM_LINEAGE_KERNEL`` alone.
"""

import inspect
import os

import jax
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.beam_search_decoder import \
    BeamSearchDecoder as JaxBeamSearch
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.runtime import TPUManager
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch import run as torch_run
from neuralmonkey_tpu_torch.dataset import BatchingScheme
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.decoders.transformer import \
    lineage_kernel_layout
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.ops import (beam_select, cuda_rnn,
                                        flash_attention, kernel_config,
                                        lineage_attention, nn, rnn)
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.utils.saving import (flatten_tree,
                                                 params_from_jax)
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "tests", "configs")
BATCH, SRC, VOCAB, BEAM = 3, 7, 60, 4

# the INIs the port builds (the others name modules it lacks)
PORT_INIS = ["small", "vocab", "beamsearch", "factored", "transformer"]
# TPUManager's mesh options and their defaults
MESH_OPTIONS = {"num_model_shards": 1, "sequence_sharding": False,
                "num_pipeline_stages": 1, "num_expert_shards": 1,
                "fsdp": False, "shard_optimizer_state": False}
NON_DEFAULT = {"num_model_shards": 2, "sequence_sharding": True,
               "num_pipeline_stages": 2, "num_expert_shards": 4,
               "fsdp": True, "shard_optimizer_state": True}


def _on_cpu(tmp_path, *extra):
    return ['tf_manager.device="cpu"', f'main.output="{tmp_path / "out"}"',
            *extra]


# ---------------------------------------------------------------------- #
# C1: train mode by default
# ---------------------------------------------------------------------- #
def test_experiment_defaults_to_train_mode_as_jax():
    def default(cls):
        return inspect.signature(cls).parameters["train_mode"].default
    assert default(JaxExperiment) is True
    assert default(Experiment) is default(JaxExperiment)


@pytest.mark.parametrize("name", PORT_INIS)
def test_port_inis_build_in_train_mode(tmp_path, monkeypatch, name):
    """Train mode requires [main]'s training keys and warns of unused
    ones: each INI the port builds still builds so."""
    monkeypatch.chdir(REPO)
    exp = Experiment(os.path.join(CONFIGS, f"{name}.ini"),
                     config_changes=_on_cpu(tmp_path))
    assert exp.train_mode
    exp.build_model()
    assert exp.model.trainer is not None and exp.model.runners


def test_default_experiment_trains_and_run_decodes(tmp_path, monkeypatch):
    """``Experiment(ini).train()`` trains (with a default of False it
    raised "train() needs train_mode=True"); ``run`` decodes the
    validation sources from the best checkpoint it wrote."""
    monkeypatch.chdir(REPO)
    ini = os.path.join(CONFIGS, "small.ini")
    changes = _on_cpu(tmp_path, "main.epochs=1", "main.batch_size=32",
                      "main.validation_period=1000")
    Experiment(ini, config_changes=changes).train()
    out = tmp_path / "out"
    assert (out / "variables.data.best").exists()
    config = tmp_path / "exp.ini"
    config.write_text(open(ini).read().replace(
        'output="tests/outputs/small"', f'output="{out}"').replace(
        "[tf_manager]", '[tf_manager]\ndevice="cpu"'))
    data = tmp_path / "data.ini"
    data.write_text(
        "[main]\ntest_datasets=[<test_data>]\n\n[test_data]\n"
        "class=dataset.load_dataset_from_files\n"
        f's_source="{REPO}/tests/data/val.en"\n'
        f's_target_out="{tmp_path}/decoded.txt"\n')
    assert torch_run.main([str(config), str(data),
                           str(out / "variables.data.best")]) == 0
    with open(os.path.join(REPO, "tests", "data", "val.en")) as f:
        sources = f.read().splitlines()
    decoded = (tmp_path / "decoded.txt").read_text().splitlines()
    assert len(decoded) == len(sources) and any(decoded)


# ---------------------------------------------------------------------- #
# C2: the lineage switch of beam search
# ---------------------------------------------------------------------- #
def _rnn_decoder(enc_cls, att_cls, dec_cls, vocab_cls):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=16, rnn_size=16, max_input_len=SRC)
    att = att_cls(name="attention", encoder=enc, state_size=16)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=8, rnn_size=16, encoders=[enc],
                   attentions=[att], embedding_size=16,
                   conditional_gru=True)


def _port_decoder():
    return _rnn_decoder(SentenceEncoder, Attention, Decoder, Vocabulary)


def _source_batch():
    rng = np.random.RandomState(5)
    mask = np.zeros((BATCH, SRC), np.float32)
    for i, n in enumerate([7, 4, 2]):
        mask[i, :n] = 1.0
    return {"encoder_input.ids": rng.randint(4, VOCAB, (BATCH, SRC)).astype(
                np.int32),
            "encoder_input.mask": mask}


def _search_both(lineage, jax_dec=None, port_dec=None, env=None,
                 monkeypatch=None):
    """(the JAX package's beam search, the port's) of one draw of
    parameters under ``lineage``; ``env`` sets ``NM_LINEAGE`` after the
    searches are built, before they run."""
    jax_dec = jax_dec or _rnn_decoder(JaxSentenceEncoder, JaxAttention,
                                      JaxDecoder, JaxVocabulary)
    port_dec = port_dec or _port_decoder()
    rng = np.random.RandomState(4)
    template = jax_init(jax_collect_parts([jax_dec]), jax.random.PRNGKey(0))
    flat = {k: (np.asarray(v) + rng.randn(*v.shape) * 0.3).astype(
        np.float32) for k, v in jax_flatten(template).items()}
    batch = _source_batch()
    jax_bs = JaxBeamSearch(name="bs", parent_decoder=jax_dec,
                           beam_size=BEAM, lineage=lineage)
    port_bs = BeamSearchDecoder(name="bs", parent_decoder=port_dec,
                                beam_size=BEAM, lineage=lineage)
    if env is not None:
        monkeypatch.setenv("NM_LINEAGE", env)
    ref = jax_bs.search(JaxContext(
        jax_restore(template, flat),
        {k: jax.numpy.asarray(v) for k, v in batch.items()}))
    params = params_from_jax(flat, init_all_params(
        collect_parts([port_dec]), seed=0))
    with torch.inference_mode():
        got = port_bs.search(Context(
            params, {k: torch.from_numpy(v) for k, v in batch.items()}))
    return ref, got


def _assert_same_search(got, ref):
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(ref.token_ids))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               atol=1e-4)


def _count_steps(monkeypatch):
    """Count the port RNN's plain and lineage decode steps."""
    counts = {"decode_step": 0, "decode_step_lineage": 0}
    for name in counts:
        plain = getattr(Decoder, name)

        def counted(self, *args, _name=name, _plain=plain, **kwargs):
            counts[_name] += 1
            return _plain(self, *args, **kwargs)
        monkeypatch.setattr(Decoder, name, counted)
    return counts


@pytest.mark.parametrize("lineage", ["auto", "on"])
def test_beam_lineage_modes_decode_jax_ids(lineage):
    """The port's beam search under ``lineage`` equals the JAX package's
    under the same setting: ids, lengths and scores (1e-4)."""
    ref, got = _search_both(lineage)
    _assert_same_search(got, ref)


@pytest.mark.parametrize("lineage,env,when", [
    ("off", None, "build"),
    ("auto", "0", "build"),
    ("auto", "off", "build"),
    ("on", "0", "search")])
def test_beam_lineage_off_raises(monkeypatch, lineage, env, when):
    """Asking for the physical reorder, in the INI or through
    ``NM_LINEAGE`` (set before the search is built, or only before it
    runs), raises nothing: every step is the plain ``decode_step`` over
    B·K rows, never the lineage step, and the ids, lengths and scores
    (1e-4) are the JAX package's under the same setting."""
    if env is not None and when == "build":
        monkeypatch.setenv("NM_LINEAGE", env)
    counts = _count_steps(monkeypatch)
    ref, got = _search_both(lineage, env=env if when == "search" else None,
                            monkeypatch=monkeypatch)
    _assert_same_search(got, ref)
    assert counts["decode_step"] > 0 and counts["decode_step_lineage"] == 0


class _NoLineageDecoder(Decoder):
    lineage_decode = False


class _JaxNoLineageDecoder(JaxDecoder):
    lineage_decode = False


def test_lineage_default_resolution_as_jax(monkeypatch):
    """The JAX package's ``test_lineage_default_resolution``: "auto"
    resolves to lineage decoding, "off" to the physical reorder, "on"
    over a decoder without lineage decoding raises the JAX package's
    ValueError, and "auto" over one decodes physically, the JAX
    package's ids."""
    monkeypatch.delenv("NM_LINEAGE", raising=False)
    for mode, lineage in (("auto", True), ("off", False), ("on", True)):
        for search_cls, dec in ((JaxBeamSearch, _rnn_decoder(
                JaxSentenceEncoder, JaxAttention, JaxDecoder,
                JaxVocabulary)), (BeamSearchDecoder, _port_decoder())):
            assert search_cls(name="pin", parent_decoder=dec, beam_size=2,
                              lineage=mode)._use_lineage() is lineage
    jax_plain = _rnn_decoder(JaxSentenceEncoder, JaxAttention,
                             _JaxNoLineageDecoder, JaxVocabulary)
    port_plain = _rnn_decoder(SentenceEncoder, Attention, _NoLineageDecoder,
                              Vocabulary)
    errors = []
    for search_cls, dec in ((JaxBeamSearch, jax_plain),
                            (BeamSearchDecoder, port_plain)):
        forced = search_cls(name="pin", parent_decoder=dec, beam_size=2,
                            lineage="on")
        with pytest.raises(ValueError) as raised:
            forced._use_lineage()
        errors.append(str(raised.value))
    assert errors[1] == errors[0].replace("_JaxNoLineageDecoder",
                                          "_NoLineageDecoder")
    counts = _count_steps(monkeypatch)
    ref, got = _search_both("auto", jax_plain, port_plain)
    _assert_same_search(got, ref)
    assert counts["decode_step"] > 0 and counts["decode_step_lineage"] == 0


@pytest.mark.parametrize("lineage", ["sideways", "ON", ""])
def test_beam_lineage_unknown_value_raises_jax_error(lineage):
    jax_dec = _rnn_decoder(JaxSentenceEncoder, JaxAttention, JaxDecoder,
                           JaxVocabulary)
    with pytest.raises(ValueError) as want:
        JaxBeamSearch(name="bs", parent_decoder=jax_dec, beam_size=BEAM,
                      lineage=lineage)
    with pytest.raises(ValueError) as got:
        BeamSearchDecoder(name="bs", parent_decoder=_port_decoder(),
                          beam_size=BEAM, lineage=lineage)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------- #
# C3: the manager's keywords
# ---------------------------------------------------------------------- #
def test_manager_takes_every_tpu_manager_keyword():
    jax_params = inspect.signature(TPUManager).parameters
    port_params = inspect.signature(CUDAManager).parameters
    assert set(jax_params) <= set(port_params)
    for name in MESH_OPTIONS:
        assert port_params[name].default == jax_params[name].default \
            == MESH_OPTIONS[name]


@pytest.mark.parametrize("option", sorted(MESH_OPTIONS))
def test_mesh_option_at_its_default_builds(tmp_path, monkeypatch, option):
    """A [tf_manager] that sets the option to its default builds."""
    monkeypatch.chdir(REPO)
    exp = Experiment(os.path.join(CONFIGS, "small.ini"),
                     config_changes=_on_cpu(
                         tmp_path, f"tf_manager.{option}="
                         f"{MESH_OPTIONS[option]}"))
    exp.build_model()
    assert exp.tf_manager.device.type == "cpu"


# the ZeRO options and the model, context, pipe and expert axes are
# ported (parallel/). In one process an axis of 2 or 4 does not divide
# the world: the JAX package's error. sequence_sharding raises where the
# JAX manager warns and ignores it.
ZERO_OPTIONS = ("fsdp", "shard_optimizer_state")
OFF_DEFAULT = {
    "num_pipeline_stages": ({"num_pipeline_stages": 2}, ValueError,
                            "1 devices not divisible by pipe=2"),
    "num_expert_shards": ({"num_expert_shards": 4}, ValueError,
                          "1 devices not divisible by expert=4"),
    "num_model_shards": ({"num_model_shards": 2}, ValueError,
                         "1 devices not divisible by model=2"),
    "num_context_shards": ({"num_context_shards": 2}, ValueError,
                           "1 devices not divisible by context=2"),
    "sequence_sharding": ({"sequence_sharding": True}, ValueError,
                          "requires num_model_shards > 1"),
    "sequence_sharding-pipeline": (
        {"sequence_sharding": True, "num_model_shards": 2,
         "num_pipeline_stages": 2}, ValueError, "num_pipeline_stages"),
    "sequence_sharding-context": (
        {"sequence_sharding": True, "num_model_shards": 2,
         "num_context_shards": 2}, ValueError, "num_context_shards"),
    "sequence_sharding-no_model_shards": (
        {"sequence_sharding": True, "num_model_shards": 1}, ValueError,
        "requires num_model_shards > 1"),
}


@pytest.mark.parametrize("option", sorted(OFF_DEFAULT))
def test_mesh_option_off_its_default_raises(option):
    kwargs, error, match = OFF_DEFAULT[option]
    with pytest.raises(error, match=match):
        CUDAManager(device="cpu", **kwargs)


def _small_step(tmp_path, *extra):
    """small.ini built on the CPU with ``extra`` overrides: its first
    training step's losses and the parameters after it."""
    exp = Experiment(os.path.join(CONFIGS, "small.ini"),
                     config_changes=_on_cpu(tmp_path, *extra))
    exp.build_model()
    batch = next(exp.model.train_dataset.batches(
        exp.model.batching_scheme or BatchingScheme(
            batch_size=exp.model.batch_size), shuffled=False))
    losses = exp.tf_manager.train_on_batch(exp.model.trainer, batch,
                                           exp.model.batch_size)
    params = {k: v.detach().clone()
              for k, v in flatten_tree(exp.tf_manager.params).items()}
    return exp.tf_manager, losses, params


@pytest.mark.parametrize("option", ZERO_OPTIONS)
def test_zero_option_builds_and_trains(tmp_path, monkeypatch, option):
    """In one process ``fsdp`` and ``shard_optimizer_state`` build
    small.ini and leave its step as it is: the same losses and the same
    parameters after the step as without the option."""
    monkeypatch.chdir(REPO)
    _, plain_losses, plain = _small_step(tmp_path / "plain")
    manager, losses, params = _small_step(tmp_path / "zero",
                                          f"tf_manager.{option}=True")
    assert manager.shard_optimizer_state
    assert manager.fsdp == (option == "fsdp")
    assert losses == plain_losses
    assert set(params) == set(plain)
    for key, value in params.items():
        torch.testing.assert_close(value, plain[key], rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# queue C: shapes past the kernels' limits take the plain path
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("gate,inside,past", [
    (cuda_rnn.scan_fits, 19368, 19369),
    (cuda_rnn.bptt_fits, 7264, 7265),
    (cuda_rnn.lstm_scan_fits, 8300, 8301),
    (flash_attention.kernel_takes, 4096, 0),
    (lineage_attention.kernel_takes, 4096, 0),
    (beam_select.topk_kernel_takes, 64, 65),
], ids=["gru_scan", "gru_bptt", "lstm", "flash", "lineage", "small_topk"])
def test_gates_keep_the_kernel_to_its_limit(gate, inside, past):
    assert gate(inside) and gate(1)
    assert not gate(past)


def test_gru_serving_keeps_k1_past_the_bptt_limit():
    assert cuda_rnn.scan_fits(8192) and not cuda_rnn.bptt_fits(8192)
    assert cuda_rnn.scan_fits(512) and cuda_rnn.bptt_fits(512)


@pytest.mark.parametrize("head_dim", [192, 512, 384, 640, 520])
def test_lineage_layout_follows_the_kernels_head_dims(monkeypatch,
                                                      head_dim):
    """The kernel takes every head dim (one pass to 512, the chunked
    instance past it), so the kernel layout follows the switch alone:
    ``NM_LINEAGE_KERNEL=1`` at any head dim and cache length, the einsum
    form without it."""
    assert lineage_attention.kernel_takes(head_dim)
    assert not lineage_kernel_layout()
    monkeypatch.setenv("NM_LINEAGE_KERNEL", "1")
    assert lineage_kernel_layout()
    plan = lineage_attention.lineage_plan(2, 2, 10, head_dim, 480, 480,
                                          132, 232448)
    assert plan.column_blocks == (-(-head_dim // 512) if head_dim > 512
                                  else 1)


def _rnn_step(cell, hidden):
    """Loss and gradients of one scan over a ragged batch."""
    gen = torch.Generator().manual_seed(3)
    model = cell(5, hidden)
    params = {k: v.requires_grad_() for k, v in model.init(gen).items()}
    x = torch.randn(3, 4, 5, generator=gen, requires_grad=True)
    mask = torch.tensor([[1.0, 1, 1, 1], [1, 1, 0, 0], [1, 0, 0, 0]])
    out, final = rnn.bidirectional_rnn(model, params, model, params, x,
                                       mask)
    loss = out.square().sum() + final.sum()
    grads = torch.autograd.grad(loss, [x, *params.values()])
    return loss.detach(), grads


@pytest.mark.parametrize("cell,limit,kernel", [
    (nn.GRUCell, "bptt_fits", "gru_bptt"),
    (nn.GRUCell, "scan_fits", "gru_scan"),
    (nn.LSTMCell, "lstm_scan_fits", "lstm_scan"),
])
def test_plain_path_past_a_limit_matches_and_logs_once(
        monkeypatch, capsys, cell, limit, kernel):
    """With a limit lowered under the hidden size, the call takes the
    plain path (the BPTT reference, or the plain scan whole under
    autograd), gives the kernel path's loss and gradients, and logs the
    plain path once."""
    want = _rnn_step(cell, 6)
    monkeypatch.setattr(cuda_rnn, limit, lambda hidden: False)
    monkeypatch.setattr(kernel_config, "_PLAIN_PATHS", set())
    for _ in range(2):
        got = _rnn_step(cell, 6)
    torch.testing.assert_close(got[0], want[0], atol=1e-6, rtol=1e-6)
    for g, w in zip(got[1], want[1]):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    logged = [line for line in capsys.readouterr().out.splitlines()
              if "plain PyTorch path" in line]
    assert len(logged) == 1 and f"{kernel}: hidden 6" in logged[0]


def test_topk_past_k_64_takes_the_plain_version():
    x = torch.round(torch.randn(3, 200, generator=torch.Generator()
                                .manual_seed(0)) * 2)
    got = beam_select.small_topk(x, 65)
    ref = beam_select.topk_reference(x, 65)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
