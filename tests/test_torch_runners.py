"""The port's runners against the JAX package's, on the CPU.

Tiny models, one numpy draw of parameters loaded into both packages (the
JAX tree's structure from ``jax.eval_shape``, its fetches under
``jax.jit``). Each runner's fetches agree to 1e-5 and its
``collect_results`` on the same fetched arrays gives the JAX runner's
outputs:

- the greedy runner's loss fetches (``train_xent``, ``runtime_xent``)
  when the batch carries targets, for the RNN and the Transformer (label
  smoothing 0.1); an INI with no evaluator tracks ``.best`` by
  ``runtime_xent`` in both packages;
- ``LogitsRunner`` (a labeler's probabilities and logits, one picked
  entry, a decoder's teacher-forced logits), ``TensorRunner`` (named
  tensors and a ``params`` path, which the manager brings to the host
  as float32 under the bf16 policy too), ``RepresentationRunner`` (its
  ``used_session`` refusal, a kept divergence) and ``CTCDebugRunner``;
- ``run --grid``: ``_grid_windows`` on the JAX package's nine cases and
  ``grid_decode`` of labeler.ini at ``max_input_len=6`` writing the JAX
  package's file.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu import run as jax_run
from neuralmonkey_tpu.dataset import Dataset as JaxDataset
from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.ctc_decoder import \
    CTCDecoder as JaxCTCDecoder
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.decoders.sequence_labeler import \
    SequenceLabeler as JaxSequenceLabeler
from neuralmonkey_tpu.models.decoders.transformer import \
    TransformerDecoder as JaxTransformerDecoder
from neuralmonkey_tpu.models.encoders.raw_rnn_encoder import \
    RawRNNEncoder as JaxRawRNNEncoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.models.encoders.transformer import \
    TransformerEncoder as JaxTransformerEncoder
from neuralmonkey_tpu.runners import ctc_debug_runner as jax_ctc_debug
from neuralmonkey_tpu.runners import logits_runner as jax_logits
from neuralmonkey_tpu.runners import representation_runner as jax_repr
from neuralmonkey_tpu.runners import runner as jax_runner
from neuralmonkey_tpu.runners import tensor_runner as jax_tensor
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch import run as torch_run
from neuralmonkey_tpu_torch.dataset import Dataset
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.ctc_decoder import CTCDecoder
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.decoders.sequence_labeler import \
    SequenceLabeler
from neuralmonkey_tpu_torch.models.decoders.transformer import \
    TransformerDecoder
from neuralmonkey_tpu_torch.models.encoders.raw_rnn_encoder import \
    RawRNNEncoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.models.encoders.transformer import \
    TransformerEncoder
from neuralmonkey_tpu_torch.runners import (ctc_debug_runner, logits_runner,
                                            representation_runner, runner,
                                            tensor_runner)
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "tests", "configs")
BATCH, SRC, TGT, WIDTH, VOCAB = 3, 7, 6, 16, 60
SRC_LENGTHS, TGT_LENGTHS = [7, 4, 2], [6, 3, 1]
ATOL = 1e-5


def _shared(jax_root, port_root, seed=0, scale=0.3):
    """(JAX params, port params): one numpy draw loaded into both."""
    jax_shapes = jax.eval_shape(lambda: jax_init(
        jax_collect_parts([jax_root]), jax.random.PRNGKey(0)))
    template = init_all_params(collect_parts([port_root]), seed=0)
    rng = np.random.RandomState(seed)
    flat = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
            for k, v in sorted(flatten_tree(template).items())}
    return jax_restore(jax_shapes, flat), params_from_jax(flat, template)


def _mask(lengths, time):
    return np.array([[1.0] * n + [0.0] * (time - n) for n in lengths],
                    np.float32)


def _batch(targets=True):
    rng = np.random.RandomState(11)
    batch = {"encoder_input.ids": rng.randint(4, VOCAB, (BATCH, SRC)
                                              ).astype(np.int32),
             "encoder_input.mask": _mask(SRC_LENGTHS, SRC)}
    if targets:
        batch.update({
            "decoder.train_inputs": rng.randint(1, VOCAB, (BATCH, TGT)
                                                ).astype(np.int32),
            "decoder.train_targets": rng.randint(2, VOCAB, (BATCH, TGT)
                                                 ).astype(np.int32),
            "decoder.train_mask": _mask(TGT_LENGTHS, TGT)})
    return batch


def _fetch_both(jax_runner_obj, port_runner_obj, jax_params, params, batch):
    """Each runner's fetches on one batch: (JAX's, the port's), numpy."""
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax.jit(lambda p: jax_runner_obj.fetches(JaxContext(
        p, jax_batch)))(jax_params)
    with torch.inference_mode():
        got = port_runner_obj.fetches(Context(
            params, {k: torch.from_numpy(v) for k, v in batch.items()}))
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.detach().numpy() for k, v in got.items()})


def _assert_fetches_match(ref, got, exact=()):
    assert set(got) == set(ref)
    for key in ref:
        if key in exact:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], ref[key], atol=ATOL,
                                       rtol=0, err_msg=key)


def _rnn(enc_cls, att_cls, dec_cls, vocab_cls):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, rnn_size=WIDTH, max_input_len=SRC)
    att = att_cls(name="attention", encoder=enc, state_size=WIDTH)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=TGT, rnn_size=WIDTH, encoders=[enc],
                   attentions=[att], embedding_size=WIDTH,
                   conditional_gru=True)


def _transformer(enc_cls, dec_cls, vocab_cls):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, ff_hidden_size=32, depth=2,
                  n_heads=2, max_input_len=SRC)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=TGT, encoders=[enc], embedding_size=WIDTH,
                   ff_hidden_size=32, depth=2, n_heads_self=2, n_heads_enc=2,
                   label_smoothing=0.1)


DECODERS = {
    "rnn": (lambda: _rnn(JaxSentenceEncoder, JaxAttention, JaxDecoder,
                         JaxVocabulary),
            lambda: _rnn(SentenceEncoder, Attention, Decoder, Vocabulary)),
    "transformer": (lambda: _transformer(JaxTransformerEncoder,
                                         JaxTransformerDecoder,
                                         JaxVocabulary),
                    lambda: _transformer(TransformerEncoder,
                                         TransformerDecoder, Vocabulary)),
}


# ---------------------------------------------------------------------- #
# the greedy runner's loss fetches
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["rnn", "transformer"])
def test_greedy_runner_fetches_the_losses_as_jax(kind):
    """With targets in the batch: the greedy ids, ``train_xent`` and
    ``runtime_xent`` (the greedy path's logits against the targets);
    without, the ids alone."""
    jax_dec, dec = DECODERS[kind][0](), DECODERS[kind][1]()
    jax_params, params = _shared(jax_dec, dec)
    jax_r = jax_runner.GreedyRunner("target", jax_dec)
    port_r = runner.GreedyRunner("target", dec)
    assert port_r.loss_names == jax_r.loss_names
    ref, got = _fetch_both(jax_r, port_r, jax_params, params, _batch())
    assert set(ref) == {"decoded", "train_xent", "runtime_xent"}
    _assert_fetches_match(ref, got, exact=("decoded",))
    want = jax_r.collect_results(ref, BATCH)
    result = port_r.collect_results(ref, BATCH)
    assert result.outputs == want.outputs
    assert result.losses == want.losses
    ref, got = _fetch_both(jax_r, port_r, jax_params, params,
                           _batch(targets=False))
    assert set(got) == {"decoded"}
    _assert_fetches_match(ref, got, exact=("decoded",))


def test_ini_without_evaluator_tracks_best_by_runtime_xent(tmp_path,
                                                           monkeypatch):
    """small.ini with ``evaluation=[]``: validation has no main metric,
    so both packages track the best checkpoint by ``runtime_xent`` and
    point ``variables.data.best`` at it."""
    monkeypatch.chdir(REPO)
    ini = os.path.join(CONFIGS, "small.ini")
    changes = ["main.evaluation=[]", "main.epochs=1", "main.batch_size=32",
               "main.validation_period=1000"]
    JaxExperiment(ini, config_changes=[
        *changes, f'main.output="{tmp_path / "jax"}"']).train()
    Experiment(ini, config_changes=[
        *changes, f'main.output="{tmp_path / "port"}"',
        'tf_manager.device="cpu"']).train()
    for name in ("jax", "port"):
        assert (tmp_path / name / "variables.data.best").exists(), name
    log = (tmp_path / "port" / "experiment.log").read_text()
    assert "runtime_xent" in log and "tracking skipped" not in log


# ---------------------------------------------------------------------- #
# logits, tensor, representation and CTC debug runners
# ---------------------------------------------------------------------- #
def _labeler(enc_cls, lab_cls, vocab_cls):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, rnn_size=WIDTH, max_input_len=SRC)
    return lab_cls(name="labeler", encoder=enc,
                   vocabulary=vocab_cls(["N", "V", "A", "D", "X"]),
                   data_id="tags", hidden_dim=WIDTH)


def _labelers():
    jax_lab = _labeler(JaxSentenceEncoder, JaxSequenceLabeler, JaxVocabulary)
    lab = _labeler(SentenceEncoder, SequenceLabeler, Vocabulary)
    return (jax_lab, lab) + _shared(jax_lab, lab, seed=3)


@pytest.mark.parametrize("options", [
    {}, {"normalize": False}, {"pick_index": 5}, {"pick_value": "V"}],
    ids=["softmax", "logits", "pick_index", "pick_value"])
def test_logits_runner_matches_jax(options):
    jax_lab, lab, jax_params, params = _labelers()
    jax_r = jax_logits.LogitsRunner("logits", jax_lab, **options)
    port_r = logits_runner.LogitsRunner("logits", lab, **options)
    assert port_r.pick_index == jax_r.pick_index
    ref, got = _fetch_both(jax_r, port_r, jax_params, params,
                           _batch(targets=False))
    _assert_fetches_match(ref, got)
    assert (port_r.collect_results(ref, BATCH).outputs
            == jax_r.collect_results(ref, BATCH).outputs)


def test_logits_runner_reads_a_decoders_teacher_forced_logits():
    """A decoder without ``logits`` gives its ``train_logits``."""
    jax_dec, dec = DECODERS["rnn"][0](), DECODERS["rnn"][1]()
    jax_params, params = _shared(jax_dec, dec)
    jax_r = jax_logits.LogitsRunner("logits", jax_dec, pick_index=7)
    port_r = logits_runner.LogitsRunner("logits", dec, pick_index=7)
    ref, got = _fetch_both(jax_r, port_r, jax_params, params, _batch())
    assert got["logits"].shape == (BATCH, TGT, VOCAB)
    _assert_fetches_match(ref, got)
    assert (port_r.collect_results(ref, BATCH).outputs
            == jax_r.collect_results(ref, BATCH).outputs)


def test_tensor_runner_matches_jax():
    """Named Context methods of two parts, a part's ``output`` by its
    bare name, and a parameter by its ``params`` path."""
    jax_lab, lab, jax_params, params = _labelers()
    kwargs = dict(tensors=["encoder.temporal_states", "labeler.logits"],
                  batch_dims=[0, 0], tensors_by_name=[
                      "encoder", "labeler.params.hidden.w"],
                  batch_dims_by_name=[0, 0])
    jax_r = jax_tensor.TensorRunner("tensors", [jax_lab.encoder, jax_lab],
                                    **kwargs)
    port_r = tensor_runner.TensorRunner("tensors", [lab.encoder, lab],
                                        **kwargs)
    ref, got = _fetch_both(jax_r, port_r, jax_params, params,
                           _batch(targets=False))
    _assert_fetches_match(ref, got)
    want = jax_r.collect_results(ref, BATCH).outputs
    result = port_r.collect_results(ref, BATCH).outputs
    assert len(result) == len(want) == BATCH
    for item, ref_item in zip(result, want):
        assert set(item) == set(ref_item)
        for name in ref_item:
            np.testing.assert_array_equal(item[name], ref_item[name])
    single = tensor_runner.TensorRunner("t", [lab.encoder], ["encoder"],
                                        single_tensor=True)
    assert isinstance(single.collect_results(
        {"encoder": ref["encoder"]}, BATCH).outputs[0], np.ndarray)
    with pytest.raises(KeyError, match="unknown part"):
        tensor_runner.TensorRunner("t", [lab], ["nothing.output"]).fetches(
            Context(params, {}))


def test_manager_fetches_parameters_to_the_host():
    """Through ``CUDAManager.run_on_batch`` a ``params`` path reaches the
    host though the parameter requires a gradient, and under the bf16
    policy (which casts it at use) as float32 holding its bf16 value."""
    from neuralmonkey_tpu_torch.ops import policy
    from neuralmonkey_tpu_torch.runtime import CUDAManager
    _, lab, _, _ = _labelers()
    tensors = tensor_runner.TensorRunner(
        "w", [lab], ["labeler.params.hidden.w"], single_tensor=True)
    manager = CUDAManager(device="cpu")
    manager.initialize_model_parts([tensors], seed=0)
    weight = manager.params["labeler"]["hidden"]["w"].requires_grad_(True)
    dataset = Dataset("d", {"source": [["w1", "w2"]]})
    try:
        for dtype in (None, "bfloat16"):
            policy.set_compute_dtype(dtype)
            got = manager.run_on_batch([tensors], dataset, 1)[0].outputs[0]
            want = weight.detach()
            if dtype:
                want = want.to(torch.bfloat16).float()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want[0].numpy())
    finally:
        policy.set_compute_dtype(None)


def test_representation_runner_matches_jax():
    jax_lab, lab, jax_params, params = _labelers()
    jax_r = jax_repr.RepresentationRunner("vectors", jax_lab.encoder)
    port_r = representation_runner.RepresentationRunner("vectors",
                                                        lab.encoder)
    ref, got = _fetch_both(jax_r, port_r, jax_params, params,
                           _batch(targets=False))
    _assert_fetches_match(ref, got)
    result = port_r.collect_results(ref, BATCH).outputs
    want = jax_r.collect_results(ref, BATCH).outputs
    assert len(result) == BATCH
    for vector, ref_vector in zip(result, want):
        np.testing.assert_array_equal(vector, ref_vector)


def test_representation_runner_refuses_another_session():
    """The JAX runner deletes ``used_session`` and reads the first
    parameter set whatever it says; the port reads the first set too and
    refuses any other value (a divergence kept on purpose)."""
    jax_lab, lab, _, _ = _labelers()
    jax_repr.RepresentationRunner("vectors", jax_lab.encoder,
                                  used_session=1)
    with pytest.raises(ValueError, match="used_session"):
        representation_runner.RepresentationRunner("vectors", lab.encoder,
                                                   used_session=1)


def _ctc(enc_cls, dec_cls, vocab_cls):
    enc = enc_cls(name="encoder", data_id="speech", input_size=5,
                  rnn_size=8)
    return dec_cls(name="decoder", encoder=enc,
                   vocabulary=vocab_cls(["a", "b", "c", "d", "e"]),
                   data_id="text")


def test_ctc_debug_runner_matches_jax():
    """Frame-wise argmax symbols up to each utterance's length; the
    weights are scaled up so that blanks and symbols both occur."""
    jax_dec = _ctc(JaxRawRNNEncoder, JaxCTCDecoder, JaxVocabulary)
    dec = _ctc(RawRNNEncoder, CTCDecoder, Vocabulary)
    jax_params, params = _shared(jax_dec, dec, seed=6, scale=1.0)
    rng = np.random.RandomState(7)
    batch = {"encoder.seq": rng.randn(BATCH, 9, 5).astype(np.float32),
             "encoder.seq_mask": _mask([9, 6, 3], 9)}
    jax_r = jax_ctc_debug.CTCDebugRunner("frames", jax_dec)
    port_r = ctc_debug_runner.CTCDebugRunner("frames", dec)
    ref, got = _fetch_both(jax_r, port_r, jax_params, params, batch)
    _assert_fetches_match(ref, got, exact=("frames",))
    result = port_r.collect_results(ref, BATCH).outputs
    assert result == jax_r.collect_results(ref, BATCH).outputs
    assert [len(r) for r in result] == [9, 6, 3]
    assert any(s == "_" for r in result for s in r)
    assert any(s != "_" for r in result for s in r)


# ---------------------------------------------------------------------- #
# grid decoding
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("length,window", [
    (5, 8), (8, 8), (9, 8), (16, 8), (17, 8), (23, 6), (100, 7),
    (1, 1), (3, 2)])
def test_grid_windows_match_jax(length, window):
    spans = torch_run._grid_windows(length, window)
    assert spans == jax_run._grid_windows(length, window)
    claimed = []
    for start, end, claim_start, claim_end in spans:
        assert 0 <= start <= claim_start <= claim_end <= end <= length
        assert end - start <= window
        claimed.extend(range(claim_start, claim_end))
    assert claimed == list(range(length))


def test_grid_decode_labeler_writes_the_jax_file(tmp_path, monkeypatch):
    """labeler.ini at ``max_input_len=6``, one set of parameters in both
    packages: long sentences decode through half-overlapping windows
    into the same token-aligned tags."""
    monkeypatch.chdir(REPO)
    ini = os.path.join(CONFIGS, "labeler.ini")
    changes = ["encoder.max_input_len=6"]
    jax_exp = JaxExperiment(ini, train_mode=False, config_changes=changes)
    jax_exp.build_model()
    exp = Experiment(ini, train_mode=False, config_changes=[
        *changes, 'tf_manager.device="cpu"'])
    exp.build_model()
    rng = np.random.RandomState(0)
    flat = {k: (rng.randn(*v.shape) * 0.5).astype(np.float32)
            for k, v in sorted(flatten_tree(exp.tf_manager.params).items())}
    jax_exp.tf_manager.params_list[0] = jax_restore(
        jax_exp.tf_manager.params, flat)
    exp.tf_manager.params = params_from_jax(flat, exp.tf_manager.params)

    words = ["vier", "fünf", "acht", "null", "sieben", "drei"]
    sentences = [[words[rng.randint(len(words))] for _ in range(n)]
                 for n in (14, 3, 9, 25)]
    for name, dataset_cls, module, experiment in (
            ("jax", JaxDataset, jax_run, jax_exp),
            ("port", Dataset, torch_run, exp)):
        module.grid_decode(experiment, dataset_cls(
            "long", {"source": sentences},
            outputs={"tags": str(tmp_path / f"{name}.txt")}))
    ref = (tmp_path / "jax.txt").read_text().splitlines()
    got = (tmp_path / "port.txt").read_text().splitlines()
    assert got == ref
    assert [len(line.split()) for line in got] == [14, 3, 9, 25]
    assert len({tag for line in got for tag in line.split()}) > 1
