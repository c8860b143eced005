"""The port's speech path against the JAX package's, on the CPU: the
audio reader, ``RawRNNEncoder``, ``CTCDecoder`` and WER.

Parameters and inputs are drawn with numpy and loaded into both
packages. The JAX package runs its Pallas RNN kernels in interpret mode
(``NM_USE_PALLAS=1``), its CTC loss is ``optax.ctc_loss``.

- Log-mel and MFCC features of a WAV of tests/data, the mel filterbank
  and ``audio_reader`` over a file list: equal (the same numpy code).
- ``RawRNNEncoder`` bidirectional, forward and backward, GRU and LSTM:
  states and final states to 1e-5 on a ragged batch; ``featurize``
  equal.
- The CTC loss per sequence against ``optax.ctc_loss``: values to 1e-5
  relative, gradients of the logits to 1e-5, a padding row (no frames,
  no labels) 0 in both; the loss of the decoder over a BiGRU and the
  gradient of every parameter (1e-4).
- A target that no alignment reaches: optax gives about 1e5, the port 0
  (a kept divergence, ROADMAP queue C); both finite, the other rows
  equal.
- Greedy CTC on logits with exact ties (the first maximum) with and
  without merging repeats, and the prefix beam search (beams 2, 4 and
  8) on random logits, on logits of few distinct values, and on all-
  equal logits (every candidate tied): prefixes equal, scores to 1e-5;
  ``PlainRunner``'s transcripts equal.
- ``levenshtein`` and WER: equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralmonkey_tpu.evaluators import edit_distance as jax_edit_distance
from neuralmonkey_tpu.evaluators import wer as jax_wer
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.decoders.ctc_decoder import \
    CTCDecoder as JaxCTCDecoder
from neuralmonkey_tpu.models.encoders.raw_rnn_encoder import \
    RawRNNEncoder as JaxRawRNNEncoder
from neuralmonkey_tpu.ops import kernel_config as jax_kernel_config
from neuralmonkey_tpu.readers import audio_reader as jax_audio
from neuralmonkey_tpu.runners.plain_runner import \
    PlainRunner as JaxPlainRunner
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.evaluators import edit_distance, wer
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.decoders import ctc_decoder
from neuralmonkey_tpu_torch.models.decoders.ctc_decoder import CTCDecoder
from neuralmonkey_tpu_torch.models.encoders.raw_rnn_encoder import \
    RawRNNEncoder
from neuralmonkey_tpu_torch.readers import audio_reader
from neuralmonkey_tpu_torch.runners.plain_runner import PlainRunner
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

import test_torch_precision as precision

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FEATS, FRAMES, LENGTHS = 5, 9, [9, 6, 3]
ATOL, GRAD_ATOL = 1e-5, 1e-4


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package's Pallas kernels, in interpret mode."""
    monkeypatch.setenv("NM_USE_PALLAS", "1")
    jax_kernel_config._use_pallas_cached.cache_clear()
    yield monkeypatch
    jax_kernel_config._use_pallas_cached.cache_clear()


def _close(got, ref, atol=ATOL, rtol=0.0, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol, err_msg=msg)


def _shared(jax_root, port_root, seed, scale=0.4):
    """(JAX params, port params): one numpy draw loaded into both."""
    jax_shapes = jax.eval_shape(lambda: jax_init(
        jax_collect_parts([jax_root]), jax.random.PRNGKey(0)))
    template = init_all_params(collect_parts([port_root]), seed=0)
    rng = np.random.RandomState(seed)
    flat = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
            for k, v in sorted(flatten_tree(template).items())}
    return jax_restore(jax_shapes, flat), params_from_jax(flat, template)


def _jax_outputs(fn, jax_params, batch):
    """``fn(ctx)`` of an inference pass of the JAX package, compiled."""
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(lambda p: fn(JaxContext(p, jax_batch)))(jax_params)


def _mask(lengths, time):
    return np.array([[1.0] * n + [0.0] * (time - n) for n in lengths],
                    np.float32)


# ---------------------------------------------------------------------- #
# features
# ---------------------------------------------------------------------- #
def test_speech_features_match_jax():
    path = os.path.join(DATA, "audio", "train_00.wav")
    rate, signal = audio_reader._read_wav(path)
    ref_rate, ref_signal = jax_audio._read_wav(path)
    assert rate == ref_rate
    np.testing.assert_array_equal(signal, ref_signal)
    for n_filters in (13, 40):
        np.testing.assert_array_equal(
            audio_reader.log_mel_features(signal, rate, n_filters=n_filters),
            jax_audio.log_mel_features(signal, rate, n_filters=n_filters))
        np.testing.assert_array_equal(
            audio_reader._mel_filterbank(n_filters, 512, rate),
            jax_audio._mel_filterbank(n_filters, 512, rate))
    mfcc = audio_reader.mfcc_features(signal, rate, n_coeffs=13)
    np.testing.assert_array_equal(
        mfcc, jax_audio.mfcc_features(signal, rate, n_coeffs=13))
    assert mfcc.shape[1] == 13 and np.isfinite(mfcc).all()


@pytest.mark.parametrize("features", ["logmel", "mfcc"])
def test_audio_reader_matches_jax(features):
    lst = [os.path.join(DATA, "audio_val.lst")]
    got = list(audio_reader.audio_reader(prefix=DATA, features=features,
                                         n_filters=13)(lst))
    ref = list(jax_audio.audio_reader(prefix=DATA, features=features,
                                      n_filters=13)(lst))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="WAV"):
        audio_reader.audio_reader(audio_format="mp3")


# ---------------------------------------------------------------------- #
# the raw RNN encoder
# ---------------------------------------------------------------------- #
class _Series:
    """A dataset of one series."""

    def __init__(self, name, items):
        self.name, self.items = name, items

    def has_series(self, name):
        return name == self.name

    def get_series(self, name):
        return self.items


def _speech_batch(rng, lengths=LENGTHS):
    return {"encoder.seq": rng.randn(len(lengths), FRAMES, FEATS
                                     ).astype(np.float32),
            "encoder.seq_mask": _mask(lengths, FRAMES)}


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
@pytest.mark.parametrize("direction", ["bidirectional", "forward",
                                       "backward"])
def test_raw_rnn_encoder_matches_jax(jax_pallas, cell, direction):
    args = dict(name="encoder", data_id="speech", input_size=FEATS,
                rnn_size=6, rnn_cell=cell, rnn_direction=direction)
    jax_enc, enc = JaxRawRNNEncoder(**args), RawRNNEncoder(**args)
    jax_params, params = _shared(jax_enc, enc, seed=1)
    batch = _speech_batch(np.random.RandomState(2))
    ref = _jax_outputs(lambda c: (jax_enc.temporal_states(c),
                                  jax_enc.output(c)), jax_params, batch)
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert enc.state_dim == jax_enc.state_dim == enc.output_dim
    _close(enc.temporal_states(ctx), ref[0])
    _close(enc.output(ctx), ref[1])


def test_raw_rnn_encoder_featurizes_like_jax():
    rng = np.random.RandomState(3)
    items = [rng.randn(n, FEATS).astype(np.float32) for n in (4, 7, 2)]
    args = dict(name="encoder", data_id="speech", input_size=FEATS,
                rnn_size=6, max_input_len=6)
    got = RawRNNEncoder(**args).featurize(_Series("speech", items))
    ref = JaxRawRNNEncoder(**args).featurize(_Series("speech", items))
    assert set(got) == set(ref) == {"encoder.seq", "encoder.seq_mask"}
    for key in got:
        np.testing.assert_array_equal(got[key], ref[key])
    with pytest.raises(ValueError, match="feature dim"):
        RawRNNEncoder(**dict(args, input_size=3)).featurize(
            _Series("speech", items))


# ---------------------------------------------------------------------- #
# the CTC loss
# ---------------------------------------------------------------------- #
def _ctc_inputs(infeasible=False):
    rng = np.random.RandomState(4)
    logits = rng.randn(4, 8, 6).astype(np.float32)
    frames = _mask([8, 5, 0, 8], 8)
    labels = np.array([[1, 2, 3, 0, 0], [4, 4, 0, 0, 0], [0] * 5,
                       [1, 2, 2, 5, 3]], np.int32)
    label_mask = _mask([3, 2, 0, 5], 5)
    if infeasible:
        # five labels with a repeat need six frames; row 3 has four
        frames[3, 4:] = 0.0
    return logits, frames, labels, label_mask


def _optax_loss(logits, frames, labels, label_mask):
    return optax.ctc_loss(jnp.asarray(logits), 1.0 - jnp.asarray(frames),
                          jnp.asarray(labels), 1.0 - jnp.asarray(label_mask),
                          blank_id=0)


def test_ctc_loss_matches_optax():
    logits, frames, labels, label_mask = _ctc_inputs()
    cot = np.array([0.5, 1.5, 1.0, 2.0], np.float32)
    ref, ref_grad = jax.value_and_grad(lambda x: jnp.sum(_optax_loss(
        x, frames, labels, label_mask) * cot))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_decoder.ctc_loss_per_sequence(
        x, torch.from_numpy(frames), torch.from_numpy(labels),
        torch.from_numpy(label_mask))
    (got * torch.from_numpy(cot)).sum().backward()
    per_seq = _optax_loss(logits, frames, labels, label_mask)
    _close(got, per_seq, rtol=1e-5)
    assert float(got.detach()[2]) == float(per_seq[2]) == 0.0  # padding
    _close(x.grad, ref_grad)


def test_unreachable_ctc_target_is_a_kept_divergence():
    """optax's log_epsilon gives an unreachable target a large finite
    loss; the port's is 0 (``zero_infinity``) with no gradient. The
    other rows agree; both stay finite."""
    logits, frames, labels, label_mask = _ctc_inputs(infeasible=True)
    ref = np.asarray(_optax_loss(logits, frames, labels, label_mask))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = ctc_decoder.ctc_loss_per_sequence(
        x, torch.from_numpy(frames), torch.from_numpy(labels),
        torch.from_numpy(label_mask))
    got.sum().backward()
    assert 1e5 < ref[3] < 1.001e5
    assert got[3].item() == 0.0
    assert not x.grad[3].abs().any()
    _close(got[:3], ref[:3], rtol=1e-5)
    assert torch.isfinite(got).all() and np.isfinite(ref).all()


# ---------------------------------------------------------------------- #
# decoding
# ---------------------------------------------------------------------- #
class _Logits:
    """An encoder whose states are the batch's ``x`` (B, T, V); with the
    identity as the decoder's projection they are its logits."""

    def __init__(self, vocab):
        self.state_dim = vocab

    @staticmethod
    def temporal_states(ctx):
        return ctx.batch["x"]

    @staticmethod
    def temporal_mask(ctx):
        return ctx.batch["m"]


VOCAB_WORDS = ["a", "b", "c", "d", "e"]


def _decoders(beam, merge=True):
    vocab = len(VOCAB_WORDS) + 4
    pair = [cls(name="ctc", encoder=_Logits(vocab),
                vocabulary=voc(VOCAB_WORDS), data_id="text",
                beam_width=beam, merge_repeated_outputs=merge)
            for cls, voc in ((JaxCTCDecoder, JaxVocabulary),
                             (CTCDecoder, Vocabulary))]
    params = {"logit": {"w": np.eye(vocab, dtype=np.float32),
                        "b": np.zeros(vocab, np.float32)}}
    return pair, params


def _logits(kind, shape, seed=5):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return (rng.randn(*shape) * 2).astype(np.float32)
    if kind == "few_values":
        return rng.randint(0, 3, shape).astype(np.float32)
    return np.zeros(shape, np.float32)


def _decode(decoders, params, batch, method):
    (jax_dec, dec) = decoders
    ref = _jax_outputs(getattr(jax_dec, method),
                       {"ctc": jax.tree_util.tree_map(jnp.asarray, params)},
                       batch)
    ctx = Context({"ctc": jax.tree_util.tree_map(torch.from_numpy, params)},
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    return ref, getattr(dec, method)(ctx)


@pytest.mark.parametrize("kind", ["random", "few_values", "equal"])
@pytest.mark.parametrize("merge", [True, False])
def test_greedy_ctc_matches_jax(kind, merge):
    decoders, params = _decoders(1, merge)
    batch = {"x": _logits(kind, (4, 10, 9)),
             "m": _mask([10, 7, 1, 0], 10)}
    ref, got = _decode(decoders, params, batch, "decoded")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["random", "few_values", "equal"])
@pytest.mark.parametrize("beam", [2, 4, 8])
def test_prefix_beam_search_matches_jax(kind, beam):
    decoders, params = _decoders(beam)
    batch = {"x": _logits(kind, (4, 10, 9), seed=beam),
             "m": _mask([10, 7, 1, 0], 10)}
    (ref_prefixes, ref_scores), (prefixes, scores) = _decode(
        decoders, params, batch, "beam_search")
    np.testing.assert_array_equal(prefixes.numpy(), np.asarray(ref_prefixes))
    _close(scores, ref_scores)
    ref, got = _decode(decoders, params, batch, "decoded")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_merge_repeated_targets_is_refused():
    with pytest.raises(ValueError, match="merge_repeated_targets"):
        CTCDecoder(name="ctc", encoder=_Logits(9),
                   vocabulary=Vocabulary(VOCAB_WORDS), data_id="text",
                   merge_repeated_targets=True)


# ---------------------------------------------------------------------- #
# the CTC model: a BiGRU under the CTC decoder
# ---------------------------------------------------------------------- #
def _ctc_model(enc_cls, dec_cls, vocab_cls, beam):
    enc = enc_cls(name="encoder", data_id="speech", input_size=FEATS,
                  rnn_size=8)
    return dec_cls(name="decoder", encoder=enc,
                   vocabulary=vocab_cls(VOCAB_WORDS), data_id="text",
                   beam_width=beam)


def _ctc_case(beam=1):
    jax_dec = _ctc_model(JaxRawRNNEncoder, JaxCTCDecoder, JaxVocabulary,
                         beam)
    dec = _ctc_model(RawRNNEncoder, CTCDecoder, Vocabulary, beam)
    jax_params, params = _shared(jax_dec, dec, seed=6)
    rng = np.random.RandomState(7)
    batch = _speech_batch(rng, LENGTHS + [0])
    batch["decoder.labels"] = np.array(
        [[5, 6, 6, 7], [8, 5, 0, 0], [4, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    batch["decoder.labels_mask"] = _mask([4, 2, 1, 0], 4)
    return jax_dec, dec, jax_params, params, batch


def test_ctc_model_loss_and_gradients_match_jax(jax_pallas):
    jax_dec, dec, jax_params, params, batch = _ctc_case()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_dec.train_loss(JaxContext(
            p, jax_batch, train=True, rng=jax.random.PRNGKey(1)))))(
                jax_params)
    leaves = flatten_tree(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss = dec.train_loss(Context(params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()},
                                  train=True, rng=1))
    loss.backward()
    _close(loss, ref_loss, rtol=1e-5)
    ref_grads = jax_flatten(ref_grads)
    assert set(leaves) == set(ref_grads)
    for key, leaf in leaves.items():
        _close(leaf.grad, ref_grads[key], atol=GRAD_ATOL, msg=key)


@pytest.mark.parametrize("beam", [1, 4])
def test_ctc_runner_transcripts_match_jax(jax_pallas, beam):
    jax_dec, dec, jax_params, params, batch = _ctc_case(beam)
    jax_runner = JaxPlainRunner("text", jax_dec)
    runner = PlainRunner("text", dec)
    want = jax_runner.collect_results(
        {k: np.asarray(v) for k, v in _jax_outputs(
            jax_runner.fetches, jax_params, batch).items()}, 3)
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = runner.collect_results(
        {k: v.numpy() for k, v in runner.fetches(ctx).items()}, 3)
    assert got.outputs == want.outputs and len(got.outputs) == 3


def test_ctc_model_bf16_loss_and_gradients_match_jax(jax_pallas):
    """Under the bf16 compute policy of both packages (the JAX program
    compiled with every bf16 rounding kept, ``test_torch_precision``):
    the CTC loss of the BiGRU model and the gradient of every float32
    master parameter, by ``test_torch_precision``'s rules (the loss to
    1e-5 relative as in float32; the gradients within float32 sum order
    and a bf16 rounding of the largest)."""
    jax_dec, dec, jax_params, params, batch = _ctc_case()
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    leaves = flatten_tree(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    with precision.both_policies(precision.BF16):
        ref_loss, ref_grads = precision._compiled(jax.value_and_grad(
            lambda p: jax_dec.train_loss(JaxContext(
                p, jax_batch, train=True, rng=jax.random.PRNGKey(1)))),
            jax_params)
        loss = dec.train_loss(Context(params, {
            k: torch.from_numpy(v) for k, v in batch.items()}, train=True,
            rng=1))
        loss.backward()
    with torch.no_grad():
        loss32 = dec.train_loss(Context(params, {
            k: torch.from_numpy(v) for k, v in batch.items()}, train=True,
            rng=1))
    # the policy changes the numbers
    assert loss.dtype == torch.float32 and loss.item() != loss32.item()
    _close(loss, ref_loss, rtol=1e-5)
    precision._assert_grads({k: leaf.grad for k, leaf in leaves.items()},
                            jax_flatten(ref_grads))


@pytest.mark.parametrize("beam", [1, 4])
def test_ctc_runner_bf16_transcripts_match_jax(jax_pallas, beam):
    """The greedy and beam-4 transcripts under both packages' bf16
    policy: equal."""
    jax_dec, dec, jax_params, params, batch = _ctc_case(beam)
    jax_runner = JaxPlainRunner("text", jax_dec)
    runner = PlainRunner("text", dec)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    with precision.both_policies(precision.BF16):
        want = jax_runner.collect_results(
            {k: np.asarray(v) for k, v in precision._compiled(
                lambda p: jax_runner.fetches(JaxContext(p, jax_batch)),
                jax_params).items()}, 3)
        ctx = Context(params, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
        got = runner.collect_results(
            {k: v.numpy() for k, v in runner.fetches(ctx).items()}, 3)
    assert got.outputs == want.outputs and len(got.outputs) == 3


# ---------------------------------------------------------------------- #
# WER
# ---------------------------------------------------------------------- #
HYPS = [["a", "b", "c"], [], ["x"], ["a", "a"], ["b", "c", "d", "e"]]
REFS = [["a", "c"], ["a"], [], ["a", "a"], ["c", "d", "e", "b"]]


def test_levenshtein_and_wer_match_jax():
    for hyp, ref in zip(HYPS, REFS):
        assert edit_distance.levenshtein(hyp, ref) == \
            jax_edit_distance.levenshtein(hyp, ref)
        assert edit_distance.EditDistance([hyp], [ref]) == \
            jax_edit_distance.EditDistance([hyp], [ref])
    assert wer.WER(HYPS, REFS) == jax_wer.WER(HYPS, REFS) == 5 / 9
    assert wer.WER([[]], [[]]) == jax_wer.WER([[]], [[]]) == 0.0
    assert wer.WER.compare_scores(0.2, 0.3) == 1  # lower is better
    with pytest.raises(ValueError):
        wer.WER(HYPS, REFS[:2])
