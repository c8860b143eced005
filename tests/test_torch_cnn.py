"""The port's CNN encoders and classifier against the JAX package's, on
the CPU.

Parameters are drawn once with numpy and loaded into both packages
(``params_from_jax``); both see the same numpy batch (batch 3, ragged
lengths 7, 4 and 2, or a padding row where a test says so). The JAX
package runs its Pallas kernels in interpret mode (``NM_USE_PALLAS=1``,
as tests/test_torch_transformer.py runs them), so its BiGRU goes through
``pallas_rnn``'s GRU scan and, in training, its BPTT kernel. Tolerance
1e-5 on values and 1e-4 on gradients (float32 sums in another order),
unless a test says otherwise; decoded ids and labels equal.

- TF ``"SAME"`` 1-D convolutions at odd and even widths and strides 1
  and 2 (an even width's extra cell on the right);
- ``SentenceCNNEncoder`` with and without its BiGRU: states, output,
  widths 1 to 4, the masked batch, and the BiGRU run once a pass;
- the sentence-CNN model of sentence_cnn.ini (encoder, Bahdanau
  attention, GRU decoder): loss, every gradient, greedy ids;
- ``SequenceCNNEncoder``'s masked max-pool, an all-padding row included;
- ``Classifier`` over it: logits, the loss with a padding row's label
  mask 0, every gradient, labels, and ``PlainRunner``'s outputs;
- ``CNNEncoder`` with strided SAME convolutions (odd and even kernels),
  max- and average-pooling, instance norm on and off, fully connected
  layers, and ``CNNTemporalView``: states, output, gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.classifier import \
    Classifier as JaxClassifier
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders import cnn_encoder as jax_cnn
from neuralmonkey_tpu.models.encoders import sentence_cnn_encoder as jax_scnn
from neuralmonkey_tpu.ops import kernel_config as jax_kernel_config
from neuralmonkey_tpu.ops import policy as jax_policy
from neuralmonkey_tpu.runners.plain_runner import \
    PlainRunner as JaxPlainRunner
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.classifier import (
    Classifier, SequenceClassifier)
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders import cnn_encoder
from neuralmonkey_tpu_torch.models.encoders import sentence_cnn_encoder
from neuralmonkey_tpu_torch.models.encoders.sequence_cnn_encoder import \
    SequenceCNNEncoder
from neuralmonkey_tpu_torch.ops import policy
from neuralmonkey_tpu_torch.runners.plain_runner import PlainRunner
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

import test_torch_precision as precision

torch.set_num_threads(1)
BATCH, SRC, WIDTH, VOCAB = 3, 7, 16, 40
LENGTHS = [7, 4, 2]
ATOL, GRAD_ATOL = 1e-5, 1e-4
FILTERS = [(1, 4), (2, 4), (3, 6), (4, 6)]


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package's Pallas kernels, in interpret mode."""
    monkeypatch.setenv("NM_USE_PALLAS", "1")
    jax_kernel_config._use_pallas_cached.cache_clear()
    yield monkeypatch
    jax_kernel_config._use_pallas_cached.cache_clear()


def _vocab(cls, size=VOCAB, prefix="w"):
    return cls([f"{prefix}{i}" for i in range(size - 4)])


def _shared(jax_root, port_root, seed=0, scale=0.3):
    """(JAX params, port params): one numpy draw loaded into both. The
    JAX tree's structure comes from ``eval_shape`` (no initialiser runs);
    ``jax_restore`` checks every shape against it."""
    jax_shapes = jax.eval_shape(lambda: jax_init(
        jax_collect_parts([jax_root]), jax.random.PRNGKey(0)))
    template = init_all_params(collect_parts([port_root]), seed=0)
    rng = np.random.RandomState(seed)
    flat = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
            for k, v in sorted(flatten_tree(template).items())}
    return jax_restore(jax_shapes, flat), params_from_jax(flat, template)


def _mask(lengths, time=SRC):
    mask = np.zeros((len(lengths), time), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return mask


def _source(rng, prefix, lengths=LENGTHS):
    return {f"{prefix}.ids": rng.randint(4, VOCAB, (len(lengths), SRC)
                                         ).astype(np.int32),
            f"{prefix}.mask": _mask(lengths)}


def _contexts(jax_params, port_params, batch, train=False):
    return (JaxContext(jax_params, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                       train=train, rng=jax.random.PRNGKey(1)),
            Context(port_params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                    train=train, rng=1))


def _jax_outputs(fn, jax_params, batch):
    """``fn(ctx)`` of an inference pass of the JAX package, compiled as
    one program (op-by-op tracing is slow)."""
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(lambda p: fn(JaxContext(p, jax_batch)))(jax_params)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _assert_grads(fn_jax, fn_port, jax_params, port_params, batch,
                  jit=False):
    """The gradients of the scalars ``fn_jax(ctx)`` and ``fn_port(ctx)``
    of train-mode passes (dropout off) equal within GRAD_ATOL; ``jit``
    compiles the JAX gradient (a recurrent model's eager trace is slow)."""
    grad = jax.grad(lambda p: fn_jax(JaxContext(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
        rng=jax.random.PRNGKey(1))))
    ref = jax_flatten((jax.jit(grad) if jit else grad)(jax_params))
    flat = flatten_tree(port_params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    fn_port(Context(port_params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                    train=True, rng=1)).backward()
    assert set(ref) == set(flat)
    for key, want in ref.items():
        got = flat[key].grad
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=GRAD_ATOL,
                                   rtol=0, err_msg=key)


# ---------------------------------------------------------------------- #
# TF "SAME" convolution over time
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("width", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("time", [7, 8])
def test_conv1d_same_matches_jax(width, stride, time):
    rng = np.random.RandomState(width * 10 + stride)
    x = rng.randn(2, time, 3).astype(np.float32)
    kernel = rng.randn(width, 3, 5).astype(np.float32)
    ref = jax_scnn._conv1d(jnp.asarray(x), jnp.asarray(kernel), stride)
    got = sentence_cnn_encoder.conv1d_same(torch.from_numpy(x),
                                           torch.from_numpy(kernel), stride)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("length,kernel,stride,pads", [
    (7, 2, 1, (0, 1)), (7, 4, 1, (1, 2)), (7, 3, 2, (1, 1)),
    (8, 3, 2, (0, 1)), (8, 1, 2, (0, 0)), (5, 8, 1, (3, 4))])
def test_same_padding_puts_the_odd_cell_on_the_right(length, kernel, stride,
                                                     pads):
    assert sentence_cnn_encoder.same_padding(length, kernel, stride) == pads


# ---------------------------------------------------------------------- #
# the sentence-CNN encoder
# ---------------------------------------------------------------------- #
def _sentence_cnn(cls, vocab_cls, rnn_size):
    return cls(name="encoder", vocabulary=_vocab(vocab_cls),
               data_id="source", embedding_size=WIDTH, max_input_len=SRC,
               filters=FILTERS, highway_depth=2, rnn_size=rnn_size)


@pytest.mark.parametrize("rnn_size", [None, 8])
def test_sentence_cnn_encoder_matches_jax(jax_pallas, rnn_size):
    jax_enc = _sentence_cnn(jax_scnn.SentenceCNNEncoder, JaxVocabulary,
                            rnn_size)
    enc = _sentence_cnn(sentence_cnn_encoder.SentenceCNNEncoder, Vocabulary,
                        rnn_size)
    jax_params, params = _shared(jax_enc, enc, seed=1)
    batch = _source(np.random.RandomState(2), "encoder_input")
    ctx = _contexts(jax_params, params, batch)[1]
    ref = _jax_outputs(lambda c: (jax_enc.temporal_states(c),
                                  jax_enc.output(c), jax_enc.temporal_mask(c)),
                       jax_params, batch)
    assert enc.state_dim == jax_enc.state_dim == enc.output_dim
    states = enc.temporal_states(ctx)
    _close(states, ref[0])
    _close(enc.output(ctx), ref[1])
    _close(enc.temporal_mask(ctx), ref[2])
    # padding positions carry nothing
    assert not states.detach()[2, 2:].abs().any()


def test_sentence_cnn_encoder_runs_its_birnn_once_a_pass(monkeypatch):
    enc = _sentence_cnn(sentence_cnn_encoder.SentenceCNNEncoder, Vocabulary,
                        8)
    params = init_all_params(collect_parts([enc]), seed=0)
    calls = []
    plain = sentence_cnn_encoder.bidirectional_rnn

    def counting(*args):
        calls.append(1)
        return plain(*args)
    monkeypatch.setattr(sentence_cnn_encoder, "bidirectional_rnn", counting)
    batch = _source(np.random.RandomState(3), "encoder_input")
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    states, final = enc.temporal_states(ctx), enc.output(ctx)
    assert len(calls) == 1
    ref_states, ref_final = plain(enc._fw, params["encoder"]["rnn_fw"],
                                  enc._bw, params["encoder"]["rnn_bw"],
                                  enc._cnn_states(ctx), enc.temporal_mask(ctx))
    assert torch.equal(states, ref_states) and torch.equal(final, ref_final)


def _cnn_model(enc_cls, att_cls, dec_cls, vocab_cls):
    """sentence_cnn.ini's model at its widths (filters cut to 4 and 6)."""
    enc = enc_cls(name="encoder", vocabulary=_vocab(vocab_cls),
                  data_id="source", embedding_size=24, max_input_len=SRC,
                  filters=[(3, 8), (4, 6)], highway_depth=2, rnn_size=16)
    att = att_cls(name="attention", encoder=enc, state_size=16)
    return dec_cls(name="decoder", encoders=[enc], attentions=[att],
                   rnn_size=16, embedding_size=24, data_id="target",
                   max_output_len=6, vocabulary=_vocab(vocab_cls))


def _decoder_batch(rng):
    batch = _source(rng, "encoder_input")
    tmask = _mask([6, 3, 1], 6)
    batch.update({
        "decoder.train_inputs": rng.randint(1, VOCAB, (BATCH, 6)
                                            ).astype(np.int32),
        "decoder.train_targets": rng.randint(2, VOCAB, (BATCH, 6)
                                             ).astype(np.int32),
        "decoder.train_mask": tmask})
    return batch


def test_sentence_cnn_model_loss_gradients_and_ids_match_jax():
    jax_dec = _cnn_model(jax_scnn.SentenceCNNEncoder, JaxAttention,
                         JaxDecoder, JaxVocabulary)
    dec = _cnn_model(sentence_cnn_encoder.SentenceCNNEncoder, Attention,
                     Decoder, Vocabulary)
    jax_params, params = _shared(jax_dec, dec, seed=4, scale=0.2)
    batch = _decoder_batch(np.random.RandomState(5))
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    _close(dec.train_loss(ctx), jax.jit(lambda p: jax_dec.train_loss(
        JaxContext(p, jax_batch)))(jax_params))
    np.testing.assert_array_equal(dec.decoded(ctx).numpy(),
                                  np.asarray(jax_dec.decoded(jax_ctx)))
    _assert_grads(lambda c: jax_dec.train_loss(c),
                  lambda c: dec.train_loss(c), jax_params, params, batch,
                  jit=True)


def _bf16_grads(fn_jax, fn_port, jax_params, port_params, batch):
    """The gradients of ``fn_jax(ctx)`` and ``fn_port(ctx)`` (train-mode
    passes, dropout off) under both packages' bf16 policy, the JAX
    program compiled with every bf16 rounding kept: within float32 sum
    order and a bf16 rounding of the largest
    (``test_torch_precision._assert_grads``)."""
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    flat = flatten_tree(port_params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    with precision.both_policies(precision.BF16):
        ref = jax_flatten(precision._compiled(jax.grad(
            lambda p: fn_jax(JaxContext(p, jax_batch, train=True,
                                        rng=jax.random.PRNGKey(1)))),
            jax_params))
        fn_port(Context(port_params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                        train=True, rng=1)).backward()
    assert set(ref) == set(flat)
    precision._assert_grads(
        {k: (torch.zeros(v.shape) if flat[k].grad is None else flat[k].grad)
         for k, v in ref.items()}, ref)


def _bf16_outputs(fn_jax, fn_port, jax_params, port_params, batch):
    """``fn_jax(ctx)`` and ``fn_port(ctx)`` of inference passes under
    both packages' bf16 policy (the JAX program compiled with every bf16
    rounding kept), and the port's under float32."""
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def port(name):
        with precision.both_policies(name), torch.inference_mode():
            return fn_port(Context(port_params, {
                k: torch.from_numpy(v) for k, v in batch.items()}))
    with precision.both_policies(precision.BF16):
        ref = precision._compiled(lambda p: fn_jax(JaxContext(p, jax_batch)),
                                  jax_params)
    return ref, port(precision.BF16), port(None)


@pytest.mark.parametrize("rnn_size", [None, 8])
def test_sentence_cnn_encoder_bf16_matches_jax(jax_pallas, rnn_size):
    """Under both packages' bf16 policy: the states, the output and the
    mask (1e-5), and the policy changes the states."""
    jax_enc = _sentence_cnn(jax_scnn.SentenceCNNEncoder, JaxVocabulary,
                            rnn_size)
    enc = _sentence_cnn(sentence_cnn_encoder.SentenceCNNEncoder, Vocabulary,
                        rnn_size)
    jax_params, params = _shared(jax_enc, enc, seed=1)
    batch = _source(np.random.RandomState(2), "encoder_input")
    ref, got, got32 = _bf16_outputs(
        lambda c: (jax_enc.temporal_states(c), jax_enc.output(c),
                   jax_enc.temporal_mask(c)),
        lambda c: (enc.temporal_states(c), enc.output(c),
                   enc.temporal_mask(c)), jax_params, params, batch)
    for value, want in zip(got, ref):
        _close(value.float(), want)
    assert not torch.equal(got[0].float(), got32[0])


def test_sentence_cnn_model_bf16_matches_jax(jax_pallas):
    """sentence_cnn.ini's model under both packages' bf16 policy: the
    loss (1e-5), the greedy ids (equal) and the gradients."""
    jax_dec = _cnn_model(jax_scnn.SentenceCNNEncoder, JaxAttention,
                         JaxDecoder, JaxVocabulary)
    dec = _cnn_model(sentence_cnn_encoder.SentenceCNNEncoder, Attention,
                     Decoder, Vocabulary)
    jax_params, params = _shared(jax_dec, dec, seed=4, scale=0.2)
    batch = _decoder_batch(np.random.RandomState(5))
    ref, got, got32 = _bf16_outputs(
        lambda c: (jax_dec.train_loss(c), jax_dec.decoded(c)),
        lambda c: (dec.train_loss(c), dec.decoded(c)), jax_params, params,
        batch)
    _close(got[0], ref[0])
    assert got[0].item() != got32[0].item()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _bf16_grads(lambda c: jax_dec.train_loss(c),
                lambda c: dec.train_loss(c), jax_params, params, batch)


# ---------------------------------------------------------------------- #
# the sequence-CNN encoder and the classifier
# ---------------------------------------------------------------------- #
def _classifier(enc_cls, cls_cls, vocab_cls, keep=1.0):
    enc = enc_cls(name="encoder", vocabulary=_vocab(vocab_cls),
                  data_id="source", embedding_size=WIDTH,
                  filters=[(2, 8), (3, 8), (5, 4)])
    return cls_cls(name="classifier", encoders=[enc],
                   vocabulary=_vocab(vocab_cls, 9, "c"), data_id="label",
                   layers=[12, 10], dropout_keep_prob=keep)


def _classifier_case():
    jax_cls = _classifier(jax_scnn.SequenceCNNEncoder, JaxClassifier,
                          JaxVocabulary)
    cls = _classifier(SequenceCNNEncoder, Classifier, Vocabulary)
    jax_params, params = _shared(jax_cls, cls, seed=6)
    rng = np.random.RandomState(7)
    # the fourth row pads the batch: an all-zero source mask, label 0 and
    # a label mask of 0
    batch = _source(rng, "encoder_input", LENGTHS + [0])
    batch["classifier.labels"] = np.array([4, 6, 2, 0], np.int32)
    batch["classifier.label_mask"] = np.array([1, 1, 1, 0], np.float32)
    return jax_cls, cls, jax_params, params, batch


def test_sequence_cnn_encoder_matches_jax():
    jax_cls, cls, jax_params, params, batch = _classifier_case()
    ctx = _contexts(jax_params, params, batch)[1]
    out = cls.encoders[0].output(ctx)
    _close(out, _jax_outputs(jax_cls.encoders[0].output, jax_params, batch))
    assert cls.encoders[0].output_dim == 20
    # the padding row pools to zeros, and every output is finite
    assert not out[3].abs().any() and torch.isfinite(out).all()


def test_classifier_loss_labels_and_gradients_match_jax():
    jax_cls, cls, jax_params, params, batch = _classifier_case()
    ctx = _contexts(jax_params, params, batch)[1]
    ref = _jax_outputs(lambda c: (jax_cls.logits(c), jax_cls.train_loss(c),
                                  jax_cls.decoded(c)), jax_params, batch)
    _close(cls.logits(ctx), ref[0])
    _close(cls.train_loss(ctx), ref[1])
    np.testing.assert_array_equal(cls.decoded(ctx).numpy(),
                                  np.asarray(ref[2]))
    # the padding row stays out of the loss
    changed = dict(batch, **{"classifier.labels": np.array([4, 6, 2, 5],
                                                           np.int32)})
    assert cls.train_loss(_contexts(jax_params, params, changed)[1]).item() \
        == pytest.approx(cls.train_loss(ctx).item(), abs=0)
    _assert_grads(lambda c: jax_cls.train_loss(c),
                  lambda c: cls.train_loss(c), jax_params, params, batch)


def test_classifier_bf16_matches_jax():
    """The classifier under both packages' bf16 policy: logits and loss
    (1e-5), labels (equal) and the gradients."""
    jax_cls, cls, jax_params, params, batch = _classifier_case()
    ref, got, got32 = _bf16_outputs(
        lambda c: (jax_cls.logits(c), jax_cls.train_loss(c),
                   jax_cls.decoded(c)),
        lambda c: (cls.logits(c), cls.train_loss(c), cls.decoded(c)),
        jax_params, params, batch)
    _close(got[0].float(), ref[0])
    _close(got[1], ref[1])
    assert got[1].item() != got32[1].item()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _bf16_grads(lambda c: jax_cls.train_loss(c),
                lambda c: cls.train_loss(c), jax_params, params, batch)


def test_classifier_dropout_and_alias():
    assert SequenceClassifier is Classifier
    cls = _classifier(SequenceCNNEncoder, Classifier, Vocabulary, keep=0.5)
    params = init_all_params(collect_parts([cls]), seed=1)
    batch = {k: torch.from_numpy(v) for k, v in _source(
        np.random.RandomState(8), "encoder_input").items()}
    evaluated = cls.logits(Context(params, batch))
    trained = cls.logits(Context(params, batch, train=True, rng=3))
    assert not torch.allclose(evaluated, trained)
    assert torch.equal(trained, cls.logits(Context(params, batch, train=True,
                                                   rng=3)))


def test_plain_runner_matches_jax():
    jax_cls, cls, jax_params, params, batch = _classifier_case()
    ctx = _contexts(jax_params, params, batch)[1]
    jax_runner = JaxPlainRunner("label", jax_cls)
    runner = PlainRunner("label", cls)
    want = jax_runner.collect_results(
        {k: np.asarray(v) for k, v in _jax_outputs(
            jax_runner.fetches, jax_params, batch).items()}, BATCH)
    got = runner.collect_results(
        {k: v.detach().numpy() for k, v in runner.fetches(ctx).items()},
        BATCH)
    assert got.outputs == want.outputs and len(got.outputs) == BATCH
    assert got.losses["loss"] == pytest.approx(want.losses["loss"],
                                               abs=ATOL)


# ---------------------------------------------------------------------- #
# the CNN image encoder
# ---------------------------------------------------------------------- #
CNN_SPEC = [("C", 3, 1, 4), ("C", 4, 2, 6), ("M", 2, 2), ("A", 2, 1),
            ("C", 3, 2, 5), ("R",)]
IMAGE = (16, 13, 3)


def _cnn(mod, batch_normalize, fully_connected):
    return mod.CNNEncoder(name="cnn", data_id="images",
                          convolutions=CNN_SPEC, image_height=IMAGE[0],
                          image_width=IMAGE[1], pixel_dim=IMAGE[2],
                          fully_connected=fully_connected,
                          batch_normalize=batch_normalize)


def _cnn_case(batch_normalize, fully_connected):
    jax_enc = _cnn(jax_cnn, batch_normalize, fully_connected)
    enc = _cnn(cnn_encoder, batch_normalize, fully_connected)
    jax_params, params = _shared(jax_enc, enc, seed=9, scale=0.5)
    images = np.random.RandomState(10).rand(2, *IMAGE).astype(np.float32)
    return jax_enc, enc, jax_params, params, {"cnn.images": images}


@pytest.mark.parametrize("batch_normalize", [False, True])
@pytest.mark.parametrize("fully_connected", [None, [7, 5]])
def test_cnn_encoder_matches_jax(batch_normalize, fully_connected):
    jax_enc, enc, jax_params, params, batch = _cnn_case(batch_normalize,
                                                        fully_connected)
    ctx = _contexts(jax_params, params, batch)[1]
    jax_view = jax_cnn.CNNTemporalView(name="view", cnn=jax_enc)
    ref, ref_mask, ref_out, ref_view, ref_view_mask = _jax_outputs(
        lambda c: (jax_enc.spatial_states(c), jax_enc.spatial_mask(c),
                   jax_enc.output(c), jax_view.temporal_states(c),
                   jax_view.temporal_mask(c)), jax_params, batch)
    states = enc.spatial_states(ctx)
    assert tuple(states.shape) == ref.shape == (2, 2, 1, 5)
    assert enc._out_shape == jax_enc._out_shape
    assert enc.output_dim == jax_enc.output_dim
    _close(states, ref)
    _close(enc.spatial_mask(ctx), ref_mask)
    _close(enc.output(ctx), ref_out)
    view = cnn_encoder.CNNTemporalView(name="view", cnn=enc)
    _close(view.temporal_states(ctx), ref_view)
    _close(view.temporal_mask(ctx), ref_view_mask)
    assert view.state_dim == 5


@pytest.mark.parametrize("batch_normalize", [False, True])
def test_cnn_encoder_gradients_match_jax(batch_normalize):
    jax_enc, enc, jax_params, params, batch = _cnn_case(batch_normalize,
                                                        [7])
    _assert_grads(lambda c: jnp.sum(jax_enc.output(c) ** 2)
                  + jnp.sum(jax_enc.spatial_states(c)),
                  lambda c: (enc.output(c) ** 2).sum()
                  + enc.spatial_states(c).sum(),
                  jax_params, params, batch)


def test_cnn_encoder_refuses_the_bf16_policy():
    """Under the bf16 compute policy both packages refuse the CNN
    encoder: the JAX package's convolution raises a TypeError on the
    float32 images beside the bf16 kernels, the port a ValueError that
    names the policy, before any convolution runs."""
    jax_enc, enc, jax_params, params, batch = _cnn_case(False, None)
    jax_policy.set_compute_dtype("bfloat16")
    policy.set_compute_dtype("bfloat16")
    try:
        with pytest.raises(TypeError):
            _jax_outputs(jax_enc.spatial_states, jax_params, batch)
        ctx = _contexts(jax_params, params, batch)[1]
        with pytest.raises(ValueError, match="bfloat16 compute policy"):
            enc.spatial_states(ctx)
    finally:
        jax_policy.set_compute_dtype(None)
        policy.set_compute_dtype(None)
    # float32 again: the same encoder runs
    assert enc.spatial_states(_contexts(jax_params, params, batch)[1]
                              ).dtype == torch.float32


def test_cnn_encoder_refuses_other_images():
    enc = _cnn(cnn_encoder, False, None)

    class Images:
        @staticmethod
        def has_series(name):
            return name == "images"

        @staticmethod
        def get_series(name):
            return [np.zeros((4, 4, 3), np.float32)]
    with pytest.raises(ValueError, match="expected"):
        enc.featurize(Images())
    with pytest.raises(ValueError, match="Unknown CNN layer"):
        cnn_encoder.CNNEncoder(name="c", data_id="i", convolutions=[("X",)],
                               image_height=4, image_width=4)
