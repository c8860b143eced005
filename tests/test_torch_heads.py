"""The port's task heads and their host modules against the JAX
package's, on the CPU.

Each part is built by both packages at small widths (batch 3, source 7,
width 16); parameters are drawn once with numpy and loaded into both
(``params_from_jax``), and both see the same numpy batch. Tolerance 1e-5
on values and 1e-4 on gradients (float32 sums in another order, through
7 recurrent steps), unless a test says otherwise:

- ``SequenceLabeler`` over a BiGRU ``SentenceEncoder``: logits, loss,
  gradients, and ``LabelRunner``'s tags;
- ``SequenceRegressor`` over a projecting ``StatefulFiller``: the
  filler's output, the predictions, the loss and the gradients, and
  ``RegressionRunner``'s outputs;
- ``WordAlignmentDecoder`` over the attentive RNN ``Decoder``: the
  attention matrix, the alignment loss (its 1e-9 floor included) and the
  gradients, and ``WordAlignmentRunner``'s matrices;
- a ``Decoder`` with no encoder and no attention (``language_model.ini``)
  through ``PerplexityRunner``: the ``xents`` and perplexities;
- the edit operations, the word-alignment preprocessor, both
  string-vector readers and the accuracy and error evaluators: equal;
- the chunked flash and lineage paths' plain versions (head dims 320
  and 640) against the JAX kernels in interpret mode, 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.evaluators import accuracy as jax_accuracy
from neuralmonkey_tpu.evaluators import mse as jax_mse
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.decoders.sequence_labeler import \
    SequenceLabeler as JaxSequenceLabeler
from neuralmonkey_tpu.models.decoders.sequence_regressor import \
    SequenceRegressor as JaxSequenceRegressor
from neuralmonkey_tpu.models.decoders.word_alignment_decoder import \
    WordAlignmentDecoder as JaxWordAlignmentDecoder
from neuralmonkey_tpu.models.encoders.numpy_stateful_filler import \
    StatefulFiller as JaxStatefulFiller
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.ops import lineage_attention as jax_la
from neuralmonkey_tpu.ops import pallas_attention as pa
from neuralmonkey_tpu.processors import alignment as jax_alignment
from neuralmonkey_tpu.processors import editops as jax_editops
from neuralmonkey_tpu.readers import string_vector_reader as jax_readers
from neuralmonkey_tpu.runners.label_runner import \
    LabelRunner as JaxLabelRunner
from neuralmonkey_tpu.runners.perplexity_runner import \
    PerplexityRunner as JaxPerplexityRunner
from neuralmonkey_tpu.runners.regression_runner import \
    RegressionRunner as JaxRegressionRunner
from neuralmonkey_tpu.runners.word_alignment_runner import \
    WordAlignmentRunner as JaxWordAlignmentRunner
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.evaluators import accuracy, mse
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.decoders.sequence_labeler import \
    SequenceLabeler
from neuralmonkey_tpu_torch.models.decoders.sequence_regressor import \
    SequenceRegressor
from neuralmonkey_tpu_torch.models.decoders.word_alignment_decoder import \
    WordAlignmentDecoder
from neuralmonkey_tpu_torch.models.encoders.numpy_stateful_filler import (
    SpatialFiller, StatefulFiller)
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.ops import flash_attention as fa
from neuralmonkey_tpu_torch.ops import lineage_attention as la
from neuralmonkey_tpu_torch.processors import alignment, editops
from neuralmonkey_tpu_torch.readers import string_vector_reader as readers
from neuralmonkey_tpu_torch.runners.label_runner import LabelRunner
from neuralmonkey_tpu_torch.runners.perplexity_runner import \
    PerplexityRunner
from neuralmonkey_tpu_torch.runners.regression_runner import \
    RegressionRunner
from neuralmonkey_tpu_torch.runners.word_alignment_runner import \
    WordAlignmentRunner
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)
DATA = os.path.join(os.path.dirname(__file__), "data")
BATCH, SRC, WIDTH, OUT = 3, 7, 16, 6
LENGTHS = [7, 4, 2]
ATOL, GRAD_ATOL = 1e-5, 1e-4


def _vocab(cls, size=40, prefix="w"):
    return cls([f"{prefix}{i}" for i in range(size - 4)])


def _shared(jax_root, port_root, seed=0):
    """(JAX params, port params) of the parts under the two roots, the
    same numpy draw loaded into both."""
    jax_params = jax_init(jax_collect_parts([jax_root]),
                          jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    flat = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
            for k, v in jax_flatten(jax_params).items()}
    template = init_all_params(collect_parts([port_root]), seed=0)
    return jax_restore(jax_params, flat), params_from_jax(flat, template)


def _mask(lengths, time):
    mask = np.zeros((len(lengths), time), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return mask


def _encoder_batch(rng, vocab_size=40):
    return {"encoder_input.ids": rng.randint(4, vocab_size, (BATCH, SRC)
                                             ).astype(np.int32),
            "encoder_input.mask": _mask(LENGTHS, SRC)}


def _contexts(jax_params, port_params, batch):
    return (JaxContext(jax_params, {k: jnp.asarray(v)
                                    for k, v in batch.items()}),
            Context(port_params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _grads(jax_part, port_part, loss_name, jax_params, port_params, batch):
    """(JAX gradients, port gradients) of ``loss_name`` as flat dicts."""
    jax_grads = jax_flatten(jax.grad(lambda p: getattr(jax_part, loss_name)(
        JaxContext(p, {k: jnp.asarray(v) for k, v in batch.items()})))(
            jax_params))
    flat = flatten_tree(port_params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    loss = getattr(port_part, loss_name)(
        Context(port_params, {k: torch.from_numpy(v)
                              for k, v in batch.items()}))
    loss.backward()
    return jax_grads, {k: v.grad for k, v in flat.items()}


def _assert_grads(jax_grads, port_grads):
    """Equal within GRAD_ATOL; a parameter the loss does not reach has
    no port gradient and a zero JAX one."""
    assert set(jax_grads) == set(port_grads)
    for key, ref in jax_grads.items():
        got = port_grads[key]
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(ref), atol=GRAD_ATOL,
                                   rtol=0, err_msg=key)


# ---------------------------------------------------------------------- #
# the labeler
# ---------------------------------------------------------------------- #
def _labeler(enc_cls, lab_cls, vocab_cls):
    enc = enc_cls(name="encoder", vocabulary=_vocab(vocab_cls),
                  data_id="source", embedding_size=WIDTH, rnn_size=WIDTH)
    return lab_cls(name="labeler", encoder=enc,
                   vocabulary=_vocab(vocab_cls, 10, "t"), data_id="tags",
                   hidden_dim=12)


def _labeler_case(label_time=SRC):
    jax_lab = _labeler(JaxSentenceEncoder, JaxSequenceLabeler, JaxVocabulary)
    lab = _labeler(SentenceEncoder, SequenceLabeler, Vocabulary)
    jax_params, params = _shared(jax_lab, lab, seed=1)
    rng = np.random.RandomState(2)
    batch = _encoder_batch(rng)
    batch["labeler.labels"] = rng.randint(0, 10, (BATCH, label_time)
                                          ).astype(np.int32)
    batch["labeler.labels_mask"] = _mask([min(n, label_time)
                                          for n in LENGTHS], label_time)
    return jax_lab, lab, jax_params, params, batch


@pytest.mark.parametrize("label_time", [SRC, 5])
def test_labeler_logits_and_loss_match_jax(label_time):
    """Labels as long as the encoder's states, and shorter (the loss
    cuts the logits' time axis to the labels')."""
    jax_lab, lab, jax_params, params, batch = _labeler_case(label_time)
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    _close(lab.logits(ctx), jax_lab.logits(jax_ctx))
    _close(lab.train_loss(ctx), jax_lab.train_loss(jax_ctx))
    np.testing.assert_array_equal(lab.decoded(ctx).numpy(),
                                  np.asarray(jax_lab.decoded(jax_ctx)))


def test_labeler_gradients_match_jax():
    jax_lab, lab, jax_params, params, batch = _labeler_case()
    _assert_grads(*_grads(jax_lab, lab, "train_loss", jax_params, params,
                          batch))


def test_label_runner_matches_jax():
    jax_lab, lab, jax_params, params, batch = _labeler_case()
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    jax_runner, runner = JaxLabelRunner("tags", jax_lab), LabelRunner(
        "tags", lab)
    want = jax_runner.collect_results(
        {k: np.asarray(v) for k, v in jax_runner.fetches(jax_ctx).items()},
        BATCH)
    got = runner.collect_results(
        {k: v.detach().numpy() for k, v in runner.fetches(ctx).items()},
        BATCH)
    assert got.outputs == want.outputs
    assert [len(t) for t in got.outputs] == LENGTHS
    assert got.losses["loss"] == pytest.approx(want.losses["loss"],
                                               abs=ATOL)


# ---------------------------------------------------------------------- #
# the regressor over a StatefulFiller
# ---------------------------------------------------------------------- #
def _regressor(fill_cls, reg_cls, output_shape):
    filler = fill_cls(name="filler", dimension=6, data_id="vec",
                      output_shape=output_shape)
    return reg_cls(name="regressor", encoders=[filler], data_id="target",
                   layers=[8, 5], dimension=2)


def _regressor_case(output_shape=4):
    jax_reg = _regressor(JaxStatefulFiller, JaxSequenceRegressor,
                         output_shape)
    reg = _regressor(StatefulFiller, SequenceRegressor, output_shape)
    jax_params, params = _shared(jax_reg, reg, seed=3)
    rng = np.random.RandomState(4)
    batch = {"filler.vector": rng.randn(BATCH, 6).astype(np.float32),
             "regressor.targets": rng.randn(BATCH, 2).astype(np.float32),
             "regressor.target_mask": np.array([1, 1, 0], np.float32)}
    return jax_reg, reg, jax_params, params, batch


@pytest.mark.parametrize("output_shape", [None, 4])
def test_stateful_filler_matches_jax(output_shape):
    """The vectors as they are, and projected to ``output_shape``."""
    jax_reg, reg, jax_params, params, batch = _regressor_case(output_shape)
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    _close(reg.encoders[0].output(ctx), jax_reg.encoders[0].output(jax_ctx))
    assert reg.encoders[0].output_dim == jax_reg.encoders[0].output_dim


def test_stateful_filler_featurizes_as_jax():
    from neuralmonkey_tpu.dataset import from_dict as jax_from_dict
    from neuralmonkey_tpu_torch.dataset import from_dict
    vectors = [np.arange(6, dtype=np.float32) + i for i in range(3)]
    want = JaxStatefulFiller("f", 6, "vec").featurize(
        jax_from_dict({"vec": vectors}))
    got = StatefulFiller("f", 6, "vec").featurize(from_dict({"vec": vectors}))
    np.testing.assert_array_equal(got["f.vector"], want["f.vector"])
    with pytest.raises(ValueError, match="expected 5"):
        StatefulFiller("f", 5, "vec").featurize(from_dict({"vec": vectors}))


def test_spatial_filler_names_its_queue_item():
    """Its queue item (A10) is done: the filler builds, and refuses a
    shape that is not (height, width, depth)."""
    assert SpatialFiller("maps", input_shape=[2, 2, 3],
                         data_id="maps").state_dim == 3
    with pytest.raises(ValueError, match="height, width, depth"):
        SpatialFiller("maps", input_shape=[2, 3], data_id="maps")


def test_regressor_outputs_loss_and_gradients_match_jax():
    """Predictions, the loss (the third row weighs 0) and gradients."""
    jax_reg, reg, jax_params, params, batch = _regressor_case()
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    _close(reg.predictions(ctx), jax_reg.predictions(jax_ctx))
    _close(reg.train_loss(ctx), jax_reg.train_loss(jax_ctx))
    _assert_grads(*_grads(jax_reg, reg, "train_loss", jax_params, params,
                          batch))


def test_regression_runner_matches_jax():
    jax_reg, reg, jax_params, params, batch = _regressor_case()
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    jax_runner = JaxRegressionRunner("score", jax_reg)
    runner = RegressionRunner("score", reg)
    want = jax_runner.collect_results(
        {k: np.asarray(v) for k, v in jax_runner.fetches(jax_ctx).items()},
        2)
    got = runner.collect_results(
        {k: v.detach().numpy() for k, v in runner.fetches(ctx).items()}, 2)
    np.testing.assert_allclose(got.outputs, want.outputs, atol=ATOL)
    assert got.losses["mse"] == pytest.approx(want.losses["mse"], abs=ATOL)


# ---------------------------------------------------------------------- #
# word alignment over the attentive decoder
# ---------------------------------------------------------------------- #
def _aligner(enc_cls, att_cls, dec_cls, align_cls, vocab_cls):
    vocab = _vocab(vocab_cls)
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, rnn_size=WIDTH, max_input_len=SRC)
    att = att_cls(name="attention", encoder=enc, state_size=WIDTH)
    dec = dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                  max_output_len=OUT, rnn_size=WIDTH, encoders=[enc],
                  attentions=[att], embedding_size=WIDTH)
    return align_cls(name="alignment_decoder", encoder=enc, decoder=dec,
                     data_id="align")


def _alignment_case(floor_hit=False):
    jax_align = _aligner(JaxSentenceEncoder, JaxAttention, JaxDecoder,
                         JaxWordAlignmentDecoder, JaxVocabulary)
    align = _aligner(SentenceEncoder, Attention, Decoder,
                     WordAlignmentDecoder, Vocabulary)
    jax_params, params = _shared(jax_align, align, seed=5)
    rng = np.random.RandomState(6)
    batch = _encoder_batch(rng)
    steps = OUT + 1
    batch["decoder.train_inputs"] = rng.randint(4, 40, (BATCH, steps)
                                                ).astype(np.int32)
    batch["decoder.train_targets"] = rng.randint(4, 40, (BATCH, steps)
                                                 ).astype(np.int32)
    batch["decoder.train_mask"] = _mask([7, 5, 3], steps)
    pre = alignment.WordAlignmentPreprocessor(source_len=SRC,
                                              target_len=steps)
    lines = ["0-0 1-1 2-2 3-2 4-3", "0-1 1-0 2-2", "0-0 1-1"]
    if floor_hit:  # a target on a masked source position: weight 0
        lines[2] = "0-0 1-1 5-2"
    batch["alignment_decoder.alignment"] = np.stack(
        [pre(line.split()) for line in lines])
    return jax_align, align, jax_params, params, batch


@pytest.mark.parametrize("floor_hit", [False, True])
def test_alignment_loss_matches_jax(floor_hit):
    """The attention matrix and the alignment loss; with an alignment on
    a masked source position, whose attention weight is 0, the loss goes
    through the 1e-9 floor of the logarithm in both."""
    jax_align, align, jax_params, params, batch = _alignment_case(floor_hit)
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    _close(align.alignment(ctx), jax_align.alignment(jax_ctx))
    loss = align.train_loss(ctx)
    _close(loss, jax_align.train_loss(jax_ctx), atol=1e-4 if floor_hit
           else ATOL)
    assert (float(loss) > 2.0) == floor_hit  # -log(1e-9) / 8 aligned


def test_alignment_gradients_match_jax():
    jax_align, align, jax_params, params, batch = _alignment_case()
    _assert_grads(*_grads(jax_align, align, "train_loss", jax_params, params,
                          batch))


def test_word_alignment_runner_matches_jax():
    jax_align, align, jax_params, params, batch = _alignment_case()
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    jax_runner = JaxWordAlignmentRunner("alignment",
                                        alignment_decoder=jax_align)
    runner = WordAlignmentRunner("alignment", alignment_decoder=align)
    want = jax_runner.collect_results(
        {k: np.asarray(v) for k, v in jax_runner.fetches(jax_ctx).items()},
        BATCH)
    got = runner.collect_results(
        {k: v.detach().numpy() for k, v in runner.fetches(ctx).items()},
        BATCH)
    for g, w in zip(got.outputs, want.outputs):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_alignment_decoder_needs_max_input_len():
    vocab = _vocab(Vocabulary)
    enc = SentenceEncoder(name="encoder", vocabulary=vocab, data_id="source",
                          embedding_size=WIDTH, rnn_size=WIDTH)
    dec = Decoder(name="decoder", vocabulary=vocab, data_id="target",
                  max_output_len=OUT, rnn_size=WIDTH, encoders=[enc],
                  embedding_size=WIDTH)
    with pytest.raises(ValueError, match="max_input_len"):
        WordAlignmentDecoder("align", enc, dec, "align")


# ---------------------------------------------------------------------- #
# the language model's perplexity
# ---------------------------------------------------------------------- #
def test_perplexity_runner_matches_jax():
    """A Decoder with no encoder and no attention (language_model.ini):
    the runner's per-sentence perplexities and mean ``xents``."""
    def build(dec_cls, vocab_cls):
        return dec_cls(name="decoder", vocabulary=_vocab(vocab_cls),
                       data_id="target", max_output_len=OUT, rnn_size=24,
                       embedding_size=WIDTH)
    jax_dec, dec = build(JaxDecoder, JaxVocabulary), build(Decoder,
                                                           Vocabulary)
    jax_params, params = _shared(jax_dec, dec, seed=7)
    rng = np.random.RandomState(8)
    steps = OUT + 1
    batch = {"decoder.train_inputs": rng.randint(4, 40, (BATCH, steps)
                                                 ).astype(np.int32),
             "decoder.train_targets": rng.randint(4, 40, (BATCH, steps)
                                                  ).astype(np.int32),
             "decoder.train_mask": _mask([7, 5, 1], steps)}
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    _close(dec.train_xents(ctx), jax_dec.train_xents(jax_ctx), atol=1e-4)
    jax_runner = JaxPerplexityRunner("perplexity", jax_dec)
    runner = PerplexityRunner("perplexity", dec)
    want = jax_runner.collect_results(
        {k: np.asarray(v) for k, v in jax_runner.fetches(jax_ctx).items()},
        BATCH)
    got = runner.collect_results(
        {k: v.detach().numpy() for k, v in runner.fetches(ctx).items()},
        BATCH)
    np.testing.assert_allclose(got.outputs, want.outputs, rtol=1e-5)
    assert got.losses["xents"] == pytest.approx(want.losses["xents"],
                                                abs=ATOL)


# ---------------------------------------------------------------------- #
# host modules
# ---------------------------------------------------------------------- #
def _lines(name):
    with open(os.path.join(DATA, name), encoding="utf-8") as f:
        return [line.split() for line in f]


def test_editops_round_trip_the_post_edit_data():
    """Every (MT, reference) pair of the post-edit data: the same edits
    as the JAX package's, and the reference back from the MT and the
    edits, through ``Preprocess`` and ``Postprocess``."""
    pairs = list(zip(_lines("pe.mt"), _lines("pe.ref")))
    assert pairs
    pre, post = editops.Preprocess(), editops.Postprocess()
    for source, target in pairs:
        edits = pre((source, target))
        assert edits == jax_editops.Preprocess()((source, target))
        assert post((source, edits)) == target
        assert post((source, edits)) == jax_editops.Postprocess()(
            (source, edits))


@pytest.mark.parametrize("source,edits", [
    (["a", "b", "c"], ["<keep>"]),            # ops end before the source
    (["a", "b"], ["<delete>", "x", "<keep>", "<keep>", "<keep>"]),
    ([], ["x", "<keep>", "<delete>"]),
])
def test_editops_reconstruct_edge_cases_as_jax(source, edits):
    assert editops.reconstruct(source, edits) == jax_editops.reconstruct(
        source, edits)


def test_editops_postprocess_applies_its_result_postprocess():
    post = editops.Postprocess(result_postprocess=lambda sents: [
        [w.upper() for w in s] for s in sents])
    assert post((["a", "b"], ["<keep>", "x"])) == ["A", "X", "B"]


def test_alignment_preprocessor_matches_jax():
    for zero_based in (True, False):
        pre = alignment.WordAlignmentPreprocessor(12, 13,
                                                  zero_based=zero_based)
        jax_pre = jax_alignment.WordAlignmentPreprocessor(
            12, 13, zero_based=zero_based)
        for line in _lines("train.align")[:20] + [["1-1", "", "30-2"]]:
            np.testing.assert_array_equal(pre(line), jax_pre(line))
    assert alignment.parse_alignment(["0-1", "2-3"]) == [(0, 1), (2, 3)]


@pytest.mark.parametrize("reader", ["FloatVectorReader", "IntVectorReader"])
def test_string_vector_readers_match_jax(reader, tmp_path):
    """The float reader over the regressor's score files; the int reader
    over a file of integer rows."""
    paths = [os.path.join(DATA, "train.scores"),
             os.path.join(DATA, "val.vecsum")]
    if reader == "IntVectorReader":
        ints = tmp_path / "ints.txt"
        ints.write_text("1 2 3\n-4 0 7\n12 13 -1\n")
        paths = [str(ints)]
    got = list(getattr(readers, reader)(paths))
    want = list(getattr(jax_readers, reader)(paths))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_get_string_vector_reader_checks_columns(tmp_path):
    path = os.path.join(DATA, "train.vec")
    got = list(readers.get_string_vector_reader(columns=6)([path]))
    want = list(jax_readers.get_string_vector_reader(columns=6)([path]))
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    bad = tmp_path / "bad.vec"
    bad.write_text("1 2 3\n1 2\n")
    with pytest.raises(ValueError, match=r"bad.vec:2: expected 3"):
        list(readers.get_string_vector_reader(columns=3)([str(bad)]))


def test_accuracy_evaluators_match_jax():
    rng = np.random.RandomState(9)
    hyps = [[str(t) for t in rng.randint(0, 3, rng.randint(1, 6))]
            for _ in range(20)]
    refs = [[str(t) for t in rng.randint(0, 3, len(h) + rng.randint(0, 2))]
            for h in hyps]
    assert accuracy.Accuracy(hyps, refs) == jax_accuracy.Accuracy(hyps, refs)
    assert accuracy.AccuracySeqLevel(hyps, refs) == \
        jax_accuracy.AccuracySeqLevel(hyps, refs)
    labels = ["a", "b", "a", 1]
    assert accuracy.Accuracy(labels, ["a", "a", "a", "1"]) == \
        jax_accuracy.Accuracy(labels, ["a", "a", "a", "1"]) == 0.75
    with pytest.raises(ValueError):
        accuracy.Accuracy(["a"], [])


def test_error_evaluators_match_jax():
    rng = np.random.RandomState(10)
    hyps = list(rng.randn(12))
    refs = [np.array([x]) for x in rng.randn(12)]
    for name in ("MSE", "MAE", "MeanSquaredError"):
        assert getattr(mse, name)(hyps, refs) == pytest.approx(
            getattr(jax_mse, name)(hyps, refs), rel=1e-12)
    assert mse.MSE.compare_scores(0.1, 0.2) == 1  # lower is better
    assert mse.MAE.compare_scores(0.3, 0.2) == -1


# ---------------------------------------------------------------------- #
# the chunked paths' plain versions against the JAX kernels
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_version_at_head_dim_320_matches_jax(causal):
    """Past the single-pass width (320: two 256-column chunks on the
    card) the plain forward and backward against the JAX Pallas kernels
    in interpret mode, as tests/test_flash_dropout.py runs them, with
    dropout (the same key words), 1e-5."""
    rng = np.random.RandomState(11)
    q, k, v, g = (rng.randn(2, 2, 9, 320).astype(np.float32)
                  for _ in range(4))
    mask = _mask([9, 5], 9)
    words = np.asarray(pa.rng_to_key_words(jax.random.PRNGKey(3)))
    key = (int(words[0]), int(words[1]))
    keep = 0.8
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, mask))
    jkey = jnp.asarray(key, jnp.int32)
    ref_out, ref_lse = pa._flash_attention_pallas(*jargs, causal, 128, 128,
                                                  jkey, keep)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    out, lse = fa.flash_forward_reference(tq, tk, tv, tm, causal, key, keep)
    _close(out, ref_out)
    _close(lse, np.asarray(ref_lse).reshape(lse.shape))
    ref_grads = pa._flash_backward_pallas(
        *jargs, ref_out, ref_lse.reshape(ref_out.shape[:3]), jnp.asarray(g),
        causal, jkey, keep)
    grads = fa.flash_backward_reference(tq, tk, tv, tm, out, lse,
                                        torch.from_numpy(g), causal, key,
                                        keep)
    for got, want in zip(grads, ref_grads):
        _close(got, want)


def test_lineage_plain_version_at_head_dim_640_matches_jax():
    """Past 512 (the chunked instance on the card) the plain version
    against the JAX lineage kernel in interpret mode, as
    tests/test_lineage_attention.py runs it, at several windows; 1e-5."""
    rng = np.random.RandomState(12)
    batch, heads, beam, time, dim = 2, 1, 4, 6, 640
    q = rng.randn(batch, heads, beam, dim).astype(np.float32)
    kq = rng.randn(batch, heads, dim, beam * time).astype(np.float32)
    vq = rng.randn(batch, heads, beam * time, dim).astype(np.float32)
    anc = rng.randint(0, beam, (batch, beam, time)).astype(np.int32)
    total = beam * time
    for step in (0, 3, time - 1):
        win = step + 1
        lanes = la.lane_window(win, beam, total)
        jlanes = jax_la.lane_window(win, beam, total)
        ref_bias = np.asarray(jax_la.lineage_bias(jnp.asarray(anc), step, win,
                                                  beam, jlanes, time))
        bias = la.lineage_bias(torch.from_numpy(anc), step, win, beam, lanes,
                               time)
        k16 = ref_bias.shape[1]
        q16 = np.pad(q, ((0, 0), (0, 0), (0, k16 - beam), (0, 0)))
        ref = np.asarray(jax_la.lineage_attention(
            jnp.asarray(q16), jnp.asarray(kq), jnp.asarray(vq),
            jnp.asarray(ref_bias), jlanes))[:, :, :beam]
        got = la.lineage_attention_reference(
            torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq),
            bias)
        _close(got, ref)
