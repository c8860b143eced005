"""Beam search with the physical per-step reorder (``lineage="off"``, or
``NM_LINEAGE=0``) in the PyTorch port, against the JAX package's on the
CPU.

Tiny models (width 16, 2 + 2 Transformer layers, a 300-word vocabulary,
8 output steps, beam 3), one numpy draw of their parameters loaded into
both packages (the JAX tree's structure from ``jax.eval_shape``, its
search under ``jax.jit``). Each case compares the ids and lengths
exactly and the scores to 1e-5, or to 1e-4 where its lineage twin does:

- the RNN: flat and hierarchical selection, ``NM_FUSED_LOGITS=0`` and
  ``1``, ``align_logits``, coverage attention (its per-beam state rides
  the reorder), the attention histories (1e-5), a two-model ensemble;
- the Transformer, by default and under ``NM_LINEAGE_KERNEL=1``: its
  caches stay plain (B·K, T, D) rows and the lineage step never runs;
  its attention maps and a two-model ensemble;
- the hierarchical multimodal attention (its children's constants tiled
  to B·K rows, Bahdanau children through their plain ``step``);
- the MoE Transformer on a batch with a padding row;
- the bf16 policy, an RNN and a Transformer through
  ``test_torch_precision``'s machinery;
- and the port's own two forms against each other, as the JAX package's
  ``tests/test_beam_search.py`` holds its own: lineage decoding gives
  the physical reorder's ids and scores.
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
from neuralmonkey_tpu.models.attention.feed_forward import \
    CoverageAttention as JaxCoverageAttention
from neuralmonkey_tpu.models.decoders.beam_search_decoder import \
    BeamSearchDecoder as JaxBeamSearch
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.decoders.transformer import \
    TransformerDecoder as JaxTransformerDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.models.encoders.transformer import \
    TransformerEncoder as JaxTransformerEncoder
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import (
    Attention, CoverageAttention)
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.decoders.transformer import \
    TransformerDecoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.models.encoders.transformer import \
    TransformerEncoder
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

import test_torch_moe as moe
import test_torch_multimodal as multimodal
import test_torch_precision as precision

torch.set_num_threads(1)

BATCH, SRC, TGT, WIDTH, VOCAB, BEAM = 3, 7, 8, 16, 300, 3
ATOL = 1e-5


def _rnn(coverage=False, port=True):
    enc_cls, att_cls, dec_cls, vocab_cls = (
        (SentenceEncoder, CoverageAttention if coverage else Attention,
         Decoder, Vocabulary) if port else
        (JaxSentenceEncoder,
         JaxCoverageAttention if coverage else JaxAttention, JaxDecoder,
         JaxVocabulary))
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, rnn_size=WIDTH, max_input_len=SRC)
    att = att_cls(name="attention", encoder=enc, state_size=WIDTH)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=TGT, rnn_size=WIDTH, encoders=[enc],
                   attentions=[att], embedding_size=WIDTH,
                   conditional_gru=True)


def _transformer(port=True):
    enc_cls, dec_cls, vocab_cls = (
        (TransformerEncoder, TransformerDecoder, Vocabulary) if port else
        (JaxTransformerEncoder, JaxTransformerDecoder, JaxVocabulary))
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, ff_hidden_size=32, depth=2,
                  n_heads=2, max_input_len=SRC)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=TGT, encoders=[enc], embedding_size=WIDTH,
                   ff_hidden_size=32, depth=2, n_heads_self=2,
                   n_heads_enc=2)


MODELS = {
    "rnn": lambda port: _rnn(port=port),
    "coverage": lambda port: _rnn(coverage=True, port=port),
    "transformer": _transformer,
    "multimodal": lambda port: multimodal._model(
        multimodal.PORT if port else multimodal.JAX, "hier"),
    "moe": lambda port: moe._build(
        *((TransformerEncoder, TransformerDecoder, Vocabulary) if port else
          (JaxTransformerEncoder, JaxTransformerDecoder, JaxVocabulary)),
        max_out=7),
}


def _parameter_sets(jax_dec, dec, seeds, scale=0.3):
    """One numpy draw a seed, loaded into both packages: [(JAX params,
    port params)]."""
    jax_shapes = jax.eval_shape(lambda: jax_init(
        jax_collect_parts([jax_dec]), jax.random.PRNGKey(0)))
    template = init_all_params(collect_parts([dec]), seed=0)
    sets = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        flat = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
                for k, v in sorted(flatten_tree(template).items())}
        sets.append((jax_restore(jax_shapes, flat),
                     params_from_jax(flat, template)))
    return sets


def _batch(kind):
    rng = np.random.RandomState(7)
    if kind == "multimodal":
        return multimodal._batch(rng)
    if kind == "moe":
        # the fourth row pads the batch: an all-zero source mask
        return moe._batch(rng, (7, 4, 2, 0), targets=False)
    mask = np.zeros((BATCH, SRC), np.float32)
    for i, n in enumerate([7, 4, 2]):
        mask[i, :n] = 1.0
    return {"encoder_input.ids": rng.randint(4, VOCAB, (BATCH, SRC)).astype(
                np.int32),
            "encoder_input.mask": mask}


def _search_both(kind, seeds=(0,), with_attention=False, jax_side=True,
                 lineage="off", **options):
    """(the JAX package's search, the port's, the port's decoder): one
    model's, or with two ``seeds`` the ensemble's, both packages under
    ``lineage`` and the BeamSearchDecoder ``options``."""
    jax_dec, dec = MODELS[kind](False), MODELS[kind](True)
    sets = _parameter_sets(jax_dec, dec, seeds)
    batch = _batch(kind)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    port_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jax_bs = JaxBeamSearch(name="bs", parent_decoder=jax_dec,
                           beam_size=BEAM, lineage=lineage, **options)
    bs = BeamSearchDecoder(name="bs", parent_decoder=dec, beam_size=BEAM,
                           lineage=lineage, **options)
    ref = None
    if len(seeds) == 1:
        if jax_side:
            ref = jax.jit(lambda p: jax_bs.search(
                JaxContext(p, jax_batch, train=False),
                with_attention=with_attention))(sets[0][0])
        with torch.inference_mode():
            got = bs.search(Context(sets[0][1], port_batch, train=False),
                            with_attention=with_attention)
    else:
        if jax_side:
            ref = jax.jit(lambda ps: jax_bs.ensemble_search(
                [JaxContext(p, jax_batch, train=False) for p in ps]))(
                    [s[0] for s in sets])
        with torch.inference_mode():
            got = bs.ensemble_search([Context(s[1], port_batch, train=False)
                                      for s in sets])
    return ref, got, dec


def _assert_same_search(got, ref, atol=ATOL):
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(ref.token_ids))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               atol=atol, rtol=0)


def _record_steps(monkeypatch, cls):
    """Record the layout of the loop state each ``decode_step`` of
    ``cls`` receives; ``decode_step_lineage`` must never run."""
    layouts = []
    step = cls.decode_step

    def recording_step(self, constants, loop_state, *args, **kwargs):
        layouts.append(loop_state)
        return step(self, constants, loop_state, *args, **kwargs)

    def lineage_step(*args, **kwargs):
        raise AssertionError("the physical reorder ran a lineage step")
    monkeypatch.setattr(cls, "decode_step", recording_step)
    monkeypatch.setattr(cls, "decode_step_lineage", lineage_step)
    return layouts


# ---------------------------------------------------------------------- #
# the RNN
# ---------------------------------------------------------------------- #
RNN_CASES = {
    "flat": ({"selection_method": "flat"}, None),
    "hierarchical_fused": ({"selection_method": "hierarchical"}, "1"),
    "hierarchical_unfused": ({"selection_method": "hierarchical"}, "0"),
    "align_logits": ({"selection_method": "hierarchical",
                      "align_logits": True}, None),
}


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_rnn_physical_search_matches_jax(monkeypatch, case):
    """Every step is the RNN's ``decode_step`` at B·K rows (the
    Bahdanau attention's plain ``step`` over tiled constants, K2's path
    on the card); the loop state is gathered by the parents."""
    options, fused = RNN_CASES[case]
    if fused is not None:
        monkeypatch.setenv("NM_FUSED_LOGITS", fused)
    layouts = _record_steps(monkeypatch, Decoder)
    ref, got, _ = _search_both("rnn", **options)
    _assert_same_search(got, ref)
    assert layouts and all(s.shape == (BATCH * BEAM, WIDTH)
                           for s in layouts)


def test_rnn_coverage_physical_search_matches_jax(monkeypatch):
    """The coverage is per beam: it is tiled with the state and gathered
    with it, beside the Bahdanau state's None-free tree."""
    layouts = _record_steps(monkeypatch, Decoder)
    ref, got, _ = _search_both("coverage")
    _assert_same_search(got, ref)
    state, (cov,) = layouts[-1]
    assert state.shape == (BATCH * BEAM, WIDTH)
    assert cov.shape == (BATCH * BEAM, SRC)


def test_rnn_attention_histories_match_jax():
    """The first attention's weights move with their hypotheses: each
    final hypothesis's history equals the JAX package's (1e-5)."""
    ref, got, _ = _search_both("rnn", with_attention=True)
    _assert_same_search(got, ref)
    assert got.attention.shape == (BATCH, BEAM, TGT, SRC)
    np.testing.assert_allclose(got.attention.numpy(),
                               np.asarray(ref.attention), atol=ATOL, rtol=0)


@pytest.mark.parametrize("selection", ["flat", "hierarchical"])
def test_rnn_ensemble_physical_search_matches_jax(monkeypatch, selection):
    """Each model's state is gathered by the parents on its own."""
    layouts = _record_steps(monkeypatch, Decoder)
    ref, got, _ = _search_both("rnn", seeds=(0, 1),
                               selection_method=selection)
    _assert_same_search(got, ref)
    assert layouts


# ---------------------------------------------------------------------- #
# the Transformer
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("lineage_kernel", ["0", "1"])
def test_transformer_physical_search_matches_jax(monkeypatch,
                                                 lineage_kernel):
    """By default and under NM_LINEAGE_KERNEL=1 the caches are plain
    (B·K, T, D) rows (never the lineage kernel's layout) and every step
    is ``decode_step`` over them."""
    monkeypatch.setenv("NM_LINEAGE_KERNEL", lineage_kernel)
    layouts = _record_steps(monkeypatch, TransformerDecoder)
    ref, got, _ = _search_both("transformer",
                               selection_method="hierarchical")
    _assert_same_search(got, ref)
    assert layouts
    for state in layouts:
        assert len(state) == 2
        for cache in state:
            assert sorted(cache) == ["k", "v"]
            assert all(c.shape == (BATCH * BEAM, TGT, WIDTH)
                       for c in cache.values())


def test_transformer_attention_maps_match_jax():
    """The last layer's first cross-attention, averaged over the heads,
    moves with its hypotheses as the RNN's weights do."""
    ref, got, _ = _search_both("transformer", with_attention=True)
    _assert_same_search(got, ref)
    assert got.attention.shape == (BATCH, BEAM, TGT, SRC)
    np.testing.assert_allclose(got.attention.numpy(),
                               np.asarray(ref.attention), atol=ATOL, rtol=0)


def test_transformer_ensemble_physical_search_matches_jax(monkeypatch):
    layouts = _record_steps(monkeypatch, TransformerDecoder)
    ref, got, _ = _search_both("transformer", seeds=(0, 1),
                               selection_method="hierarchical")
    _assert_same_search(got, ref)
    assert layouts and all(sorted(s[0]) == ["k", "v"] for s in layouts)


def test_moe_transformer_physical_search_matches_jax(monkeypatch):
    """The MoE FFN routes the B·K rows of each step with ``row_valid``
    tiled to them: the padding row's K rows stay masked out, and the
    real rows decode as without it."""
    layouts = _record_steps(monkeypatch, TransformerDecoder)
    ref, got, dec = _search_both("moe")
    _assert_same_search(got, ref, atol=1e-4)
    assert layouts
    # the real rows' hypotheses without the padding row
    sets = _parameter_sets(MODELS["moe"](False), dec, (0,))
    batch = {k: torch.from_numpy(v[:3]) for k, v in _batch("moe").items()}
    bs = BeamSearchDecoder(name="bs", parent_decoder=dec, beam_size=BEAM,
                           lineage="off")
    with torch.inference_mode():
        real = bs.search(Context(sets[0][1], batch, train=False))
    np.testing.assert_array_equal(got.token_ids[:3].numpy(),
                                  real.token_ids.numpy())


def test_hierarchical_multimodal_physical_search_matches_jax(monkeypatch):
    """The hierarchical attention's children tile their own constants to
    B·K rows; each Bahdanau child takes its plain step over them."""
    steps = []
    plain = Attention.step

    def counted(self, params, constants, query, **kwargs):
        steps.append(tuple(constants.keys.shape[:1]) + (query.shape[0],))
        return plain(self, params, constants, query, **kwargs)
    monkeypatch.setattr(Attention, "step", counted)
    ref, got, _ = _search_both("multimodal")
    _assert_same_search(got, ref, atol=1e-4)
    assert steps and all(s == (BATCH * BEAM, BATCH * BEAM) for s in steps)


# ---------------------------------------------------------------------- #
# the bf16 policy
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["rnn", "transformer"])
def test_physical_search_under_bf16_matches_jax(bf16, jax_pallas, tmp_path,
                                                model):
    """Under the bf16 compute policy of both packages (the JAX program
    compiled with every bf16 rounding kept, its Pallas kernels in
    interpret mode): beam-10 ids and lengths equal, scores within 1e-4,
    as the lineage form's twin in ``test_torch_precision`` holds them."""
    jax_pallas.setenv("NM_LINEAGE", "0")
    jax_pallas.setenv("NM_LINEAGE_KERNEL", "1")
    ref, got = precision._decode_both(model, 10, tmp_path)
    for name, a, b in zip(("greedy", "beam ids", "lengths"), got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=1e-4)


bf16 = precision.bf16
jax_pallas = precision.jax_pallas


# ---------------------------------------------------------------------- #
# the port's two forms
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,seeds,with_attention,options", [
    ("rnn", (0,), False, {"selection_method": "flat"}),
    ("rnn", (0,), False, {"selection_method": "hierarchical"}),
    ("rnn", (0, 1), False, {}),
    ("coverage", (0,), False, {}),
    ("rnn", (0,), True, {}),
    ("transformer", (0,), False, {"selection_method": "hierarchical"}),
    ("transformer", (0, 1), False, {})],
    ids=["rnn-flat", "rnn-hierarchical", "rnn-ensemble", "coverage",
         "rnn-histories", "transformer", "transformer-ensemble"])
def test_lineage_decoding_equals_the_physical_reorder(
        kind, seeds, with_attention, options):
    """The port's lineage and physical searches from one draw: the same
    ids and lengths, scores within 1e-5, and the same attention
    histories (``tests/test_beam_search.py:287-420``)."""
    outs = {mode: _search_both(kind, seeds, with_attention, jax_side=False,
                               lineage=mode, **options)[1]
            for mode in ("off", "on")}
    _assert_same_search(outs["on"], outs["off"])
    if with_attention:
        torch.testing.assert_close(outs["on"].attention,
                                   outs["off"].attention, atol=ATOL,
                                   rtol=0)


def test_transformer_lineage_kernel_layout_equals_the_physical_reorder(
        monkeypatch):
    """The lineage kernel's cache layout (its plain version on the CPU)
    against the physical reorder's plain rows."""
    monkeypatch.setenv("NM_LINEAGE_KERNEL", "1")
    outs = {mode: _search_both("transformer", jax_side=False, lineage=mode,
                               selection_method="hierarchical")[1]
            for mode in ("off", "on")}
    _assert_same_search(outs["on"], outs["off"])
