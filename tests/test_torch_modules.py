"""The port's model parts against the JAX package's, module by module.

The same parts are built by both packages at small widths (batch 3,
source 7, width 16, vocabulary 300, beam 4); their parameters are drawn
once with numpy and loaded into both. The GRU encoder, the attention
step and its beam-shared form, and the decoder's ``decode_step`` and
``decode_step_lineage`` (plain and with the fused logit projection
armed) must agree to 1e-5. Also: parameter names and shapes, the
checkpoint checks of ``params_from_jax``, and the config resolver.
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
from neuralmonkey_tpu.models.decoders.beam_search_decoder import \
    length_penalty as jax_length_penalty
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.ops import nn as jax_nn
from neuralmonkey_tpu.ops.rnn import \
    bidirectional_rnn as jax_bidirectional_rnn
from neuralmonkey_tpu.ops.rnn import unidirectional_rnn as jax_rnn
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.config.builder import resolve_class_symbol
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    length_penalty
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.ops import nn, rnn
from neuralmonkey_tpu_torch.utils.saving import (flatten_tree, load_flat,
                                                 params_from_jax, save_tree)
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BATCH, SRC, WIDTH, VOCAB, BEAM = 3, 7, 16, 300, 4
ATOL = 1e-5


def _vocabulary(cls):
    return cls([f"w{i}" for i in range(VOCAB - 4)])


def _build(enc_cls, att_cls, dec_cls, conditional_gru):
    vocab = _vocabulary(JaxVocabulary if enc_cls is JaxSentenceEncoder
                        else Vocabulary)
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, rnn_size=WIDTH, max_input_len=SRC)
    att = att_cls(name="attention", encoder=enc, state_size=WIDTH)
    dec = dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                  max_output_len=6, rnn_size=WIDTH, encoders=[enc],
                  attentions=[att], embedding_size=WIDTH,
                  conditional_gru=conditional_gru)
    return enc, att, dec


class Pair:
    """The same model in both packages, with shared random parameters."""

    def __init__(self, conditional_gru=True, seed=0):
        self.jax = _build(JaxSentenceEncoder, JaxAttention, JaxDecoder,
                          conditional_gru)
        self.port = _build(SentenceEncoder, Attention, Decoder,
                           conditional_gru)
        jax_params = jax_init(jax_collect_parts([self.jax[2]]),
                              jax.random.PRNGKey(0))
        rng = np.random.RandomState(seed)
        flat = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
                for k, v in jax_flatten(jax_params).items()}
        self.jax_params = jax_restore(jax_params, flat)
        template = init_all_params(collect_parts([self.port[2]]), seed=0)
        self.port_params = params_from_jax(flat, template)
        ids = rng.randint(4, VOCAB, (BATCH, SRC)).astype(np.int32)
        mask = np.zeros((BATCH, SRC), np.float32)
        for i, n in enumerate([7, 4, 2]):
            mask[i, :n] = 1.0
        self.jax_ctx = JaxContext(self.jax_params, {
            "encoder_input.ids": jnp.asarray(ids),
            "encoder_input.mask": jnp.asarray(mask)})
        self.ctx = Context(self.port_params, {
            "encoder_input.ids": torch.from_numpy(ids),
            "encoder_input.mask": torch.from_numpy(mask)})
        self.rng = rng


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol)


def test_parameter_names_and_shapes_match_jax():
    jax_parts = jax_collect_parts([_build(JaxSentenceEncoder, JaxAttention,
                                          JaxDecoder, True)[2]])
    port_parts = collect_parts([_build(SentenceEncoder, Attention, Decoder,
                                       True)[2]])
    jax_flat = jax_flatten(jax_init(jax_parts, jax.random.PRNGKey(1)))
    port_flat = flatten_tree(init_all_params(port_parts, seed=1))
    assert {k: v.shape for k, v in jax_flat.items()} == {
        k: tuple(v.shape) for k, v in port_flat.items()}
    assert [p.name for p in jax_parts] == [p.name for p in port_parts]


def test_params_from_jax_checks_keys_and_shapes(tmp_path):
    template = {"a": {"w": torch.zeros(2, 3), "b": torch.zeros(3)}}
    good = {"a/w": np.ones((2, 3), np.float32),
            "a/b": np.ones(3, np.float32)}
    with pytest.raises(KeyError, match="missing"):
        params_from_jax({"a/w": good["a/w"]}, template)
    with pytest.raises(KeyError, match="extra"):
        params_from_jax({**good, "a/c": good["a/b"]}, template)
    with pytest.raises(ValueError, match="shape mismatch"):
        params_from_jax({**good, "a/b": np.ones(4, np.float32)}, template)
    path = str(tmp_path / "ckpt.npz")
    save_tree(path, params_from_jax(good, template))
    restored = params_from_jax(load_flat(path), template)
    assert torch.equal(restored["a"]["w"], torch.ones(2, 3))


def test_gru_cell_matches_jax():
    rng = np.random.RandomState(3)
    params = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
              for k, v in jax_flatten(jax_nn.GRUCell(5, 6).init(
                  jax.random.PRNGKey(0))).items()}
    h = rng.randn(4, 6).astype(np.float32)
    x = rng.randn(4, 5).astype(np.float32)
    ref, _ = jax_nn.GRUCell(5, 6)({k: jnp.asarray(v) for k, v in
                                   params.items()}, jnp.asarray(h),
                                  jnp.asarray(x))
    got, _ = nn.GRUCell(5, 6)({k: torch.from_numpy(v) for k, v in
                               params.items()}, torch.from_numpy(h),
                              torch.from_numpy(x))
    _close(got, ref)


@pytest.mark.parametrize("reverse", [False, True])
def test_step_scan_matches_jax(reverse):
    """The masked scan at a hidden size that is no multiple of 4, through
    ``ops.rnn`` (the plain version of K1 on the CPU)."""
    cell = jax_nn.GRUCell(5, 6)
    rng = np.random.RandomState(4)
    params = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
              for k, v in jax_flatten(cell.init(jax.random.PRNGKey(0))
                                      ).items()}
    x = rng.randn(BATCH, SRC, 5).astype(np.float32)
    mask = np.zeros((BATCH, SRC), np.float32)
    mask[0], mask[1, :3], mask[2, :1] = 1, 1, 1
    ref = jax_rnn(cell, {k: jnp.asarray(v) for k, v in params.items()},
                  jnp.asarray(x), jnp.asarray(mask), reverse=reverse,
                  allow_pallas=False)
    got = rnn.unidirectional_rnn(
        nn.GRUCell(5, 6), {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), torch.from_numpy(mask), reverse)
    for g, r in zip(got, ref):
        _close(g, r)


def test_bidirectional_rnn_of_two_sizes_matches_jax():
    """Forward and backward cells of different sizes (one scan each)."""
    cells = jax_nn.GRUCell(5, 6), jax_nn.GRUCell(5, 8)
    rng = np.random.RandomState(5)
    params = [{k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
               for k, v in jax_flatten(c.init(jax.random.PRNGKey(0))).items()}
              for c in cells]
    x = rng.randn(BATCH, SRC, 5).astype(np.float32)
    mask = np.zeros((BATCH, SRC), np.float32)
    mask[0], mask[1, :5], mask[2, :2] = 1, 1, 1
    ref = jax_bidirectional_rnn(
        cells[0], {k: jnp.asarray(v) for k, v in params[0].items()},
        cells[1], {k: jnp.asarray(v) for k, v in params[1].items()},
        jnp.asarray(x), jnp.asarray(mask), allow_pallas=False)
    got = rnn.bidirectional_rnn(
        nn.GRUCell(5, 6), {k: torch.from_numpy(v) for k, v in
                           params[0].items()},
        nn.GRUCell(5, 8), {k: torch.from_numpy(v) for k, v in
                           params[1].items()},
        torch.from_numpy(x), torch.from_numpy(mask))
    assert got[0].shape == (BATCH, SRC, 14) and got[1].shape == (BATCH, 14)
    for g, r in zip(got, ref):
        _close(g, r)


def test_encoder_matches_jax():
    pair = Pair()
    (jenc, _, _), (enc, _, _) = pair.jax, pair.port
    _close(enc.temporal_states(pair.ctx), jenc.temporal_states(pair.jax_ctx))
    _close(enc.output(pair.ctx), jenc.output(pair.jax_ctx))


def test_attention_step_and_step_beamed_match_jax():
    pair = Pair()
    (_, jatt, _), (_, att, _) = pair.jax, pair.port
    jconst, const = jatt.precompute(pair.jax_ctx), att.precompute(pair.ctx)
    params, jparams = pair.port_params["attention"], \
        pair.jax_params["attention"]
    query = pair.rng.randn(BATCH, WIDTH).astype(np.float32)
    ref = jatt.step(jparams, jconst, jnp.asarray(query))
    got = att.step(params, const, torch.from_numpy(query))
    for g, r in zip(got, ref):
        _close(g, r)
    beam_query = pair.rng.randn(BATCH * BEAM, WIDTH).astype(np.float32)
    ref = jatt.step_beamed(jparams, jconst, jnp.asarray(beam_query), BEAM)
    got = att.step_beamed(params, const, torch.from_numpy(beam_query), BEAM)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("conditional_gru", [True, False])
def test_decode_step_matches_jax(conditional_gru):
    pair = Pair(conditional_gru)
    jdec, dec = pair.jax[2], pair.port[2]
    jconst = jdec.decode_constants(pair.jax_ctx)
    const = dec.decode_constants(pair.ctx)
    jstate = jdec.decode_initial_state(pair.jax_ctx, jconst)
    state = dec.decode_initial_state(pair.ctx, const)
    _close(state, jstate[0])
    prev = pair.rng.randint(4, VOCAB, BATCH).astype(np.int32)
    (jnew, _), jlogits, jaux = jdec.decode_step(jconst, jstate,
                                                jnp.asarray(prev), 0)
    new, logits, aux = dec.decode_step(const, state, torch.from_numpy(prev),
                                       0)
    _close(new, jnew)
    _close(logits, jlogits)
    _close(aux["attention_weights"][0], jaux["attention_weights"][0])


@pytest.mark.parametrize("step,fused", [(0, False), (3, False), (3, True)])
def test_decode_step_lineage_matches_jax(monkeypatch, step, fused):
    """Lineage step over beam-shared attention constants. Both take the
    ancestry and read the parents from its column step - 1 (at step 0
    the JAX version reads column -1 and the port column 0; a search's
    ancestry is the identity in both). With ``fused`` the decode
    constants are armed for the fused logit projection in both."""
    monkeypatch.setenv("NM_FUSED_LOGITS", "1" if fused else "0")
    pair = Pair()
    jdec, dec = pair.jax[2], pair.port[2]
    jconst = jdec.decode_constants(pair.jax_ctx)
    const = dec.decode_constants(pair.ctx)
    if fused:
        jconst = jdec.prepare_selection_fusion(jconst)
        const = dec.prepare_selection_fusion(const)
    jconst = jdec.tile_decode_constants_lineage(jconst, BEAM)
    const = dec.tile_decode_constants_lineage(const, BEAM)
    rows = BATCH * BEAM
    state = pair.rng.randn(rows, WIDTH).astype(np.float32)
    prev = pair.rng.randint(4, VOCAB, rows).astype(np.int32)
    anc = np.stack([np.stack([pair.rng.permutation(BEAM) for _ in range(6)],
                             axis=1) for _ in range(BATCH)])
    anc[:, :, 0] = anc[:, :, -1] = np.arange(BEAM)
    anc = anc.astype(np.int32)
    (jnew, _), jlogits, jaux = jdec.decode_step_lineage(
        jconst, (jnp.asarray(state), (None,)), jnp.asarray(prev), step,
        jnp.asarray(anc), BEAM)
    new, logits, aux = dec.decode_step_lineage(
        const, torch.from_numpy(state), torch.from_numpy(prev), step,
        torch.from_numpy(anc), BEAM)
    _close(new, jnew)
    _close(logits, jlogits)
    if fused:
        assert logits.shape == (rows, 1024)
        _close(aux["sel_rowmax"], jaux["sel_rowmax"])
        _close(aux["sel_lse"], jaux["sel_lse"])


def test_lineage_step_zero_reads_the_first_ancestry_column():
    """A search's first parents are the identity (the ancestry's first
    column): the step keeps each beam's own state. Other parents gather
    the state rows, as a reorder of the state before the step would."""
    pair = Pair()
    dec = pair.port[2]
    const = dec.tile_decode_constants_lineage(
        dec.decode_constants(pair.ctx), BEAM)
    rows = BATCH * BEAM
    state = torch.from_numpy(pair.rng.randn(rows, WIDTH).astype(np.float32))
    prev = torch.from_numpy(pair.rng.randint(4, VOCAB, rows).astype(np.int32))
    identity = torch.arange(BEAM, dtype=torch.int32)[None, :, None].repeat(
        BATCH, 1, 4)
    flipped = identity.clone()
    flipped[:, :, 1] = flipped[:, :, 1].flip(1)
    ref = dec._finish_step(const, state, prev, beam=BEAM)
    got = dec.decode_step_lineage(const, state, prev, 0, identity, BEAM)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    reordered = state.reshape(BATCH, BEAM, WIDTH).flip(1).reshape(rows, -1)
    ref = dec._finish_step(const, reordered, prev, beam=BEAM)
    got = dec.decode_step_lineage(const, state, prev, 2, flipped, BEAM)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_length_penalty_matches_jax():
    lengths = np.arange(0, 12, dtype=np.int32)
    for alpha in (0.0, 0.6, 1.0):
        _close(length_penalty(torch.from_numpy(lengths), alpha),
               jax_length_penalty(jnp.asarray(lengths), alpha))


def test_resolver_builds_port_modules_only():
    from neuralmonkey_tpu_torch.evaluators.bleu import BLEU
    from neuralmonkey_tpu_torch.processors.bpe import BPEPreprocessor
    from neuralmonkey_tpu_torch.trainers.optimizers import AdamOptimizer
    from neuralmonkey_tpu_torch.vocabulary import from_wordlist
    assert resolve_class_symbol("encoders.recurrent.SentenceEncoder") \
        is SentenceEncoder
    assert resolve_class_symbol(
        "neuralmonkey.decoders.decoder.Decoder") is Decoder
    # a JAX-package path resolves to the port's class, never into JAX
    assert resolve_class_symbol(
        "neuralmonkey_tpu.models.attention.feed_forward.Attention") \
        is Attention
    # the JAX package's JAX-free modules resolve to the port's copies
    assert resolve_class_symbol("evaluators.bleu.BLEU") is BLEU
    assert resolve_class_symbol(
        "neuralmonkey_tpu.vocabulary.from_wordlist") is from_wordlist
    assert resolve_class_symbol("tf.train.AdamOptimizer") is AdamOptimizer
    with pytest.raises(ImportError, match="not ported"):
        resolve_class_symbol("neuralmonkey_tpu.trainers.optimizers.Adam")
    assert resolve_class_symbol("processors.bpe.BPEPreprocessor") \
        is BPEPreprocessor
    from neuralmonkey_tpu_torch.processors.wordpiece import \
        WordpiecePreprocessor
    assert resolve_class_symbol(
        "processors.wordpiece.WordpiecePreprocessor") is WordpiecePreprocessor
    # the pipeline and the ring resolve to the port's
    from neuralmonkey_tpu_torch.parallel.pipeline import gpipe_apply
    assert resolve_class_symbol("neuralmonkey_tpu.parallel.pipeline."
                                "gpipe_apply") is gpipe_apply
    from neuralmonkey_tpu_torch.parallel.ring_attention import \
        ring_attention
    assert resolve_class_symbol("neuralmonkey_tpu.parallel.ring_attention."
                                "ring_attention") is ring_attention
