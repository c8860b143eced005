"""The port's multimodal inputs and attentions against the JAX package's,
on the CPU.

Each part is built by both packages at small widths (batch 3, source 7,
a 2 x 3 grid of 5 channels, width 16); parameters are drawn once with
numpy and loaded into both (``params_from_jax``), and both see the same
numpy batch. Tolerance 1e-5 on values and 1e-4 on gradients (float32
sums in another order), unless a test says otherwise:

- ``numpy_reader.single_tensor`` and ``from_file_list``: equal rows;
- ``SpatialFiller`` (as it is, projected, through its tanh layer): the
  features, states, mask and mean-pooled output, and the flattening of
  a spatial encoder to T = H·W for attention;
- ``FlatMultiAttention`` and ``HierarchicalMultiAttention``: ``step``
  (with and without shared projections) and the hierarchical
  ``tile_constants``; both raise a ValueError for the two knobs the
  reference accepts and ignores;
- ``ScaledDotProdAttention`` and ``MultiHeadAttention``: ``step``,
  ``step_beamed`` and ``attend_sequence`` with dropout off; with dropout
  on, the keep rate and a fresh draw each step;
- ``CoverageAttention`` in a decoder: the loss and gradients, greedy ids
  and lineage beam ids;
- a tiny multimodal model (text BiGRU, a spatial filler, hierarchical or
  flat attention, conditional-GRU decoder): the loss, the gradients, the
  greedy ids and the beam-3 ids; then hier_multimodal.ini through both
  packages' managers from one ``.npz``, five training steps' losses;
- the INIs to the JAX package's gates (tests/test_capability_inis.py,
  tests/test_multimodal_integration.py): captioning BLEU > 60, the
  hierarchical model BLEU > 60 and more than 10 over its image-blind
  control, flat_multiattention trained with a BLEU.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.dataset import BatchingScheme as JaxBatchingScheme
from neuralmonkey_tpu.dataset import from_dict as jax_from_dict
from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.attention import base_attention as jax_base
from neuralmonkey_tpu.models.attention import combination as jax_comb
from neuralmonkey_tpu.models.attention import feed_forward as jax_ff
from neuralmonkey_tpu.models.attention import scaled_dot_product as jax_sdp
from neuralmonkey_tpu.models.decoders.beam_search_decoder import \
    BeamSearchDecoder as JaxBeamSearch
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders.numpy_stateful_filler import \
    SpatialFiller as JaxSpatialFiller
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.readers import numpy_reader as jax_numpy_reader
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.dataset import BatchingScheme, from_dict
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention import base_attention
from neuralmonkey_tpu_torch.models.attention import combination
from neuralmonkey_tpu_torch.models.attention import coverage
from neuralmonkey_tpu_torch.models.attention import feed_forward
from neuralmonkey_tpu_torch.models.attention import scaled_dot_product
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders.numpy_stateful_filler import \
    SpatialFiller
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.readers import numpy_reader
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

import test_torch_precision as precision

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
CONFIG_DIR = os.path.join(TESTS, "configs")
DATA = os.path.join(TESTS, "data")
BATCH, SRC, WIDTH, OUT, BEAM = 3, 7, 16, 6, 3
GRID = (2, 3, 5)
LENGTHS = [7, 4, 2]
ATOL, GRAD_ATOL = 1e-5, 1e-4

JAX = SimpleNamespace(
    Encoder=JaxSentenceEncoder, Filler=JaxSpatialFiller,
    Attention=jax_ff.Attention, Coverage=jax_ff.CoverageAttention,
    Flat=jax_comb.FlatMultiAttention, Hier=jax_comb.HierarchicalMultiAttention,
    ScaledDot=jax_sdp.ScaledDotProdAttention,
    MultiHead=jax_sdp.MultiHeadAttention, Decoder=JaxDecoder,
    Vocabulary=JaxVocabulary)
PORT = SimpleNamespace(
    Encoder=SentenceEncoder, Filler=SpatialFiller,
    Attention=feed_forward.Attention, Coverage=coverage.CoverageAttention,
    Flat=combination.FlatMultiAttention,
    Hier=combination.HierarchicalMultiAttention,
    ScaledDot=scaled_dot_product.ScaledDotProdAttention,
    MultiHead=scaled_dot_product.MultiHeadAttention, Decoder=Decoder,
    Vocabulary=Vocabulary)


def _vocab(ns, size=30, prefix="w"):
    return ns.Vocabulary([f"{prefix}{i}" for i in range(size - 4)])


def _shared(jax_roots, port_roots, seed=0):
    """(JAX params, port params) of the parts under the roots, one numpy
    draw loaded into both."""
    jax_params = jax_init(jax_collect_parts(jax_roots), jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    flat = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
            for k, v in jax_flatten(jax_params).items()}
    template = init_all_params(collect_parts(port_roots), seed=0)
    return jax_restore(jax_params, flat), params_from_jax(flat, template)


def _mask(lengths, time):
    mask = np.zeros((len(lengths), time), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return mask


def _batch(rng, targets=True):
    batch = {"text_input.ids": rng.randint(4, 30, (BATCH, SRC)
                                           ).astype(np.int32),
             "text_input.mask": _mask(LENGTHS, SRC),
             "image.spatial": rng.randn(BATCH, *GRID).astype(np.float32)}
    if targets:
        full = rng.randint(4, 30, (BATCH, OUT + 1)).astype(np.int32)
        full[:, 0] = 1  # <s>
        batch.update({"decoder.train_inputs": full[:, :-1],
                      "decoder.train_targets": full[:, 1:],
                      "decoder.train_mask": _mask([6, 5, 3], OUT)})
    return batch


def _contexts(jax_params, port_params, batch):
    return (JaxContext(jax_params, {k: jnp.asarray(v)
                                    for k, v in batch.items()}),
            Context(port_params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}))


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _encoders(ns, projection=WIDTH, ff=None):
    text = ns.Encoder(name="text", vocabulary=_vocab(ns), data_id="source",
                      embedding_size=WIDTH, rnn_size=WIDTH // 2)
    image = ns.Filler(name="image", input_shape=list(GRID), data_id="maps",
                      projection_dim=projection, ff_hidden_dim=ff)
    return text, image


# ---------------------------------------------------------------------- #
# the reader and the filler
# ---------------------------------------------------------------------- #
def test_numpy_readers_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    a, b = rng.randn(3, 2, 4), rng.randn(2, 2, 4)
    np.save(tmp_path / "a.npy", a)
    np.savez(tmp_path / "b.npz", b)
    paths = [str(tmp_path / "a.npy"), str(tmp_path / "b.npz")]
    got = list(numpy_reader.single_tensor(paths))
    want = list(jax_numpy_reader.single_tensor(paths))
    assert len(got) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for i, row in enumerate(rng.randn(3, 8)):
        np.save(tmp_path / f"item{i}.npy", row)
    with open(tmp_path / "list.txt", "w") as f:
        f.write("item0\nitem1\nitem2\n")
    kwargs = dict(prefix=str(tmp_path), shape=[2, 4], suffix=".npy")
    got = list(numpy_reader.numpy_file_list_reader(**kwargs)(
        [str(tmp_path / "list.txt")]))
    want = list(jax_numpy_reader.from_file_list(**kwargs)(
        [str(tmp_path / "list.txt")]))
    assert [g.shape for g in got] == [(2, 4)] * 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("projection,ff", [(None, None), (WIDTH, None),
                                           (WIDTH, 12)])
def test_spatial_filler_matches_jax(projection, ff):
    """The maps as they are, projected, and through the tanh layer
    first: states, the all-ones mask, the mean-pooled output and the
    flattening to T = H·W that every attention reads."""
    jax_fill = _encoders(JAX, projection, ff)[1]
    fill = _encoders(PORT, projection, ff)[1]
    jax_params, params = _shared([jax_fill], [fill])
    batch = {"image.spatial": np.random.RandomState(1).randn(
        BATCH, *GRID).astype(np.float32)}
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    assert fill.state_dim == jax_fill.state_dim == (projection or GRID[2])
    _close(fill.spatial_states(ctx), jax_fill.spatial_states(jax_ctx))
    _close(fill.spatial_mask(ctx), jax_fill.spatial_mask(jax_ctx))
    _close(fill.output(ctx), jax_fill.output(jax_ctx))
    states = base_attention.get_attention_states(ctx, fill)
    assert states.shape == (BATCH, GRID[0] * GRID[1], fill.state_dim)
    _close(states, jax_base.get_attention_states(jax_ctx, jax_fill))
    _close(base_attention.get_attention_mask(ctx, fill),
           jax_base.get_attention_mask(jax_ctx, jax_fill))


def test_spatial_filler_featurizes_as_jax():
    maps = [np.full(GRID, i, np.float32) for i in range(3)]
    want = JaxSpatialFiller("f", list(GRID), "maps").featurize(
        jax_from_dict({"maps": maps}))
    got = SpatialFiller("f", list(GRID), "maps").featurize(
        from_dict({"maps": maps}))
    np.testing.assert_array_equal(got["f.spatial"], want["f.spatial"])
    with pytest.raises(ValueError, match="expected"):
        SpatialFiller("f", [2, 3, 4], "maps").featurize(
            from_dict({"maps": maps}))
    with pytest.raises(ValueError, match="height, width, depth"):
        SpatialFiller("f", [2, 3], "maps")


# ---------------------------------------------------------------------- #
# the multi-source attentions
# ---------------------------------------------------------------------- #
def _combination(ns, kind, share):
    text, image = _encoders(ns)
    if kind == "flat":
        att = ns.Flat(name="flat", encoders=[text, image],
                      attention_state_size=12, share_attn_projections=share)
    else:
        children = [ns.Attention(name="text_att", encoder=text,
                                 state_size=10),
                    ns.Attention(name="image_att", encoder=image,
                                 state_size=10)]
        att = ns.Hier(name="hier", attentions=children,
                      attention_state_size=12, share_attn_projections=share)
    att.register_query_dim(WIDTH)
    return att


@pytest.mark.parametrize("kind", ["flat", "hier"])
@pytest.mark.parametrize("share", [False, True])
def test_combination_step_matches_jax(kind, share):
    """One step's context and weights (the hierarchical attention's are
    its children's, side by side); the projections shared or not. The
    parameter trees have the same keys."""
    jax_att, att = _combination(JAX, kind, share), _combination(PORT, kind,
                                                                share)
    jax_params, params = _shared([jax_att], [att])
    assert sorted(flatten_tree(params)) == sorted(jax_flatten(jax_params))
    rng = np.random.RandomState(2)
    jax_ctx, ctx = _contexts(jax_params, params, _batch(rng, False))
    query = rng.randn(BATCH, WIDTH).astype(np.float32)
    want = jax_att.step(jax_params[att.name], jax_att.precompute(jax_ctx),
                        jnp.asarray(query))
    got = att.step(params[att.name], att.precompute(ctx),
                   torch.from_numpy(query))
    assert got[1].shape == (BATCH, SRC + GRID[0] * GRID[1])
    for g, w in zip(got, want):
        _close(g, w)


def test_hierarchical_tile_constants_matches_jax():
    """Each child's constants repeat K times on the batch axis; the
    children's parameters stay; a step over the tiled constants is the
    step of each row repeated K times. Under lineage beam search the
    hierarchical attention tiles too (its children step per beam)."""
    jax_att, att = _combination(JAX, "hier", False), _combination(
        PORT, "hier", False)
    jax_params, params = _shared([jax_att], [att])
    rng = np.random.RandomState(3)
    jax_ctx, ctx = _contexts(jax_params, params, _batch(rng, False))
    assert not att.beam_shared_constants
    tiled = att.tile_constants_lineage(att.precompute(ctx), BEAM)
    jax_tiled = jax_att.tile_constants(jax_att.precompute(jax_ctx), BEAM)
    assert tiled["child_params"] is att.precompute(ctx)["child_params"]
    for child, jax_child in zip(tiled["children"], jax_tiled["children"]):
        assert child.states.shape[0] == BATCH * BEAM
        for g, w in zip(child, jax_child):
            _close(g, w)
    query = rng.randn(BATCH * BEAM, WIDTH).astype(np.float32)
    got = att.step(params["hier"], tiled, torch.from_numpy(query))
    want = jax_att.step(jax_params["hier"], jax_tiled, jnp.asarray(query))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("kind", ["flat", "hier"])
@pytest.mark.parametrize("knob", [{"use_sentinels": True},
                                  {"dropout_keep_prob": 0.5}])
def test_combination_refuses_the_ignored_knobs(kind, knob):
    """The reference accepts these and never reads them; the port
    raises, naming the knob."""
    text, image = _encoders(PORT)
    name = next(iter(knob))
    with pytest.raises(ValueError, match=name):
        if kind == "flat":
            combination.FlatMultiAttention(
                name="flat", encoders=[text, image],
                attention_state_size=12, **knob)
        else:
            combination.HierarchicalMultiAttention(
                name="hier", attentions=[feed_forward.Attention(
                    name="a", encoder=text)], attention_state_size=12,
                **knob)


# ---------------------------------------------------------------------- #
# scaled dot-product attentions
# ---------------------------------------------------------------------- #
def _dot_attention(ns, heads, keep=1.0, query_dim=WIDTH + 4):
    text, _ = _encoders(ns)
    if heads:
        att = ns.MultiHead(name="mh", n_heads=heads, keys_encoder=text,
                           dropout_keep_prob=keep)
    else:
        att = ns.ScaledDot(name="sdp", keys_encoder=text,
                           dropout_keep_prob=keep)
    att.register_query_dim(query_dim)
    return att


@pytest.mark.parametrize("heads", [0, 4])
@pytest.mark.parametrize("query_dim", [WIDTH, WIDTH + 4])
def test_scaled_dot_product_matches_jax(heads, query_dim):
    """``step``, ``step_beamed`` over one shared copy of the constants,
    and ``attend_sequence``, dropout off; the query projected where its
    width differs from the keys' (single head)."""
    jax_att = _dot_attention(JAX, heads, query_dim=query_dim)
    att = _dot_attention(PORT, heads, query_dim=query_dim)
    jax_params, params = _shared([jax_att], [att])
    rng = np.random.RandomState(4)
    jax_ctx, ctx = _contexts(jax_params, params, _batch(rng, False))
    jax_const, const = jax_att.precompute(jax_ctx), att.precompute(ctx)
    jp, p = jax_params[att.name], params[att.name]
    query = rng.randn(BATCH, query_dim).astype(np.float32)
    for g, w in zip(att.step(p, const, torch.from_numpy(query)),
                    jax_att.step(jp, jax_const, jnp.asarray(query))):
        _close(g, w)
    beam_query = rng.randn(BATCH * BEAM, query_dim).astype(np.float32)
    assert att.beam_shared_constants
    for g, w in zip(att.step_beamed(p, const, torch.from_numpy(beam_query),
                                    BEAM),
                    jax_att.step_beamed(jp, jax_const,
                                        jnp.asarray(beam_query), BEAM)):
        _close(g, w)
    queries = rng.randn(BATCH, 5, query_dim).astype(np.float32)
    for g, w in zip(att.attend_sequence(p, const, torch.from_numpy(queries)),
                    jax_att.attend_sequence(jp, jax_const,
                                            jnp.asarray(queries))):
        assert g.shape[:2] == (BATCH, 5)
        _close(g, w)


@pytest.mark.parametrize("heads", [0, 2])
def test_scaled_dot_product_dropout_keeps_its_rate_and_draws_fresh(heads):
    """With keep 0.75 and a generator, a step's softmax weights are
    dropped (inverted: the kept ones scaled by 1/0.75, not renormalized)
    before the values are summed; the returned weights stay undropped.
    Over 512 rows the kept share is 0.75 (within 0.02); one seed draws
    one mask, another seed another (the decoder gives each step its
    own)."""
    att = _dot_attention(PORT, heads, keep=0.75, query_dim=WIDTH)
    _, params = _shared([_dot_attention(JAX, heads, query_dim=WIDTH)], [att])
    rng = np.random.RandomState(5)
    ctx = Context(params, {
        "text_input.ids": torch.from_numpy(rng.randint(
            4, 30, (512, SRC)).astype(np.int32)),
        "text_input.mask": torch.ones(512, SRC)})
    const = att.precompute(ctx)
    p = params[att.name]
    query = torch.from_numpy(rng.randn(512, WIDTH).astype(np.float32))
    plain_context, weights = att.step(p, const, query)

    def dropped(seed):
        return att._drop_weights(
            weights if not heads else weights[:, None].expand(
                -1, heads, -1), torch.Generator().manual_seed(seed))

    first, again, second = dropped(7), dropped(7), dropped(8)
    assert torch.equal(first, again) and not torch.equal(first, second)
    kept = first > 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    full = weights if not heads else weights[:, None].expand(-1, heads, -1)
    torch.testing.assert_close(first[kept], full[kept] / 0.75)
    context, step_weights = att.step(p, const, query,
                                     dropout_gen=torch.Generator().manual_seed(7))
    assert torch.equal(step_weights, weights)
    assert not torch.allclose(context, plain_context)
    if not heads:
        torch.testing.assert_close(
            context, torch.einsum("bt,btd->bd", first, const.states))


def test_decoder_gives_weights_dropout_a_fresh_generator_each_step():
    """The teacher-forced pass hands a scaled dot-product attention with
    keep < 1 one generator a step, each from its own seed; Bahdanau
    attention gets none; inference hands none."""
    text, _ = _encoders(PORT)
    sdp = scaled_dot_product.ScaledDotProdAttention(
        name="sdp", keys_encoder=text, dropout_keep_prob=0.5)
    bahdanau = feed_forward.Attention(name="att", encoder=text,
                                      dropout_keep_prob=0.5)
    dec = Decoder(name="decoder", vocabulary=_vocab(PORT), data_id="target",
                  max_output_len=OUT, encoders=[text],
                  attentions=[sdp, bahdanau], rnn_size=WIDTH,
                  embedding_size=WIDTH)
    params = init_all_params(collect_parts([dec]), seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(
        np.random.RandomState(6)).items()}
    seen = []
    plain_step = sdp.step

    def step(p, c, q, dropout_gen=None):
        seen.append(None if dropout_gen is None
                    else dropout_gen.initial_seed())
        return plain_step(p, c, q, dropout_gen=dropout_gen)
    sdp.step = step
    dec.train_loss(Context(params, batch, train=True, rng=3))
    assert len(seen) == OUT and len(set(seen)) == OUT and None not in seen
    seen.clear()
    dec.train_loss(Context(params, batch))
    assert seen == [None] * OUT


# ---------------------------------------------------------------------- #
# decoders over coverage and the multi-source attentions
# ---------------------------------------------------------------------- #
def _model(ns, kind, conditional_gru=True):
    """A decoder over a text BiGRU and a spatial filler through ``kind``:
    "hier" (a Bahdanau child each), "flat", or "coverage" (a coverage
    attention over the text alone)."""
    text, image = _encoders(ns)
    if kind == "coverage":
        attentions = [ns.Coverage(name="cov", encoder=text, state_size=10)]
    elif kind == "flat":
        attentions = [ns.Flat(name="flat", encoders=[text, image],
                              attention_state_size=12)]
    else:
        attentions = [ns.Hier(name="hier", attentions=[
            ns.Attention(name="text_att", encoder=text, state_size=10),
            ns.Attention(name="image_att", encoder=image, state_size=10)],
            attention_state_size=12)]
    return ns.Decoder(name="decoder", vocabulary=_vocab(ns),
                      data_id="target", max_output_len=OUT,
                      encoders=[text, image], attentions=attentions,
                      rnn_size=WIDTH, embedding_size=WIDTH,
                      conditional_gru=conditional_gru)


def _model_case(kind, conditional_gru=True, seed=7):
    jax_dec = _model(JAX, kind, conditional_gru)
    dec = _model(PORT, kind, conditional_gru)
    jax_params, params = _shared([jax_dec], [dec], seed=seed)
    batch = _batch(np.random.RandomState(seed + 1))
    return jax_dec, dec, jax_params, params, batch


CASES = [("hier", True), ("hier", False), ("flat", True),
         ("coverage", True), ("coverage", False)]


@pytest.mark.parametrize("kind,conditional_gru", CASES)
def test_model_loss_and_gradients_match_jax(kind, conditional_gru):
    jax_dec, dec, jax_params, params, batch = _model_case(kind,
                                                          conditional_gru)
    jax_loss, jax_grads = jax.value_and_grad(lambda p: jax_dec.train_loss(
        JaxContext(p, {k: jnp.asarray(v) for k, v in batch.items()})))(
            jax_params)
    flat = flatten_tree(params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    loss = dec.train_loss(Context(params, {k: torch.from_numpy(v)
                                           for k, v in batch.items()}))
    loss.backward()
    _close(loss, jax_loss)
    jax_grads = jax_flatten(jax_grads)
    assert set(jax_grads) == set(flat)
    for key, ref in jax_grads.items():
        got = flat[key].grad
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(ref), atol=GRAD_ATOL,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("kind,conditional_gru", CASES)
def test_model_greedy_and_beam_ids_match_jax(kind, conditional_gru):
    """Greedy ids, and the ids and scores of a beam-3 lineage search (the
    coverage threaded through the search's parents, the hierarchical
    children's constants tiled to B·K rows)."""
    jax_dec, dec, jax_params, params, batch = _model_case(kind,
                                                          conditional_gru)
    jax_ctx, ctx = _contexts(jax_params, params, batch)
    with torch.inference_mode():
        np.testing.assert_array_equal(dec.greedy_ids(ctx).numpy(),
                                      np.asarray(jax_dec.greedy_ids(jax_ctx)))
        got = BeamSearchDecoder(name="bs", parent_decoder=dec,
                                beam_size=BEAM).search(ctx)
    want = JaxBeamSearch(name="bs", parent_decoder=jax_dec,
                         beam_size=BEAM).search(jax_ctx)
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(want.token_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4)


jax_pallas = precision.jax_pallas


@pytest.mark.parametrize("kind,conditional_gru", CASES)
def test_model_bf16_matches_jax(jax_pallas, kind, conditional_gru):
    """Under the bf16 compute policy of both packages (the JAX program
    compiled with every bf16 rounding kept and its Pallas GRU in
    interpret mode, whose carries stay float32 as the port's do;
    ``test_torch_precision``): the teacher-forced loss (1e-5) and the
    gradient of every float32 master parameter (within float32 sum
    order and a bf16 rounding of the largest), the greedy ids, and the
    beam-3 ids (equal) and scores (1e-4)."""
    jax_dec, dec, jax_params, params, batch = _model_case(kind,
                                                          conditional_gru)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    flat = flatten_tree(params)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    search = BeamSearchDecoder(name="bs", parent_decoder=dec,
                               beam_size=BEAM)
    jax_search = JaxBeamSearch(name="bs", parent_decoder=jax_dec,
                               beam_size=BEAM)
    with precision.both_policies(precision.BF16):
        jax_loss, jax_grads = precision._compiled(jax.value_and_grad(
            lambda p: jax_dec.train_loss(JaxContext(p, jax_batch))),
            jax_params)
        jax_greedy, want = precision._compiled(lambda p: (
            jax_dec.greedy_ids(JaxContext(p, jax_batch)),
            jax_search.search(JaxContext(p, jax_batch))), jax_params)
        loss = dec.train_loss(Context(params, {
            k: torch.from_numpy(v) for k, v in batch.items()}))
        loss.backward()
        with torch.inference_mode():
            ctx = Context(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
            greedy = dec.greedy_ids(ctx)
            got = search.search(ctx)
    with torch.no_grad():
        loss32 = dec.train_loss(Context(params, {
            k: torch.from_numpy(v) for k, v in batch.items()}))
    # the policy changes the numbers
    assert loss.item() != loss32.item()
    _close(loss, jax_loss)
    jax_grads = jax_flatten(jax_grads)
    assert set(jax_grads) == set(flat)
    precision._assert_grads(
        {k: (torch.zeros(v.shape) if flat[k].grad is None else flat[k].grad)
         for k, v in jax_grads.items()}, jax_grads)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jax_greedy))
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(want.token_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-4)


def test_coverage_state_follows_the_beam_parents():
    """The lineage step gathers the coverage by the previous step's
    parents, as it gathers the recurrent state: a step from reversed
    parents equals the step from the reordered loop state."""
    _, dec, _, params, batch = _model_case("coverage")
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    const = dec.decode_constants(ctx)
    state, (cov,) = dec.tile_decode_state(
        dec.decode_initial_state(ctx, const), BEAM)
    const = dec.tile_decode_constants_lineage(const, BEAM)
    rng = np.random.RandomState(9)
    state = state + torch.from_numpy(rng.randn(*state.shape).astype(
        np.float32))
    cov = cov + torch.from_numpy(rng.rand(*cov.shape).astype(np.float32))
    prev = torch.from_numpy(rng.randint(4, 30, BATCH * BEAM).astype(
        np.int32))
    flipped = torch.arange(BEAM, dtype=torch.int32)[None, :, None].repeat(
        BATCH, 1, 4)
    flipped[:, :, 1] = flipped[:, :, 1].flip(1)

    def reorder(x):
        return x.reshape(BATCH, BEAM, -1).flip(1).reshape(BATCH * BEAM, -1)
    got = dec.decode_step_lineage(const, (state, (cov,)), prev, 2, flipped,
                                  BEAM)
    ref = dec.decode_step(const, (reorder(state), (reorder(cov),)), prev, 2)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0][1][0], ref[0][1][0], rtol=0, atol=0)
    assert torch.allclose(ref[0][1][0].sum(-1),
                          reorder(cov).sum(-1) + 1.0, atol=1e-5)


# ---------------------------------------------------------------------- #
# hier_multimodal.ini through both packages
# ---------------------------------------------------------------------- #
def _ini_changes(out):
    return [f'main.output="{out}"', "decoder.dropout_keep_prob=1.0",
            "text_encoder.dropout_keep_prob=1.0"]


def test_hier_multimodal_ini_trains_like_jax(tmp_path):
    """From one ``.npz`` of the JAX package's initial draw, five training
    steps of hier_multimodal.ini (Adam, clipping 1.0, dropout off) give
    the same losses and gradient norms in both managers (1e-5
    relative)."""
    ini = os.path.join(CONFIG_DIR, "hier_multimodal.ini")
    jax_exp = JaxExperiment(ini, train_mode=True,
                            config_changes=_ini_changes(tmp_path / "j"))
    jax_exp.build_model()
    exp = Experiment(ini, train_mode=True, config_changes=_ini_changes(
        tmp_path / "p") + ['tf_manager.device="cpu"'])
    exp.build_model()
    path = tmp_path / "shared.npz"
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in jax_flatten(
            jax_exp.tf_manager.params).items()})
    exp.tf_manager.restore(str(path))
    jax_batches = jax_exp.model.train_dataset.batches(
        JaxBatchingScheme(batch_size=16), shuffled=False)
    batches = exp.model.train_dataset.batches(BatchingScheme(batch_size=16),
                                              shuffled=False)
    for step in range(5):
        want = jax_exp.tf_manager.train_on_batch(
            jax_exp.model.trainer, next(jax_batches), 16)
        got = exp.tf_manager.train_on_batch(exp.model.trainer, next(batches),
                                            16)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=f"step {step} {key}")


# ---------------------------------------------------------------------- #
# the INIs to their gates
# ---------------------------------------------------------------------- #
def _train(config, out, changes=(), initial=None):
    """Train ``config`` through the port on the CPU (from the ``.npz``
    ``initial`` when given); the last validation record."""
    changes = ['tf_manager.device="cpu"', f'main.output="{out}"',
               *changes]
    if initial:
        changes.append(f'main.initial_variables="{initial}"')
    Experiment(os.path.join(CONFIG_DIR, config), train_mode=True,
               config_changes=changes).train()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["kind"] == "train"]
    assert train[-1]["loss"] < train[0]["loss"], "loss did not decrease"
    return [r for r in records if r["kind"] == "val"][-1]


@pytest.fixture(autouse=True)
def _at_the_root(monkeypatch):
    monkeypatch.chdir(os.path.dirname(TESTS))  # the INIs' data paths


def test_captioning_ini_clears_its_gate(tmp_path):
    """tests/test_multimodal_integration.py's captioning gate."""
    val = _train("captioning.ini", tmp_path / "cap", [
        "main.epochs=12", "main.logging_period=50",
        "main.validation_period=200", "decoder.dropout_keep_prob=1.0"])
    assert val["caption/BLEU-4"] > 60.0, val


def test_flat_multiattention_ini_trains(tmp_path):
    """tests/test_capability_inis.py's gate: trained, with a BLEU."""
    val = _train("flat_multiattention.ini", tmp_path / "flat",
                 ["main.logging_period=10"])
    assert "target/BLEU-4" in val


def test_hier_multimodal_ini_uses_the_image(tmp_path):
    """tests/test_multimodal_integration.py's gate: the full model's
    BLEU over 60 and more than 10 over its image-blind control (zeroed
    features), both from the JAX package's initial draw at the INI's
    seed, as the JAX test trains them (the port's own draw at that seed
    is another sample of the same spread)."""
    ini = os.path.join(CONFIG_DIR, "hier_multimodal.ini")
    jax_exp = JaxExperiment(ini, train_mode=True, config_changes=[
        f'main.output="{tmp_path / "j"}"'])
    jax_exp.build_model()
    initial = str(tmp_path / "initial.npz")
    with open(initial, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in jax_flatten(
            jax_exp.tf_manager.params).items()})
    changes = ["main.epochs=10", "main.logging_period=50",
               "main.validation_period=400", "decoder.dropout_keep_prob=1.0",
               "text_encoder.dropout_keep_prob=1.0"]
    full = _train("hier_multimodal.ini", tmp_path / "full", changes,
                  initial)["target/BLEU-4"]
    zero_train = os.path.join(DATA, "mmt_feats_zero_train.npy")
    zero_val = os.path.join(DATA, "mmt_feats_zero_val.npy")
    blind = _train("hier_multimodal.ini", tmp_path / "blind", changes + [
        f'train_data.s_feats=("{zero_train}", '
        "readers.numpy_reader.single_tensor)",
        f'val_data.s_feats=("{zero_val}", '
        "readers.numpy_reader.single_tensor)"], initial)["target/BLEU-4"]
    assert full > 60.0, (full, blind)
    assert full - blind > 10.0, (full, blind)
