"""The port's layer-normalized and noisy-activation GRU cells against the
JAX package, on the CPU.

Parameters and inputs come from numpy seeds or from one ``.npz`` the JAX
package writes; batch <= 4, time <= 9, hidden <= 8.

- ``LayerNormGRUCell`` and ``NoisyGRUCell``, one step, without and with
  noise, to 1e-6; the noise formula is held by feeding both packages the
  same standard normal draws (the JAX side's ``jax.random.normal``
  replaced by one that returns them, the port's ``draw_noise``).
- Their parameter names and shapes are the JAX package's.
- ``SentenceEncoder`` with either cell, bidirectional in two layers,
  forward and backward, with padding: states and final output to 1e-5
  at inference; in training with the noise both packages draw replaced
  by one shared set of draws (the JAX scan run eagerly under
  ``jax.disable_jit`` so that each step reads its own draws).
- The same encoders under both packages' bf16 compute policy, at
  inference: states and final output to 1e-5.
- A ``Decoder`` with a noisy cell: its teacher-forced loss in training,
  with shared draws, to 1e-5 relative.
- Routing: these cells never reach ``gru_scan`` (K1), and a plain GRU,
  an OrthoGRU and an LSTM never reach the step scan.
- ``NoisyGRUCell(training=True)``, an unknown cell and a conditional GRU
  decoder over another cell raise.
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
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.ops import nn as jax_nn
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.ops import nn, rnn
from neuralmonkey_tpu_torch.utils.saving import load_flat, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

import test_torch_precision as precision

torch.set_num_threads(1)

BATCH, WIDTH, HIDDEN, TIME = 3, 6, 5, 9
CELLS = ["LayerNormGRU", "NoisyGRU"]


def _mask(lengths, time=TIME):
    mask = np.zeros((len(lengths), time), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return mask


def _random_params(rng, cell_type):
    """Parameters of the JAX cell's names and shapes, drawn from ``rng``
    (wide enough that the hard activations saturate)."""
    shapes = jax.eval_shape(
        jax_nn.make_cell(cell_type, WIDTH, HIDDEN).init,
        jax.random.PRNGKey(0))
    return {k: rng.uniform(-1.5, 1.5, v.shape).astype(np.float32)
            for k, v in shapes.items()}


class SharedNormals:
    """Replaces ``jax.random.normal`` by one that returns, call by call,
    the gate then the candidate columns of each step's draw (the order
    ``NoisyGRUCell.__call__`` draws them in)."""

    def __init__(self, draws):
        self.pending = [part for step in draws
                        for part in (step[:, :2 * HIDDEN],
                                     step[:, 2 * HIDDEN:])]

    def __call__(self, key, shape=(), dtype=jnp.float32):
        del key
        value = self.pending.pop(0)
        assert value.shape == tuple(shape)
        return jnp.asarray(value, dtype)


def _shared_npz(tmp_path, jax_params):
    path = tmp_path / "shared.npz"
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v)
                       for k, v in jax_flatten(jax_params).items()})
    return load_flat(str(path))


# ---------------------------------------------------------------------- #
# the cells
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cell_type", CELLS)
def test_cell_parameters_match_jax(cell_type):
    got = nn.make_cell(cell_type, WIDTH, HIDDEN).init(
        torch.Generator().manual_seed(0))
    ref = jax.eval_shape(jax_nn.make_cell(cell_type, WIDTH, HIDDEN).init,
                         jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}


@pytest.mark.parametrize("cell_type,noisy", [
    ("LayerNormGRU", False), ("NoisyGRU", False), ("NoisyGRU", True)],
    ids=["layer_norm", "noisy_inference", "noisy_training"])
def test_cell_step_matches_jax(cell_type, noisy, monkeypatch):
    rng = np.random.RandomState(0)
    params = _random_params(rng, cell_type)
    h = rng.uniform(-1, 1, (BATCH, HIDDEN)).astype(np.float32)
    x = rng.randn(BATCH, WIDTH).astype(np.float32) * 2
    draw = rng.randn(BATCH, 3 * HIDDEN).astype(np.float32)
    jax_cell = jax_nn.make_cell(cell_type, WIDTH, HIDDEN)
    kwargs = {}
    if noisy:
        monkeypatch.setattr(jax.random, "normal", SharedNormals([draw]))
        kwargs = {"noise_rng": jax.random.PRNGKey(1)}
    ref, ref_out = jax_cell({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(h), jnp.asarray(x), **kwargs)
    got, got_out = nn.make_cell(cell_type, WIDTH, HIDDEN)(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(h), torch.from_numpy(x),
        **({"noise": torch.from_numpy(draw)} if noisy else {}))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out),
                               atol=1e-6)
    if noisy:
        # the noise moved the state: the formula is exercised
        quiet, _ = nn.NoisyGRUCell(WIDTH, HIDDEN)(
            {k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(h), torch.from_numpy(x))
        assert not torch.allclose(quiet, got)


def test_noisy_cell_refuses_training_flag():
    with pytest.raises(ValueError, match="training=True"):
        nn.NoisyGRUCell(WIDTH, HIDDEN, training=True)
    with pytest.raises(ValueError, match="Unknown rnn_cell 'Bogus'"):
        nn.make_cell("Bogus", WIDTH, HIDDEN)


# ---------------------------------------------------------------------- #
# the encoders, from one shared checkpoint
# ---------------------------------------------------------------------- #
def _encoders(cell_type, direction, layers):
    def build(enc_cls, vocab_cls):
        return enc_cls(name="encoder", vocabulary=vocab_cls(
            [f"w{i}" for i in range(40)]), data_id="source",
            embedding_size=WIDTH, rnn_size=HIDDEN, rnn_cell=cell_type,
            rnn_direction=direction, num_layers=layers, max_input_len=TIME)
    return (build(JaxSentenceEncoder, JaxVocabulary),
            build(SentenceEncoder, Vocabulary))


def _encoder_batch(seed):
    rng = np.random.RandomState(seed)
    return {"encoder_input.ids": rng.randint(4, 44, (4, TIME)).astype(
                np.int32),
            "encoder_input.mask": _mask([9, 5, 2, 1])}


ENCODER_CASES = [(c, d, n) for c in CELLS for d, n in (
    ("bidirectional", 2), ("forward", 1), ("backward", 1))]


@pytest.mark.parametrize("cell_type,direction,layers", ENCODER_CASES)
@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_encoder_matches_jax(tmp_path, monkeypatch, cell_type, direction,
                             layers, train):
    """States and final output. In training the noisy cells' draws are
    shared: the port's cell by cell (``draw_noise``), the JAX package's
    call by call in the same order (layer by layer, the forward
    direction's steps before the backward one's)."""
    jax_enc, enc = _encoders(cell_type, direction, layers)
    jax_params = jax_init(jax_collect_parts([jax_enc]),
                          jax.random.PRNGKey(3))
    params = params_from_jax(_shared_npz(tmp_path, jax_params),
                             init_all_params(collect_parts([enc]), seed=0))
    batch = _encoder_batch(4)
    noisy = train and cell_type == "NoisyGRU"
    drawn = []
    if noisy:
        rng = np.random.RandomState(5)
        cells = [c for pair in enc._cells for c in pair if c is not None]
        draws = [rng.randn(TIME, 4, 3 * HIDDEN).astype(np.float32)
                 for _ in cells]
        for cell, draw in zip(cells, draws):
            def draw_noise(steps, batch_size, generator, device,
                           draw=draw):
                assert (steps, batch_size) == draw.shape[:2]
                assert isinstance(generator, torch.Generator)
                drawn.append(draw)
                return torch.from_numpy(draw).to(device)
            monkeypatch.setattr(cell, "draw_noise", draw_noise)
        monkeypatch.setattr(jax.random, "normal", SharedNormals(
            [step for draw in draws for step in draw]))
    jax_ctx = JaxContext(jax_params, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                         train=train, rng=jax.random.PRNGKey(7))
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                  train=train, rng=7)
    with jax.disable_jit(noisy):
        refs = [np.asarray(jax_enc.temporal_states(jax_ctx)),
                np.asarray(jax_enc.output(jax_ctx))]
    for got, ref, name in zip((enc.temporal_states(ctx), enc.output(ctx)),
                              refs, ("temporal_states", "output")):
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5,
                                   err_msg=name)
    assert len(drawn) == (len(enc._cells) * (2 if direction ==
                                             "bidirectional" else 1)
                          if noisy else 0)


@pytest.mark.parametrize("cell_type,direction,layers", ENCODER_CASES)
def test_encoder_bf16_matches_jax(tmp_path, cell_type, direction, layers):
    """Under both packages' bf16 compute policy (the JAX program compiled
    with every bf16 rounding kept, ``test_torch_precision``): the
    encoder's states and final output at inference to 1e-5, as in
    float32; the policy changes the states."""
    jax_enc, enc = _encoders(cell_type, direction, layers)
    jax_params = jax_init(jax_collect_parts([jax_enc]),
                          jax.random.PRNGKey(3))
    params = params_from_jax(_shared_npz(tmp_path, jax_params),
                             init_all_params(collect_parts([enc]), seed=0))
    batch = _encoder_batch(4)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def port(name):
        with precision.both_policies(name):
            ctx = Context(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
            return enc.temporal_states(ctx), enc.output(ctx)
    with precision.both_policies(precision.BF16):
        refs = precision._compiled(lambda p: (
            jax_enc.temporal_states(JaxContext(p, jax_batch)),
            jax_enc.output(JaxContext(p, jax_batch))), jax_params)
    got, got32 = port(precision.BF16), port(None)
    for value, ref, name in zip(got, refs, ("temporal_states", "output")):
        np.testing.assert_allclose(value.detach().float().numpy(),
                                   np.asarray(ref, np.float32), atol=1e-5,
                                   err_msg=name)
    assert not torch.equal(got[0].float(), got32[0])


def _decoders(cell_type):
    def build(enc_cls, att_cls, dec_cls, vocab_cls):
        vocab = vocab_cls([f"w{i}" for i in range(40)])
        enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                      embedding_size=WIDTH, rnn_size=HIDDEN,
                      max_input_len=TIME)
        att = att_cls(name="attention", encoder=enc, state_size=HIDDEN)
        return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                       max_output_len=7, encoders=[enc], attentions=[att],
                       rnn_size=HIDDEN, embedding_size=WIDTH,
                       rnn_cell=cell_type)
    return (build(JaxSentenceEncoder, JaxAttention, JaxDecoder,
                  JaxVocabulary),
            build(SentenceEncoder, Attention, Decoder, Vocabulary))


@pytest.mark.parametrize("cell_type,train", [
    ("LayerNormGRU", True), ("NoisyGRU", False), ("NoisyGRU", True)],
    ids=["layer_norm", "noisy_inference", "noisy_training"])
def test_decoder_loss_matches_jax(tmp_path, monkeypatch, cell_type, train):
    """The teacher-forced loss of a (non-conditional) decoder over the
    cell; the noisy decoder's draws shared in training."""
    jax_dec, dec = _decoders(cell_type)
    jax_params = jax_init(jax_collect_parts([jax_dec]),
                          jax.random.PRNGKey(2))
    params = params_from_jax(_shared_npz(tmp_path, jax_params),
                             init_all_params(collect_parts([dec]), seed=0))
    rng = np.random.RandomState(6)
    batch = _encoder_batch(8)
    batch.update({
        "decoder.train_targets": rng.randint(4, 34, (4, 7)).astype(np.int32),
        "decoder.train_mask": _mask([7, 5, 3, 1], time=7)})
    batch["decoder.train_inputs"] = np.concatenate(
        [np.full((4, 1), 2, np.int32), batch["decoder.train_targets"][:, :-1]],
        axis=1)
    noisy = train and cell_type == "NoisyGRU"
    if noisy:
        draw = rng.randn(7, 4, 3 * HIDDEN).astype(np.float32)
        monkeypatch.setattr(dec._cell1, "draw_noise",
                            lambda steps, b, generator, device:
                            torch.from_numpy(draw))
        monkeypatch.setattr(jax.random, "normal", SharedNormals(list(draw)))
    jax_ctx = JaxContext(jax_params, {k: jnp.asarray(v)
                                      for k, v in batch.items()},
                         train=train, rng=jax.random.PRNGKey(7))
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                  train=train, rng=7)
    with jax.disable_jit(noisy):
        ref = float(jax_dec.train_loss(jax_ctx))
    np.testing.assert_allclose(float(dec.train_loss(ctx)), ref, rtol=1e-5)


def test_conditional_gru_needs_a_gru_cell():
    jax_dec_args = dict(vocabulary=None, data_id="target", max_output_len=4,
                        rnn_size=4, embedding_size=4,
                        rnn_cell="LayerNormGRU", conditional_gru=True)
    for cls, vocab in ((JaxDecoder, JaxVocabulary), (Decoder, Vocabulary)):
        with pytest.raises(ValueError, match="requires a GRU cell"):
            cls(name="decoder", **dict(jax_dec_args, vocabulary=vocab(
                ["a", "b"])))


# ---------------------------------------------------------------------- #
# routing: kernels for the plain cells only
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cell_type", ["GRU", "OrthoGRU", "LSTM"] + CELLS)
def test_cells_reach_their_scan(monkeypatch, cell_type):
    """The fused scans (K1 ``gru_scan``, ``lstm_scan``) take the plain
    GRU, the OrthoGRU and the LSTM, both directions in one call; every
    other cell runs the step scan, never a kernel."""
    calls = {"gru_scan": 0, "lstm_scan": 0, "step_scan": 0}

    def counting(name):
        real = getattr(rnn, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return wrapper
    for name in calls:
        monkeypatch.setattr(rnn, name, counting(name))
    _, enc = _encoders(cell_type, "bidirectional", 1)
    params = init_all_params(collect_parts([enc]), seed=0)
    batch = _encoder_batch(1)
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert enc.temporal_states(ctx).shape == (4, TIME, 2 * HIDDEN)
    expected = {"GRU": "gru_scan", "OrthoGRU": "gru_scan",
                "LSTM": "lstm_scan"}.get(cell_type)
    if expected is None:
        assert calls == {"gru_scan": 0, "lstm_scan": 0, "step_scan": 2}
    else:
        assert calls == dict({"gru_scan": 0, "lstm_scan": 0,
                              "step_scan": 0}, **{expected: 1})


def test_step_scan_of_a_plain_gru_matches_k1_plain_version():
    """The step scan computes the masked scan that ``gru_scan`` does:
    for a plain GRU cell (never routed there) both agree, so the step
    scan's masking, reversal and concatenation are those of the scan."""
    rng = np.random.RandomState(9)
    cell = nn.GRUCell(WIDTH, HIDDEN)
    params = [cell.init(torch.Generator().manual_seed(i)) for i in range(2)]
    inputs = torch.from_numpy(rng.randn(4, TIME, WIDTH).astype(np.float32))
    mask = torch.from_numpy(_mask([9, 5, 2, 1]))
    directions = [(params[0], False), (params[1], True)]
    got = rnn.step_scan(cell, directions, inputs, mask)
    ref = rnn.gru_scan(directions, inputs, mask)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-6, rtol=1e-6)
