"""The port's LSTM path and unfused beam selection against the JAX
package, on the CPU.

Inputs and parameters come from numpy seeds or from one ``.npz`` the
JAX package writes; batch <= 4, time <= 9, hidden <= 8 where a kernel's
plain version is the subject.

- ``LSTMCell``, one step, to 1e-6.
- ``lstm_scan``'s plain version (forward, reverse, bidirectional, with
  ragged lengths) against the JAX Pallas ``lstm_scan`` in interpret mode
  (``batch_tile=2``), outputs, finals and both carries to 1e-5.
- Gradients of ``kernel_x``, ``kernel_h``, ``bias`` and the inputs
  through ``_LSTMScan`` (the plain BPTT) against ``jax.grad`` through
  the Pallas custom VJP in interpret mode, to 1e-4.
- ``rowmax_lse``'s plain version with 4·NEG_INF pad columns and 13 rows
  (no multiple of 8) against ``_rowmax_lse_reference``, to 1e-6.
- ``SentenceEncoder(rnn_cell="LSTM")`` from one shared ``.npz``: states
  and final output to 1e-5.
- A small.ini-shaped model with an LSTM encoder, dropout off, from one
  shared ``.npz``: 5 training steps with equal losses (1e-5 relative),
  then equal greedy ids and hierarchical beam ids under
  ``NM_FUSED_LOGITS=0`` and ``=1`` in both packages.
- ``tests/configs/factored.ini`` (``FactoredEncoder``) through the
  port: 3 steps' losses against the JAX package from one shared
  ``.npz`` (1e-5 relative), then the ``train`` and ``run`` CLIs.
- The port's ``Decoder`` refuses an LSTM cell.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.decoders.beam_search_decoder import \
    BeamSearchDecoder as JaxBeamSearch
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.ops import beam_select as jax_beam_select
from neuralmonkey_tpu.ops import nn as jax_nn
from neuralmonkey_tpu.ops.pallas_rnn import \
    _lstm_scan_pallas as jax_lstm_scan_carries
from neuralmonkey_tpu.ops.pallas_rnn import lstm_scan as jax_lstm_scan
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch import run as torch_run
from neuralmonkey_tpu_torch import train as torch_train
from neuralmonkey_tpu_torch.dataset import BatchingScheme
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import (
    NEG_INF, BeamSearchDecoder)
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.ops import beam_select, cuda_rnn, nn
from neuralmonkey_tpu_torch.utils.saving import load_flat, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
BATCH, TIME, WIDTH, HIDDEN = 3, 7, 6, 5


def _mask(lengths, time=TIME):
    mask = np.zeros((len(lengths), time), np.float32)
    for i, n in enumerate(lengths):
        mask[i, :n] = 1.0
    return mask


def _lstm_params(rng, width=WIDTH, hidden=HIDDEN):
    def u(*shape):
        return rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return {"kernel_x": u(width, 4 * hidden), "kernel_h": u(hidden, 4 * hidden),
            "bias": u(4 * hidden)}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in tree.items()}


def _save_shared(tmp_path, flat):
    path = tmp_path / "shared.npz"
    with open(path, "wb") as f:
        np.savez(f, **flat)
    return load_flat(str(path))


# ---------------------------------------------------------------------- #
# the cell and the scan
# ---------------------------------------------------------------------- #
def test_lstm_cell_matches_jax():
    rng = np.random.RandomState(0)
    params = _lstm_params(rng)
    c, h = (rng.randn(BATCH, HIDDEN).astype(np.float32) for _ in range(2))
    x = rng.randn(BATCH, WIDTH).astype(np.float32)
    (ref_c, ref_h), ref_out = jax_nn.LSTMCell(WIDTH, HIDDEN)(
        _jax(params), (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(x))
    cell = nn.LSTMCell(WIDTH, HIDDEN)
    (got_c, got_h), got_out = cell(_torch(params), (torch.from_numpy(c),
                                                    torch.from_numpy(h)),
                                   torch.from_numpy(x))
    for got, ref in ((got_c, ref_c), (got_h, ref_h), (got_out, ref_out)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert cell.output((got_c, got_h)) is got_h
    shapes = {k: tuple(v.shape) for k, v in
              cell.init(torch.Generator().manual_seed(0)).items()}
    assert shapes == {k: v.shape for k, v in jax_nn.LSTMCell(
        WIDTH, HIDDEN).init(jax.random.PRNGKey(0)).items()}


@pytest.mark.parametrize("reverse", [(False,), (True,), (False, True)],
                         ids=["forward", "reverse", "bidirectional"])
def test_lstm_scan_matches_pallas(reverse):
    """Outputs, finals and the c and h carries after every step."""
    rng = np.random.RandomState(1)
    params = [_lstm_params(rng) for _ in reverse]
    inputs = rng.randn(BATCH, TIME, WIDTH).astype(np.float32)
    mask = _mask([7, 4, 2])
    refs = [jax_lstm_scan_carries(_jax(p), jnp.asarray(inputs),
                                  jnp.asarray(mask), rev, 1.0, 2,
                                  save_carries=True)
            for p, rev in zip(params, reverse)]
    ref_out, ref_final = (np.concatenate([np.asarray(r[i]) for r in refs],
                                         axis=-1) for i in range(2))
    # the JAX carries are time-major
    ref_c, ref_h = (np.concatenate([np.swapaxes(np.asarray(r[i]), 0, 1)
                                    for r in refs], axis=-1)
                    for i in (2, 3))
    directions = [_torch(p) for p in params]
    out, final = cuda_rnn.lstm_scan(list(zip(directions, reverse)),
                                    torch.from_numpy(inputs),
                                    torch.from_numpy(mask))
    xz = cuda_rnn.lstm_hoisted_inputs(directions, torch.from_numpy(inputs))
    wh = torch.stack([p["kernel_h"] for p in directions])
    _, _, c_car, h_car = cuda_rnn.lstm_scan_reference(
        xz, torch.from_numpy(mask), wh, 1.0, reverse)
    for got, ref in ((out, ref_out), (final, ref_final), (c_car, ref_c),
                     (h_car, ref_h)):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the plain path launches nothing
    assert not any(cuda_rnn.kernel_config.launch_counts().values())


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_bptt_matches_pallas_vjp(reverse):
    """Every gradient through ``_LSTMScan`` (the plain BPTT and the
    recurrent weight product) against ``jax.grad`` through the JAX
    package's custom VJP (its BPTT kernel in interpret mode)."""
    rng = np.random.RandomState(2)
    params = _lstm_params(rng)
    inputs = rng.randn(4, 9, WIDTH).astype(np.float32)
    mask = _mask([9, 6, 3, 1], time=9)
    cot_out = rng.randn(4, 9, HIDDEN).astype(np.float32)
    cot_fin = rng.randn(4, HIDDEN).astype(np.float32)

    def loss(p, x):
        out, fin = jax_lstm_scan(p, x, jnp.asarray(mask), reverse, 1.0, 2)
        return jnp.sum(out * cot_out) + jnp.sum(fin * cot_fin)
    ref_p, ref_x = jax.grad(loss, argnums=(0, 1))(_jax(params),
                                                  jnp.asarray(inputs))
    leaves = _torch(params, grad=True)
    x = torch.tensor(inputs, requires_grad=True)
    out, fin = cuda_rnn.lstm_scan([(leaves, reverse)], x,
                                  torch.from_numpy(mask))
    ((out * torch.from_numpy(cot_out)).sum()
     + (fin * torch.from_numpy(cot_fin)).sum()).backward()
    for key, p in leaves.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_p[key]),
                                   atol=1e-4, err_msg=key)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_x), atol=1e-4)


def test_rowmax_lse_reference_matches_jax():
    """13 rows (the TPU kernel's 8-row blocks do not bind the port) of a
    vocabulary of 300 padded to 384 as the selector pads it."""
    rng = np.random.RandomState(3)
    x = np.full((13, 384), 4 * NEG_INF, np.float32)
    x[:, :300] = rng.randn(13, 300) * 4
    ref = jax_beam_select._rowmax_lse_reference(jnp.asarray(x))
    got = beam_select.rowmax_lse(torch.from_numpy(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="multiple of 128"):
        beam_select.rowmax_lse(torch.zeros(2, 300))


# ---------------------------------------------------------------------- #
# the encoder, from one shared checkpoint
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("direction,layers", [("bidirectional", 2),
                                              ("backward", 1)])
def test_lstm_sentence_encoder_matches_jax(tmp_path, direction, layers):
    def build(enc_cls, vocab_cls):
        return enc_cls(name="encoder", vocabulary=vocab_cls(
            [f"w{i}" for i in range(40)]), data_id="source",
            embedding_size=WIDTH, rnn_size=8, rnn_cell="LSTM",
            rnn_direction=direction, num_layers=layers, max_input_len=9)
    jax_enc = build(JaxSentenceEncoder, JaxVocabulary)
    enc = build(SentenceEncoder, Vocabulary)
    jax_params = jax_init(jax_collect_parts([jax_enc]), jax.random.PRNGKey(3))
    flat = _save_shared(tmp_path, {k: np.asarray(v) for k, v in
                                   jax_flatten(jax_params).items()})
    params = params_from_jax(flat, init_all_params(collect_parts([enc]),
                                                   seed=0))
    rng = np.random.RandomState(4)
    batch = {"encoder_input.ids": rng.randint(4, 44, (4, 9)).astype(np.int32),
             "encoder_input.mask": _mask([9, 5, 2, 1], time=9)}
    jax_ctx = JaxContext(jax_params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    for name in ("temporal_states", "output"):
        np.testing.assert_allclose(
            getattr(enc, name)(ctx).numpy(),
            np.asarray(getattr(jax_enc, name)(jax_ctx)), atol=1e-5,
            err_msg=name)


def test_lstm_decoder_raises():
    vocab = Vocabulary([f"w{i}" for i in range(10)])
    enc = SentenceEncoder(name="encoder", vocabulary=vocab, data_id="source",
                          embedding_size=4, rnn_size=4, rnn_cell="LSTM")
    with pytest.raises(ValueError, match="'LSTM'"):
        Decoder(name="decoder", vocabulary=vocab, data_id="target",
                max_output_len=4, encoders=[enc], embedding_size=4,
                rnn_cell="LSTM")


# ---------------------------------------------------------------------- #
# the slice: train, greedy and beam through both packages
# ---------------------------------------------------------------------- #
SLICE_INI = """\
[main]
name="lstm translation test"
tf_manager=<tf_manager>
output="{out}"
overwrite_output_dir=True
batch_size=16
epochs=1
train_dataset=<train_data>
val_dataset=<val_data>
trainer=<trainer>
runners=[<runner>]
evaluation=[("target", evaluators.bleu.BLEU)]
logging_period=4
validation_period=1000
random_seed=1234

[tf_manager]
class=tf_manager.TensorFlowManager
num_sessions=1
{manager_extra}

[train_data]
class=dataset.load_dataset_from_files
s_source="{data}/train.en"
s_target="{data}/train.de"
lazy=False

[val_data]
class=dataset.load_dataset_from_files
s_source="{data}/val.en"
s_target="{data}/val.de"

[encoder_vocabulary]
class=vocabulary.from_dataset
datasets=[<train_data>]
series_ids=["source"]
max_size=60

[decoder_vocabulary]
class=vocabulary.from_dataset
datasets=[<train_data>]
series_ids=["target"]
max_size=60

[encoder]
class=encoders.recurrent.SentenceEncoder
name="sentence_encoder"
rnn_size=8
rnn_cell="LSTM"
max_input_len=9
embedding_size=8
data_id="source"
vocabulary=<encoder_vocabulary>

[attention]
class=attention.feed_forward.Attention
name="attention_sentence_encoder"
encoder=<encoder>
state_size=8

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size=8
embedding_size=8
conditional_gru=True
data_id="target"
max_output_len=9
vocabulary=<decoder_vocabulary>

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>]
clip_norm=1.0
optimizer=<adam>

[adam]
class=tf.train.AdamOptimizer
learning_rate=0.005

[runner]
class=runners.runner.GreedyRunner
decoder=<decoder>
output_series="target"
"""


def _slice_ini(tmp_path, port):
    path = tmp_path / f"lstm{'_port' if port else ''}.ini"
    path.write_text(SLICE_INI.format(
        out=tmp_path / "out", data=DATA,
        manager_extra='device="cpu"' if port else ""))
    return str(path)


def test_lstm_slice_trains_and_decodes_like_jax(tmp_path, monkeypatch):
    """Five training steps from one ``.npz``, the same losses; then the
    same greedy ids, and the same hierarchical beam-4 ids with the fused
    logit projection switched off (the selector reduces the padded
    logits with ``rowmax_lse``) and on, in both packages."""
    jax_exp = JaxExperiment(_slice_ini(tmp_path, False), train_mode=True)
    jax_exp.build_model()
    exp = Experiment(_slice_ini(tmp_path, True), train_mode=True)
    exp.build_model()
    manager = exp.tf_manager
    flat = _save_shared(tmp_path, {
        k: np.asarray(v)
        for k, v in jax_flatten(jax_exp.tf_manager.params).items()})
    manager.params = params_from_jax(flat, manager.params)
    scheme = BatchingScheme(batch_size=16)
    jax_batches = jax_exp.model.train_dataset.batches(scheme, shuffled=False)
    port_batches = exp.model.train_dataset.batches(scheme, shuffled=False)
    for step in range(5):
        ref = jax_exp.tf_manager.train_on_batch(
            jax_exp.model.trainer, next(jax_batches), 16)
        got = manager.train_on_batch(exp.model.trainer, next(port_batches),
                                     16)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5,
                                   err_msg=f"step {step}")

    val = jax_exp.model.val_dataset.subset(0, 8)
    port_val = exp.model.val_dataset.subset(0, 8)
    _, ref_out = jax_exp.run_model(val)
    _, got_out = exp.run_model(port_val)
    assert got_out["target"] == ref_out["target"]

    jax_batch, _ = jax_exp.tf_manager.build_batch(val, 8)
    batch, _ = manager.build_batch(port_val, 8)
    jax_dec = jax_exp.model.runners[0].decoder
    dec = exp.model.runners[0].decoder
    from neuralmonkey_tpu_torch.models.decoders import beam_search_decoder
    reductions = []

    def counting_rowmax_lse(x):
        reductions.append(x.shape)
        return beam_select.rowmax_lse(x)
    monkeypatch.setattr(beam_search_decoder, "rowmax_lse",
                        counting_rowmax_lse)
    for fused in ("0", "1"):
        monkeypatch.setenv("NM_FUSED_LOGITS", fused)
        reductions.clear()
        ref = JaxBeamSearch(
            name="bs", parent_decoder=jax_dec, beam_size=4,
            selection_method="hierarchical").search(
                JaxContext(jax_exp.tf_manager.params, jax_batch))
        with torch.inference_mode():
            got = BeamSearchDecoder(
                name="bs", parent_decoder=dec, beam_size=4,
                selection_method="hierarchical").search(
                    Context(manager.params, batch))
        np.testing.assert_array_equal(got.token_ids.numpy(),
                                      np.asarray(ref.token_ids),
                                      err_msg=f"NM_FUSED_LOGITS={fused}")
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                                   atol=1e-4)
        # unfused, every step reduces the logits padded to 128 columns
        assert bool(reductions) == (fused == "0")
        assert all(shape == (8 * 4, 128) for shape in reductions)


def _factored_ini(tmp_path, port):
    """tests/configs/factored.ini for one epoch, writing under
    ``tmp_path``; the port's copy asks for the CPU."""
    with open(os.path.join(REPO, "tests", "configs", "factored.ini")) as f:
        text = f.read()
    text = (text.replace('"tests/data/', f'"{DATA}/')
            .replace('output="tests/outputs/factored"',
                     f'output="{tmp_path / "out"}"')
            .replace("epochs=4", "epochs=1")
            .replace("validation_period=60", "validation_period=1000"))
    if port:
        text = text.replace("class=tf_manager.TensorFlowManager\n",
                            'class=tf_manager.TensorFlowManager\n'
                            'device="cpu"\n')
    path = tmp_path / f"factored{'_port' if port else ''}.ini"
    path.write_text(text)
    return str(path)


def test_factored_ini_trains_like_jax(tmp_path):
    """``FactoredEncoder`` over (word, factor) pairs: three steps from one
    ``.npz`` with the JAX package's losses, then one epoch through the
    ``train`` CLI and a decode through ``run``."""
    jax_exp = JaxExperiment(_factored_ini(tmp_path, False), train_mode=True)
    jax_exp.build_model()
    config = _factored_ini(tmp_path, True)
    exp = Experiment(config, train_mode=True)
    exp.build_model()
    manager = exp.tf_manager
    flat = _save_shared(tmp_path, {
        k: np.asarray(v)
        for k, v in jax_flatten(jax_exp.tf_manager.params).items()})
    manager.params = params_from_jax(flat, manager.params)
    scheme = BatchingScheme(batch_size=16)
    jax_batches = jax_exp.model.train_dataset.batches(scheme, shuffled=False)
    port_batches = exp.model.train_dataset.batches(scheme, shuffled=False)
    for step in range(3):
        ref = jax_exp.tf_manager.train_on_batch(
            jax_exp.model.trainer, next(jax_batches), 16)
        got = manager.train_on_batch(exp.model.trainer, next(port_batches),
                                     16)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5,
                                   err_msg=f"step {step}")

    assert torch_train.main([config]) == 0
    out = tmp_path / "out"
    data_ini = tmp_path / "data.ini"
    data_ini.write_text(
        "[main]\ntest_datasets=[<val_data>]\n\n[val_data]\n"
        "class=dataset.load_dataset_from_files\n"
        f's_source="{DATA}/val.en"\ns_factors="{DATA}/val.factors"\n'
        f's_target_out="{out}/greedy.txt"\n')
    assert torch_run.main([config, str(data_ini),
                           str(out / "variables.data.best")]) == 0
    with open(out / "greedy.txt", encoding="utf-8") as f:
        assert len(f.read().splitlines()) == 30
