"""The port's training path against the JAX package, on the CPU.

- The decoder's teacher-forced ``train_loss`` and the gradient of every
  parameter against ``jax.value_and_grad`` of the JAX decoder's, from
  the same parameters, dropout off; through materialized logits and
  through the fused cross-entropy (``NM_FUSED_XENT=1``), with and
  without label smoothing. Tolerance 1e-5 on the loss and 2e-5 absolute
  plus 1e-4 relative on the gradients: float32 sums in another order
  through the recurrences.
- A training step in train mode (dropout on) leaves a nonzero gradient
  on every parameter: no kernel wrapper cuts the graph.
- The slice: an INI shaped like tests/configs/small.ini, dropout off,
  trained for 5 steps by both packages from one set of parameters;
  the losses agree step by step (1e-4 relative: Adam divides by the
  square root of tiny second moments, where float32 rounding
  differences grow) and so do the greedy ids after training.
- The train CLI writes checkpoints, ``.best``, the optimizer state and
  the logs; ``run`` decodes from ``.best``; a resumed run continues the
  optimizer state.
- The port's quality gate: tests/configs/beamsearch.ini trained with the
  overrides of tests/test_quality_gates.py, from the JAX package's
  initial parameters, reaches >95 BLEU on the training sample and >90
  on validation.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralmonkey_tpu.dataset import load_dataset_from_files as \
    jax_load_dataset
from neuralmonkey_tpu.experiment import Experiment as JaxExperiment
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch import run as torch_run
from neuralmonkey_tpu_torch import train as torch_train
from neuralmonkey_tpu_torch.dataset import BatchingScheme
from neuralmonkey_tpu_torch.dataset import load_dataset_from_files
from neuralmonkey_tpu_torch.evaluators.bleu import BLEU
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.utils.saving import (flatten_tree,
                                                 params_from_jax)
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
BATCH, SRC, TGT, WIDTH, VOCAB = 3, 7, 6, 16, 300


# ---------------------------------------------------------------------- #
# the decoder's loss and gradients
# ---------------------------------------------------------------------- #
def _build(enc_cls, att_cls, dec_cls, vocab_cls, conditional_gru,
           label_smoothing, keep_prob=1.0):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, rnn_size=WIDTH, max_input_len=SRC,
                  dropout_keep_prob=keep_prob)
    att = att_cls(name="attention", encoder=enc, state_size=WIDTH,
                  dropout_keep_prob=keep_prob)
    dec = dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                  max_output_len=TGT, rnn_size=WIDTH, encoders=[enc],
                  attentions=[att], embedding_size=WIDTH,
                  conditional_gru=conditional_gru,
                  label_smoothing=label_smoothing,
                  dropout_keep_prob=keep_prob)
    return dec


def _batch(rng):
    mask = np.zeros((BATCH, SRC), np.float32)
    for i, n in enumerate([7, 4, 2]):
        mask[i, :n] = 1.0
    tmask = np.zeros((BATCH, TGT), np.float32)
    for i, n in enumerate([6, 3, 1]):
        tmask[i, :n] = 1.0
    return {
        "encoder_input.ids": rng.randint(4, VOCAB, (BATCH, SRC)).astype(
            np.int32),
        "encoder_input.mask": mask,
        "decoder.train_inputs": rng.randint(1, VOCAB, (BATCH, TGT)).astype(
            np.int32),
        "decoder.train_targets": rng.randint(2, VOCAB, (BATCH, TGT)).astype(
            np.int32),
        "decoder.train_mask": tmask}


@pytest.mark.parametrize("conditional_gru,label_smoothing,fused", [
    (True, None, False), (False, 0.1, False), (True, None, True),
    (True, 0.1, True)])
def test_decoder_loss_and_gradients_match_jax(monkeypatch, conditional_gru,
                                              label_smoothing, fused):
    if fused:
        monkeypatch.setenv("NM_FUSED_XENT", "1")
    jax_dec = _build(JaxSentenceEncoder, JaxAttention, JaxDecoder,
                     JaxVocabulary, conditional_gru, label_smoothing)
    port_dec = _build(SentenceEncoder, Attention, Decoder, Vocabulary,
                      conditional_gru, label_smoothing)
    rng = np.random.RandomState(0)
    template = jax_init(jax_collect_parts([jax_dec]), jax.random.PRNGKey(0))
    flat = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
            for k, v in jax_flatten(template).items()}
    batch = _batch(rng)

    def jax_loss(p):
        return jax_dec.train_loss(JaxContext(
            p, {k: jnp.asarray(v) for k, v in batch.items()}, train=True,
            rng=jax.random.PRNGKey(1)))
    ref_loss, ref_grads = jax.value_and_grad(jax_loss)(
        jax_restore(template, flat))
    ref_grads = jax_flatten(ref_grads)

    params = params_from_jax(flat, init_all_params(
        collect_parts([port_dec]), seed=0))
    leaves = flatten_tree(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = port_dec.train_loss(Context(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        train=True, rng=1))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), atol=1e-5,
                               rtol=0)
    assert set(leaves) == set(ref_grads)
    for key, p in leaves.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_grads[key]),
                                   atol=2e-5, rtol=1e-4, err_msg=key)


# ---------------------------------------------------------------------- #
# the slice through the INI entry points
# ---------------------------------------------------------------------- #
TRAIN_INI = """\
[main]
name="small translation test"
tf_manager=<tf_manager>
output="{out}"
overwrite_output_dir=True
batch_size=16
epochs={epochs}
train_dataset=<train_data>
val_dataset=<val_data>
trainer=<trainer>
runners=[<runner>]
postprocess=None
evaluation=[("target", evaluators.bleu.BLEU)]
logging_period=4
validation_period={validation_period}
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
rnn_size=24
max_input_len=12
embedding_size=16
dropout_keep_prob={keep_prob}
data_id="source"
vocabulary=<encoder_vocabulary>

[attention]
class=attention.feed_forward.Attention
name="attention_sentence_encoder"
encoder=<encoder>
state_size=24
dropout_keep_prob={keep_prob}

[decoder]
class=decoders.decoder.Decoder
name="decoder"
encoders=[<encoder>]
attentions=[<attention>]
rnn_size=24
embedding_size=16
dropout_keep_prob={keep_prob}
conditional_gru=True
data_id="target"
max_output_len=12
vocabulary=<decoder_vocabulary>

[trainer]
class=trainers.cross_entropy_trainer.CrossEntropyTrainer
decoders=[<decoder>]
l2_weight=1.0e-8
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

DATA_INI = """\
[main]
test_datasets=[<val_data>]

[val_data]
class=dataset.load_dataset_from_files
s_source="{data}/val.en"
s_target_out="{out}/greedy.txt"
"""


def _write_ini(tmp_path, port=True, epochs=1, keep_prob=1.0,
               validation_period=1000, name="exp"):
    path = tmp_path / f"{name}{'_port' if port else ''}.ini"
    path.write_text(TRAIN_INI.format(
        out=tmp_path / f"{name}_out", data=DATA, epochs=epochs,
        keep_prob=keep_prob, validation_period=validation_period,
        manager_extra='device="cpu"' if port else ""))
    return str(path)


def test_every_parameter_gets_a_gradient(tmp_path):
    exp = Experiment(_write_ini(tmp_path, keep_prob=0.8), train_mode=True)
    exp.build_model()
    manager = exp.tf_manager
    dataset = next(exp.model.train_dataset.batches(
        BatchingScheme(batch_size=16), shuffled=False))
    batch, _ = manager.build_batch(dataset, 16, train=True)
    flat = flatten_tree(manager.params)
    for p in flat.values():
        p.requires_grad_(True)
    total, _ = exp.model.trainer.total_loss(manager.params, batch, rng=5)
    total.backward()
    missing = [k for k, p in flat.items()
               if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    assert not missing, missing
    before = {k: p.detach().clone() for k, p in flat.items()}
    manager.train_on_batch(exp.model.trainer, dataset, 16)
    after = flatten_tree(manager.params)
    assert all(not torch.equal(before[k], after[k]) for k in before)


def test_slice_trains_like_jax(tmp_path):
    """Five steps from one set of parameters: the same losses, the same
    gradient norms, then the same greedy ids."""
    jax_exp = JaxExperiment(_write_ini(tmp_path, port=False),
                            train_mode=True)
    jax_exp.build_model()
    exp = Experiment(_write_ini(tmp_path), train_mode=True)
    exp.build_model()
    manager = exp.tf_manager
    manager.params = params_from_jax(jax_flatten(jax_exp.tf_manager.params),
                                     manager.params)
    scheme = BatchingScheme(batch_size=16)
    jax_batches = jax_exp.model.train_dataset.batches(scheme, shuffled=False)
    port_batches = exp.model.train_dataset.batches(scheme, shuffled=False)
    for step in range(5):
        ref = jax_exp.tf_manager.train_on_batch(
            jax_exp.model.trainer, next(jax_batches), 16)
        got = manager.train_on_batch(exp.model.trainer, next(port_batches),
                                     16)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                       err_msg=f"step {step} {key}")

    val = jax_load_dataset(name="val", s_source=os.path.join(DATA, "val.en"))
    port_val = load_dataset_from_files(
        name="val", s_source=os.path.join(DATA, "val.en"))
    _, ref_out = jax_exp.run_model(val)
    _, got_out = exp.run_model(port_val)
    assert got_out["target"] == ref_out["target"]


def test_train_cli_checkpoints_and_run(tmp_path):
    ini = _write_ini(tmp_path, epochs=2, validation_period=10)
    assert torch_train.main([ini]) == 0
    out = tmp_path / "exp_out"
    names = set(os.listdir(out))
    assert {"experiment.ini", "experiment.log", "metrics.jsonl",
            "variables.data.best", "variables.data.opt"} <= names
    steps = sorted(int(n.rsplit("-", 1)[1]) for n in names
                   if n.startswith("variables.data-")
                   and not n.endswith(".json"))
    # 300 sentences in batches of 16: 19 steps an epoch; the newest 3
    # checkpoints stay, plus the best one's if it is older
    assert steps[-1] == 38 and 3 <= len(steps) <= 4
    best = os.path.realpath(out / "variables.data.best")
    assert os.path.exists(best) and os.path.exists(best + ".meta.json")

    data_ini = tmp_path / "data.ini"
    data_ini.write_text(DATA_INI.format(data=DATA, out=out))
    assert torch_run.main([ini, str(data_ini),
                           str(out / "variables.data.best")]) == 0
    with open(out / "greedy.txt", encoding="utf-8") as f:
        assert len(f.read().splitlines()) == 30


def test_resumed_optimizer_state_continues_training(tmp_path):
    """Saving after two steps and restoring parameters and optimizer
    state into a fresh manager gives the same third step."""
    exp = Experiment(_write_ini(tmp_path), train_mode=True)
    exp.build_model()
    manager, trainer = exp.tf_manager, exp.model.trainer
    batches = list(exp.model.train_dataset.batches(
        BatchingScheme(batch_size=16), shuffled=False))[:3]
    for batch in batches[:2]:
        manager.train_on_batch(trainer, batch, 16)
    path = str(tmp_path / "ckpt" / "variables.data")
    ckpt = manager.save(path)
    expected = manager.train_on_batch(trainer, batches[2], 16)

    fresh = CUDAManager(device="cpu")
    fresh.initialize_model_parts([trainer], seed=1)
    fresh.restore(ckpt)
    fresh.load_optimizer_state(path)
    assert fresh.global_step == 2
    got = fresh.train_on_batch(trainer, batches[2], 16)
    assert got["loss"] == pytest.approx(expected["loss"], rel=1e-6)
    for k, v in flatten_tree(fresh.params).items():
        torch.testing.assert_close(v, flatten_tree(manager.params)[k])


# ---------------------------------------------------------------------- #
# the quality gate of tests/test_quality_gates.py, through the port
# ---------------------------------------------------------------------- #
def test_port_quality_gate(tmp_path):
    """From the JAX package's initial parameters for this INI and seed,
    so that the gate holds the port's training, not one draw of its
    initializer: on this corpus the gate is sensitive to the draw in
    both packages."""
    changes = [f'main.output="{tmp_path}"', "main.epochs=20",
               "main.validation_period=5000", "main.logging_period=100",
               "encoder.dropout_keep_prob=1.0",
               "decoder.dropout_keep_prob=1.0"]
    config = os.path.join(REPO, "tests", "configs", "beamsearch.ini")
    jax_exp = JaxExperiment(config, train_mode=True, config_changes=changes)
    jax_exp.build_model()
    exp = Experiment(config, train_mode=True,
                     config_changes=changes + ['tf_manager.device="cpu"'])
    exp.build_model()
    exp.tf_manager.params = params_from_jax(
        jax_flatten(jax_exp.tf_manager.params), exp.tf_manager.params)
    exp.train()
    scores = {}
    for split, limit in (("train", 100), ("val", None)):
        ds = load_dataset_from_files(
            name=split, s_source=os.path.join(DATA, f"{split}.en"),
            s_target=os.path.join(DATA, f"{split}.de"))
        _, outputs = exp.run_model(ds)
        refs = list(ds.get_series("target"))[:limit]
        scores[split] = {s: BLEU(outputs[s][:len(refs)], refs)
                         for s in ("target", "target_beam")}
    assert scores["train"]["target"] > 95.0, scores
    assert scores["val"]["target"] > 90.0, scores
    assert scores["val"]["target_beam"] > 90.0, scores
