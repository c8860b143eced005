"""The port's Adadelta, RMSProp and Adafactor against optax, and their
``.opt`` state across the two packages, on the CPU.

- Ten updates of each optimizer (and of each with a learning-rate
  schedule; RMSProp also without momentum) on one tree of parameters
  with per-step gradients, clipped and unclipped: the parameters to
  1e-5 relative (to each tensor's largest entry) of ``optax``'s, and
  the state under the same flat keys
  as the JAX package's ``flatten_tree`` of the optax state, with the
  same values. The tree holds Adafactor's factored shapes (2-D and
  3-D) and unfactored ones (a vector, a matrix with both dims under 128).
- ``.opt`` across the packages, on one small model: the JAX package
  resumes a port run's checkpoint and ``.opt`` and continues its losses,
  and the port resumes the JAX run's and continues its, to 1e-5
  relative.
- The port's own resume, as ``tests/test_optimizer_resume.py`` has it
  for the JAX package: an interrupted run continues the uninterrupted
  trajectory; a cold restart does not; a ``.opt`` of another trainer
  label is not applied.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neuralmonkey_tpu.dataset import Dataset as JaxDataset
from neuralmonkey_tpu.models.attention.feed_forward import \
    Attention as JaxAttention
from neuralmonkey_tpu.models.decoders.decoder import Decoder as JaxDecoder
from neuralmonkey_tpu.models.encoders.recurrent import \
    SentenceEncoder as JaxSentenceEncoder
from neuralmonkey_tpu.runtime import TPUManager
from neuralmonkey_tpu.trainers import optimizers as jax_optimizers
from neuralmonkey_tpu.trainers.cross_entropy_trainer import \
    CrossEntropyTrainer as JaxCrossEntropyTrainer
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.dataset import Dataset
from neuralmonkey_tpu_torch.models.attention.feed_forward import Attention
from neuralmonkey_tpu_torch.models.decoders.decoder import Decoder
from neuralmonkey_tpu_torch.models.encoders.recurrent import SentenceEncoder
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.trainers import optimizers
from neuralmonkey_tpu_torch.trainers.cross_entropy_trainer import \
    CrossEntropyTrainer
from neuralmonkey_tpu_torch.trainers.generic_trainer import Update
from neuralmonkey_tpu_torch.utils.saving import load_flat
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)

SHAPES = {"enc": {"w": (130, 140), "v": (3, 200), "small": (7, 9),
                  "b": (7,)},
          "dec": [{"k": (2, 128, 160)}]}


def _schedule(count):
    return 0.5 / (1.0 + count)


# (name, keyword arguments of both packages' factories)
OPTIMIZERS = [
    ("AdadeltaOptimizer", {}),
    ("AdadeltaOptimizer", {"learning_rate": _schedule, "epsilon": 1e-4}),
    ("RMSPropOptimizer", {}),
    ("RMSPropOptimizer", {"learning_rate": _schedule, "momentum": 0.5}),
    ("RMSPropOptimizer", {"momentum": None}),
    ("AdafactorOptimizer", {}),
    ("AdafactorOptimizer", {"learning_rate": _schedule}),
]
IDS = ["adadelta", "adadelta_schedule", "rmsprop", "rmsprop_schedule",
       "rmsprop_no_momentum", "adafactor", "adafactor_schedule"]


def _tree(rng, scale=1.0):
    def leaf(shape):
        return (rng.randn(*shape) * scale).astype(np.float32)
    return {"enc": {k: leaf(s) for k, s in SHAPES["enc"].items()},
            "dec": [{"k": leaf(SHAPES["dec"][0]["k"])}]}


@pytest.mark.parametrize("clip_norm", [None, 1.0], ids=["plain", "clipped"])
@pytest.mark.parametrize("name,kwargs", OPTIMIZERS, ids=IDS)
def test_updates_and_state_match_optax(name, kwargs, clip_norm):
    rng = np.random.RandomState(0)
    params = _tree(rng, 0.3)
    tx = getattr(jax_optimizers, name)(**kwargs).make()
    if clip_norm:
        tx = optax.chain(optax.clip_by_global_norm(clip_norm), tx)
    jax_params = jax.tree_util.tree_map(jnp.asarray, params)
    jax_state = tx.init(jax_params)
    update = Update(getattr(optimizers, name)(**kwargs).make(), clip_norm)
    flat = {k: torch.from_numpy(v.copy())
            for k, v in jax_flatten(params).items()}
    state = update.init(flat)
    assert set(state) == set(jax_flatten(jax_state))
    for _ in range(10):
        grads = _tree(rng)
        updates, jax_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jax_state,
            jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        update.apply(flat, {k: torch.from_numpy(v) for k, v in
                            jax_flatten(grads).items()}, state)
    # relative to each tensor's largest entry: entries near zero after
    # cancellation carry the rounding of the larger terms
    for got, ref in ((flat, jax_flatten(jax_params)),
                     (state, jax_flatten(jax_state))):
        for key, value in ref.items():
            value = np.asarray(value)
            np.testing.assert_allclose(
                got[key].numpy(), value, rtol=1e-5,
                atol=1e-5 * float(np.abs(value).max()), err_msg=key)
            assert got[key].numpy().dtype == value.dtype, key


# ---------------------------------------------------------------------- #
# .opt across the packages, on one small model
# ---------------------------------------------------------------------- #
def _small_schedule(count):
    # Adafactor's steps scale with the parameters' size; at rates near 1
    # the small model's trajectory magnifies the packages' rounding
    return 0.05 / (1.0 + count)


RESUMED = [("AdadeltaOptimizer", {"epsilon": 1e-4}),
           ("RMSPropOptimizer", {"learning_rate": 1e-2}),
           ("AdafactorOptimizer", {"learning_rate": _small_schedule})]
RESUMED_IDS = ["adadelta", "rmsprop", "adafactor"]


def _sentences():
    rng = np.random.RandomState(1)
    src = [[f"s{i}" for i in rng.randint(0, 20, size=rng.randint(2, 7))]
           for _ in range(8)]
    tgt = [[f"t{i}" for i in rng.randint(0, 20, size=rng.randint(2, 7))]
           for _ in range(8)]
    return src, tgt


def _problem(port, name, kwargs, trainer_name=None):
    """(trainer, dataset) of a small translation model in one package."""
    src, tgt = _sentences()
    if port:
        vocab_cls, enc_cls, att_cls, dec_cls, trainer_cls, ds_cls, opt = (
            Vocabulary, SentenceEncoder, Attention, Decoder,
            CrossEntropyTrainer, Dataset, optimizers)
    else:
        vocab_cls, enc_cls, att_cls, dec_cls, trainer_cls, ds_cls, opt = (
            JaxVocabulary, JaxSentenceEncoder, JaxAttention, JaxDecoder,
            JaxCrossEntropyTrainer, JaxDataset, jax_optimizers)
    vs, vt = vocab_cls(), vocab_cls()
    for s in src:
        vs.add_tokenized_text(s)
    for t in tgt:
        vt.add_tokenized_text(t)
    enc = enc_cls(name="enc_r", vocabulary=vs, data_id="source",
                  embedding_size=8, rnn_size=6)
    att = att_cls(name="att_r", encoder=enc)
    dec = dec_cls(name="dec_r", vocabulary=vt, data_id="target",
                  max_output_len=8, rnn_size=7, encoders=[enc],
                  attentions=[att], embedding_size=8)
    trainer = trainer_cls(decoders=[dec], clip_norm=1.0, name=trainer_name,
                          optimizer=getattr(opt, name)(**kwargs))
    return trainer, ds_cls("toy", {"source": src, "target": tgt})


def _manager(port, problem, init_path=None):
    trainer, _ = problem
    manager = (CUDAManager(random_seed=3, device="cpu") if port
               else TPUManager(random_seed=3))
    manager.initialize_model_parts([trainer], seed=3)
    if init_path is not None:
        manager.restore([init_path])
    return manager


def _steps(manager, problem, n):
    trainer, ds = problem
    return [manager.train_on_batch(trainer, ds, batch_size=8)["loss"]
            for _ in range(n)]


def _run_saving_at_3(manager, problem, base):
    """Six steps, saving (parameters and ``.opt``) after the third."""
    losses = _steps(manager, problem, 3)
    ckpt = manager.save(base)
    return losses + _steps(manager, problem, 3), ckpt


@pytest.mark.parametrize("name,kwargs", RESUMED, ids=RESUMED_IDS)
def test_opt_resumes_across_packages(tmp_path, name, kwargs):
    """A port run saves at step 3; the JAX package resumes its checkpoint
    and ``.opt`` and continues the port's uninterrupted losses, saving
    at step 4; the port resumes that and continues the JAX run's."""
    problem = _problem(True, name, kwargs)
    jax_problem = _problem(False, name, kwargs)
    base, jax_base = str(tmp_path / "port"), str(tmp_path / "jax")
    losses, ckpt = _run_saving_at_3(_manager(True, problem), problem, base)

    jax_resumed = _manager(False, jax_problem, ckpt)
    jax_resumed.load_optimizer_state(base)
    jax_losses = _steps(jax_resumed, jax_problem, 1)
    jax_ckpt = jax_resumed.save(jax_base)
    jax_losses += _steps(jax_resumed, jax_problem, 2)
    np.testing.assert_allclose(jax_losses, losses[3:], rtol=1e-5)
    # both packages wrote the same state keys
    assert set(load_flat(base + ".opt")) == set(load_flat(jax_base + ".opt"))

    resumed = _manager(True, problem, jax_ckpt)
    resumed.load_optimizer_state(jax_base)
    np.testing.assert_allclose(_steps(resumed, problem, 2), jax_losses[1:],
                               rtol=1e-5)


@pytest.mark.parametrize("name,kwargs", RESUMED, ids=RESUMED_IDS)
def test_port_resume_continues_trajectory(tmp_path, name, kwargs):
    problem = _problem(True, name, kwargs)
    ref_losses = _steps(_manager(True, problem), problem, 6)

    first = _manager(True, problem)
    np.testing.assert_allclose(_steps(first, problem, 3), ref_losses[:3],
                               rtol=1e-5)
    base = str(tmp_path / "variables.data")
    ckpt = first.save(base)

    resumed = _manager(True, problem, ckpt)
    resumed.load_optimizer_state(base)
    np.testing.assert_allclose(_steps(resumed, problem, 3), ref_losses[3:],
                               rtol=1e-5)

    # without the optimizer state the first loss is equal, later not
    cold = _manager(True, problem, ckpt)
    cold_losses = _steps(cold, problem, 3)
    assert cold_losses[0] == pytest.approx(ref_losses[3], rel=1e-5)
    assert not np.allclose(cold_losses[1:], ref_losses[4:], rtol=1e-4)

    # another trainer label: the state is not applied (the run follows
    # the cold restart), and training goes on
    other = _problem(True, name, kwargs, trainer_name="other")
    mismatched = _manager(True, other, ckpt)
    mismatched.load_optimizer_state(base)
    np.testing.assert_allclose(_steps(mismatched, other, 2),
                               cold_losses[:2], rtol=1e-5)
