"""Global-batch losses of the PyTorch port's data parallelism against the
JAX package on the CPU.

Each case of ``test_torch_parallel.build_case`` is built in both
packages with one numpy draw of its parameters; its batch holds four
sentences, the two of the first half longer than the two of the second,
so that the two halves hold different token counts. The JAX package's
one-device step (its trainer's ``total_loss``, its gradient and its
optax SGD update) is the reference; the port takes the same step on two
gloo ranks, each holding one half of the batch (a split batch: every
batch-level sum goes through ``distributed.global_sum``, and the ranks'
gradients are summed). Loss and updated parameters agree within 1e-5
for the cross-entropy, its l2 term, the labeler, CTC, the self-critical
objective (the port's sampler replays the JAX package's draws) and a
MoE Transformer's balance and z terms; the cross-entropy also under
ZeRO-1 and FSDP, and under FSDP (which gathers at use) the l2 term and
a 2 + 2-layer Transformer, whose layers are gather units of their own. The ranks are started from ``test_torch_parallel``;
``test_torch_model_axes_jax.py`` and
``test_torch_model_axes_transformer_jax.py`` hold the cases under the
model and context axes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from neuralmonkey_tpu.dataset import Dataset as JaxDataset
from neuralmonkey_tpu.model.part import Context as JaxContext
from neuralmonkey_tpu.model.part import collect_parts as jax_collect_parts
from neuralmonkey_tpu.model.part import init_all_params as jax_init
from neuralmonkey_tpu.utils.batching import pad_batch
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore

import test_torch_parallel as workers

ATOL = 1e-5
KEY = jax.random.PRNGKey(5)
# (name, case, manager keywords)
RUNS = [(kind, kind, {}) for kind in workers.CASES] + [
    ("xent_zero1", "xent", {"shard_optimizer_state": True}),
    ("xent_fsdp", "xent", {"fsdp": True}),
    ("l2_fsdp", "l2", {"fsdp": True}),
    ("transformer_fsdp", "transformer", {"fsdp": True})]


def _reference(kind):
    """(flat parameters, numpy batch, the JAX sampler's ids or None,
    the JAX step's losses and updated flat parameters)."""
    trainer = workers.build_case(kind, "neuralmonkey_tpu")
    parts = jax_collect_parts([trainer])
    template = jax_init(parts, jax.random.PRNGKey(0))
    rng = np.random.RandomState(11)
    flat = {k: (np.asarray(v) + rng.randn(*v.shape) * 0.3).astype(
        np.float32) for k, v in jax_flatten(template).items()}
    params = jax_restore(template, flat)
    dataset = JaxDataset("case", workers.case_series(kind))
    features = {}
    for part in parts:
        features.update(part.featurize(dataset, train=True))
    batch, _ = pad_batch(features, 4)
    arrays = {k: jnp.asarray(v) for k, v in batch.items()}
    sampled = None
    if kind == "self_critical":
        decoder = trainer.objectives[0].decoder
        sampled = np.asarray(jax.jit(lambda p, a: decoder.sample_outputs(
            JaxContext(p, a, train=True, rng=KEY))[0])(params, arrays))

    def loss_fn(p):
        return trainer.total_loss(p, arrays, KEY)
    # compiled once: faster than the op-by-op dispatch of the eager step
    (total, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    tx = trainer.make_optax()
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    new = jax_flatten(optax.apply_updates(params, updates))
    losses = {k: float(v) for k, v in losses.items()}
    losses["loss"] = float(total)
    return flat, batch, sampled, losses, {k: np.asarray(v)
                                          for k, v in new.items()}


def run_cases(tmp_path_factory, runs):
    """The JAX references of ``runs``' cases, and the two ranks' steps of
    every run."""
    kinds = sorted({kind for _, kind, _ in runs})
    references = {kind: _reference(kind) for kind in kinds}
    for flat, batch, _, _, _ in references.values():
        # the halves differ in their tokens
        masks = [v for k, v in batch.items() if k.endswith("mask")]
        assert masks and masks[0][:2].sum() != masks[0][2:].sum()
    cases = [(name, kind, *references[kind][:3], kwargs)
             for name, kind, kwargs in runs]
    ranks = workers.run_ranks(str(tmp_path_factory.mktemp("global")),
                              ["global_losses"], (cases,))
    return references, [r["global_losses"] for r in ranks]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return run_cases(tmp_path_factory, RUNS)


def check_step(steps, name, kind):
    """Every rank's losses and updated parameters of run ``name``: the
    JAX package's one-device step of ``kind`` (1e-5); both ranks
    computed the global loss."""
    references, ranks = steps
    _, _, _, want_losses, want_params = references[kind]
    for rank in ranks:
        got = rank[name]
        for key, value in want_losses.items():
            assert got["losses"][key] == pytest.approx(value, abs=ATOL), key
        assert set(got["params"]) == set(want_params)
        for key, value in want_params.items():
            np.testing.assert_allclose(got["params"][key], value, atol=ATOL,
                                       rtol=0, err_msg=f"{name}: {key}")
    # every rank computed the global loss
    assert ranks[0][name]["losses"] == ranks[1][name]["losses"]


@pytest.mark.parametrize("name,kind", [(name, kind)
                                       for name, kind, _ in RUNS])
def test_two_ranks_take_the_jax_one_device_step(steps, name, kind):
    check_step(steps, name, kind)


def test_moe_case_has_balance_and_z_terms(steps):
    references, _ = steps
    losses = references["moe"][3]
    assert any("moe_balance" in k for k in losses)
    assert any("moe_z" in k for k in losses)


def test_l2_term_moves_the_step(steps):
    """The l2 case's step differs from the plain cross-entropy's, so its
    term (entered once, not once a rank) is what the comparison holds."""
    references, _ = steps
    assert references["l2"][3]["loss"] != pytest.approx(
        references["xent"][3]["loss"], abs=1e-4)
