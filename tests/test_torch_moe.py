"""The port's mixture-of-experts FFN and MoE Transformer against the JAX
package's, on the CPU.

The JAX package computes its MoE outside any Pallas kernel; its
attention here runs its plain path. Parameters and inputs are drawn with
numpy and loaded into both packages. Router noise is off wherever the
two are compared (each framework draws its own numbers).

- ``moe_capacity`` on the edge cases of its float arithmetic: equal.
- ``top_k_lowest_index`` against ``lax.top_k`` on rows full of ties:
  equal values and indices.
- ``moe_ffn``: overflow that drops tokens (capacity factor 0.5), a
  masked group (one group all padding), ties in the router (duplicated
  router columns and an all-zero token), top-1 routing, and the no-drop
  decode routing (one group, capacity factor E / k): the output, the
  balance and z losses (also as ``moe_combine_stats`` of the JAX
  package's routing sums) to 1e-5, the gradients of the input and of
  every parameter to 1e-5.
- Router noise: drawn from its seed, the same on every call, a different
  output from the noiseless one.
- A MoE Transformer (2 + 2 layers, width 32, 4 heads, 4 experts, top 2):
  the training loss, both auxiliary losses and the gradient of every
  parameter (1e-5 for the losses, 2e-5 absolute plus 1e-4 relative for
  the gradients, as tests/test_torch_transformer.py), and greedy and
  beam-4 ids through both lineage forms on a batch with a padding row,
  the real rows' ids also equal to those of the batch without it.
- moe.ini (``DelayedUpdateTrainer`` at k = 2, Adam, noam) trained 4
  steps by both packages from one set of parameters, noise and dropout
  off: the losses and gradient norms step by step to 1e-4 relative.
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
from neuralmonkey_tpu.models.decoders.transformer import \
    TransformerDecoder as JaxTransformerDecoder
from neuralmonkey_tpu.models.encoders.transformer import \
    TransformerEncoder as JaxTransformerEncoder
from neuralmonkey_tpu.ops import moe as jax_moe
from neuralmonkey_tpu.utils.saving import flatten_tree as jax_flatten
from neuralmonkey_tpu.utils.saving import restore_into as jax_restore
from neuralmonkey_tpu.vocabulary import Vocabulary as JaxVocabulary

from neuralmonkey_tpu_torch.dataset import BatchingScheme
from neuralmonkey_tpu_torch.experiment import Experiment
from neuralmonkey_tpu_torch.model.part import (Context, collect_parts,
                                               init_all_params)
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.transformer import \
    TransformerDecoder
from neuralmonkey_tpu_torch.models.encoders.transformer import \
    TransformerEncoder
from neuralmonkey_tpu_torch.ops import moe
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, params_from_jax
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_INI = os.path.join(REPO, "tests", "configs", "moe.ini")
ATOL = 1e-5
BATCH, SRC, TGT, WIDTH, VOCAB, EXPERTS = 3, 7, 6, 32, 60, 4


def _close(got, ref, atol=ATOL, rtol=0.0, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=rtol, err_msg=msg)


@pytest.mark.parametrize("group,experts,k,factor", [
    (8, 4, 2, 1.5), (7, 4, 2, 0.5), (640, 8, 2, 4.0), (5, 3, 2, 1.5),
    (3, 8, 2, 1.25), (64, 8, 2, 1.5), (1, 4, 1, 0.1), (9, 3, 3, 1.0)])
def test_moe_capacity_matches_jax(group, experts, k, factor):
    assert moe.moe_capacity(group, experts, k, factor) == \
        jax_moe.moe_capacity(group, experts, k, factor)


def test_top_k_breaks_ties_by_the_lowest_index():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 3, (6, 5, 9)).astype(np.float32)
    for k in (1, 2, 4):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = moe.top_k_lowest_index(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


# ---------------------------------------------------------------------- #
# the MoE FFN
# ---------------------------------------------------------------------- #
G, S, D, H = 2, 8, 6, 10
CASES = ["overflow", "masked", "ties", "top1", "decode", "plain"]


def _moe_case(case):
    """(params, x, mask, kwargs) of one routing case, as numpy."""
    rng = np.random.RandomState(CASES.index(case))
    experts = 3 if case == "top1" else EXPERTS
    params = {"router": {"w": rng.randn(D, experts).astype(np.float32)},
              "in": {"w": (rng.randn(experts, D, H) * 0.4).astype(np.float32),
                     "b": (rng.randn(experts, H) * 0.1).astype(np.float32)},
              "out": {"w": (rng.randn(experts, H, D) * 0.4
                            ).astype(np.float32),
                      "b": (rng.randn(experts, D) * 0.1).astype(np.float32)}}
    groups, size = (1, 6) if case == "decode" else (G, S)
    x = rng.randn(groups, size, D).astype(np.float32)
    mask = None
    kwargs = {"top_k": 2, "capacity_factor": 1.5}
    if case == "overflow":
        kwargs["capacity_factor"] = 0.5
    elif case == "masked":
        mask = np.ones((G, S), np.float32)
        mask[0, 5:] = 0.0
        mask[1] = 0.0
    elif case == "ties":
        # experts 1 and 3 duplicate 0 and 2; token (0, 0) is all zeros
        params["router"]["w"][:, 1] = params["router"]["w"][:, 0]
        params["router"]["w"][:, 3] = params["router"]["w"][:, 2]
        x[0, 0] = 0.0
    elif case == "top1":
        kwargs["top_k"] = 1
    elif case == "decode":
        mask = np.array([[1, 1, 0, 1, 1, 0]], np.float32)
        kwargs["capacity_factor"] = EXPERTS / 2
    return params, x, mask, kwargs


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_matches_jax(case):
    params, x, mask, kwargs = _moe_case(case)
    cot = np.random.RandomState(1).randn(*x.shape).astype(np.float32)

    def jax_objective(p, x_):
        y, aux = jax_moe.moe_ffn(p, x_, None if mask is None
                                 else jnp.asarray(mask), **kwargs)
        return jnp.sum(y * cot) + aux["balance"] + 0.3 * aux["z"], (y, aux)
    (_, (ref_y, ref_aux)), (ref_gp, ref_gx) = jax.jit(jax.value_and_grad(
        jax_objective, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in flatten_tree(params).items()}
    tree = {"router": {"w": leaves["router/w"]},
            "in": {"w": leaves["in/w"], "b": leaves["in/b"]},
            "out": {"w": leaves["out/w"], "b": leaves["out/b"]}}
    px = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_ffn(tree, px, None if mask is None
                         else torch.from_numpy(mask), **kwargs)
    ((y * torch.from_numpy(cot)).sum() + aux["balance"]
     + 0.3 * aux["z"]).backward()
    _close(y, ref_y)
    for name in ("balance", "z"):
        _close(aux[name], ref_aux[name], msg=name)
    _close(px.grad, ref_gx)
    for key, ref in jax_flatten(ref_gp).items():
        _close(leaves[key].grad, ref, msg=key)
    if case == "overflow":
        # tokens past the capacity get less than every choice's share
        full, _ = moe.moe_ffn(tree, px, capacity_factor=4.0, top_k=2)
        assert not torch.allclose(full, y)
    if case == "masked":
        assert not y[1].detach().abs().any()


@pytest.mark.parametrize("case", ["overflow", "masked"])
def test_moe_combine_stats_matches_jax(case):
    """The losses from the JAX package's routing sums, and the port's
    losses of the same routing equal to them."""
    params, x, mask, kwargs = _moe_case(case)
    _, sums = jax_moe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, params),
                              jnp.asarray(x), None if mask is None
                              else jnp.asarray(mask), return_stats=True,
                              **kwargs)
    ref = jax_moe.moe_combine_stats(sums)
    got = moe.moe_combine_stats({k: torch.tensor(np.asarray(v))
                                 for k, v in sums.items()})
    _, aux = moe.moe_ffn(jax.tree_util.tree_map(torch.from_numpy, params),
                         torch.from_numpy(x), None if mask is None
                         else torch.from_numpy(mask), **kwargs)
    assert set(got) == set(ref) == set(aux)
    for key in ref:
        _close(got[key], ref[key], msg=key)
        _close(aux[key], ref[key], msg=key)


def test_router_noise_is_drawn_from_its_seed():
    params, x, _, kwargs = _moe_case("plain")
    tree = jax.tree_util.tree_map(torch.from_numpy, params)
    x = torch.from_numpy(x)
    plain, _ = moe.moe_ffn(tree, x, **kwargs)
    noisy = [moe.moe_ffn(tree, x, router_noise=0.5, noise_seed=seed,
                         **kwargs)[0] for seed in (7, 7, 8)]
    assert torch.equal(noisy[0], noisy[1])
    assert not torch.equal(noisy[0], noisy[2])
    assert not torch.allclose(noisy[0], plain)
    # without a seed (inference) the noise is off
    assert torch.equal(moe.moe_ffn(tree, x, router_noise=0.5, **kwargs)[0],
                       plain)


# ---------------------------------------------------------------------- #
# a MoE Transformer
# ---------------------------------------------------------------------- #
def _build(enc_cls, dec_cls, vocab_cls, max_out=TGT):
    vocab = vocab_cls([f"w{i}" for i in range(VOCAB - 4)])
    moe_args = dict(moe_experts=EXPERTS, moe_top_k=2, moe_z_loss_weight=0.001,
                    dropout_keep_prob=1.0)
    enc = enc_cls(name="encoder", vocabulary=vocab, data_id="source",
                  embedding_size=WIDTH, ff_hidden_size=48, depth=2,
                  n_heads=4, max_input_len=SRC, **moe_args)
    return dec_cls(name="decoder", vocabulary=vocab, data_id="target",
                   max_output_len=max_out, encoders=[enc],
                   embedding_size=WIDTH, ff_hidden_size=48, depth=2,
                   n_heads_self=4, n_heads_enc=4, label_smoothing=0.1,
                   **moe_args)


def _params(jax_dec, port_dec, seed, scale=0.1):
    """The JAX initialisation perturbed by a numpy draw, in both
    packages."""
    rng = np.random.RandomState(seed)
    template = jax_init(jax_collect_parts([jax_dec]), jax.random.PRNGKey(0))
    flat = {k: (np.asarray(v) + rng.randn(*v.shape) * scale).astype(
        np.float32) for k, v in jax_flatten(template).items()}
    return jax_restore(template, flat), params_from_jax(
        flat, init_all_params(collect_parts([port_dec]), seed=0))


def _batch(rng, lengths=(7, 4, 2), targets=True):
    batch = {"encoder_input.ids": rng.randint(4, VOCAB, (len(lengths), SRC)
                                              ).astype(np.int32),
             "encoder_input.mask": np.array(
                 [[1.0] * n + [0.0] * (SRC - n) for n in lengths],
                 np.float32)}
    if targets:
        batch.update({
            "decoder.train_inputs": rng.randint(1, VOCAB, (BATCH, TGT)
                                                ).astype(np.int32),
            "decoder.train_targets": rng.randint(2, VOCAB, (BATCH, TGT)
                                                 ).astype(np.int32),
            "decoder.train_mask": np.array(
                [[1.0] * n + [0.0] * (TGT - n) for n in (6, 3, 1)],
                np.float32)})
    return batch


def test_moe_transformer_loss_and_gradients_match_jax():
    jax_dec = _build(JaxTransformerEncoder, JaxTransformerDecoder,
                     JaxVocabulary)
    dec = _build(TransformerEncoder, TransformerDecoder, Vocabulary)
    jax_params, params = _params(jax_dec, dec, seed=0)
    batch = _batch(np.random.RandomState(2))
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        ctx = JaxContext(p, jax_batch, train=True, rng=jax.random.PRNGKey(1))
        loss = jax_dec.train_loss(ctx)
        return loss + sum(ctx.aux_losses.values()), (loss, ctx.aux_losses)
    (ref_total, (ref_loss, ref_aux)), ref_grads = jax.jit(
        jax.value_and_grad(jax_loss, has_aux=True))(jax_params)

    leaves = flatten_tree(params)
    for p in leaves.values():
        p.requires_grad_(True)
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                  train=True, rng=1)
    loss = dec.train_loss(ctx)
    total = loss + sum(ctx.aux_losses.values())
    total.backward()
    _close(loss, ref_loss)
    _close(total, ref_total)
    assert set(ctx.aux_losses) == set(ref_aux) == {
        f"{part}/{name}" for part in ("encoder", "decoder")
        for name in ("moe_balance", "moe_z")}
    for key, value in ctx.aux_losses.items():
        _close(value, ref_aux[key], msg=key)
    ref_grads = jax_flatten(ref_grads)
    assert set(leaves) == set(ref_grads)
    for key, p in leaves.items():
        _close(p.grad, ref_grads[key], atol=2e-5, rtol=1e-4, msg=key)


def test_moe_aux_losses_only_in_training():
    dec = _build(TransformerEncoder, TransformerDecoder, Vocabulary)
    params = init_all_params(collect_parts([dec]), seed=1)
    ctx = Context(params, {k: torch.from_numpy(v) for k, v in _batch(
        np.random.RandomState(3)).items()})
    dec.train_loss(ctx)
    assert ctx.aux_losses == {}


@pytest.mark.parametrize("lineage_kernel", ["0", "1"])
def test_moe_transformer_ids_match_jax(monkeypatch, lineage_kernel):
    """Greedy and beam-4 ids of a batch whose fourth row pads it (an
    all-zero source mask): equal to the JAX package's, and the real
    rows' equal to those of the batch without the padding row (the
    decode steps route every row without dropping, padding rows masked
    out)."""
    monkeypatch.setenv("NM_LINEAGE_KERNEL", lineage_kernel)
    jax_dec = _build(JaxTransformerEncoder, JaxTransformerDecoder,
                     JaxVocabulary, max_out=7)
    dec = _build(TransformerEncoder, TransformerDecoder, Vocabulary,
                 max_out=7)
    jax_params, params = _params(jax_dec, dec, seed=4, scale=0.3)
    padded = _batch(np.random.RandomState(5), (7, 4, 2, 0), targets=False)
    jax_bs = JaxBeamSearch(name="bs", parent_decoder=jax_dec, beam_size=4)
    bs = BeamSearchDecoder(name="bs", parent_decoder=dec, beam_size=4)
    jax_batch = {k: jnp.asarray(v) for k, v in padded.items()}
    ref_greedy, ref = jax.jit(lambda p: (
        jax_dec.decoded(JaxContext(p, jax_batch)),
        jax_bs.search(JaxContext(p, jax_batch))))(jax_params)
    outs = []
    for batch in (padded, {k: v[:BATCH] for k, v in padded.items()}):
        with torch.inference_mode():
            ctx = Context(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
            outs.append((dec.decoded(ctx).numpy(), bs.search(ctx)))
    (greedy, got), (greedy_real, got_real) = outs
    np.testing.assert_array_equal(greedy, ref_greedy)
    np.testing.assert_array_equal(got.token_ids.numpy(),
                                  np.asarray(ref.token_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               atol=1e-4)
    np.testing.assert_array_equal(greedy[:BATCH], greedy_real)
    np.testing.assert_array_equal(got.token_ids[:BATCH].numpy(),
                                  got_real.token_ids.numpy())


def test_moe_ini_trains_like_jax(tmp_path):
    """moe.ini's first four batches at batches_per_update=2 in both
    packages from one set of parameters, router noise and dropout off."""
    changes = [f'main.output="{tmp_path / "out"}"'] + [
        f"{part}.{key}={value}" for part in ("encoder", "decoder")
        for key, value in (("dropout_keep_prob", 1.0),
                           ("moe_router_noise", 0.0))]
    jax_exp = JaxExperiment(MOE_INI, train_mode=True, config_changes=changes)
    jax_exp.build_model()
    exp = Experiment(MOE_INI, train_mode=True, config_changes=changes + [
        'tf_manager.device="cpu"'])
    exp.build_model()
    manager = exp.tf_manager
    manager.params = params_from_jax(jax_flatten(jax_exp.tf_manager.params),
                                     manager.params)
    scheme = BatchingScheme(batch_size=16)
    jax_batches = jax_exp.model.train_dataset.batches(scheme, shuffled=False)
    batches = exp.model.train_dataset.batches(scheme, shuffled=False)
    for step in range(4):
        ref = jax_exp.tf_manager.train_on_batch(jax_exp.model.trainer,
                                                next(jax_batches), 16)
        got = manager.train_on_batch(exp.model.trainer, next(batches), 16)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-4,
                                       err_msg=f"step {step} {key}")
