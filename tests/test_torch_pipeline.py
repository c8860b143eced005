"""Pipeline parallelism in the PyTorch port (``parallel/pipeline.py``,
the ``pipe`` axis of ``parallel/mesh.py``) at two gloo ranks on the CPU:
the counterparts of the JAX package's ``tests/test_pipeline.py`` and
``tests/test_moe_pipeline.py``.

The two ranks are started once for this module
(``test_torch_parallel.run_ranks``) with ``num_pipeline_stages=2``; each
scenario runs on both ranks and alone in the test process, where the
same stacked layout runs its layers one after another (the JAX
package's fallback without a pipe mesh). With dropout off the two
compute one function: losses and parameters to 1e-5, greedy and beam
ids equal. The model is the JAX tests' 4 + 4-layer Transformer (width
16, FFN 32, 4 heads, a 32-entry vocabulary), two layers a stage.
"""

import os

import numpy as np
import pytest
import torch

from neuralmonkey_tpu_torch.ops import moe
from neuralmonkey_tpu_torch.parallel import distributed, mesh, pipeline
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.utils.saving import load_flat

import test_torch_parallel as harness
import test_torch_tensor_parallel as tp_tests

torch.set_num_threads(1)

ATOL = 1e-5


def _build(**kwargs):
    """``tp_tests.build``'s model, 4 layers a part."""
    return tp_tests.build("pp", depth=4, **kwargs)


def _stages() -> int:
    return distributed.process_count()


def train_and_decode(directory, stages=2, micro=0, rows=16, steps=2,
                     keep=1.0, att_keep=1.0, experts=0, save=False,
                     physical=False, **kwargs):
    """``steps`` steps and both decodes of the stacked Transformer (its
    parts' ``pipeline_stages`` and ``pipeline_microbatches``) on ``rows``
    sentences, with ``physical`` also the beam search by the physical
    reorder (``NM_LINEAGE=0``); on the ranks over a pipe axis of two,
    alone one process's. Returns the losses, parameters, ids, the
    pipeline's calls and the stage's shard shapes."""
    calls = {"gpipe": 0}
    real = pipeline.gpipe_apply

    def counted(*args, **kw):
        calls["gpipe"] += 1
        return real(*args, **kw)
    pipeline.gpipe_apply = counted
    try:
        trainer, runner, search = _build(keep=keep, att_keep=att_keep,
                                         stages=stages, experts=experts)
        for part in (runner.decoder, runner.decoder.encoders[0]):
            part.pipeline_microbatches = micro
        manager = CUDAManager(device="cpu", random_seed=0,
                              num_pipeline_stages=_stages(), **kwargs)
        manager.initialize_model_parts([trainer, runner, search], seed=0)
        ds = tp_tests.dataset(n=rows)
        out = [manager.train_on_batch(trainer, ds, rows)
               for _ in range(steps)]
        decodes = manager.run_on_batch([runner, search], ds, rows)
        beam_physical = (harness.physical_beam(manager, search, ds,
                                               rows).outputs
                         if physical else None)
        ckpt = (manager.save(os.path.join(
            directory, f"pp{distributed.process_index()}", "variables.data"))
            if save else None)
    finally:
        pipeline.gpipe_apply = real
    layers = manager.params["pp_src"]["layers"]
    return {"losses": [o["loss"] for o in out],
            "aux": [{k: v for k, v in o.items() if k.startswith("aux/")}
                    for o in out],
            "params": tp_tests.whole(manager),
            "greedy": decodes[0].outputs, "beam": decodes[1].outputs,
            "beam_physical": beam_physical,
            "gpipe_calls": calls["gpipe"], "ckpt": ckpt,
            "q_w": tuple(layers["att"]["q"]["w"].shape),
            "ff_in": tuple(layers["ff"]["in"]["w"].shape),
            "mesh": manager.mesh.shape}


# ---------------------------------------------------------------------- #
# scenarios: each runs on both ranks, or alone as the reference
# ---------------------------------------------------------------------- #
def executor(directory):
    """``gpipe_apply`` on a stack of 4 tanh layers in 4 microbatches
    (test_pipeline.py:36) and with routing-like stats folded by an
    ``aux_fn`` (test_moe_pipeline.py:75): the output, the folded total
    and the gradients of the layers, the input and the per-microbatch
    aux; alone, the sequential stack's."""
    del directory
    pipelined = distributed.is_initialized()
    if pipelined:
        CUDAManager(device="cpu", num_pipeline_stages=_stages())
    gen = torch.Generator().manual_seed(0)
    ws = (torch.randn(4, 8, 8, generator=gen) * 0.3).requires_grad_()
    bs = (torch.randn(4, 8, generator=gen) * 0.1).requires_grad_()
    x = torch.randn(16, 6, 8, generator=gen).requires_grad_()
    mask = (torch.rand(16, 6, generator=gen) > 0.2).float()
    enc = torch.randn(16, 6, 8, generator=gen).requires_grad_()

    def layer(w, b, h, mask_a, enc_a):
        out = torch.tanh(h @ w + b) * mask_a[..., None] + 0.1 * enc_a
        return out, {"s": out.sum(), "c": out.new_tensor(
            float(out.shape[0] * out.shape[1]))}

    def aux_fn(stats):
        return {"mean": stats["s"] / stats["c"]}

    if pipelined:
        out, total = pipeline.gpipe_apply(
            lambda lp, la, h, aux: layer(lp["w"], lp["b"], h, aux["mask"],
                                         aux["enc"]),
            {"w": ws, "b": bs}, None, x, {"mask": mask, "enc": enc},
            n_microbatches=4, aux_fn=aux_fn)
        total = total["mean"]
    else:
        out, total = x, 0.0
        for i in range(4):
            out, stats = layer(ws[i], bs[i], out, mask, enc)
            total = total + aux_fn(stats)["mean"]
    (out.square().sum() + total).backward()
    return {"out": out.detach(), "total": float(total.detach()),
            "grads": {name: t.grad.clone() for name, t in
                      (("ws", ws), ("bs", bs), ("x", x), ("enc", enc))}}


def transformer(directory):
    return train_and_decode(directory, save=True, physical=True)


def more_microbatches(directory):
    """4 microbatches on 2 stages (test_pipeline.py:197)."""
    return train_and_decode(directory, micro=4, steps=1)


def ragged(directory):
    """15 rows, which 2 microbatches do not divide: the stacked layers
    gathered and run one after another on the pipe mesh too
    (test_pipeline.py:161)."""
    return train_and_decode(directory, rows=15, steps=1)


def dropout(directory):
    """Residual and FFN dropout: each microbatch's masks are its rows of
    the whole batch's, the one-process run's."""
    return train_and_decode(directory, keep=0.8, steps=1)


def attention_dropout(directory):
    """Attention dropout folds the microbatch's ordinal into its seed:
    the loss depends on the seed, the layer and the microbatch alone, so
    one process with a pipe axis of 1 and the same 2 microbatches
    computes it (and a second run repeats it)."""
    del directory
    try:
        losses = []
        for _ in range(2):
            trainer, runner, _ = _build(att_keep=0.7, stages=2)
            for part in (runner.decoder, runner.decoder.encoders[0]):
                part.pipeline_microbatches = 2
            manager = CUDAManager(device="cpu", random_seed=0,
                                  num_pipeline_stages=_stages())
            if not distributed.is_initialized():
                # one stage of the same microbatches
                pipeline.enable_pipeline(mesh.current())
            manager.initialize_model_parts([trainer, runner], seed=0)
            losses.append(manager.train_on_batch(
                trainer, tp_tests.dataset(), 16)["loss"])
    finally:
        if not distributed.is_initialized():
            pipeline.disable_pipeline()
    return {"losses": losses}


def bf16(directory):
    """One step under the bf16 compute policy: the first layer turns the
    bf16 stream float32 (a float32 residual), so the stages' activations
    change dtype on the way; one process's loss and parameters."""
    from neuralmonkey_tpu_torch.ops import policy
    policy.set_compute_dtype("bfloat16")
    try:
        return train_and_decode(directory, steps=1)
    finally:
        policy.set_compute_dtype(None)


def moe_pipeline(directory):
    """MoE FFNs in the stacked layers (test_moe_pipeline.py:126): the
    balance terms from the routing sums added over the microbatches."""
    return train_and_decode(directory, experts=4)


def pp_ini(directory):
    """transformer.ini through the train CLI with both parts'
    ``pipeline_stages=2`` and ``tf_manager.num_pipeline_stages`` (alone,
    the stacked layers one after another), dropout off."""
    return harness.train_cli(directory, [
        f"tf_manager.num_pipeline_stages={_stages()}",
        "encoder.pipeline_stages=2", "decoder.pipeline_stages=2"],
        "pp_ini", "transformer.ini")


def fallback_logged(directory):
    del directory
    return sorted(pipeline._FALLBACKS)


SCENARIOS = ("executor", "transformer", "more_microbatches", "ragged",
             "dropout", "attention_dropout", "bf16", "moe_pipeline",
             "pp_ini", "fallback_logged")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return harness.run_ranks(str(tmp_path_factory.mktemp("pipe")),
                             SCENARIOS, module="test_torch_pipeline")


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    assert not distributed.is_initialized()
    directory = str(tmp_path_factory.mktemp("pipe_single"))
    return {name: globals()[name](directory) for name in SCENARIOS[:-1]}


def _same_run(got, want, decodes=True, params_atol=ATOL):
    np.testing.assert_allclose(got["losses"], want["losses"], atol=ATOL,
                               rtol=0)
    assert set(got["params"]) == set(want["params"])
    for key, value in want["params"].items():
        np.testing.assert_allclose(got["params"][key].numpy(), value.numpy(),
                                   atol=params_atol, rtol=0, err_msg=key)
    if decodes:
        assert got["greedy"] == want["greedy"]
        assert got["beam"] == want["beam"]
        assert got["beam_physical"] == want["beam_physical"]


def test_gpipe_executor_matches_sequential(ranks, single):
    """test_pipeline.py:36 and test_moe_pipeline.py:75: the output and
    the folded stats' total of the sequential stack on both ranks; each
    stage's gradient of its own layers (zeros elsewhere), the input's and
    the aux tensor's on every rank summed over the stages."""
    want = single["executor"]
    for stage, rank in enumerate(ranks):
        got = rank["executor"]
        np.testing.assert_allclose(got["out"], want["out"], atol=1e-6,
                                   rtol=0)
        assert got["total"] == pytest.approx(want["total"], abs=1e-6)
        for name in ("x", "enc"):
            np.testing.assert_allclose(got["grads"][name],
                                       want["grads"][name], atol=1e-5,
                                       rtol=0, err_msg=name)
        for name in ("ws", "bs"):
            mine = slice(2 * stage, 2 * stage + 2)
            np.testing.assert_allclose(got["grads"][name][mine],
                                       want["grads"][name][mine],
                                       atol=1e-5, rtol=0, err_msg=name)
            assert not got["grads"][name][2 - 2 * stage:4 - 2 * stage].any()


def test_pipelined_transformer_matches_one_process(ranks, single):
    """test_pipeline.py:112: two steps, losses and parameters to 1e-5,
    greedy and beam ids; each stage holds 2 of the 4 layers, through the
    pipeline (each step's encoder and decoder, the decodes' encoder)."""
    for rank in ranks:
        got = rank["transformer"]
        _same_run(got, single["transformer"])
        assert got["mesh"] == {"data": 1, "pipe": 2}
        assert got["q_w"] == (2, 16, 16)
        assert got["gpipe_calls"] >= 2 * 2 + 1
    assert single["transformer"]["q_w"] == (4, 16, 16)
    assert single["transformer"]["gpipe_calls"] == 0


def test_pipelined_physical_beam_matches_one_process(ranks, single):
    """The beam search by the physical reorder (``NM_LINEAGE=0``) over
    the stacked layers (gathered whole for the decode, every step over
    B·K rows): one process's ids on both stages, which are the lineage
    search's."""
    want = single["transformer"]
    assert want["beam_physical"] == want["beam"]
    for rank in ranks:
        assert rank["transformer"]["beam_physical"] == want["beam_physical"]


def test_pipelined_checkpoint_is_one_process_layout(ranks, single):
    """Rank 0 writes the whole stacked arrays, one process's keys,
    shapes and values; it restores into one process."""
    want = load_flat(single["transformer"]["ckpt"])
    got = load_flat(ranks[0]["transformer"]["ckpt"])
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        np.testing.assert_allclose(got[key], value, atol=ATOL, rtol=0,
                                   err_msg=key)
    assert got["pp_src/layers/att/q/w"].shape == (4, 16, 16)
    trainer, runner, search = _build(stages=2)
    manager = CUDAManager(device="cpu")
    manager.initialize_model_parts([trainer, runner, search], seed=1)
    manager.restore(ranks[0]["transformer"]["ckpt"])
    ds = tp_tests.dataset()
    assert manager.run_on_batch([runner], ds, 16)[0].outputs == \
        single["transformer"]["greedy"]


def test_more_microbatches_than_stages(ranks, single):
    """test_pipeline.py:197: M = 4 > S = 2."""
    for rank in ranks:
        _same_run(rank["more_microbatches"], single["more_microbatches"])


def test_ragged_batch_falls_back_on_the_pipe_mesh(ranks, single):
    """test_pipeline.py:161: 15 rows run the gathered layers one after
    another, the gradients back on their stages; the fallback logged
    once a part and reason."""
    for rank in ranks:
        got = rank["ragged"]
        _same_run(got, single["ragged"])
        assert got["gpipe_calls"] == 0
        reasons = rank["fallback_logged"]
        assert ("pp_src", "batch 15 not divisible by 2 microbatches") \
            in reasons
        assert len(reasons) == len(set(reasons))


def test_residual_dropout_matches_one_process(ranks, single):
    """test_pipeline.py:144: dropout under the pipeline trains; the
    residual and FFN masks are the one-process run's."""
    for rank in ranks:
        got = rank["dropout"]
        _same_run(got, single["dropout"])
        assert got["losses"] != pytest.approx(
            single["more_microbatches"]["losses"], abs=1e-3)


def test_attention_dropout_depends_on_seed_layer_and_microbatch(ranks,
                                                                single):
    """Attention dropout's masks fold the microbatch: two stages and one
    stage of the same two microbatches draw the same masks (and the
    loss differs from the undropped one)."""
    want = single["attention_dropout"]["losses"]
    assert want[0] == want[1]
    for rank in ranks:
        np.testing.assert_allclose(rank["attention_dropout"]["losses"],
                                   want, atol=ATOL, rtol=0)
    assert want[0] != pytest.approx(
        single["more_microbatches"]["losses"][0], abs=1e-3)


def test_bf16_policy_matches_one_process(ranks, single):
    """Under the bf16 policy the stages hand on the dtype their layers
    return: one process's loss (1e-5); the parameters after one Adam step
    to 1e-4, as a microbatch's products, blocked otherwise than the whole
    batch's, can round a bf16 operand to its neighbour and move a
    near-zero gradient's step (a float32 run holds 1e-5), and for the
    same reason the decodes' near ties are not compared."""
    for rank in ranks:
        _same_run(rank["bf16"], single["bf16"], decodes=False,
                  params_atol=1e-4)
        assert len(rank["bf16"]["greedy"]) == 16
    assert single["bf16"]["losses"] != single["more_microbatches"]["losses"]


def test_moe_pipeline_matches_one_process(ranks, single):
    """test_moe_pipeline.py:126: losses with the balance terms, the
    parameters and ids of one process."""
    want = single["moe_pipeline"]
    for rank in ranks:
        got = rank["moe_pipeline"]
        _same_run(got, want)
        for got_aux, want_aux in zip(got["aux"], want["aux"]):
            assert sorted(got_aux) == ["aux/pp_src/moe_balance",
                                       "aux/pp_tgt/moe_balance"]
            for key, value in want_aux.items():
                assert got_aux[key] == pytest.approx(value, abs=1e-6), key
        assert got["ff_in"] == (2, 4, 16, 32)


def test_pipeline_ini_driven(ranks, single):
    """The INI surface: ``[tf_manager] num_pipeline_stages`` and the
    parts' ``pipeline_stages`` through the train CLI; rank 0 logs one
    process's losses, rank 1 writes no metrics."""
    want = [r for r in single["pp_ini"]["records"] if r["kind"] == "train"]
    first, second = (r["pp_ini"] for r in ranks)
    assert first["code"] == second["code"] == 0
    train = [r for r in first["records"] if r["kind"] == "train"]
    assert train and [r["step"] for r in train] == [r["step"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in train],
                               [r["loss"] for r in want], atol=ATOL, rtol=0)
    assert second["records"] == []


@pytest.mark.parametrize("kwargs,match", [
    ({"depth": 5, "pipeline_stages": 4}, "depth 5 not divisible by 4"),
    ({"depth": 4, "pipeline_stages": 4, "pipeline_microbatches": 2},
     "pipeline_microbatches=2 must be >= pipeline_stages=4")])
def test_pipeline_rejects_bad_options(kwargs, match):
    """test_pipeline.py:190 and :226."""
    from neuralmonkey_tpu_torch.models.encoders.transformer import \
        TransformerEncoder
    with pytest.raises(ValueError, match=match):
        TransformerEncoder(name="bad", vocabulary=tp_tests.vocab(),
                           data_id="source", embedding_size=16, n_heads=4,
                           **kwargs)


def test_fsdp_with_pipeline_stages_raises():
    """The JAX package's refusal: the stages hold their layers whole."""
    with pytest.raises(ValueError, match="fsdp"):
        CUDAManager(device="cpu", fsdp=True, num_pipeline_stages=2)


def test_stacked_layout_without_a_mesh_is_the_plain_model():
    """test_pipeline.py:161: one process without a pipe mesh runs the
    stacked layers one after another; its step is the unstacked model's
    (the same initial values, stacked)."""
    results = []
    for stages in (0, 2):
        trainer, runner, search = _build(stages=stages)
        manager = CUDAManager(device="cpu", random_seed=0)
        assert pipeline.pipeline_mesh() is None
        manager.initialize_model_parts([trainer, runner], seed=0)
        results.append(manager.train_on_batch(trainer, tp_tests.dataset(),
                                              16)["loss"])
    assert results[0] == results[1]


def test_gpipe_apply_raises_the_jax_errors():
    """gpipe_apply's three ValueErrors (parallel/pipeline.py:126-137)
    and its refusal without a mesh."""
    x = torch.zeros(6, 2, 4)
    layers = {"w": torch.zeros(4, 4, 4)}
    with pytest.raises(RuntimeError, match="without a registered"):
        pipeline.gpipe_apply(lambda p, a, h, m: h, layers, None, x, {})
    CUDAManager(device="cpu")
    pipeline.enable_pipeline(mesh.Mesh(1, 0, {}))
    try:
        with pytest.raises(ValueError, match="batch 6 not divisible by 4"):
            pipeline.gpipe_apply(lambda p, a, h, m: h, layers, None, x, {},
                                 n_microbatches=4)
        grid = mesh.Mesh(3, 0, {"pipe": 3})
        mesh.enable(grid)
        with pytest.raises(ValueError, match="4 layers not divisible by 3"):
            pipeline.gpipe_apply(lambda p, a, h, m: h, layers, None, x, {},
                                 n_microbatches=3)
        # a data axis of 2 beside the pipe axis: 6 rows in microbatches of
        # 3 would not divide over the data ranks
        mesh.enable(mesh.Mesh(4, 0, {"pipe": 2}))
        with pytest.raises(ValueError, match="microbatch size 3 not "
                           "divisible by data-parallel degree 2"):
            pipeline.gpipe_apply(lambda p, a, h, m: h, layers, None, x, {},
                                 n_microbatches=2)
    finally:
        pipeline.disable_pipeline()
        mesh.disable()
    assert moe.expert_sharding_mesh() is None
