"""Expert parallelism in the PyTorch port (the ``expert`` axis of
``parallel/mesh.py``, ``ops/moe.py``) at two gloo ranks on the CPU: the
counterparts of the JAX package's ``tests/test_moe.py`` cases on an
expert mesh.

The two ranks are started once for this module
(``test_torch_parallel.run_ranks``) with ``num_expert_shards=2``: each
holds 2 of a MoE Transformer's 4 experts a layer and both route the
same rows; the same scenarios alone in the test process are one
process's. With dropout off the two compute one function: losses, the
router's gradient and parameters to 1e-5, greedy and beam ids equal.
The model is ``test_torch_tensor_parallel``'s Transformer with MoE FFNs.
"""

import numpy as np
import pytest
import torch

from neuralmonkey_tpu_torch.ops import moe
from neuralmonkey_tpu_torch.parallel import distributed, pipeline
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.utils.saving import flatten_tree

import test_torch_parallel as harness
import test_torch_tensor_parallel as tp_tests

torch.set_num_threads(1)

ATOL = 1e-5
ROUTER = "ep_src/layer_0/ff/router/w"


def _shards() -> int:
    return distributed.process_count()


def experts(directory):
    """The router's gradient of one pass, then two steps and both
    decodes of the MoE Transformer over an expert axis of two (alone,
    one process)."""
    del directory
    trainer, runner, search = tp_tests.build("ep", experts=4)
    manager = CUDAManager(device="cpu", random_seed=0,
                          num_expert_shards=_shards())
    manager.initialize_model_parts([trainer, runner, search], seed=0)
    ds = tp_tests.dataset()
    batch, _ = manager.build_batch(ds, 16, train=True)
    flat = flatten_tree(manager.params)
    for value in flat.values():
        value.requires_grad_(True)
    with distributed.sharded_batch(batch.split):
        total, _ = trainer.total_loss(manager.params, batch, 0)
    total.backward()
    router_grad = flat[ROUTER].grad.clone()
    for value in flat.values():
        value.grad = None
    out = [manager.train_on_batch(trainer, ds, 16) for _ in range(2)]
    decodes = manager.run_on_batch([runner, search], ds, 16)
    layer = manager.params["ep_src"]["layer_0"]["ff"]
    return {"router_grad": router_grad,
            "losses": [o["loss"] for o in out],
            "aux": [{k: v for k, v in o.items() if k.startswith("aux/")}
                    for o in out],
            "params": tp_tests.whole(manager),
            "greedy": decodes[0].outputs, "beam": decodes[1].outputs,
            "shapes": {name: tuple(layer[name]["w"].shape)
                       for name in ("in", "out", "router")},
            "mesh": manager.mesh.shape}


def ep_ini(directory):
    """moe.ini through the train CLI with ``tf_manager.num_expert_shards``
    (its comment's knob), dropout and router noise off."""
    return harness.train_cli(directory, [
        f"tf_manager.num_expert_shards={_shards()}",
        "encoder.moe_router_noise=0.0", "decoder.moe_router_noise=0.0"],
        "ep_ini", "moe.ini")


def registries(directory):
    """test_moe.py:442: a manager clears the pipeline and expert
    registries a previous one left, then sets its own."""
    del directory
    seen = []
    for kwargs in ({"num_pipeline_stages": 2}, {"num_expert_shards": 2},
                   {"num_model_shards": 2, "sequence_sharding": True}, {}):
        manager = CUDAManager(device="cpu", **kwargs)
        seen.append((pipeline.pipeline_mesh() is not None,
                     moe.expert_sharding_mesh() is not None,
                     manager.mesh.sequence))
    return seen


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return harness.run_ranks(str(tmp_path_factory.mktemp("experts")),
                             ["experts", "ep_ini", "registries"],
                             module="test_torch_expert_parallel")


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    assert not distributed.is_initialized()
    return {**experts(None), "ep_ini": ep_ini(
        str(tmp_path_factory.mktemp("experts_single")))}


def test_expert_parallel_matches_one_process(ranks, single):
    """test_moe.py:219: two steps (losses with their balance terms,
    parameters), greedy and beam ids of one process; the router's
    gradient, whole on each rank, summed from both ranks' experts."""
    for rank in ranks:
        got = rank["experts"]
        np.testing.assert_allclose(got["router_grad"], single["router_grad"],
                                   atol=ATOL, rtol=0)
        assert got["router_grad"].abs().sum() > 0
        np.testing.assert_allclose(got["losses"], single["losses"],
                                   atol=ATOL, rtol=0)
        for got_aux, want_aux in zip(got["aux"], single["aux"]):
            assert set(got_aux) == set(want_aux) == {
                "aux/ep_src/moe_balance", "aux/ep_tgt/moe_balance"}
            for key, value in want_aux.items():
                assert got_aux[key] == pytest.approx(value, abs=1e-6), key
        assert set(got["params"]) == set(single["params"])
        for key, value in single["params"].items():
            np.testing.assert_allclose(got["params"][key].numpy(),
                                       value.numpy(), atol=ATOL, rtol=0,
                                       err_msg=key)
        assert got["greedy"] == single["greedy"]
        assert got["beam"] == single["beam"]


def test_expert_parallel_ini_driven(ranks, single):
    """The INI surface: ``[tf_manager] num_expert_shards`` through the
    train CLI; rank 0 logs one process's losses."""
    want = [r for r in single["ep_ini"]["records"] if r["kind"] == "train"]
    first, second = (r["ep_ini"] for r in ranks)
    assert first["code"] == second["code"] == 0
    train = [r for r in first["records"] if r["kind"] == "train"]
    assert train and [r["step"] for r in train] == [r["step"] for r in want]
    np.testing.assert_allclose([r["loss"] for r in train],
                               [r["loss"] for r in want], atol=ATOL, rtol=0)


def test_expert_shard_shapes(ranks, single):
    """Each rank holds 2 of the 4 experts of a layer; the router whole."""
    assert single["shapes"] == {"in": (4, 16, 32), "out": (4, 32, 16),
                                "router": (16, 4)}
    for rank in ranks:
        got = rank["experts"]
        assert got["mesh"] == {"data": 1, "expert": 2}
        assert got["shapes"] == {"in": (2, 16, 32), "out": (2, 32, 16),
                                 "router": (16, 4)}


def test_new_manager_clears_stale_registries(ranks):
    """test_moe.py:442."""
    for rank in ranks:
        assert rank["registries"] == [(True, False, False),
                                      (False, True, False),
                                      (False, False, True),
                                      (False, False, False)]


def test_constrain_dispatch_takes_the_rank_experts():
    """Without an expert mesh the dispatch stays whole; with one, each
    rank takes its experts' part of the expert axis."""
    x = torch.arange(8.0).reshape(1, 1, 4, 2)
    assert moe.expert_sharding_mesh() is None
    assert moe.constrain_dispatch(x, 2) is x
    from neuralmonkey_tpu_torch.parallel import mesh
    grid = mesh.Mesh(2, 1, {"expert": 2})
    mesh.enable(grid)
    moe.enable_expert_sharding(grid)
    try:
        assert moe.constrain_dispatch(x, 2).tolist() == [[[[4.0, 5.0],
                                                            [6.0, 7.0]]]]
    finally:
        moe.disable_expert_sharding()
        mesh.disable()
