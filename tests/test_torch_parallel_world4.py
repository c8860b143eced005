"""The mesh axes together at four gloo ranks on the CPU: data
parallelism over two replicas of a model split over two model ranks
(DP 2 x TP 2) under ZeRO-1 and under FSDP (also with the sequence
split over the model ranks), FSDP over two replicas of a model whose
sequence splits over two context ranks (DP 2 x CP 2), a model split over two model
ranks and two context ranks (TP 2 x CP 2, the ring on the heads each
rank holds), the stacked layers of two pipeline stages or 4 MoE experts
over two ranks beside two model or context ranks (PP x TP, EP x TP,
CP x PP, CP x EP), and two pipeline stages under ZeRO-1 over two data
replicas. The one group of four ranks of the tier-1 tests; every run is
one process's of its model (losses, norms and parameters after two
steps to 1e-5, greedy and beam ids equal). The model is
``test_torch_tensor_parallel``'s Transformer on sentences of 6 and 3
words (time axes of 8 after bucketing, so both context ranks hold 4
steps).
"""

import os

import numpy as np
import pytest
import torch

from neuralmonkey_tpu_torch.ops import moe
from neuralmonkey_tpu_torch.parallel import (distributed, fsdp, pipeline,
                                             ring_attention)
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.utils.saving import load_flat

import test_torch_parallel as harness
import test_torch_tensor_parallel as tp_tests

torch.set_num_threads(1)

ATOL = 1e-5
WORLD = 4
MODES = {"dp_tp_zero1": {"num_model_shards": 2,
                         "shard_optimizer_state": True},
         "dp_tp_fsdp": {"num_model_shards": 2, "fsdp": True},
         "dp_tp_sp_fsdp": {"num_model_shards": 2, "sequence_sharding": True,
                           "fsdp": True},
         "dp_cp_fsdp": {"num_context_shards": 2, "fsdp": True},
         "tp_cp": {"num_model_shards": 2, "num_context_shards": 2},
         "pp_tp": {"num_pipeline_stages": 2, "num_model_shards": 2},
         "ep_tp": {"num_expert_shards": 2, "num_model_shards": 2},
         "cp_pp": {"num_context_shards": 2, "num_pipeline_stages": 2},
         "cp_ep": {"num_context_shards": 2, "num_expert_shards": 2},
         "dp_pp_zero1": {"num_pipeline_stages": 2,
                         "shard_optimizer_state": True}}
# the model of each mode: the stacked layers of two pipeline stages
# where a pipe axis is, MoE FFNs of 4 experts where an expert axis is
VARIANTS = {"plain": {}, "stacked": {"stages": 2},
            "moe": {"experts": 4}}


def variant(kwargs) -> str:
    if kwargs.get("num_pipeline_stages", 1) > 1:
        return "stacked"
    if kwargs.get("num_expert_shards", 1) > 1:
        return "moe"
    return "plain"


def run(directory=None, model="plain", **kwargs):
    """Two steps and both decodes of the ``model`` variant; with
    ``kwargs`` on the ranks, alone the one-process run; with a
    ``directory`` the checkpoint after them (rank 0 writes)."""
    # the ring's, the pipeline's and the expert dispatch's calls
    counted = [(ring_attention, "ring_attention"),
               (pipeline, "gpipe_apply"), (moe, "constrain_dispatch")]
    calls = {name: 0 for _, name in counted}
    reals = [getattr(module, name) for module, name in counted]

    def counting(name, real):
        def call(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        return call
    for (module, name), real in zip(counted, reals):
        setattr(module, name, counting(name, real))
    try:
        trainer, runner, search = tp_tests.build("w4", **VARIANTS[model])
        manager = CUDAManager(device="cpu", random_seed=0, **kwargs)
        manager.initialize_model_parts([trainer, runner, search], seed=0)
        ds = tp_tests.dataset(src=6, tgt=3)
        # each step's unit collectives (under fsdp)
        manager.fsdp_stats.record = True
        out, events = [], []
        for _ in range(2):
            manager.fsdp_stats.reset()
            out.append(manager.train_on_batch(trainer, ds, 16))
            events.append(list(manager.fsdp_stats.events))
        decodes = manager.run_on_batch([runner, search], ds, 16)
        ckpt = (manager.save(os.path.join(
            directory, f"ck{distributed.process_index()}", "variables.data"))
            if directory else None)
    finally:
        for (module, name), real in zip(counted, reals):
            setattr(module, name, real)
    return {"losses": [o["loss"] for o in out],
            "norms": [o["grad_norm"] for o in out],
            "params": tp_tests.whole(manager),
            "greedy": decodes[0].outputs, "beam": decodes[1].outputs,
            "calls": calls, "ckpt": ckpt, "fsdp_events": events,
            "units": sorted(fsdp.unit_names(manager.params)),
            "mesh": manager.mesh.shape,
            "emb": tuple(manager.params["w4_src_input"]["embeddings"].shape),
            "opt_q": {k: tuple(v.shape) for state in
                      manager._opt_states.values() for k, v in state.items()
                      if k.endswith("w4_src/layers/att/q/w")},
            "ff_in": tuple((manager.params["w4_src"]["layers"]
                            if model == "stacked" else
                            manager.params["w4_src"]["layer_0"])["ff"]["in"][
                "w"].shape)}


def world4(directory):
    assert distributed.process_count() == WORLD
    return {mode: run(os.path.join(directory, mode) if "fsdp" in kwargs
                      else None, variant(kwargs), **kwargs)
            for mode, kwargs in MODES.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return [r["world4"] for r in harness.run_ranks(
        str(tmp_path_factory.mktemp("world4")), ["world4"],
        module=__name__, world=WORLD)]


@pytest.fixture(scope="module")
def singles(tmp_path_factory):
    """Each variant's one-process run."""
    assert not distributed.is_initialized()
    return {model: run(str(tmp_path_factory.mktemp(f"world4_{model}"))
                       if model == "plain" else None, model)
            for model in VARIANTS}


@pytest.fixture(scope="module")
def single(singles):
    return singles["plain"]


def _same_run(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got["norms"], want["norms"], atol=ATOL,
                               rtol=0)
    assert set(got["params"]) == set(want["params"])
    for key, value in want["params"].items():
        np.testing.assert_allclose(got["params"][key].numpy(), value.numpy(),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert got["greedy"] == want["greedy"]
    assert got["beam"] == want["beam"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_four_ranks_match_one_process(ranks, singles, mode):
    """Each layout of four ranks trains and decodes as one process of
    its model; the ring runs only where a context axis is, the pipeline
    where a pipe axis is, the experts' dispatch split where an expert
    axis is."""
    kwargs = MODES[mode]
    for result in ranks:
        got = result[mode]
        _same_run(got, singles[variant(kwargs)])
        assert (got["calls"]["ring_attention"] > 0) == (
            "num_context_shards" in kwargs)
        assert (got["calls"]["gpipe_apply"] > 0) == (
            "num_pipeline_stages" in kwargs)
        assert (got["calls"]["constrain_dispatch"] > 0) == (
            "num_expert_shards" in kwargs)


@pytest.mark.parametrize("mode", ["dp_tp_fsdp", "dp_tp_sp_fsdp",
                                  "dp_cp_fsdp"])
def test_fsdp_beside_other_axes_gathers_each_unit_once_a_step(ranks, mode):
    """Under FSDP beside TP, SP or CP (whose logits come from the output
    projection sliced along the time axis out of the decoder's
    parameters) each step's forward gathers each unit once, and the
    backward reduces each once, in the reverse order: no unit's gradient
    waits for the step's end."""
    for result in ranks:
        got = result[mode]
        for events in got["fsdp_events"]:
            gathers = [u for kind, u in events if kind == "gather"]
            reduces = [u for kind, u in events if kind == "reduce"]
            assert sorted(gathers) == got["units"]
            assert reduces == gathers[::-1]


def test_four_rank_layouts(ranks):
    """The meshes, and the shards each rank holds at rest: the embedding
    table's vocabulary halved over the model axis (and under FSDP its
    free dim over the data axis), the FFN's hidden columns halved over
    the model axis (and its rows over the data axis under FSDP)."""
    for result in ranks:
        assert result["dp_tp_zero1"]["mesh"] == {"data": 2, "model": 2}
        assert result["tp_cp"]["mesh"] == {"data": 1, "context": 2,
                                           "model": 2}
        assert result["dp_tp_zero1"]["emb"] == (16, 16)
        assert result["dp_tp_fsdp"]["emb"] == (16, 8)
        assert result["dp_tp_zero1"]["ff_in"] == (16, 16)
        assert result["dp_tp_fsdp"]["ff_in"] == (8, 16)


def test_pipe_and_expert_layouts(ranks, singles):
    """test_pipeline.py:234 and :283, test_moe.py:255,
    test_context_parallel.py:414-497: the meshes; a stage's layers, its
    FFN's hidden columns over the model axis (PP x TP); 2 of 4 experts,
    their hidden columns halved (EP x TP); under PP x ZeRO-1 the stacked
    moments keep the stage's layer and divide their largest free dim
    over the data axis."""
    assert singles["stacked"]["ff_in"] == (2, 16, 32)
    assert singles["moe"]["ff_in"] == (4, 16, 32)
    for result in ranks:
        assert result["pp_tp"]["mesh"] == {"data": 1, "pipe": 2,
                                           "model": 2}
        assert result["pp_tp"]["ff_in"] == (1, 16, 16)
        assert result["ep_tp"]["mesh"] == {"data": 1, "expert": 2,
                                           "model": 2}
        assert result["ep_tp"]["ff_in"] == (2, 16, 16)
        assert result["cp_pp"]["mesh"] == {"data": 1, "pipe": 2,
                                           "context": 2}
        assert result["cp_ep"]["ff_in"] == (2, 16, 32)
        assert result["dp_pp_zero1"]["mesh"] == {"data": 2, "pipe": 2}
        assert result["dp_pp_zero1"]["opt_q"] == {
            "mu/w4_src/layers/att/q/w": (1, 8, 16),
            "nu/w4_src/layers/att/q/w": (1, 8, 16)}


def test_dp_tp_fsdp_checkpoint_is_one_process_layout(ranks, single):
    """Parameters split over both the model and the data axes gather into
    rank 0's checkpoint and its optimizer state with one process's keys,
    shapes and (after the same two steps) values."""
    want = load_flat(single["ckpt"])
    want_opt = load_flat(os.path.join(os.path.dirname(single["ckpt"]),
                                      "variables.data.opt"))
    path = ranks[0]["dp_tp_fsdp"]["ckpt"]
    got = load_flat(path)
    got_opt = load_flat(os.path.join(os.path.dirname(path),
                                     "variables.data.opt"))
    for reference, flat in ((want, got), (want_opt, got_opt)):
        assert list(flat) == list(reference)
        for key, value in reference.items():
            assert flat[key].shape == value.shape, key
            np.testing.assert_allclose(flat[key], value, atol=ATOL, rtol=0,
                                       err_msg=key)
    for rank in ranks[1:]:
        written = os.path.dirname(rank["dp_tp_fsdp"]["ckpt"])
        assert not os.path.isdir(written) or not os.listdir(written)
