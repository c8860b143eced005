"""Context parallelism of the PyTorch port's Transformer (the ``context``
axis, ``ops/sharding.py``, the ring of
``parallel/ring_attention.py``) at two gloo ranks on the CPU, and the
rank grid's shapes and refusals: the counterparts of the JAX package's
``tests/test_context_parallel.py`` product-path tests.

Each scenario runs on both ranks (``num_context_shards=2``) and alone in
the test process; with dropout off the two compute one process's
function (losses and parameters to 1e-5, greedy and beam ids equal),
and a counter proves that the ring ran where the time axes divide and
not where they do not. transformer.ini also trains through the train
CLI with ``[tf_manager] num_context_shards``, with attention dropout
riding the ring's blockwise masks. The ranks are started once.
"""

import numpy as np
import pytest
import torch

from neuralmonkey_tpu_torch.parallel import distributed
from neuralmonkey_tpu_torch.parallel.mesh import Mesh
from neuralmonkey_tpu_torch.runtime import CUDAManager

import test_torch_parallel as harness
import test_torch_tensor_parallel as tp_tests

torch.set_num_threads(1)

ATOL = 1e-5
shards = tp_tests.shards


def cp_transformer(directory):
    """Sources of 6 and targets of 3 words in batches padded to length 8:
    the encoder's self-attention on the contiguous ring, the decoder's on
    the causal zigzag ring (4 steps a rank), its cross-attention on the
    contiguous one."""
    del directory
    return tp_tests.counted_run("cp", 6, 3, num_context_shards=shards())


def cp_ragged(directory):
    """Sources of 5 words and targets of 2 (3 steps) left unpadded: no
    time axis divides, so nothing splits and the ring never runs (the
    JAX package's ``ring_eligible`` gate), the run is one process's."""
    del directory
    return tp_tests.counted_run("cpr", 5, 2, bucketed=False,
                                num_context_shards=shards())


def cp_ini(directory):
    """transformer.ini through the train CLI with
    ``tf_manager.num_context_shards``: dropout off (against one process),
    then residual and attention dropout on, the ring engaged."""
    shards = ["tf_manager.num_context_shards="
              f"{distributed.process_count()}"]
    calls, undo = tp_tests.counted_ring()
    try:
        plain = harness.train_cli(directory, shards, "cp_plain",
                                  "transformer.ini")
        plain["ring_calls"] = calls["n"]
        calls["n"] = 0
        dropped = harness.train_cli(directory, shards + [
            "encoder.dropout_keep_prob=0.9", "decoder.dropout_keep_prob=0.9",
            "encoder.attention_dropout_keep_prob=0.9",
            "decoder.attention_dropout_keep_prob=0.9"], "cp_dropout",
            "transformer.ini")
        dropped["ring_calls"] = calls["n"]
    finally:
        undo()
    return {"plain": plain, "dropout": dropped}


SCENARIOS = ("cp_transformer", "cp_ragged", "cp_ini")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return harness.run_ranks(str(tmp_path_factory.mktemp("cp_ranks")),
                             SCENARIOS, module=__name__)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("cp_single"))
    assert not distributed.is_initialized()
    return {name: globals()[name](directory) for name in SCENARIOS}


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


def test_context_parallel_transformer_matches_one_process(ranks, single):
    """Two steps and both decodes on two context ranks: one process's
    losses, norms, parameters and ids. In training the ring ran on every
    layer's attentions, each rank holding half of each time axis (per
    step 2 encoder self-attentions, 2 causal decoder self-attentions, 2
    cross-attentions); in decoding on the encoder (and the runners'
    teacher-forced losses), never on a decode step's single query."""
    assert single["cp_transformer"]["ring_calls"] == 0
    encoder = ((16, 4, 4, 4), (16, 4, 4, 4), False)
    decoder = ((16, 4, 4, 4), (16, 4, 4, 4), True)
    cross = ((16, 4, 4, 4), (16, 4, 4, 4), False)
    for result in ranks:
        got = result["cp_transformer"]
        _same_run(got, single["cp_transformer"])
        assert got["train_seen"] == 2 * (2 * [encoder] + 2 * [decoder,
                                                            cross])
        # the runners' losses are teacher-forced passes; no decode step's
        # single query ever rides the ring
        assert encoder in got["decode_seen"]
        assert set(got["decode_seen"]) <= {encoder, decoder, cross}


def test_context_parallel_ragged_time_runs_whole(ranks, single):
    """Time axes the context axis does not divide stay whole (the
    ``ring_eligible`` gate): one process's run, the ring never called."""
    for result in ranks:
        got = result["cp_ragged"]
        _same_run(got, single["cp_ragged"])
        assert got["ring_calls"] == 0


def test_context_parallel_ini_driven(ranks, single):
    """``[tf_manager] num_context_shards=2`` from the INI: with dropout
    off rank 0 logs one process's losses (the batches whose time axes
    divide ride the ring); with attention dropout on the ring stays
    engaged (blockwise masks) and the run ends."""
    want = single["cp_ini"]["plain"]
    first, second = (r["cp_ini"] for r in ranks)
    for result in (first, second):
        assert result["plain"]["code"] == 0
        assert result["dropout"]["code"] == 0
        assert result["plain"]["ring_calls"] > 0
        assert result["dropout"]["ring_calls"] > 0
    train = [r for r in first["plain"]["records"] if r["kind"] == "train"]
    ref = [r for r in want["records"] if r["kind"] == "train"]
    assert [r["step"] for r in train] == [r["step"] for r in ref]
    np.testing.assert_allclose([r["loss"] for r in train],
                               [r["loss"] for r in ref], atol=ATOL, rtol=0)
    losses = [r["loss"] for r in first["dropout"]["records"]
              if r["kind"] == "train"]
    assert losses and all(np.isfinite(losses))


def test_context_mesh_shapes_and_rejections():
    """The rank grid: data outermost, context, model innermost; a world
    the axes do not divide raises the JAX package's error, also for CP
    beside a pipe or expert axis in one process."""
    assert Mesh(8, 0, {"context": 4}).shape == {"data": 2, "context": 4}
    grid = Mesh(8, 5, {"context": 2, "model": 2})
    assert grid.shape == {"data": 2, "context": 2, "model": 2}
    assert grid.coords == {"data": 1, "pipe": 0, "expert": 0,
                           "context": 0, "model": 1}
    assert grid.axis_ranks("model") == [(0, 1), (2, 3), (4, 5), (6, 7)]
    assert grid.axis_ranks("context") == [(0, 2), (1, 3), (4, 6), (5, 7)]
    assert grid.axis_ranks("data") == [(0, 4), (1, 5), (2, 6), (3, 7)]
    with pytest.raises(ValueError, match="8 devices not divisible by "
                       "context=3"):
        Mesh(8, 0, {"context": 3})
    for other, axis in (("num_pipeline_stages", "pipe"),
                        ("num_expert_shards", "expert")):
        with pytest.raises(ValueError, match=f"1 devices not divisible by "
                           rf"{axis}=2\*context=2"):
            CUDAManager(device="cpu", num_context_shards=2, **{other: 2})
    with pytest.raises(ValueError, match="1 devices not divisible by "
                       "context=2"):
        CUDAManager(device="cpu", num_context_shards=2)
