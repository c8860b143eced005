"""The PyTorch port's model and context axes against the JAX package's
one-device step on the CPU, the Transformer's cases (see
``test_torch_model_axes_jax.py``).

A label-smoothed 2 + 2-layer Transformer (width 16, FFN 32, 4 heads, a
34-entry vocabulary, sources and targets of up to 8 steps) takes the
JAX package's step on two gloo ranks: splitting its batch (data
parallelism), its attention, FFN and vocabulary over two model ranks,
also with sequence sharding (the residual stream's time axis over the
model ranks), and its time axes over two context ranks (the ring); a
MoE Transformer's experts' hidden columns over two model ranks, and
its stream over the model or the context ranks; the stacked layers of
a two-stage pipeline over two pipe ranks, and the MoE model's experts
over two expert ranks. Loss and updated parameters agree with the JAX
step within 1e-5; counters show the sequence split, the ring and the
pipeline ran.
"""

import pytest

import test_torch_model_axes_jax as axes
import test_torch_parallel_jax as dp_jax

RUNS = [("transformer", "transformer", {}),
        ("moe_tp", "moe", {"num_model_shards": 2}),
        ("transformer_tp", "transformer", {"num_model_shards": 2}),
        ("transformer_sp", "transformer", {"num_model_shards": 2,
                                           "sequence_sharding": True}),
        ("transformer_cp", "transformer", {"num_context_shards": 2}),
        # the MoE FFN routes whole sentences: a split stream is gathered
        # for it and split again after it
        ("moe_sp", "moe", {"num_model_shards": 2,
                           "sequence_sharding": True}),
        ("moe_cp", "moe", {"num_context_shards": 2}),
        # the stacked layers of two pipeline stages: the JAX package's
        # one-device step runs them one after another, the ranks through
        # the pipeline; the MoE layers' experts split over two ranks
        ("transformer_pp", "pipeline", {"num_pipeline_stages": 2}),
        ("moe_ep", "moe", {"num_expert_shards": 2})]


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return axes.run_counted(tmp_path_factory, RUNS)


@pytest.mark.parametrize("name,kind", [(name, kind)
                                       for name, kind, _ in RUNS])
def test_transformer_axes_take_the_jax_one_device_step(steps, name, kind):
    references, ranks, _ = steps
    dp_jax.check_step((references, ranks), name, kind)


def test_sequence_split_and_ring_ran(steps):
    """Under sequence sharding each Transformer layer's blocks return to
    the stream by a reduce-scatter of its time axis (2 encoder layers x 2
    blocks, 2 decoder layers x 3); the context runs fold on the ring
    (encoder 2, decoder 2 x 2; the MoE model's 1 and 2); the pipeline
    runs the stacked encoder and decoder once each; the expert run
    dispatches to its experts (each MoE layer's FFN, 1 + 1); the plain
    model-axis runs do none of these."""
    _, _, counts = steps
    none = axes.NONE
    for rank in counts:
        assert rank["transformer_sp"] == {**none, "reduce_scatter": 2 * 2
                                          + 2 * 3}
        assert rank["transformer_cp"] == {**none, "ring": 2 + 2 * 2}
        assert rank["transformer_tp"] == none
        assert rank["moe_tp"] == none
        # the MoE layers' attention blocks (1 encoder, 2 decoder); their
        # FFNs run on the gathered stream and are split after it
        assert rank["moe_sp"]["reduce_scatter"] == 1 + 2
        assert rank["moe_cp"]["ring"] == 1 + 2
        assert rank["transformer_pp"] == {**none, "gpipe": 2}
        # the dispatch and the combine of each expert FFN
        assert rank["moe_ep"] == {**none, "dispatch": 2 * (1 + 1)}
