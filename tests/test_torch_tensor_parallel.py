"""Tensor parallelism in the PyTorch port (the ``model`` axis of
``parallel/mesh.py``, ``parallel/tensor.py``) at two gloo ranks on the
CPU: the counterparts of the JAX package's model-axis tests
(``tests/test_data_parallel.py``: the declarative specs, the Megatron
Transformer, its loss and greedy decode).

The ranks are started once for this module from
``test_torch_parallel.run_ranks``; each scenario below runs on both
ranks (``num_model_shards=2``) and alone in the test process (one
process), and with dropout off the two compute one process's function:
losses and parameters to 1e-5, greedy and beam ids equal. The model is
the JAX tests' Transformer: width 16, FFN 32, 2 + 2 layers, 4 heads, a
32-entry vocabulary.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from neuralmonkey_tpu_torch.dataset import Dataset
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.transformer import \
    TransformerDecoder
from neuralmonkey_tpu_torch.models.encoders.transformer import \
    TransformerEncoder
from neuralmonkey_tpu_torch.ops import kernel_config
from neuralmonkey_tpu_torch.parallel import (distributed, ring_attention,
                                             tensor)
from neuralmonkey_tpu_torch.runners.beam_search_runner import \
    BeamSearchRunner
from neuralmonkey_tpu_torch.runners.runner import GreedyRunner
from neuralmonkey_tpu_torch.runtime import CUDAManager, LocalBatch
from neuralmonkey_tpu_torch.trainers.cross_entropy_trainer import \
    CrossEntropyTrainer
from neuralmonkey_tpu_torch.trainers.optimizers import AdamOptimizer
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, load_flat
from neuralmonkey_tpu_torch.vocabulary import Vocabulary

import test_torch_parallel as harness

torch.set_num_threads(1)

REPO = harness.REPO
ATOL = 1e-5


# ---------------------------------------------------------------------- #
# the JAX tests' Transformer
# ---------------------------------------------------------------------- #
def vocab(words=28):
    v = Vocabulary()
    for i in range(words):  # 28 + 4 specials = 32 entries
        v.add_word(f"w{i}")
    return v


def dataset(n=16, src=3, tgt=2):
    return Dataset("toy", {
        "source": [[f"w{(i + j) % 24}" for j in range(src)]
                   for i in range(n)],
        "target": [[f"w{(i + 3 * j) % 24}" for j in range(tgt)]
                   for i in range(n)]})


def build(name="tp", keep=1.0, width=16, ff=32, heads=4, words=28,
          clip_norm=1.0, att_keep=1.0, tie=False, stages=0, experts=0,
          depth=2):
    """The model; ``stages`` pipeline stages (the stacked layers) and
    ``experts`` MoE FFNs in both parts, each of ``depth`` layers."""
    more = {"pipeline_stages": stages, "moe_experts": experts}
    enc = TransformerEncoder(
        name=f"{name}_src", vocabulary=vocab(words), data_id="source",
        embedding_size=width, ff_hidden_size=ff, depth=depth,
        n_heads=heads, dropout_keep_prob=keep,
        attention_dropout_keep_prob=att_keep, **more)
    dec = TransformerDecoder(
        name=f"{name}_tgt", vocabulary=vocab(words), data_id="target",
        encoders=[enc], embedding_size=width, ff_hidden_size=ff,
        depth=depth, n_heads_self=heads, n_heads_enc=heads,
        max_output_len=6, tie_embeddings=tie, dropout_keep_prob=keep,
        attention_dropout_keep_prob=att_keep, **more)
    # Adam's epsilon raised from 1e-8, as in test_torch_parallel: the key
    # biases' exact gradient is 0 and their rounding noise would otherwise
    # take steps of the learning rate
    trainer = CrossEntropyTrainer(
        decoders=[dec], clip_norm=clip_norm,
        optimizer=AdamOptimizer(learning_rate=1e-3, epsilon=1e-4))
    runner = GreedyRunner(output_series="target", decoder=dec)
    search = BeamSearchRunner(output_series="target_beam",
                              decoder=BeamSearchDecoder(
                                  name=f"{name}_bs", parent_decoder=dec,
                                  beam_size=3))
    return trainer, runner, search


def shards() -> int:
    """The model axis: the ranks of the group, 1 alone."""
    return distributed.process_count()


def manager_for(roots, **kwargs):
    manager = CUDAManager(device="cpu", random_seed=0,
                          num_model_shards=kwargs.pop("model", shards()),
                          **kwargs)
    manager.initialize_model_parts(roots, seed=0)
    return manager


def whole(manager):
    return {k: v.detach().clone()
            for k, v in flatten_tree(manager.whole_params()).items()}


def train_and_decode(trainer, runner, search, ds, steps=2, **kwargs):
    manager = manager_for([trainer, runner, search], **kwargs)
    out = [manager.train_on_batch(trainer, ds, len(ds)) for _ in range(steps)]
    decodes = manager.run_on_batch([runner, search], ds, len(ds))
    return manager, {"losses": [o["loss"] for o in out],
                     "norms": [o["grad_norm"] for o in out],
                     "params": whole(manager),
                     "greedy": decodes[0].outputs,
                     "beam": decodes[1].outputs}


def local_shape(manager, *path):
    tree = manager.params
    for key in path:
        tree = tree[key]
    return tuple(tree.shape), tensor.split_dim(tree)


def counted_ring():
    """Count the ring's calls from here on: (counter, undo)."""
    calls = {"n": 0, "seen": []}
    real = ring_attention.ring_attention

    def counted(q, k, v, mask, causal=False, *args, **kwargs):
        calls["n"] += 1
        calls["seen"].append((tuple(q.shape), tuple(k.shape), causal))
        return real(q, k, v, mask, causal, *args, **kwargs)
    ring_attention.ring_attention = counted
    return calls, lambda: setattr(ring_attention, "ring_attention", real)


def counted_run(name, src, tgt, steps=2, bucketed=True, **kwargs):
    """Two steps and the greedy and beam decodes of the Transformer under
    the manager keywords ``kwargs`` (on the ranks; alone, one process's
    run), on sentences of ``src`` and ``tgt`` words: in batches padded to
    the length buckets (``bucketed``), or as they are (a ragged time
    axis), the decodes then by ``fetch``; the ring's calls counted."""
    if not distributed.is_initialized():
        kwargs = {}
    calls, undo = counted_ring()
    try:
        trainer, runner, search = build(name)
        manager = CUDAManager(device="cpu", random_seed=0, **kwargs)
        manager.initialize_model_parts([trainer, runner, search], seed=0)
        ds = dataset(src=src, tgt=tgt)
        if bucketed:
            out = [manager.train_on_batch(trainer, ds, 16)
                   for _ in range(steps)]
        else:
            features = {}
            for part in manager.parts:
                features.update(part.featurize(ds, train=True))
            batch = LocalBatch({k: torch.from_numpy(v)
                                for k, v in features.items()})
            out = [manager.train_on_prepared(trainer, batch)
                   for _ in range(steps)]
        trained = calls["n"]
        if bucketed:
            decodes = [r.outputs for r in manager.run_on_batch(
                [runner, search], ds, 16)]
        else:
            with torch.inference_mode():
                decodes = [f["decoded"].numpy().tolist() if "decoded" in f
                           else f["token_ids"].numpy().tolist()
                           for f in manager.fetch([runner, search], batch)]
    finally:
        undo()
    return {"losses": [float(o["loss"]) for o in out],
            "norms": [float(o["grad_norm"]) for o in out],
            "params": whole(manager),
            "greedy": decodes[0], "beam": decodes[1],
            "ring_calls": trained, "train_seen": calls["seen"][:trained],
            "decode_seen": calls["seen"][trained:]}


# ---------------------------------------------------------------------- #
# scenarios: on both ranks, and alone as the reference
# ---------------------------------------------------------------------- #
def megatron(directory):
    """The Megatron Transformer: two steps, greedy and beam decodes, and
    each rank's shard shapes (``test_transformer_tensor_parallel_layers``
    and ``test_model_axis_sharding_transformer_declarative``)."""
    del directory
    trainer, runner, search = build("oddly_named")
    manager, result = train_and_decode(trainer, runner, search, dataset())
    src, tgt = "oddly_named_src", "oddly_named_tgt"
    result["shapes"] = {
        "q": local_shape(manager, src, "layer_0", "att", "q", "w"),
        "q_b": local_shape(manager, src, "layer_0", "att", "q", "b"),
        "o": local_shape(manager, src, "layer_0", "att", "o", "w"),
        "o_b": local_shape(manager, src, "layer_0", "att", "o", "b"),
        "ff_in": local_shape(manager, src, "layer_0", "ff", "in", "w"),
        "ff_out": local_shape(manager, src, "layer_0", "ff", "out", "w"),
        "cross_v": local_shape(manager, tgt, "layer_1", "cross_att_0", "v",
                               "w"),
        "ln": local_shape(manager, tgt, "layer_1", "ln_ff", "scale"),
        "src_emb": local_shape(manager, f"{src}_input", "embeddings"),
        "tgt_emb": local_shape(manager, f"{tgt}_embeddings", "embeddings"),
        "logit": local_shape(manager, tgt, "logit", "w"),
        "logit_b": local_shape(manager, tgt, "logit", "b")}
    return result


def tied(directory):
    """Tied embeddings: the decoder's table is the output projection, its
    vocabulary split over the model axis."""
    del directory
    trainer, runner, search = build("tied", tie=True)
    return train_and_decode(trainer, runner, search, dataset())[1]


def clipped(directory):
    """Clipping that bites (the norm far above 1e-3): the global norm
    counts each split leaf's squares once over the model axis."""
    del directory
    trainer, runner, search = build("clip", clip_norm=1e-3)
    return train_and_decode(trainer, runner, search, dataset())[1]


def undivided(directory):
    """Declared dims the model axis does not divide stay whole, with the
    JAX package's warning: a 33-entry vocabulary (the embedding tables
    and the output projection), FFN 33 and 3 heads of 6 (the attention's
    columns split, its heads gathered whole)."""
    del directory
    logged = io.StringIO()
    with contextlib.redirect_stdout(logged):
        trainer, runner, search = build("odd", width=18, ff=33, heads=3,
                                        words=29)
        manager, result = train_and_decode(trainer, runner, search,
                                           dataset())
    result["log"] = logged.getvalue()
    result["shapes"] = {
        "emb": local_shape(manager, "odd_src_input", "embeddings"),
        "logit": local_shape(manager, "odd_tgt", "logit", "w"),
        "ff_in": local_shape(manager, "odd_src", "layer_0", "ff", "in",
                             "w"),
        "q": local_shape(manager, "odd_src", "layer_0", "att", "q", "w")}
    return result


def dropout(directory):
    """Two steps with residual, FFN and attention dropout: the leaves
    every model rank holds whole stay equal on the ranks."""
    del directory
    trainer, runner, search = build("drop", keep=0.5, att_keep=0.8)
    manager = manager_for([trainer, runner, search])
    losses = [manager.train_on_batch(trainer, dataset(), 16)["loss"]
              for _ in range(2)]
    local = {k: v.detach().clone()
             for k, v in flatten_tree(manager.params).items()}
    return {"losses": losses, "local": local,
            "split": sorted(k for k, v in flatten_tree(
                manager.params).items() if tensor.is_split(v))}


def checkpoints(directory, whole_ckpt=None):
    """One step under TP, saved by rank 0 (whole tensors, one process's
    keys); and a whole checkpoint restored into TP, decoded."""
    rank = distributed.process_index()
    trainer, runner, search = build("ck")
    manager = manager_for([trainer, runner, search])
    manager.train_on_batch(trainer, dataset(), 16)
    path = manager.save(os.path.join(directory, f"ck{rank}",
                                     "variables.data"))
    result = {"ckpt": path, "params": whole(manager)}
    if whole_ckpt is not None:
        trainer, runner, search = build("ck")
        fresh = manager_for([trainer, runner, search])
        fresh.restore(whole_ckpt)
        result["restored"] = whole(fresh)
        result["restored_shape"] = local_shape(fresh, "ck_src", "layer_0",
                                               "att", "q", "w")
        result["decodes"] = [r.outputs for r in fresh.run_on_batch(
            [runner, search], dataset(), 16)]
    return result


def sequence(directory):
    """Sequence sharding (``sequence_sharding=True``): sources of 6 and
    targets of 3 words in batches padded to 8, so each model rank holds 4
    steps of the residual stream between the blocks."""
    del directory
    return counted_run("sp", 6, 3, num_model_shards=shards(),
                       sequence_sharding=True)


def sequence_ragged(directory):
    """Sequence sharding on unpadded sentences of 5 and 2 words: the
    time axes do not divide, so the streams stay whole (the same
    function, as the JAX package's padded layout computes it)."""
    del directory
    return counted_run("spr", 5, 2, bucketed=False,
                       num_model_shards=shards(), sequence_sharding=True)


def decodes(directory):
    """Decodes of untrained models with their vocabularies split: the
    tied Transformer's greedy and beam search with the caches in the
    lineage kernel's layout (``NM_LINEAGE_KERNEL=1``), each rank's
    heads, and its beam search by the physical reorder (plain B·K rows
    of this rank's heads, the cross-attention constants tiled); the
    RNN's greedy and hierarchical beam search (the fused logit
    projection armed over the gathered vocabulary), and its physical
    beam search; one RNN step under ``NM_FUSED_XENT=1``; and the plain
    paths the gates of K3 and of the fused cross-entropy logged."""
    del directory
    os.environ["NM_LINEAGE_KERNEL"] = "1"
    try:
        trainer, runner, search = build("lin", tie=True)
        manager = manager_for([trainer, runner, search])
        lineage = [r.outputs for r in manager.run_on_batch(
            [runner, search], dataset(), 16)]
        physical = harness.physical_beam(manager, search, dataset(),
                                            16).outputs
        heads = manager.params["lin_tgt"]["layer_0"]["self_att"]["q"][
            "w"].shape[1] // 4
    finally:
        del os.environ["NM_LINEAGE_KERNEL"]
    trainer = harness.build_case("xent", "neuralmonkey_tpu_torch")
    decoder = trainer.objectives[0].decoder
    runner = GreedyRunner(output_series="target", decoder=decoder)
    search = BeamSearchRunner(output_series="target_beam",
                              decoder=BeamSearchDecoder(
                                  name="rnn_bs", parent_decoder=decoder,
                                  beam_size=3,
                                  selection_method="hierarchical"))
    manager = manager_for([trainer, runner, search])
    data = Dataset("case", harness.case_series("xent"))
    rnn = [r.outputs for r in manager.run_on_batch([runner, search], data,
                                                   4)]
    rnn_physical = harness.physical_beam(manager, search, data, 4).outputs
    os.environ["NM_FUSED_XENT"] = "1"
    try:
        loss = manager.train_on_batch(trainer, data, 4)["loss"]
    finally:
        del os.environ["NM_FUSED_XENT"]
    return {"lineage": lineage, "physical": physical, "heads": heads,
            "rnn": rnn, "rnn_physical": rnn_physical, "loss": loss,
            "plain_paths": sorted(kernel_config._PLAIN_PATHS)}


def small_ini(directory):
    """small.ini's RNN through the train CLI with ``[tf_manager]
    num_model_shards`` (the INI key), each rank into its own output
    directory, a loss logged every step."""
    return harness.train_cli(directory, [
        f"tf_manager.num_model_shards={shards()}"], "small_ini")


SCENARIOS = ("megatron", "tied", "clipped", "undivided", "dropout",
             "sequence", "sequence_ragged", "decodes", "small_ini")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("tp_ranks"))
    # a whole checkpoint of one process, restored by the ranks
    single_dir = str(tmp_path_factory.mktemp("tp_whole"))
    trainer, runner, search = build("ck")
    one = manager_for([trainer, runner, search], model=1)
    one.train_on_batch(trainer, dataset(), 16)
    whole_ckpt = one.save(os.path.join(single_dir, "variables.data"))

    results = harness.run_ranks(directory, SCENARIOS, module=__name__)
    saved = harness.run_ranks(os.path.join(directory, "ck"),
                              ["checkpoints"], (whole_ckpt,),
                              module=__name__)
    return results, [r["checkpoints"] for r in saved], whole_ckpt


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("tp_single"))
    assert not distributed.is_initialized()
    return {name: globals()[name](directory) for name in (
        "megatron", "tied", "clipped", "undivided", "sequence",
        "sequence_ragged", "decodes", "small_ini")}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def _params_close(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   atol=ATOL, rtol=0, err_msg=key)


def _same_run(got, want):
    _close(got["losses"], want["losses"])
    _close(got["norms"], want["norms"])
    _params_close(got["params"], want["params"])
    assert got["greedy"] == want["greedy"]
    assert got["beam"] == want["beam"]


def test_megatron_transformer_matches_one_process(ranks, single):
    """Loss, gradient norm, parameters after two steps, greedy and beam
    ids of the Transformer split over two model ranks: one process's."""
    results, _, _ = ranks
    for result in results:
        _same_run(result["megatron"], single["megatron"])


def test_declared_specs_split_the_shard_shapes(ranks):
    """Each rank holds the declared dims halved, whatever its parts are
    named: q/k/v and FFN-in columns, o and FFN-out rows, the embedding
    tables' and the output projection's vocabulary; the layer norms and
    the o bias whole."""
    results, _, _ = ranks
    want = {"q": ((16, 8), 1), "q_b": ((8,), 0), "o": ((8, 16), 0),
            "o_b": ((16,), None), "ff_in": ((16, 16), 1),
            "ff_out": ((16, 16), 0), "cross_v": ((16, 8), 1),
            "ln": ((16,), None), "src_emb": ((16, 16), 0),
            "tgt_emb": ((16, 16), 0), "logit": ((16, 16), 1),
            "logit_b": ((16,), 0)}
    for result in results:
        assert result["megatron"]["shapes"] == want


def test_tied_embeddings_split_their_vocabulary(ranks, single):
    results, _, _ = ranks
    for result in results:
        _same_run(result["tied"], single["tied"])


def test_clipping_that_bites_matches_one_process(ranks, single):
    results, _, _ = ranks
    assert single["clipped"]["norms"][0] > 1e-2
    for result in results:
        _same_run(result["clipped"], single["clipped"])


def test_undivided_dims_stay_whole_and_match(ranks, single):
    """Dims the model axis does not divide stay whole on each rank (and
    their layers run whole); the 3 heads of split columns attend whole;
    the run is one process's."""
    results, _, _ = ranks
    for result in results:
        got = result["undivided"]
        assert got["shapes"] == {"emb": ((33, 18), None),
                                 "logit": ((18, 33), None),
                                 "ff_in": ((18, 33), None),
                                 "q": ((18, 9), 1)}
        _same_run(got, single["undivided"])


def test_undivided_dim_warns(ranks):
    """The manager warns for each declared dim it keeps whole, as the JAX
    package's ``_declared_axes`` does."""
    results, _, _ = ranks
    for result in results:
        text = result["undivided"]["log"]
        for name in ("odd_src_input/embeddings", "odd_tgt/logit/w",
                     "odd_src/layer_0/ff/in/w"):
            assert f"Param '{name}' dim 33 not divisible by mesh axis " \
                "model=2; replicating" in text, name
        assert "odd_src/layer_0/att/q/w" not in text


def test_dropout_keeps_replicated_leaves_equal_on_the_model_ranks(ranks):
    """With dropout on, the ranks of a model group draw the same masks on
    the activations they both hold, so after two steps every leaf each
    holds whole is bit-equal on both, and the split leaves differ."""
    results, _, _ = ranks
    first, second = (r["dropout"] for r in results)
    assert first["losses"] == second["losses"]
    assert first["split"] == second["split"] and first["split"]
    for key, value in first["local"].items():
        if key in first["split"]:
            assert not torch.equal(value, second["local"][key]), key
        else:
            assert torch.equal(value, second["local"][key]), key


def test_tp_checkpoint_is_one_process_layout(ranks, tmp_path):
    """Rank 0 writes whole tensors under one process's keys and shapes;
    rank 1 writes nothing; a whole checkpoint restores into two model
    ranks, sliced, and decodes as one process restored from it."""
    _, saved, whole_ckpt = ranks
    trainer, runner, search = build("ck")
    one = manager_for([trainer, runner, search], model=1)
    reference = load_flat(one.save(str(tmp_path / "one" / "variables.data")))
    flat = load_flat(saved[0]["ckpt"])
    assert list(flat) == list(reference)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in reference.items()}
    for key, value in saved[0]["params"].items():
        np.testing.assert_array_equal(flat[key], value.numpy())
    assert not os.path.exists(os.path.dirname(saved[1]["ckpt"])) or \
        not os.listdir(os.path.dirname(saved[1]["ckpt"]))
    trainer, runner, search = build("ck")
    restored = manager_for([trainer, runner, search], model=1)
    restored.restore(whole_ckpt)
    want = [r.outputs for r in restored.run_on_batch([runner, search],
                                                     dataset(), 16)]
    for result in saved:
        assert result["restored_shape"] == ((16, 8), 1)
        _params_close(result["restored"], whole(restored))
        assert result["decodes"] == want


def test_small_ini_under_tp_matches_one_process(ranks, single):
    """small.ini's RNN (embeddings and output projection split) through
    the train CLI with ``tf_manager.num_model_shards=2``: rank 0's logged
    losses and validation are one process's, rank 1 writes its log
    only."""
    results, _, _ = ranks
    want = single["small_ini"]
    got = results[0]["small_ini"]
    assert got["code"] == 0 and results[1]["small_ini"]["code"] == 0
    train = [r for r in got["records"] if r["kind"] == "train"]
    ref = [r for r in want["records"] if r["kind"] == "train"]
    assert [r["step"] for r in train] == [r["step"] for r in ref]
    _close([r["loss"] for r in train], [r["loss"] for r in ref])
    val = [r for r in got["records"] if r["kind"] == "val"]
    ref_val = [r for r in want["records"] if r["kind"] == "val"]
    assert len(val) == len(ref_val) == 1
    for key, value in ref_val[0].items():
        if key not in ("time", "kind"):
            assert val[0][key] == pytest.approx(value, abs=ATOL), key
    assert results[1]["small_ini"]["written"] == ["experiment.log.p1"]


def test_sequence_parallel_matches_replicated(ranks, single):
    """The residual stream's time axis split over the two model ranks
    between the blocks (an all-gather before the column-parallel
    projections, a reduce-scatter after the row-parallel ones): one
    process's run and ids."""
    results, _, _ = ranks
    for result in results:
        _same_run(result["sequence"], single["sequence"])
        assert result["sequence"]["ring_calls"] == 0


def test_sequence_parallel_ragged_time_stays_whole(ranks, single):
    """Time axes the model axis does not divide: the stream stays whole
    on both ranks, the run is one process's."""
    results, _, _ = ranks
    for result in results:
        _same_run(result["sequence_ragged"], single["sequence_ragged"])


def test_decodes_over_split_vocabularies_match_one_process(ranks, single):
    """The tied Transformer's greedy and lineage-kernel beam ids (each
    rank's caches holding its 2 of 4 heads), the RNN's greedy and beam
    ids and its NM_FUSED_XENT=1 step's loss: one process's. Under the
    model axis K3 and the fused cross-entropy took their plain paths, as
    the JAX package's, and logged it once."""
    results, _, _ = ranks
    want = single["decodes"]
    assert want["heads"] == 4
    for result in results:
        got = result["decodes"]
        assert got["heads"] == 2
        assert got["lineage"] == want["lineage"]
        assert got["rnn"] == want["rnn"]
        assert abs(got["loss"] - want["loss"]) <= ATOL
        paths = dict(got["plain_paths"])
        assert paths.get("fused_logits_rowmax_lse") == "a model axis is on"
        assert "split over the model axis" in paths.get("fused_xent", "")


def test_physical_beam_over_split_heads_matches_one_process(ranks, single):
    """Under ``NM_LINEAGE=0`` the tied Transformer's beam ids (each rank's
    plain B·K-row caches and tiled cross-attention keys holding its 2 of
    4 heads) and the RNN's: one process's, which are its lineage
    searches'."""
    results, _, _ = ranks
    want = single["decodes"]
    assert want["physical"] == want["lineage"][1]
    assert want["rnn_physical"] == want["rnn"][1]
    for result in results:
        got = result["decodes"]
        assert got["physical"] == want["physical"]
        assert got["rnn_physical"] == want["rnn_physical"]
