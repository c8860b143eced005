"""Data parallelism, ZeRO-1 and FSDP in the PyTorch port
(``neuralmonkey_tpu_torch/parallel``), at two ranks over gloo on the CPU.

The counterparts of the JAX package's ``tests/test_distributed.py``,
``tests/test_data_parallel.py`` and ``tests/test_fsdp.py``: the ranks
are processes started with ``spawn`` from this module's
``rank_main``, which runs the scenarios named to it in one process group
(a ``file://`` store under the test's temporary directory) and saves
each scenario's result; the same scenario functions run in the test
process with no process group give the one-process reference. A rank
that raises, or a group that outlives ``RANK_TIMEOUT``, fails the test
and is killed. With dropout off, two ranks compute the one-process
function: losses and parameters to 1e-5.

The model is ``tests/test_fsdp.py``'s: a 2 + 2-layer Transformer, width
32, FFN 64, 4 heads, a 64-entry vocabulary, 16 sentences of 2-6 words.
"""

import json
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

from neuralmonkey_tpu_torch import train as torch_train
from neuralmonkey_tpu_torch.dataset import Dataset
from neuralmonkey_tpu_torch.models.decoders.beam_search_decoder import \
    BeamSearchDecoder
from neuralmonkey_tpu_torch.models.decoders.transformer import \
    TransformerDecoder
from neuralmonkey_tpu_torch.models.encoders.transformer import \
    TransformerEncoder
from neuralmonkey_tpu_torch.parallel import distributed, zero
from neuralmonkey_tpu_torch.parallel import fsdp as fsdp_units
from neuralmonkey_tpu_torch.runners.beam_search_runner import \
    BeamSearchRunner
from neuralmonkey_tpu_torch.runners.runner import GreedyRunner
from neuralmonkey_tpu_torch.runtime import CUDAManager
from neuralmonkey_tpu_torch.server import ModelService
from neuralmonkey_tpu_torch.trainers.cross_entropy_trainer import \
    CrossEntropyTrainer
from neuralmonkey_tpu_torch.trainers.delayed_update_trainer import \
    DelayedUpdateTrainer
from neuralmonkey_tpu_torch.trainers.optimizers import (AdafactorOptimizer,
                                                        AdamOptimizer)
from neuralmonkey_tpu_torch.utils.saving import flatten_tree, load_flat
from neuralmonkey_tpu_torch.vocabulary import END_TOKEN_INDEX, Vocabulary

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANK_TIMEOUT = 300.0
ATOL = 1e-5


# ---------------------------------------------------------------------- #
# starting ranks
# ---------------------------------------------------------------------- #
def rank_main(rank: int, world: int, directory: str, module: str,
              scenarios, args) -> None:
    """One rank: join the group over ``directory``'s file store, run
    each scenario function of ``module`` named in ``scenarios`` with
    ``args`` and save the results as ``rank<rank>.pkl``; on an error
    save its traceback and exit non-zero."""
    torch.set_num_threads(1)
    try:
        distributed.maybe_initialize(
            f"file://{os.path.join(directory, 'store')}", world, rank,
            backend="gloo")
        functions = __import__(module)
        results = {name: getattr(functions, name)(directory, *args)
                   for name in scenarios}
        with open(os.path.join(directory, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_ranks(directory: str, scenarios, args=(), module: str = __name__,
              world: int = WORLD, timeout: float = RANK_TIMEOUT):
    """Each rank's results of ``scenarios`` (see ``rank_main``), by
    rank. A rank that fails or a group past ``timeout`` seconds raises;
    every rank left is killed."""
    os.makedirs(directory, exist_ok=True)
    context = multiprocessing.get_context("spawn")
    procs = [context.Process(target=rank_main, args=(
        rank, world, directory, module, list(scenarios), tuple(args)))
        for rank in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=30)
    errors = []
    for rank, proc in enumerate(procs):
        err = os.path.join(directory, f"rank{rank}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {rank}:\n{f.read()}")
        elif proc.exitcode != 0:
            errors.append(f"rank {rank}: exit code {proc.exitcode} "
                          f"(killed after {timeout:.0f} s or by a peer's "
                          "failure)")
    if errors:
        raise AssertionError("\n".join(errors))
    results = []
    for rank in range(world):
        with open(os.path.join(directory, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------- #
# the model of tests/test_fsdp.py
# ---------------------------------------------------------------------- #
def _vocab(n=60):
    return Vocabulary([f"w{i}" for i in range(n)])


def _dataset(n=16):
    return Dataset("toy", {
        "source": [[f"w{i % 60}" for i in range(j % 5 + 2)]
                   for j in range(n)],
        "target": [[f"w{(i + 3) % 60}" for i in range(j % 4 + 2)]
                   for j in range(n)],
    })


def _build(optimizer=None, keep=1.0, delayed=False, width=32,
           clip_norm=1.0, l2=0.0, max_len=6):
    enc = TransformerEncoder(
        name="fs_src", vocabulary=_vocab(), data_id="source",
        embedding_size=width, ff_hidden_size=2 * width, depth=2, n_heads=4,
        dropout_keep_prob=keep)
    dec = TransformerDecoder(
        name="fs_tgt", vocabulary=_vocab(), data_id="target",
        encoders=[enc], embedding_size=width, ff_hidden_size=2 * width,
        depth=2,
        n_heads_self=4, n_heads_enc=4, max_output_len=max_len,
        tie_embeddings=False, dropout_keep_prob=keep)
    # Adam's epsilon raised from 1e-8: the attention's key biases have an
    # exact gradient of 0, and at 1e-8 Adam turns their rounding noise
    # (which depends on the order of any sum) into steps of the learning
    # rate, in one process as in two
    optimizer = optimizer or AdamOptimizer(learning_rate=1e-3,
                                           epsilon=1e-4)
    if delayed:
        trainer = DelayedUpdateTrainer(batches_per_update=2, decoders=[dec],
                                       clip_norm=clip_norm,
                                       optimizer=optimizer, l2_weight=l2)
    else:
        trainer = CrossEntropyTrainer(decoders=[dec], clip_norm=clip_norm,
                                      optimizer=optimizer, l2_weight=l2)
    return trainer, GreedyRunner(output_series="target", decoder=dec)


def _search(runner, beam=3, name="fs_bs", **kwargs):
    """A beam-search runner over ``runner``'s decoder (``kwargs`` the
    search's)."""
    return BeamSearchRunner(output_series="target_beam",
                            decoder=BeamSearchDecoder(
                                name=name, parent_decoder=runner.decoder,
                                beam_size=beam, **kwargs))


def physical_beam(manager, search, data, batch):
    """The beam search's result under ``NM_LINEAGE=0`` (the physical
    reorder)."""
    os.environ["NM_LINEAGE"] = "0"
    try:
        return manager.run_on_batch([search], data, batch)[0]
    finally:
        del os.environ["NM_LINEAGE"]


def _manager(trainer, runner, *more, **kwargs):
    manager = CUDAManager(device="cpu", random_seed=0, **kwargs)
    manager.initialize_model_parts([trainer, runner, *more], seed=0)
    return manager


def _whole(manager):
    return {k: v.detach().clone()
            for k, v in flatten_tree(manager.whole_params()).items()}


def _run(n_steps=3, batch_size=16, optimizer=None, delayed=False,
         width=32, clip_norm=1.0, l2=0.0, **kwargs):
    ds = _dataset(batch_size)
    trainer, runner = _build(optimizer, delayed=delayed, width=width,
                             clip_norm=clip_norm, l2=l2)
    manager = _manager(trainer, runner, **kwargs)
    steps = [manager.train_on_batch(trainer, ds, batch_size)
             for _ in range(n_steps)]
    outs = manager.run_on_batch([runner], ds, batch_size=16)[0].outputs
    # the norm shows the gradients' scale (summed, not averaged, over a
    # split batch), which Adam's and Adafactor's steps do not
    return manager, {"losses": [s["loss"] for s in steps],
                     "norms": [s["grad_norm"] for s in steps],
                     "outputs": outs, "params": _whole(manager)}


def _opt_shapes(manager):
    """Each optimizer-state entry's shape on this rank, and whole."""
    label = next(iter(manager._opt_states))
    update = manager._updates[label]
    whole = update.init(manager._meta)
    return ({k: tuple(v.shape) for k, v in
             manager._opt_states[label].items()},
            {k: tuple(v.shape) for k, v in whole.items()})


# ---------------------------------------------------------------------- #
# scenarios: each runs on every rank, or alone as the reference
# ---------------------------------------------------------------------- #
def helpers(directory):
    del directory
    rank = distributed.process_index()
    flags = distributed.broadcast_flags((rank == 0, rank == 1, True))
    distributed.sync_processes("test")
    rows = distributed.local_rows(np.arange(8 * 3).reshape(8, 3))
    length = 5 + 2 * rank
    tree = {"ids": torch.full((4, length), rank + 1, dtype=torch.int32),
            "finished": torch.ones(4, dtype=torch.bool),
            "loss": torch.tensor(0.5)}
    try:
        ModelService(None)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return {"rank": rank, "count": distributed.process_count(),
            "server": refused,
            "main": distributed.is_main_process(), "flags": flags,
            "rows": rows, "split16": distributed.split_rows(16),
            "split15": distributed.split_rows(15),
            "fetched": distributed.fetch_to_host(tree),
            "by_axis_1": distributed.fetch_to_host(
                {"x": torch.full((3, 2), float(rank))}, {"x": 1})["x"]}


def build_batch(directory):
    del directory
    trainer, runner = _build()
    manager = _manager(trainer, runner)
    ds = _dataset()
    even, real_even = manager.build_batch(ds, 16)
    odd, real_odd = manager.build_batch(ds.subset(0, 15), 15)
    return {"even": (even.split, real_even,
                     tuple(even["fs_src_input.ids"].shape),
                     even["fs_src_input.ids"].numpy()),
            "odd": (odd.split, real_odd, tuple(odd["fs_src_input.ids"].shape))}


def replicated(directory):
    del directory
    return _run()[1]


def zero1(directory):
    del directory
    manager, result = _run(shard_optimizer_state=True)
    result["opt"] = _opt_shapes(manager)
    result["emb"] = tuple(manager.params["fs_src_input"]["embeddings"].shape)
    return result


def fsdp(directory):
    manager, result = _run(fsdp=True)
    rest = manager.params
    result["emb"] = tuple(rest["fs_src_input"]["embeddings"].shape)
    result["ff"] = tuple(rest["fs_src"]["layer_0"]["ff"]["in"]["w"].shape)
    result["opt"] = _opt_shapes(manager)
    # the whole parameters on the host, gathered a few tensors at a time
    result["host"] = zero.gather_to_host(
        flatten_tree(rest), manager._rest_plan, manager._meta,
        manager.device, limit=4096)
    # checkpoints written by rank 0 only: each rank saves into its own
    # directory
    out = os.path.join(directory, f"fsdp{distributed.process_index()}")
    result["ckpt"] = manager.save(os.path.join(out, "variables.data"))
    result["written"] = sorted(os.listdir(out)) if os.path.isdir(out) \
        else []
    return result


def fsdp_restore(directory, ckpt):
    """An FSDP manager restored from ``ckpt`` (rank 0's file): its
    parameters at rest and its decode."""
    del directory
    trainer, runner = _build()
    manager = _manager(trainer, runner, fsdp=True)
    manager.restore(ckpt)
    outs = manager.run_on_batch([runner], _dataset(), 16)[0].outputs
    return {"emb": tuple(manager.params["fs_src_input"]["embeddings"].shape),
            "outputs": outs, "params": _whole(manager)}


def continued(directory):
    """Two steps under ZeRO-1, a checkpoint with its ``.opt``, and a
    third step from a manager restored from them."""
    ds = _dataset()
    trainer, runner = _build()
    manager = _manager(trainer, runner, shard_optimizer_state=True)
    for _ in range(2):
        manager.train_on_batch(trainer, ds, 16)
    path = os.path.join(directory, "continued", "variables.data")
    ckpt = manager.save(path)
    distributed.sync_processes()
    trainer, runner = _build()
    fresh = _manager(trainer, runner, shard_optimizer_state=True)
    fresh.restore(ckpt)
    fresh.load_optimizer_state(path)
    loss = fresh.train_on_batch(trainer, ds, 16)["loss"]
    return {"loss": loss, "opt_keys": sorted(load_flat(path + ".opt")),
            "opt_shapes": {k: v.shape
                           for k, v in load_flat(path + ".opt").items()},
            "ckpt_shapes": {k: v.shape for k, v in load_flat(ckpt).items()}}


def delayed(directory):
    del directory
    manager, result = _run(n_steps=4, delayed=True,
                           shard_optimizer_state=True)
    result["opt"] = _opt_shapes(manager)
    return result


def delayed_plain(directory):
    del directory
    return _run(n_steps=4, delayed=True)[1]


# width 128: the FFN's (128, 256) matrices have factored moments. No
# clipping: the layouts then compute bit-equal updates (the clip's norm
# sums in another order under ZeRO, and Adafactor's normalised steps of
# the key biases, whose exact gradient is 0, follow their rounding noise)
def adafactor(directory):
    del directory
    manager, result = _run(optimizer=AdafactorOptimizer(learning_rate=1e-2),
                           width=128, clip_norm=None,
                           shard_optimizer_state=True)
    result["opt"] = _opt_shapes(manager)
    return result


def adafactor_plain(directory):
    del directory
    return _run(optimizer=AdafactorOptimizer(learning_rate=1e-2),
                width=128, clip_norm=None)[1]


adafactor_replicated = adafactor_plain


def adafactor_fsdp(directory):
    """``adafactor`` under fsdp, recording each gather its training steps
    make (the units' and the updates': the whole bytes each fills of
    the divided tensors) beside the bytes of the whole tree, of each
    rank's owned parameters and of the largest unit."""
    del directory
    gathered, real = [], zero.gather_into
    step = CUDAManager.train_on_prepared

    def counted(targets, plan, local):
        gathered.append(sum(4 * t.numel() for n, t in targets.items()
                            if not plan[n].replicated))
        return real(targets, plan, local)

    def counting(self, *args):
        zero.gather_into = counted
        try:
            return step(self, *args)
        finally:
            zero.gather_into = real
    CUDAManager.train_on_prepared = counting
    try:
        manager, result = _run(
            optimizer=AdafactorOptimizer(learning_rate=1e-2), width=128,
            clip_norm=None, shard_optimizer_state=True, fsdp=True)
    finally:
        CUDAManager.train_on_prepared = step
    result["opt"] = _opt_shapes(manager)
    plan = next(iter(manager._update_plans.values()))
    meta = manager._local_meta
    result["gathered"] = gathered
    result["tree_bytes"] = sum(4 * m.numel() for m in meta.values())
    result["owned_bytes"] = [sum(4 * meta[n].numel() for n, s in
                                 plan.items() if s.owner == r)
                             for r in range(WORLD)]
    result["unit_bytes"] = max(
        sum(4 * meta[n].numel() for n in names)
        for names in fsdp_units.unit_names(manager.params).values())
    result["owners"] = {n: s.owner for n, s in plan.items()}
    return result


def fsdp_at_use(directory):
    """One FSDP step, then a greedy, a beam-3 and a hierarchical beam-3
    decode with its logits aligned (``align_logits``, which replaces the
    output projection in the decoder's parameters) of the split batch,
    the gathers' record reset before each: the collectives this rank
    posted, the most bytes the gathers' tensors held alive at once, what
    they held before and after (freed by reference counts alone, no
    cycle collection), and how many of the passes' ``AtUse`` objects
    outlived them; and the units with their leaves and whole bytes."""
    del directory
    import weakref
    ds = _dataset()
    trainer, runner = _build()
    search = _search(runner)
    aligned = _search(runner, name="fs_bs_aligned",
                      selection_method="hierarchical", align_logits=True)
    manager = _manager(trainer, runner, search, aligned, fsdp=True)
    manager.fsdp_stats.record = True
    made, at_use = [], manager._at_use

    def recording(params, **kwargs):
        made_now = at_use(params, **kwargs)
        made.append(weakref.ref(made_now))
        return made_now
    manager._at_use = recording
    phases = {}
    for phase, call in (
            ("step", lambda: manager.train_on_batch(trainer, ds, 16)),
            ("greedy", lambda: manager.run_on_batch([runner], ds, 16)),
            ("beam", lambda: manager.run_on_batch([search], ds, 16)),
            ("beam_aligned",
             lambda: manager.run_on_batch([aligned], ds, 16))):
        stats = manager.fsdp_stats
        stats.reset()
        before = stats.alive
        call()
        phases[phase] = {"events": list(stats.events),
                         "peak": stats.peak - before, "before": before,
                         "after": stats.alive,
                         "passes_alive": sum(r() is not None for r in made)}
    units = fsdp_units.unit_names(manager.params)
    meta = manager._local_meta
    return {"phases": phases, "units": units,
            "unit_bytes": {u: sum(4 * meta[n].numel() for n in names)
                           for u, names in units.items()},
            "leaves": sorted(meta)}


def fsdp_early_end(directory):
    """Greedy and beam-3 decodes under fsdp of a split batch whose rows
    all end at the first step on rank 0 (END's logit raised there) and
    never on rank 1 (lowered), by a decoder of 12 steps, past the loops'
    first look at the finished rows: each decode's collectives on this
    rank, and the sentences of both ranks."""
    del directory
    ds = _dataset()
    trainer, runner = _build(max_len=12)
    search = _search(runner)
    manager = _manager(trainer, runner, search, fsdp=True)
    decoder = runner.decoder
    finish = decoder._finish
    shift = 1e4 if distributed.data_index() == 0 else -1e4

    def ending(constants, x, att_map):
        logits, aux = finish(constants, x, att_map)
        logits = logits.clone()
        logits[..., END_TOKEN_INDEX] += shift
        return logits, aux
    decoder._finish = ending
    stats = manager.fsdp_stats
    stats.record = True
    result = {}
    for name, run in (("greedy", runner), ("beam", search)):
        stats.reset()
        result[name] = manager.run_on_batch([run], ds, 16)[0].outputs
        result[f"{name}_events"] = list(stats.events)
    return result


def fsdp_l2(directory):
    del directory
    return _run(l2=0.01, fsdp=True)[1]


def l2_plain(directory):
    del directory
    return _run(l2=0.01)[1]


def fsdp_delayed(directory):
    del directory
    manager, result = _run(n_steps=4, delayed=True, fsdp=True)
    result["opt"] = _opt_shapes(manager)
    return result


def whole_batch(directory):
    """A batch of 15 rows, which two ranks do not divide: every rank
    holds it whole and the gradients are averaged."""
    del directory
    return _run(batch_size=15)[1]


def dropout_masks(directory):
    """One step with dropout on a batch every rank holds whole: each
    rank's own masks give it its own loss; the averaged update keeps
    the parameters equal on the ranks."""
    del directory
    ds = _dataset(15)
    trainer, runner = _build(keep=0.5)
    manager = _manager(trainer, runner)
    loss = manager.train_on_batch(trainer, ds, 15)["loss"]
    return {"loss": loss, "params": _whole(manager)}


def beam(directory):
    """Greedy and beam-3 decodes of a split batch after one step,
    replicated and under fsdp; then, the fsdp model's parameters scaled
    by 3 (which makes its hypotheses part ways), its beam search by
    lineage and by the physical reorder (each decoder layer gathered at
    each step over B·K rows, the states gathered by their parents):
    every runner's outputs and losses."""
    del directory
    ds = _dataset()
    decodes = {}
    for mode, kwargs in (("replicated", {}), ("fsdp", {"fsdp": True})):
        trainer, runner = _build()
        search = _search(runner)
        manager = _manager(trainer, runner, search, **kwargs)
        manager.train_on_batch(trainer, ds, 16)
        decodes[mode] = [(r.outputs, r.losses) for r in
                         manager.run_on_batch([runner, search], ds, 16)]
    with torch.no_grad():
        for leaf in flatten_tree(manager.params).values():
            leaf.mul_(3.0)
    for form, result in (
            ("lineage", manager.run_on_batch([search], ds, 16)[0]),
            ("physical", physical_beam(manager, search, ds, 16))):
        decodes[f"fsdp_scaled_{form}"] = [(result.outputs, result.losses)]
    return decodes


def ensemble(directory):
    """Two parameter sets (the second one step on) as a greedy and a
    beam-3 ensemble over a split batch."""
    del directory
    ds = _dataset()
    trainer, runner = _build()
    search = _search(runner)
    manager = _manager(trainer, runner, search, fsdp=True)
    first = manager.params
    manager.train_on_batch(trainer, ds, 16)
    manager.params_list = [first, manager.params]
    return {"outputs": [(r.outputs, r.losses) for r in
                        manager.run_on_batch([runner, search], ds, 16)]}


def train_cli(directory, extra=(), name="train", config="small.ini"):
    """small.ini (or another INI of tests/configs) through the train CLI
    with ``extra`` overrides, each rank into its own output directory,
    logging every step."""
    rank = distributed.process_index()
    out = os.path.join(directory, f"{name}{rank}")
    cwd = os.getcwd()
    os.chdir(REPO)  # small.ini's data paths
    try:
        code = torch_train.main([
            os.path.join(REPO, "tests", "configs", config),
            'tf_manager.device="cpu"', f'main.output="{out}"',
            "main.epochs=1", "main.logging_period=1",
            "main.validation_period=1000", "encoder.dropout_keep_prob=1.0",
            "decoder.dropout_keep_prob=1.0", *extra])
    finally:
        os.chdir(cwd)
    records = []
    if os.path.exists(os.path.join(out, "metrics.jsonl")):
        with open(os.path.join(out, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    return {"code": code, "written": sorted(os.listdir(out)),
            "records": records}


# ---------------------------------------------------------------------- #
# global-batch losses, held against the JAX package by
# tests/test_torch_parallel_jax.py, which builds each case in both
# packages with ``build_case`` and runs ``global_loss`` on two ranks
# ---------------------------------------------------------------------- #
CASES = ("xent", "l2", "labeler", "ctc", "self_critical", "moe")
CASE_WORDS = 30


def case_series(kind):
    """Four sentences: the first two long, the last two short, so that
    the halves the two ranks hold have different token counts. The
    ``transformer`` case's (``test_torch_model_axes_transformer_jax.py``)
    longest source and target (with its start) are 8, so that two model
    or context ranks divide their time axes."""
    lengths = (8, 6, 2, 1) if kind in ("transformer", "pipeline") \
        else (7, 6, 2, 1)
    rng = np.random.RandomState(3)
    source = [[f"w{i}" for i in rng.randint(0, CASE_WORDS, n)]
              for n in lengths]
    series = {"source": source}
    if kind == "labeler":
        series["tags"] = [[f"w{(int(w[1:]) * 7) % CASE_WORDS}" for w in s]
                          for s in source]
    elif kind == "ctc":
        series["target"] = [s[:max(1, len(s) // 2)] for s in source]
    else:
        series["target"] = [[f"w{i}" for i in rng.randint(
            0, CASE_WORDS, max(1, n - 1))] for n in lengths]
    return series


def build_case(kind, package):
    """The trainer of one global-loss case, built from ``package``
    (``neuralmonkey_tpu`` or ``neuralmonkey_tpu_torch``, whose classes
    take the same arguments), with plain SGD at 0.1."""
    import importlib

    def cls(module, name):
        return getattr(importlib.import_module(f"{package}.{module}"),
                       name)

    vocab = cls("vocabulary", "Vocabulary")(
        [f"w{i}" for i in range(CASE_WORDS)])
    sgd = cls("trainers.optimizers", "GradientDescentOptimizer")(0.1)
    if kind == "adafactor":
        # the cross-entropy case's model under Adafactor, whose update
        # reduces over whole parameters
        sgd = cls("trainers.optimizers", "AdafactorOptimizer")(0.01)
    xent_trainer = cls("trainers.cross_entropy_trainer",
                       "CrossEntropyTrainer")
    if kind == "moe":
        moe = dict(moe_experts=4, moe_top_k=2, moe_aux_weight=0.1,
                   moe_z_loss_weight=0.01, dropout_keep_prob=1.0)
        enc = cls("models.encoders.transformer", "TransformerEncoder")(
            name="encoder", vocabulary=vocab, data_id="source",
            embedding_size=16, ff_hidden_size=24, depth=1, n_heads=2,
            max_input_len=8, **moe)
        dec = cls("models.decoders.transformer", "TransformerDecoder")(
            name="decoder", vocabulary=vocab, data_id="target",
            max_output_len=7, encoders=[enc], embedding_size=16,
            ff_hidden_size=24, depth=1, n_heads_self=2, n_heads_enc=2,
            **moe)
        return xent_trainer(decoders=[dec], optimizer=sgd)
    if kind in ("transformer", "pipeline"):
        # "pipeline": the stacked layers of two pipeline stages
        stages = 2 if kind == "pipeline" else 0
        enc = cls("models.encoders.transformer", "TransformerEncoder")(
            name="encoder", vocabulary=vocab, data_id="source",
            embedding_size=16, ff_hidden_size=32, depth=2, n_heads=4,
            max_input_len=8, dropout_keep_prob=1.0,
            pipeline_stages=stages)
        dec = cls("models.decoders.transformer", "TransformerDecoder")(
            name="decoder", vocabulary=vocab, data_id="target",
            max_output_len=8, encoders=[enc], embedding_size=16,
            ff_hidden_size=32, depth=2, n_heads_self=4, n_heads_enc=4,
            tie_embeddings=False, label_smoothing=0.1,
            dropout_keep_prob=1.0, pipeline_stages=stages)
        return xent_trainer(decoders=[dec], optimizer=sgd)
    enc = cls("models.encoders.recurrent", "SentenceEncoder")(
        name="encoder", vocabulary=vocab, data_id="source",
        embedding_size=8, rnn_size=8, max_input_len=8)
    if kind == "labeler":
        dec = cls("models.decoders.sequence_labeler", "SequenceLabeler")(
            name="labeler", encoder=enc, vocabulary=vocab, data_id="tags")
        return xent_trainer(decoders=[dec], optimizer=sgd)
    if kind == "ctc":
        dec = cls("models.decoders.ctc_decoder", "CTCDecoder")(
            name="ctc", encoder=enc, vocabulary=vocab, data_id="target",
            max_length=8)
        return xent_trainer(decoders=[dec], optimizer=sgd)
    att = cls("models.attention.feed_forward", "Attention")(
        name="attention", encoder=enc, state_size=8)
    dec = cls("models.decoders.decoder", "Decoder")(
        name="decoder", vocabulary=vocab, data_id="target",
        max_output_len=7, rnn_size=8, encoders=[enc], attentions=[att],
        embedding_size=8, conditional_gru=True)
    if kind == "self_critical":
        objective = cls("trainers.self_critical_objective",
                        "self_critical_objective")(dec)
        return cls("trainers.generic_trainer", "GenericTrainer")(
            objectives=[objective], optimizer=sgd)
    return xent_trainer(decoders=[dec], optimizer=sgd,
                        l2_weight=0.01 if kind == "l2" else 0.0)


def global_loss(directory, kind, flat, batch, sampled=None, **kwargs):
    """One step of ``build_case(kind)`` from the parameters ``flat`` on
    this rank's rows of the numpy ``batch`` (a split batch); with
    ``sampled``, the sampler draws those ids. Returns the losses and
    the parameters after the step."""
    del directory
    from neuralmonkey_tpu_torch.runtime import LocalBatch
    from neuralmonkey_tpu_torch.utils.saving import params_from_jax

    trainer = build_case(kind, "neuralmonkey_tpu_torch")
    manager = CUDAManager(device="cpu", random_seed=0, **kwargs)
    manager.initialize_model_parts([trainer], seed=0)
    manager.params_list = [manager._to_rest(
        params_from_jax(flat, manager._template()))]
    if sampled is not None:
        decoder = trainer.objectives[0].decoder
        columns = iter(torch.from_numpy(
            distributed.local_rows(sampled)).unbind(1))
        decoder.draw_samples = lambda log_probs, generator: next(columns)
    local = LocalBatch({k: torch.from_numpy(distributed.local_rows(v))
                        for k, v in batch.items()}, split=True)
    losses = manager.train_on_prepared(trainer, local)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "params": {k: v.numpy() for k, v in _whole(manager).items()}}


def global_losses(directory, cases):
    """``global_loss`` of each (name, kind, flat, batch, sampled,
    manager keywords) of ``cases``."""
    return {name: global_loss(directory, kind, flat, batch, sampled,
                              **kwargs)
            for name, kind, flat, batch, sampled, kwargs in cases}


# ---------------------------------------------------------------------- #
# the two-rank run and its one-process references
# ---------------------------------------------------------------------- #
SCENARIOS = ("helpers", "build_batch", "replicated", "zero1", "fsdp",
             "continued", "delayed", "adafactor", "adafactor_fsdp",
             "adafactor_replicated", "fsdp_at_use", "fsdp_early_end",
             "fsdp_l2", "fsdp_delayed",
             "whole_batch", "dropout_masks", "beam", "ensemble",
             "train_cli")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("ranks"))
    results = run_ranks(directory, SCENARIOS)
    ckpt = results[0]["fsdp"]["ckpt"]
    restored = run_ranks(os.path.join(directory, "restore"),
                         ["fsdp_restore"], (ckpt,))
    return results, [r["fsdp_restore"] for r in restored]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The same scenarios in this process, with no process group."""
    directory = str(tmp_path_factory.mktemp("single"))
    assert not distributed.is_initialized()
    return {name: globals()[name](directory) for name in (
        "replicated", "continued", "delayed_plain", "adafactor_plain",
        "l2_plain", "whole_batch", "beam", "ensemble", "train_cli")}


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=0)


def _params_close(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        _close(got[key].numpy(), value.numpy(), ATOL)


def test_maybe_initialize_noop_without_env(monkeypatch):
    monkeypatch.delenv("NM_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("NM_DISTRIBUTED", raising=False)
    assert distributed.maybe_initialize() is False
    assert not distributed.is_initialized()


def test_single_process_helpers():
    assert distributed.process_count() == 1
    assert distributed.is_main_process()
    distributed.sync_processes("test")  # no-op, must not hang
    assert distributed.broadcast_flags([1, 0]) == (True, False)
    assert not distributed.split_rows(16)
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    with distributed.sharded_batch(True):
        assert distributed.global_sum(x) is x
        assert distributed.param_term(x) is x


def test_broadcast_flags_take_rank_0s_decision(ranks):
    results, _ = ranks
    for rank, result in enumerate(results):
        assert result["helpers"]["rank"] == rank
        assert result["helpers"]["count"] == WORLD
        assert result["helpers"]["main"] == (rank == 0)
        assert result["helpers"]["flags"] == (True, False, True)


def test_server_refuses_a_process_group(ranks):
    results, _ = ranks
    for result in results:
        assert "one process" in result["helpers"]["server"]


def test_rows_split_and_fetch_to_host_round_trip(ranks):
    """Each rank takes its contiguous rows; ``fetch_to_host`` gives every
    rank all rows in rank order, the shorter rank's padded with zeros,
    and a scalar as it is."""
    results, _ = ranks
    everything = np.arange(8 * 3).reshape(8, 3)
    for rank, result in enumerate(results):
        helpers_ = result["helpers"]
        np.testing.assert_array_equal(helpers_["rows"],
                                      everything[4 * rank:4 * rank + 4])
        assert helpers_["split16"] and not helpers_["split15"]
        fetched = helpers_["fetched"]
        want = np.zeros((8, 7), np.int32)
        want[:4, :5] = 1
        want[4:, :7] = 2
        np.testing.assert_array_equal(fetched["ids"], want)
        assert fetched["finished"].dtype == np.bool_
        assert fetched["finished"].shape == (8,) and fetched["finished"].all()
        assert float(fetched["loss"]) == 0.5
        # a runner's batch axis other than 0 (TensorRunner's batch_dims)
        np.testing.assert_array_equal(helpers_["by_axis_1"],
                                      [[0.0, 0.0, 1.0, 1.0]] * 3)


def test_build_batch_shards_when_the_batch_divides(ranks):
    results, _ = ranks
    trainer, runner = _build()
    whole, _ = _manager(trainer, runner).build_batch(_dataset(), 16)
    ids = whole["fs_src_input.ids"].numpy()
    for rank, result in enumerate(results):
        split, real, shape, rows = result["build_batch"]["even"]
        assert split and real == 16 and shape == (8, ids.shape[1])
        np.testing.assert_array_equal(rows, ids[8 * rank:8 * rank + 8])
        assert result["build_batch"]["odd"][:2] == (False, 15)
        assert result["build_batch"]["odd"][2][0] == 15


def test_dp_step_and_decode_match_one_process(ranks, single):
    results, _ = ranks
    want = single["replicated"]
    for result in results:
        got = result["replicated"]
        _close(got["losses"], want["losses"])
        _close(got["norms"], want["norms"])
        _params_close(got["params"], want["params"])
        assert got["outputs"] == want["outputs"]
    # bit-equal on the ranks: one bucket, one order
    for key, value in results[0]["replicated"]["params"].items():
        assert torch.equal(value, results[1]["replicated"]["params"][key])


def test_zero1_matches_replicated_and_shards_moments(ranks, single):
    """ZeRO-1: the one-process losses, parameters and decode; at least
    10 matrix-shaped moments halved on each rank, the parameters
    whole."""
    results, _ = ranks
    want = single["replicated"]
    for result in results:
        got = result["zero1"]
        _close(got["losses"], want["losses"])
        _close(got["norms"], want["norms"])
        _params_close(got["params"], want["params"])
        assert got["outputs"] == want["outputs"]
        local, whole = got["opt"]
        assert set(local) == set(whole)
        halved = [k for k in local if local[k] != whole[k]]
        assert len(halved) >= 10
        for key in halved:
            assert 2 * int(np.prod(local[key])) == int(np.prod(whole[key]))
        assert got["emb"] == (64, 32)


def test_fsdp_matches_replicated_and_shards_params(ranks, single):
    results, _ = ranks
    want = single["replicated"]
    for result in results:
        got = result["fsdp"]
        _close(got["losses"], want["losses"])
        _close(got["norms"], want["norms"])
        _params_close(got["params"], want["params"])
        assert got["outputs"] == want["outputs"]
        assert got["emb"] == (32, 32)
        assert got["ff"] == (32, 32)
        local, whole = got["opt"]
        assert any(local[k] != whole[k] for k in local)


def test_gather_to_host_in_groups_gives_the_whole_parameters(ranks):
    """Gathered to the host in groups of at most 4 KiB of whole tensors,
    every parameter equals its whole value on the device, on each
    rank."""
    results, _ = ranks
    for result in results:
        got = result["fsdp"]["host"]
        assert set(got) == set(result["fsdp"]["params"])
        for name, value in result["fsdp"]["params"].items():
            assert got[name].device.type == "cpu"
            assert torch.equal(got[name], value)


def test_only_rank_0_writes_checkpoints(ranks):
    results, _ = ranks
    written = results[0]["fsdp"]["written"]
    assert any(name.startswith("variables.data-") for name in written)
    assert "variables.data.opt" in written
    assert results[1]["fsdp"]["written"] == []
    assert {"metrics.jsonl", "variables.data.best", "variables.data.opt",
            "experiment.ini", "experiment.log"} <= set(
                results[0]["train_cli"]["written"])
    # rank 1 logs to a file of its own, and writes nothing else
    assert results[1]["train_cli"]["written"] == ["experiment.log.p1"]


def test_fsdp_checkpoint_round_trip_into_world_1_and_2(ranks, single,
                                                       tmp_path):
    """The FSDP checkpoint has the one-process file's keys and whole
    shapes; restored into two FSDP ranks (sliced at rest) and into one
    process it decodes as before and holds the trained parameters."""
    results, restored = ranks
    trainer, runner = _build()
    manager = _manager(trainer, runner)
    path = manager.save(str(tmp_path / "one" / "variables.data"))
    one = load_flat(path)
    ckpt = results[0]["fsdp"]["ckpt"]
    flat = load_flat(ckpt)
    assert list(flat) == list(one)
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in one.items()}
    want = results[0]["fsdp"]
    for result in restored:
        assert result["emb"] == (32, 32)
        assert result["outputs"] == want["outputs"]
        _params_close(result["params"], want["params"])
    world_one = fsdp_restore(str(tmp_path), ckpt)
    assert world_one["emb"] == (64, 32)
    assert world_one["outputs"] == want["outputs"]
    _params_close(world_one["params"], want["params"])


def test_restore_and_continue_matches_one_process(ranks, single):
    """Two ZeRO-1 steps, save (the ``.opt`` whole, in the one-process
    keys), restore with the optimizer state, one more step: the loss of
    the one-process run of the same."""
    results, _ = ranks
    want = single["continued"]
    for result in results:
        got = result["continued"]
        assert got["loss"] == pytest.approx(want["loss"], abs=ATOL)
        assert got["opt_keys"] == want["opt_keys"]
        assert got["opt_shapes"] == want["opt_shapes"]
        assert got["ckpt_shapes"] == want["ckpt_shapes"]


def test_zero1_composes_with_delayed_update(ranks, single):
    """``DelayedUpdate``'s accumulators divide as their parameters."""
    results, _ = ranks
    want = single["delayed_plain"]
    for result in results:
        got = result["delayed"]
        _close(got["losses"], want["losses"])
        _close(got["norms"], want["norms"])
        _params_close(got["params"], want["params"])
        local, whole = got["opt"]
        acc = [k for k in local if k.startswith("acc/")]
        assert acc and any(local[k] != whole[k] for k in acc)


@pytest.mark.parametrize("mode", ["adafactor", "adafactor_fsdp"])
def test_adafactor_under_zero_matches_replicated(ranks, single, mode):
    """Adafactor's update reduces over whole parameters, so under ZeRO
    each parameter and its state stay whole on one owner rank: the
    ranks' state keys part the one-process keys between them, and the
    parameters are those of two replicated ranks (the same reduced
    gradients; against one process the attention's key biases, whose
    exact gradient is 0, take Adafactor's normalised steps of rounding
    noise in another summation order). The losses are one process's."""
    results, _ = ranks
    keys = []
    for result in results:
        got = result[mode]
        _close(got["losses"], single["adafactor_plain"]["losses"])
        _params_close(got["params"],
                      result["adafactor_replicated"]["params"])
        local, whole = got["opt"]
        assert all(local[k] == whole[k] for k in local)
        keys.append(set(local))
    assert keys[0] & keys[1] == {"0/count"}
    assert keys[0] | keys[1] == set(results[0][mode]["opt"][1])
    whole = results[0][mode]["opt"][1]
    assert any(k.startswith("0/v_row/") and whole[k] != (1,)
               for k in keys[0] | keys[1])


def test_adafactor_under_fsdp_updates_on_the_owners(ranks):
    """Under fsdp Adafactor's update gathers each parameter whole to its
    owner alone, one owner's group at a time: no gather of the steps
    (the units' and the update's) fills more than the larger of the
    largest unit and the largest rank's owned share, which is less than
    the whole tree, and the owners part the parameters between the
    ranks."""
    results, _ = ranks
    for result in results:
        got = result["adafactor_fsdp"]
        bound = max(got["unit_bytes"], max(got["owned_bytes"]))
        assert bound < got["tree_bytes"]
        assert got["gathered"] and max(got["gathered"]) <= bound
        assert sorted(set(got["owners"].values())) == list(range(WORLD))


def test_fsdp_gathers_each_unit_at_use(ranks):
    """The units are each part's ``layer_<i>`` sub-trees and its other
    leaves, together every leaf once. In the step's forward each unit is
    gathered once; the backward reduces each once, in the reverse order
    of those gathers, and gathers a unit again at most once; the greedy
    and beam decodes (the aligned hierarchical one too) gather units
    only."""
    results, _ = ranks
    got = results[0]["fsdp_at_use"]
    units = got["units"]
    parts = ("fs_src", "fs_src_input", "fs_tgt", "fs_tgt_embeddings")
    assert set(units) == set(parts) | {
        f"{part}/layer_{i}" for part in ("fs_src", "fs_tgt")
        for i in range(2)}
    leaves = [leaf for names in units.values() for leaf in names]
    assert sorted(leaves) == got["leaves"]
    for unit, names in units.items():
        if "/layer_" in unit:
            assert all(n.startswith(unit + "/") for n in names)
        else:
            assert all("/layer_" not in n for n in names)
    events = got["phases"]["step"]["events"]
    gathers = [u for kind, u in events if kind == "gather"]
    reduces = [u for kind, u in events if kind == "reduce"]
    regathers = [u for kind, u in events if kind == "regather"]
    assert sorted(gathers) == sorted(units)
    assert reduces == gathers[::-1]
    assert len(set(regathers)) == len(regathers)
    assert set(regathers) <= set(units)
    # every gather of the forward comes before the first reduction
    assert events.index(("reduce", reduces[0])) > max(
        events.index(("gather", u)) for u in gathers)
    for phase in ("greedy", "beam", "beam_aligned"):
        kinds = {kind for kind, _ in got["phases"][phase]["events"]}
        assert kinds == {"gather"}, phase


@pytest.mark.parametrize("phase", ["step", "greedy", "beam",
                                   "beam_aligned"])
def test_fsdp_gathered_bytes_stay_within_two_units(ranks, phase):
    """The gathered tensors alive at once never exceed the two largest
    units' whole bytes together (a part's other unit, a decoder's
    table, may stay while a layer's is gathered; the whole tree, as a
    gather of it at the step's start held, is far more), and none stays
    alive after the step or the decode, nor the pass that gathered them
    (no reference cycle holds it)."""
    results, _ = ranks
    for result in results:
        got = result["fsdp_at_use"]
        sizes = sorted(got["unit_bytes"].values())
        record = got["phases"][phase]
        assert record["before"] == 0 and record["after"] == 0
        assert record["passes_alive"] == 0
        assert 0 < record["peak"] <= sizes[-1] + sizes[-2]
        assert sizes[-1] + sizes[-2] < sum(sizes)


def test_fsdp_ranks_post_the_same_collectives_in_order(ranks):
    results, _ = ranks
    for phase in ("step", "greedy", "beam", "beam_aligned"):
        first, second = (r["fsdp_at_use"]["phases"][phase]["events"]
                         for r in results)
        assert first and first == second, phase


def test_fsdp_decodes_end_on_every_rank_together(ranks):
    """Where one rank's rows all end at the first step and the other's
    never, both ranks run every step of the greedy and beam decodes
    (each step gathers the decoder's layers over the data group), post
    the same collectives, and collect both ranks' sentences: rank 0's
    rows empty, rank 1's of all 12 steps."""
    results, _ = ranks
    got = [r["fsdp_early_end"] for r in results]
    for name in ("greedy", "beam"):
        events = got[0][f"{name}_events"]
        assert events and events == got[1][f"{name}_events"], name
        # once a step, and for the decode's reads outside the loop
        layer_gathers = [u for kind, u in events
                         if kind == "gather" and u == "fs_tgt/layer_0"]
        assert len(layer_gathers) >= 12, name
        for result in got:
            sentences = result[name]
            assert len(sentences) == 16
            assert all(s == [] for s in sentences[:8]), name
            assert all(len(s) == 12 for s in sentences[8:]), name


def test_fsdp_l2_term_matches_replicated(ranks, single):
    """The l2 term on each rank's parts, its sum over the ranks, its
    gradient each rank's own: one process's losses and parameters."""
    results, _ = ranks
    want = single["l2_plain"]
    assert want["losses"] != pytest.approx(single["replicated"]["losses"],
                                           abs=1e-4)
    for result in results:
        got = result["fsdp_l2"]
        _close(got["losses"], want["losses"])
        _close(got["norms"], want["norms"])
        _params_close(got["params"], want["params"])
        assert got["outputs"] == want["outputs"]


def test_fsdp_composes_with_delayed_update(ranks, single):
    results, _ = ranks
    want = single["delayed_plain"]
    for result in results:
        got = result["fsdp_delayed"]
        _close(got["losses"], want["losses"])
        _close(got["norms"], want["norms"])
        _params_close(got["params"], want["params"])
        local, whole = got["opt"]
        acc = [k for k in local if k.startswith("acc/")]
        assert acc and any(local[k] != whole[k] for k in acc)


def test_batch_the_ranks_do_not_divide_averages(ranks, single):
    results, _ = ranks
    want = single["whole_batch"]
    for result in results:
        _close(result["whole_batch"]["losses"], want["losses"])
        _close(result["whole_batch"]["norms"], want["norms"])
        _params_close(result["whole_batch"]["params"], want["params"])


def test_two_ranks_draw_different_dropout_masks(ranks):
    results, _ = ranks
    first, second = (r["dropout_masks"] for r in results)
    assert first["loss"] != second["loss"]
    for key, value in first["params"].items():
        assert torch.equal(value, second["params"][key])


def _same_decodes(got, want):
    """Every runner's sentences equal, its losses (the beam's mean
    score) within ATOL."""
    assert len(got) == len(want)
    for (outputs, losses), (want_outputs, want_losses) in zip(got, want):
        assert outputs == want_outputs
        assert set(losses) == set(want_losses)
        for key, value in want_losses.items():
            _close(losses[key], value)


def test_dp_beam_decode_matches_one_process(ranks, single):
    """Each rank searches its rows; every rank collects all of them in
    order, as one process searches the whole batch."""
    results, _ = ranks
    for result in results:
        for mode in ("replicated", "fsdp"):
            assert "beam_score" in result["beam"][mode][1][1]
            _same_decodes(result["beam"][mode], single["beam"][mode])


def test_fsdp_physical_beam_matches_one_process(ranks, single):
    """Under fsdp the beam search by the physical reorder (``NM_LINEAGE=0``)
    of each rank's rows gives one process's sentences and scores, which
    are the lineage search's."""
    results, _ = ranks
    want = single["beam"]["fsdp_scaled_physical"]
    _same_decodes(want, single["beam"]["fsdp_scaled_lineage"])
    for result in results:
        _same_decodes(result["beam"]["fsdp_scaled_physical"], want)


def test_ensemble_through_dp_matches_one_process(ranks, single):
    results, _ = ranks
    for result in results:
        _same_decodes(result["ensemble"]["outputs"],
                      single["ensemble"]["outputs"])


def test_train_cli_matches_one_process_step_for_step(ranks, single):
    """small.ini through the train CLI: every rank's code 0, rank 0's
    logged losses and validation those of one process."""
    results, _ = ranks
    want = single["train_cli"]
    got = results[0]["train_cli"]
    assert got["code"] == 0 and results[1]["train_cli"]["code"] == 0
    train = [r for r in got["records"] if r["kind"] == "train"]
    ref = [r for r in want["records"] if r["kind"] == "train"]
    assert [r["step"] for r in train] == [r["step"] for r in ref]
    _close([r["loss"] for r in train], [r["loss"] for r in ref])
    assert [r["target_tokens"] if "target_tokens" in r else None
            for r in train] == [r.get("target_tokens") for r in ref]
    val = [r for r in got["records"] if r["kind"] == "val"]
    ref_val = [r for r in want["records"] if r["kind"] == "val"]
    assert len(val) == len(ref_val) == 1
    for key, value in ref_val[0].items():
        if key not in ("time", "kind"):
            assert val[0][key] == pytest.approx(value, abs=ATOL), key
    assert results[1]["train_cli"]["records"] == []


def test_parallel_imports_no_jax():
    """``parallel/`` imports neither JAX nor the JAX package."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import neuralmonkey_tpu_torch.parallel.distributed\n"
            "import neuralmonkey_tpu_torch.parallel.zero\n"
            "import neuralmonkey_tpu_torch.parallel.mesh\n"
            "import neuralmonkey_tpu_torch.parallel.tensor\n"
            "import neuralmonkey_tpu_torch.parallel.ring_attention\n"
            "import neuralmonkey_tpu_torch.ops.sharding\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'neuralmonkey_tpu.')) or "
            "k == 'neuralmonkey_tpu']\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("shape,world,dim", [
    ((64, 32), 2, 0), ((32, 64), 2, 1), ((7, 5), 2, None),
    ((6, 6), 2, 0), ((30, 12), 4, 1), ((5,), 1, None)])
def test_data_axis_is_the_jax_rule(shape, world, dim):
    """The largest dim the ranks divide, the first of equal ones."""
    assert zero.data_axis(shape, world) == dim


@pytest.mark.parametrize("shape,skip,dim", [
    ((64, 32), 0, 1), ((32, 64), 1, 0), ((64, 7), 0, None)])
def test_data_axis_skips_the_model_split_dim(shape, skip, dim):
    """Under a model axis the data axis takes the largest dim still free
    (``_add_data_axis``), never the one split over the model axis."""
    assert zero.data_axis(shape, 2, skip) == dim


def test_fsdp_with_pipeline_stages_raises():
    with pytest.raises(ValueError, match="fsdp"):
        CUDAManager(device="cpu", fsdp=True, num_pipeline_stages=2)
