"""Runtime manager for one CUDA device a process (counterpart of
``neuralmonkey_tpu/runtime.py`` ``TPUManager``).

Owns the model parts, their parameters and optimizer state, batch
building, the train step, batched execution of runners and
checkpoints. The reference's ``[tf_manager]`` keyword arguments are
accepted so existing INI files load; the ones that only meant something
to TensorFlow sessions are ignored, as in the JAX package.

In a process group (``parallel/distributed.py``) each process runs one
device, placed on the JAX package's mesh axes (``parallel/mesh.py``):
``num_model_shards`` ranks a model group, ``num_context_shards`` a
context group, the rest data replicas. A batch whose size the data
ranks divide splits into their rows, the gradients are reduced over the
data group in one buffer in a fixed order, and with
``shard_optimizer_state`` (ZeRO-1) or ``fsdp`` the optimizer state, or
the parameters too, are divided among the data ranks by the JAX
package's rule (``parallel/zero.py``), and the divided gradients
reduce-scattered; under ``fsdp`` a pass gathers the parameters unit by
unit as it reads them and reduces each unit's gradients as the backward
completes them (``parallel/fsdp.py``). The parts' declared
``param_partition_specs`` split parameters over the model group
(tensor parallelism, ``parallel/tensor.py``); ``sequence_sharding``
splits the Transformer's residual stream over it,
``num_context_shards`` over the context group with the ring attention
(``ops/sharding.py``, ``parallel/ring_attention.py``).
``num_pipeline_stages`` lays ranks out on the pipe axis, where a
pipelined part's stacked layers split their layer axis
(``parallel/pipeline.py``), and ``num_expert_shards`` on the expert
axis, where the experts of a MoE FFN split (``ops/moe.py``).
Checkpoints hold whole tensors in one process's layout.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .dataset import BatchingScheme
from .logging import log, warn
from .model.part import (Context, ModelPart, collect_parts, fold_seed,
                         init_all_params)
from .ops.moe import disable_expert_sharding, enable_expert_sharding
from .parallel import distributed, tensor, zero
from .parallel import fsdp as fsdp_units
from .parallel import mesh as mesh_lib
from .parallel.pipeline import disable_pipeline, enable_pipeline
from .runners.base_runner import ExecutionResult, reduce_execution_results
from .trainers.multitask_trainer import MultitaskTrainer
from .utils.average_checkpoints import average_flat
from .utils.batching import pad_batch
from .utils.saving import (flatten_tree, load_flat, load_meta, map_leaves,
                           params_from_jax, save_tree)


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _host_array(value: torch.Tensor) -> np.ndarray:
    """A fetched tensor on the host; bf16 (which numpy lacks) widened
    to float32."""
    value = value.detach().cpu()
    if value.dtype == torch.bfloat16:
        value = value.float()
    return value.numpy()


def resolve_device(device: Optional[str]) -> torch.device:
    """``device``, or the CUDA card when none is named (in a process
    group, ``cuda:<local rank>``). Without a visible card that raises:
    the port runs on the CPU only when asked (``[tf_manager]
    device="cpu"``)."""
    if device is None or device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; to run on the CPU, ask for it "
                'with [tf_manager] device="cpu"')
        if distributed.is_initialized():
            return torch.device("cuda", distributed.local_device_index())
        device = "cuda"
    return torch.device(device)


class LocalBatch(dict):
    """A featurized batch's tensors on this process's device; ``split``
    when they are its rows of a batch divided among the ranks (else the
    whole batch)."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 split: bool = False) -> None:
        super().__init__(tensors)
        self.split = split


class CUDAManager:
    """Parameters, optimizer state and execution on one device a
    process: ``device`` (default ``cuda``, in a process group
    ``cuda:<local rank>``; ``cpu`` runs every kernel's plain PyTorch
    version). In a process group ``num_model_shards``,
    ``num_context_shards``, ``num_expert_shards`` and
    ``num_pipeline_stages`` lay the ranks out on the model, context,
    expert and pipe axes (``sequence_sharding`` splits the residual
    stream over the model axis too), and ``shard_optimizer_state``
    divides the optimizer state among the data ranks (ZeRO-1) and
    ``fsdp`` the parameters too."""

    def __init__(self,
                 num_sessions: int = 1,
                 num_threads: int = 0,
                 save_n_best: int = 1,
                 max_to_keep: int = 3,
                 minimize_metric: bool = False,
                 gpu_allow_growth: bool = True,
                 per_process_gpu_memory_fraction: float = 1.0,
                 report_gpu_memory_consumption: bool = False,
                 enable_tf_debug: bool = False,
                 num_model_shards: int = 1,
                 sequence_sharding: bool = False,
                 num_pipeline_stages: int = 1,
                 num_expert_shards: int = 1,
                 num_context_shards: int = 1,
                 fsdp: bool = False,
                 shard_optimizer_state: bool = False,
                 device: str = None,
                 random_seed: int = None) -> None:
        del (num_threads, gpu_allow_growth,
             per_process_gpu_memory_fraction,
             report_gpu_memory_consumption, enable_tf_debug)
        if num_sessions < 1:
            raise ValueError("num_sessions must be >= 1")
        self.num_sessions = num_sessions
        if fsdp and num_pipeline_stages > 1:
            raise ValueError(
                "fsdp cannot combine with num_pipeline_stages: the "
                "pipeline's stages hold their layers' parameters whole "
                "(use shard_optimizer_state=True for the ZeRO-1 part)")
        if sequence_sharding:
            # where the JAX manager warns and ignores the knob
            if num_pipeline_stages > 1:
                raise ValueError(
                    "sequence_sharding=True cannot combine with "
                    "num_pipeline_stages (the residual stream's split "
                    "would sit inside the pipeline's stages)")
            if num_context_shards > 1:
                raise ValueError(
                    "sequence_sharding=True is redundant under "
                    "num_context_shards (the ring attention already "
                    "splits the residual stream's time axis over the "
                    "context axis)")
            if num_model_shards <= 1:
                raise ValueError(
                    "sequence_sharding=True requires num_model_shards > 1")
        # a previous manager's registries go first (the JAX package's
        # rule), then this one's are set
        disable_pipeline()
        disable_expert_sharding()
        # the rank grid: model groups innermost, then context, expert and
        # pipe groups, data replicas outermost (a world the axes do not
        # divide raises the JAX package's error)
        self.mesh = mesh_lib.Mesh(
            distributed.process_count(), distributed.process_index(),
            {"pipe": num_pipeline_stages, "expert": num_expert_shards,
             "context": num_context_shards, "model": num_model_shards},
            sequence=sequence_sharding)
        self.mesh.build_groups()
        mesh_lib.enable(self.mesh)
        if num_expert_shards > 1:
            enable_expert_sharding(self.mesh)
        if num_pipeline_stages > 1:
            enable_pipeline(self.mesh)
        # ZeRO over the data-parallel ranks: fsdp divides the parameters
        # (gathered at use, unit by unit), shard_optimizer_state the
        # optimizer state alone; the moments follow their parameters, so
        # fsdp implies the latter
        self.fsdp = fsdp
        self.shard_optimizer_state = shard_optimizer_state or fsdp
        # what fsdp's gathers at use did (parallel/fsdp.Stats)
        self.fsdp_stats = fsdp_units.Stats()
        # the data axis: the ranks a batch splits over and ZeRO divides
        # among
        self.world = self.mesh.size("data")
        self.rank = self.mesh.index("data")
        self.device = resolve_device(device)
        self.seed = random_seed or 0
        self.save_n_best = max(save_n_best, 1)
        self.max_to_keep = max(max_to_keep, self.save_n_best)
        self.minimize_metric = minimize_metric
        self.parts: List[ModelPart] = []
        # the parameter sets: several after restoring several checkpoints
        # (a logit ensemble); training and saving use the first. Under
        # fsdp each holds this rank's parts (_rest_plan)
        self.params_list: List[Dict[str, Any]] = [{}]
        # the parameters' whole shapes and dtypes (meta tensors), the
        # dims each is split along over the model, expert and pipe axes,
        # this rank's shards' shapes, and how each shard divides at rest
        # over the data axis (fsdp)
        self._meta: Dict[str, torch.Tensor] = {}
        self._split: Dict[str, Dict[str, int]] = {}
        self._local_meta: Dict[str, torch.Tensor] = {}
        self._rest_plan: Dict[str, zero.Shard] = {}
        self.global_step = 0
        self.epoch = 0
        self.best_score: Optional[float] = None
        self.best_score_step = 0
        self.best_score_epoch = 0
        # per trainer: its Update, optimizer state (this rank's parts)
        # and how the parameters divide for its update, by stable label
        self._updates: Dict[str, Any] = {}
        self._opt_states: Dict[str, Dict[str, torch.Tensor]] = {}
        self._update_plans: Dict[str, Dict[str, zero.Shard]] = {}
        # optimizer state read from disk before its trainer's first step
        self._pending_opt_flat: Optional[Dict[str, np.ndarray]] = None
        self._checkpoint_paths: List[str] = []
        # ex-best checkpoints kept from rotation while the .best link
        # pointed at them; swept once the link moves on
        self._protected_paths: List[str] = []
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "host")
        where = ""
        if distributed.is_initialized():
            mode = ("fsdp" if fsdp else "ZeRO-1"
                    if self.shard_optimizer_state else "replicated")
            where = (f", rank {self.mesh.rank} of {self.mesh.world}, mesh "
                     f"{self.mesh.shape} ({mode})")
        log(f"CUDAManager: device {self.device} [{name}]{where}")

    @property
    def params(self) -> Dict[str, Any]:
        return self.params_list[0]

    @params.setter
    def params(self, value: Dict[str, Any]) -> None:
        self.params_list[0] = value

    # ------------------------------------------------------------------ #
    # model lifecycle
    # ------------------------------------------------------------------ #
    def initialize_model_parts(self, roots: Sequence[Any],
                               seed: int = None) -> None:
        """Collect the parts reachable from the trainers and runners and
        initialize their parameters from ``seed`` (the same on every
        rank; under fsdp each keeps its parts)."""
        self.parts = collect_parts(roots)
        if seed is not None:
            self.seed = seed
        params = init_all_params(self.parts, self.seed)
        self._meta = {name: torch.empty(value.shape, dtype=value.dtype,
                                        device="meta")
                      for name, value in flatten_tree(params).items()}
        self._split = self._split_dims()
        self._local_meta = {}
        for name, m in self._meta.items():
            shape = list(m.shape)
            for axis, dim in self._split[name].items():
                shape[dim] //= self.mesh.size(axis)
            self._local_meta[name] = torch.empty(shape, dtype=m.dtype,
                                                 device="meta")
        self._rest_plan = (
            zero.slice_plan({n: m.shape for n, m in self._local_meta.items()},
                            self.world, {n: set(d.values())
                                         for n, d in self._split.items()})
            if self.fsdp else {n: zero.Shard() for n in self._meta})
        self.params_list = [self._to_rest(_to_device(params, self.device))]
        total = sum(m.numel() for m in self._meta.values())
        log(f"Initialized {len(self.parts)} model parts, "
            f"{total:,} parameters")
        for part in self.parts:
            if part.load_checkpoint:
                self.load_part_checkpoint(part, part.load_checkpoint)

    def _split_dims(self) -> Dict[str, Dict[str, int]]:
        """For each parameter, the dim its part declares on each of the
        model, expert and pipe axes (``param_partition_specs``, as
        ``_declared_partition_specs`` and ``_declared_axes`` collect
        them), by axis: none where it is undeclared, of another rank, or
        has a dim its axis does not divide (kept whole on every rank,
        with the JAX package's warning). Axes this mesh lacks are
        dropped."""
        sizes = {axis: self.mesh.size(axis) for axis in zero.AXES}
        dims: Dict[str, Dict[str, int]] = {n: {} for n in self._meta}
        if all(size == 1 for size in sizes.values()):
            return dims
        declared: Dict[str, tuple] = {}
        for part in self.parts:
            for rel, axes in (part.param_partition_specs() or {}).items():
                declared[f"{part.param_key}/{rel}"] = tuple(axes)
        for name, m in self._meta.items():
            axes = declared.get(name)
            if axes is None:
                continue
            if len(axes) != m.dim():
                warn(f"Param '{name}' declares partition {axes} but "
                     f"has rank {m.dim()}; replicating")
                continue
            chosen = {axis: i for i, axis in enumerate(axes)
                      if sizes.get(axis, 1) > 1}
            undivided = [(axis, i) for axis, i in chosen.items()
                         if m.shape[i] % sizes[axis]]
            if undivided:
                axis, i = undivided[0]
                warn(f"Param '{name}' dim {m.shape[i]} not divisible by "
                     f"mesh axis {axis}={sizes[axis]}; replicating")
                continue
            dims[name] = chosen
        if not any(dims.values()):
            warn("mesh has a model, expert or pipe axis but no parameter "
                 "declares a matching partition (param_partition_specs); "
                 "everything replicates")
        return dims

    # ------------------------------------------------------------------ #
    # parameters whole and at rest (this rank's model shards; under fsdp
    # each data rank's parts of them)
    # ------------------------------------------------------------------ #
    def _template(self) -> Any:
        """The parameter tree with whole shapes (for ``params_from_jax``)."""
        return map_leaves(lambda name, _: self._meta[name], self.params)

    def _sharded_params(self) -> bool:
        return any(not s.replicated for s in self._rest_plan.values())

    def _split_names(self) -> List[str]:
        return [n for n, d in self._split.items() if d]

    def _own_part(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole tensor of parameter ``name`` over
        the axes it is split along (the tensor itself where it is
        whole)."""
        for axis, dim in self._split.get(name, {}).items():
            value = tensor.own_part(value, dim, axis)
        return value

    def _gather_whole(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """The whole tensor from this rank's shard ``value`` of parameter
        ``name`` (collectives over its axes' groups)."""
        dims = self._split.get(name, {})
        for axis in zero.AXES:
            if axis in dims:
                value = tensor.all_gather(value, dims[axis], axis)
        return value

    def _to_rest(self, tree: Any, prefix: str = "") -> Any:
        """Whole parameters (of the part ``prefix``, or all) as this rank
        keeps them: its model shards, under fsdp its data parts of
        those; each marked with the dim it is split along over the
        model axis."""
        def cut(name, value):
            value = self._own_part(name, value)
            shard = self._rest_plan[name]
            if not shard.replicated:
                value = zero.region(value, shard, self.rank, self.world)
            if value is not None and (not shard.replicated
                                      or self._split.get(name)):
                value = value.contiguous().clone()
            return tensor.mark_axes(value, self._split.get(name))
        return map_leaves(cut, tree, prefix)

    def _at_use(self, params: Dict[str, Any], **kwargs) -> fsdp_units.AtUse:
        """A parameter set at rest under fsdp as a pass reads it: unit by
        unit, each gathered at use (``parallel/fsdp.py``; ``kwargs`` a
        training pass's)."""
        return fsdp_units.AtUse(params, self._rest_plan, self._local_meta,
                                self._split, self.fsdp_stats, **kwargs)

    def whole_params(self) -> Dict[str, Any]:
        """The first parameter set with every parameter whole, in one
        process's shapes (over data and model ranks a collective: every
        rank calls it; gathered a group of at most 64 MiB at a time)."""
        params = self.params
        if not self._sharded_params() and not self._split_names():
            return params
        whole = zero.gather_whole(flatten_tree(params), self._rest_plan,
                                  self._local_meta, self.device,
                                  split_dims=self._split)
        return map_leaves(lambda name, _: whole[name], params)

    def load_part_checkpoint(self, part: ModelPart, path: str) -> None:
        """Warm-start ``part``'s parameters from the ``.npz`` at
        ``path``: its ``<param_key>/...`` entries, or, when it has none,
        the whole file as the part's own flat keys. Every key and shape
        of the part must match."""
        flat = load_flat(path)
        key = part.param_key
        prefix = f"{key}/"
        sub = {k[len(prefix):]: v for k, v in flat.items()
               if k.startswith(prefix)}
        whole = params_from_jax(sub or flat, self._template()[key])
        self.params[key] = self._to_rest(_to_device(whole, self.device),
                                         key)
        log(f"Part '{part.name}' warm-started from {path}")

    def restore(self, paths: Union[str, Sequence[str]],
                average: bool = False) -> None:
        """Load parameters from ``.npz`` checkpoints, written by either
        package on any number of processes: one parameter set a
        checkpoint (several make a logit ensemble), or with ``average``
        one set, the checkpoints' parameters averaged
        (``utils.average_checkpoints.average_flat``: float32 sums, each
        leaf cast back to its dtype). Under fsdp each rank keeps its
        parts. The first checkpoint's meta, when present, sets the
        step."""
        if isinstance(paths, str):
            paths = [paths]
        flats = [load_flat(path) for path in paths]
        if average and len(flats) > 1:
            flats = [average_flat(flats)]
            log(f"Averaged {len(paths)} checkpoints into one parameter "
                "set")
        template = self._template()
        self.params_list = [
            self._to_rest(_to_device(params_from_jax(flat, template),
                                     self.device))
            for flat in flats]
        meta = load_meta(paths[0])
        if meta:
            self.global_step = meta.get("step", self.global_step)
        log(f"Restored variables from {', '.join(paths)}")

    def restore_best_vars(self, output_dir: str,
                          link_name: str = "variables.data.best") -> None:
        self.restore([os.path.join(output_dir, link_name)])

    # ------------------------------------------------------------------ #
    # batches
    # ------------------------------------------------------------------ #
    def build_batch(self, dataset, batch_size: int, train: bool = False
                    ) -> Tuple[LocalBatch, int]:
        """Featurize all parts, pad to bucketed shapes, move this rank's
        rows to the device: its contiguous share when the ranks divide
        ``batch_size``, else all of them. Returns (batch, real_size of
        the whole batch)."""
        padded, real_size = self._host_batch(dataset, batch_size, train)
        split = distributed.split_rows(batch_size)
        batch = LocalBatch({key: torch.from_numpy(value).to(self.device)
                            for key, value in padded.items()}, split)
        return batch, real_size

    def _host_batch(self, dataset, batch_size: int, train: bool
                    ) -> Tuple[Dict[str, np.ndarray], int]:
        """Every part's features of ``dataset``, padded on the host, this
        rank's rows of them (see ``build_batch``)."""
        features: Dict[str, np.ndarray] = {}
        for part in self.parts:
            features.update(part.featurize(dataset, train=train))
        padded, real_size = pad_batch(features, batch_size)
        if distributed.split_rows(batch_size):
            padded = {key: distributed.local_rows(value)
                      for key, value in padded.items()}
        return padded, real_size

    def _prepare_batch(self, dataset, batch_size: int, train: bool,
                       stream: Optional["torch.cuda.Stream"]):
        """``build_batch`` for the prefetch worker: on the card the host
        arrays are copied from pinned buffers on the worker's own
        ``stream``, and an event recorded there marks the copies' end.
        Returns (batch, real_size, event or None)."""
        if stream is None:
            batch, real_size = self.build_batch(dataset, batch_size, train)
            return batch, real_size, None
        padded, real_size = self._host_batch(dataset, batch_size, train)
        with torch.cuda.stream(stream):
            batch = LocalBatch(
                {key: torch.from_numpy(value).pin_memory().to(
                    self.device, non_blocking=True)
                 for key, value in padded.items()},
                distributed.split_rows(batch_size))
            event = torch.cuda.Event()
            event.record(stream)
        return batch, real_size, event

    def iter_prepared_batches(self, dataset, batching_scheme,
                              batch_size: int, train: bool = False,
                              shuffled: bool = None,
                              prefetch_depth: int = 2):
        """(batch, real_size) for every batch of ``dataset`` (shuffled
        when training, unless ``shuffled`` says otherwise), prepared
        ``prefetch_depth`` batches ahead by a worker thread: it
        featurizes and pads, and on the card copies each batch to the
        device on a side stream of its own, whose event the consumer's
        stream waits on (``record_stream`` keeps the caching allocator
        from reusing a block before the consumer's work on it is done).

        The consumer may leave at any point (break, exception, close):
        the ``finally`` signals the worker, drains the queue so a worker
        blocked in ``put`` wakes, and joins it. An exception in the
        worker is raised in the consumer."""
        sentinel = object()
        out_queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        stop = threading.Event()
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)

        def put(item) -> bool:
            """A bounded put that re-checks ``stop``, so the worker never
            waits in ``put`` after the consumer has left."""
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for dataset_batch in dataset.batches(
                        batching_scheme,
                        shuffled=train if shuffled is None else shuffled):
                    if stop.is_set():
                        return
                    if not put(self._prepare_batch(
                            dataset_batch, batch_size, train, stream)):
                        return
            except BaseException as exc:  # raised again in the consumer
                put(exc)
                return
            put(sentinel)

        thread = threading.Thread(target=worker, name="nm-prefetch",
                                  daemon=True)
        thread.start()
        try:
            while True:
                item = out_queue.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, real_size, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    for tensor in batch.values():
                        tensor.record_stream(consumer)
                yield batch, real_size
        finally:
            stop.set()
            try:
                while True:
                    out_queue.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=60.0)
            if thread.is_alive():
                warn("prefetch worker did not stop within 60s; "
                     "a copy to the device may still be in flight")

    # ------------------------------------------------------------------ #
    # training
    # ------------------------------------------------------------------ #
    @staticmethod
    def _trainer_label(trainer) -> str:
        """Stable identity of a trainer's optimizer state on disk."""
        objectives = getattr(trainer, "objectives", None)
        base = getattr(trainer, "name", type(trainer).__name__)
        if objectives:
            return base + ":" + "+".join(o.name for o in objectives)
        return base

    def _optimizer(self, trainer):
        """(label, Update, state) of ``trainer``; made at its first
        step, from staged state on disk when there is some. Under ZeRO
        the state holds this rank's parts: an elementwise rule's state
        divides as its parameter does, Adafactor's (whose update reduces
        over whole parameters) stays whole on each parameter's owner
        rank (``_update_plans``) and, for a parameter split over the
        model, expert or pipe axes, whole over them too: the update runs
        on the parameter gathered whole (``_apply``)."""
        label = self._trainer_label(trainer)
        if label not in self._updates:
            update = trainer.make_update()
            # this rank's shards are what the update divides
            shapes = {name: m.shape for name, m in self._local_meta.items()}
            meta = self._update_meta(update)
            if not self.shard_optimizer_state:
                plan = {name: zero.Shard() for name in shapes}
            elif update.transform.elementwise:
                plan = zero.slice_plan(shapes, self.world, {
                    n: set(d.values()) for n, d in self._split.items()})
            else:
                plan = zero.owner_plan(shapes, self.world)
            local = {}
            for name, m in meta.items():
                shape = zero.region_shape(m.shape, plan[name], self.rank,
                                          self.world)
                if shape is not None:
                    # init reads shapes, dtypes and devices alone
                    local[name] = torch.empty(shape, dtype=m.dtype,
                                              device=self.device)
            state = update.init(local)
            if self._pending_opt_flat is not None:
                prefix = f"{label}/"
                staged = {k[len(prefix):]: v
                          for k, v in self._pending_opt_flat.items()
                          if k.startswith(prefix)}
                if set(staged) == set(update.init(meta)):
                    state_plan = self._state_plan(update, meta, plan)
                    dims = self._state_split_dims(update)
                    state = {k: self._state_part(staged[k], state_plan[k],
                                                 dims[k]).to(v.device)
                             for k, v in state.items()}
                    log(f"Optimizer state restored for trainer '{label}'")
                else:
                    warn(f"No matching optimizer state for trainer "
                         f"'{label}' in the checkpoint; reinitializing")
            self._updates[label] = update
            self._opt_states[label] = state
            self._update_plans[label] = plan
        return label, self._updates[label], self._opt_states[label]

    @staticmethod
    def _state_plan(update, meta: Dict[str, torch.Tensor],
                    plan: Dict[str, "zero.Shard"]
                    ) -> Dict[str, "zero.Shard"]:
        """How each optimizer-state entry divides: as the parameter it
        belongs to (the entries ``init`` adds for that parameter alone),
        the rule's own scalars whole on every rank."""
        base = update.init({})
        state_plan = {key: zero.Shard() for key in base}
        for name, m in meta.items():
            for key, leaf in update.init({name: m}).items():
                if key in base:
                    continue
                shard = plan[name]
                if shard.dim is not None and leaf.shape != m.shape:
                    raise ValueError(
                        f"optimizer state '{key}' is not shaped as its "
                        f"parameter '{name}', so it cannot divide as it")
                state_plan[key] = shard
        return state_plan

    def _update_meta(self, update) -> Dict[str, torch.Tensor]:
        """The parameters' shapes the update and its state take: this
        rank's shards for an elementwise rule, the whole parameters for
        one that reduces over them."""
        return self._local_meta if update.transform.elementwise \
            else self._meta

    def _state_split_dims(self, update) -> Dict[str, Dict[str, int]]:
        """The split dims of each optimizer-state entry: its parameter's,
        for an elementwise rule's entries (shaped as it); none for a rule
        whose state is whole."""
        dims: Dict[str, Dict[str, int]] = {
            key: {} for key in update.init({})}
        meta = self._update_meta(update)
        for name, m in meta.items():
            for key in update.init({name: m}):
                dims.setdefault(key, self._split.get(name, {})
                                if update.transform.elementwise else {})
        return dims

    def _state_part(self, value: np.ndarray, shard: "zero.Shard",
                    dims: Optional[Dict[str, int]] = None) -> torch.Tensor:
        """This rank's part of a whole optimizer-state entry: its shard
        over the axes of ``dims``, then its data part."""
        whole = torch.from_numpy(np.array(value))
        for axis, dim in (dims or {}).items():
            whole = tensor.own_part(whole, dim, axis)
        return zero.region(whole, shard, self.rank,
                           self.world).contiguous().clone()

    def train_on_batch(self, trainer, dataset_batch,
                       batch_size: int) -> Dict[str, float]:
        """One training step on a dataset batch; losses as floats."""
        batch, _ = self.build_batch(dataset_batch, batch_size, train=True)
        return {name: float(value) for name, value in
                self.train_on_prepared(trainer, batch).items()}

    def train_on_prepared(self, trainer, batch: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
        """One training step on a device-resident batch: loss, backward,
        the gradients reduced over the ranks, clipping and the in-place
        update (``_get_train_fn``'s step). On a split batch
        (``LocalBatch.split``) the losses are the global batch's (every
        batch-level sum goes through ``distributed.global_sum``) and the
        ranks' gradients are summed; on a batch every rank holds whole,
        averaged. Under fsdp the pass gathers the parameters at use and
        the backward reduces each unit's gradients (``parallel/fsdp.py``).
        The returned losses, gradient norm and ``target_tokens`` stay on
        the device; the training loop syncs them once per logging
        window. A ``MultitaskTrainer`` hands the step to its child for
        this global step."""
        if isinstance(trainer, MultitaskTrainer):
            trainer = trainer.select(self.global_step)
        label, update, state = self._optimizer(trainer)
        plan = self._update_plans[label]
        flat = flatten_tree(self.params)
        for p in flat.values():
            p.grad = None
            p.requires_grad_(True)
        rng = fold_seed(self.seed, self.global_step)
        if self.world > 1:
            # each data rank draws its own dropout masks for its rows; the
            # ranks of a model or context group hold the same rows and
            # draw the same masks (a split tensor folds in its part,
            # ops/sharding.shard_seed)
            rng = fold_seed(rng, self.rank)
        split = getattr(batch, "split", False)
        mask_keys = [k for k in batch if k.endswith("train_mask")]
        at_use = (self._at_use(self.params, grad_plan=plan,
                               split_batch=split,
                               trainable=trainer.is_trainable)
                  if self._sharded_params() else None)
        saving = (at_use.saving() if at_use is not None
                  else contextlib.nullcontext())
        with saving, distributed.sharded_batch(split):
            total, losses = trainer.total_loss(
                self.params if at_use is None else at_use, batch, rng)
            tokens = (distributed.global_sum(
                sum(batch[k].sum() for k in mask_keys))
                if mask_keys else None)
        total.backward()
        if at_use is not None:
            norm = self._update_parts(update, state, plan,
                                      at_use.gradients())
        else:
            grads = {name: (p.grad if p.grad is not None and
                            trainer.is_trainable(name)
                            else torch.zeros_like(p))
                     for name, p in flat.items()}
            for p in flat.values():
                p.grad = None
            norm = self._update(update, state, plan, flat, grads, split)
        out = {name: value.detach() for name, value in losses.items()}
        out["loss"] = total.detach()
        out["grad_norm"] = norm
        if tokens is not None:
            out["target_tokens"] = tokens
        self.global_step += 1
        return out

    @torch.no_grad()
    def _update(self, update, state, plan, flat, grads, split
                ) -> torch.Tensor:
        """Reduce the gradients over the ranks (``grads`` is emptied),
        clip by their global norm and update this rank's parts of the
        whole parameters ``flat``; then give every rank the updated parts
        all-gathered (ZeRO-1). Returns the norm."""
        if distributed.is_initialized():
            grads = self._reduce_gradients(grads, plan, split)
        targets = {}
        for name, value in flat.items():
            part = zero.region(value, plan[name], self.rank, self.world)
            if part is not None:
                targets[name] = part
        norm = self._apply(update, state, plan, targets, grads)
        # the reduced gradients go before the gather's buffers come
        del grads
        if any(not s.replicated for s in plan.values()):
            zero.gather_into(flat, plan, targets)
        return norm

    @torch.no_grad()
    def _update_parts(self, update, state, plan, grads) -> torch.Tensor:
        """The update under fsdp, from ``grads``, this rank's parts of
        the reduced gradients under ``plan``: an elementwise rule updates
        the parts at rest in place; under Adafactor's owner plan each
        parameter is gathered whole to its owner, updated there, and its
        parts copied back to the ranks (``zero.owner_gather`` and
        ``owner_scatter``, one owner's group at a time). Returns the
        norm."""
        rest = flatten_tree(self.params)
        if plan == self._rest_plan:
            return self._apply(update, state, plan, rest, grads)
        owned = zero.owner_gather(rest, self._rest_plan, plan,
                                  self._local_meta)
        norm = self._apply(update, state, plan, owned, grads)
        del grads
        zero.owner_scatter(owned, plan, self._rest_plan, rest,
                           self._local_meta)
        return norm

    def _apply(self, update, state, plan, targets, grads) -> torch.Tensor:
        """Clip ``grads`` by their global norm (``plan`` says how they
        divide) and update ``targets`` in place, this rank's parts of
        the parameters under ``plan``. Returns the norm."""
        split = {name: set(dims) for name, dims in self._split.items()}
        whole_update = (not update.transform.elementwise
                        and self._split_names())
        if whole_update:
            # a rule that reduces over whole parameters updates the split
            # ones gathered whole (every rank of their groups the same),
            # then each rank keeps its shard
            parts = targets
            targets = {name: self._gather_whole(name, part)
                       for name, part in parts.items()}
            grads = {name: self._gather_whole(name, grad)
                     for name, grad in grads.items()}
            split = {}
        norm = update.apply(targets, grads, state, norm_of=lambda t: (
            zero.sharded_norm(t, plan, self.device, split)))
        if whole_update:
            for name, part in parts.items():
                if self._split[name]:
                    part.copy_(self._own_part(name, targets[name]))
        return norm

    def _reduce_gradients(self, grads, plan, split):
        """This rank's parts (by ``plan``) of the gradients summed over
        the ranks, each in one buffer in sorted name order: the divided
        ones reduce-scattered, the whole ones all-reduced (so every rank
        holds the same sums). On a batch every rank holds whole, their
        mean. Empties ``grads``: each gradient is let go once packed, so
        a buffer never sits beside all of them."""
        whole = {name: grads.pop(name) for name in sorted(grads)
                 if plan[name].replicated}
        reduced = zero.reduce_scatter(grads, plan)
        reduced.update(zero.all_reduce(whole))
        if not split:
            reduced = {name: part / self.world
                       for name, part in reduced.items()}
        return reduced

    # ------------------------------------------------------------------ #
    # inference
    # ------------------------------------------------------------------ #
    def fetch(self, runners, batch: Dict[str, torch.Tensor]
              ) -> List[Dict[str, torch.Tensor]]:
        """Every runner's fetches on a device-resident batch: with
        several parameter sets, a runner that has ``ensemble_fetches``
        gets a context of each, every other runner the first set's.
        Under fsdp each set is gathered at use, unit by unit: an
        encoder's units go once its states are computed, a decoder's
        layers are gathered at each step that reads them and its other
        unit kept for the search (``fsdp.Pins``). On a split batch
        a batch-level loss among the fetches is the global batch's."""
        contexts = [Context(self._at_use(params) if self._sharded_params()
                            else params, batch, train=False)
                    for params in self.params_list]
        with distributed.sharded_batch(getattr(batch, "split", False)):
            return [runner.ensemble_fetches(contexts)
                    if len(contexts) > 1
                    and hasattr(runner, "ensemble_fetches")
                    else runner.fetches(contexts[0])
                    for runner in runners]

    def run_on_batch(self, runners, dataset_batch, batch_size: int
                     ) -> List[ExecutionResult]:
        """Every runner's fetches on one batch, collected on the host;
        on a split batch each rank decodes its rows and every rank
        collects all of them (``distributed.fetch_to_host``)."""
        batch, real_size = self.build_batch(dataset_batch, batch_size)
        with torch.inference_mode():
            fetched = self.fetch(runners, batch)
            host = [distributed.fetch_to_host(
                        out, getattr(runner, "fetch_batch_dims", None))
                    if batch.split else
                    {k: _host_array(v) for k, v in out.items()}
                    for runner, out in zip(runners, fetched)]
        return [runner.collect_results(out, real_size)
                for runner, out in zip(runners, host)]

    def execute(self, dataset, runners, batch_size: int,
                batching_scheme: Optional[BatchingScheme] = None
                ) -> List[ExecutionResult]:
        """Run every runner over the dataset, in the dataset's order."""
        scheme = batching_scheme or BatchingScheme(batch_size=batch_size)
        per_runner: List[List[ExecutionResult]] = [[] for _ in runners]
        for batch in dataset.batches(scheme, shuffled=False):
            for results, result in zip(per_runner, self.run_on_batch(
                    runners, batch, batch_size)):
                results.append(result)
        return [reduce_execution_results(results)
                for results in per_runner]

    # ------------------------------------------------------------------ #
    # checkpoints: rotation, the .best link, optimizer state
    # ------------------------------------------------------------------ #
    def save(self, path: str, step: int = None) -> str:
        """Write ``<path>-<step>`` (and its meta), keep the newest
        ``max_to_keep`` (the ``.best`` target stays until the link moves
        on), and write the optimizer state to ``<path>.opt``. In a
        process group every rank gathers the whole tensors and process 0
        alone writes, in the layout of one process; then a barrier."""
        step = step if step is not None else self.global_step
        ckpt_path = f"{path}-{step}"
        host = zero.gather_to_host(flatten_tree(self.params),
                                   self._rest_plan, self._local_meta,
                                   self.device, split_dims=self._split)
        params = map_leaves(lambda name, _: host[name], self.params)
        combined = self._gather_optimizer_state()
        if not distributed.is_main_process():
            distributed.sync_processes("nm_checkpoint")
            return ckpt_path
        save_tree(ckpt_path, params,
                  meta={"step": step, "epoch": self.epoch,
                        "best_score": self.best_score})
        self._checkpoint_paths.append(ckpt_path)
        link = path + ".best"

        def is_best_target(p: str) -> bool:
            return (os.path.islink(link)
                    and os.path.realpath(link) == os.path.realpath(p))

        def remove(p: str) -> None:
            for stale in (p, p + ".meta.json"):
                if os.path.exists(stale):
                    os.remove(stale)

        while len(self._checkpoint_paths) > self.max_to_keep:
            stale = self._checkpoint_paths.pop(0)
            if is_best_target(stale):
                self._protected_paths.append(stale)
            else:
                remove(stale)
        for stale in list(self._protected_paths):
            if not is_best_target(stale):
                remove(stale)
                self._protected_paths.remove(stale)
        self._write_optimizer_state(path, combined)
        log(f"Checkpoint saved to {ckpt_path}")
        distributed.sync_processes("nm_checkpoint")
        return ckpt_path

    def _gather_optimizer_state(self) -> Dict[str, np.ndarray]:
        """Every trainer's optimizer state, whole, in the port's own keys
        (``<trainer label>/<state>/<parameter>``) on the host; under
        ZeRO or model shards every rank's parts all-gathered
        (collectives)."""
        combined: Dict[str, np.ndarray] = {}
        for label, state in self._opt_states.items():
            update = self._updates[label]
            meta = self._update_meta(update)
            local_meta = update.init(meta)
            host = zero.gather_to_host(
                state, self._state_plan(update, meta,
                                        self._update_plans[label]),
                local_meta, self.device,
                split_dims=self._state_split_dims(update))
            for key in local_meta:
                combined[f"{label}/{key}"] = host[key].numpy()
        return combined

    @staticmethod
    def _write_optimizer_state(path: str,
                               combined: Dict[str, np.ndarray]) -> None:
        if not combined:
            return
        opt_path = f"{path}.opt"
        with open(opt_path + ".tmp", "wb") as f:
            np.savez(f, **combined)
        os.replace(opt_path + ".tmp", opt_path)

    def save_optimizer_state(self, path: str) -> None:
        """Every trainer's optimizer state, whole, to ``<path>.opt``
        (gathered by every rank, written by process 0)."""
        combined = self._gather_optimizer_state()
        if distributed.is_main_process():
            self._write_optimizer_state(path, combined)

    def load_optimizer_state(self, path: str) -> None:
        """Stage ``<path>.opt`` for the trainers' first steps."""
        opt_path = f"{path}.opt"
        if not os.path.exists(opt_path):
            warn(f"No optimizer state at {opt_path}; "
                 "optimizer will start fresh")
            return
        self._pending_opt_flat = load_flat(opt_path)
        log(f"Optimizer state staged from {opt_path}")

    def validation_hook(self, score: float, step: int, epoch: int,
                        path: str) -> bool:
        """Track the best main-metric score; on a new best, save and
        point ``<path>.best`` at the checkpoint. Returns whether the
        score is a new best."""
        is_better = (self.best_score is None
                     or (score < self.best_score if self.minimize_metric
                         else score > self.best_score))
        if is_better:
            self.best_score = score
            self.best_score_step = step
            self.best_score_epoch = epoch
            ckpt_path = self.save(path, step=step)
            link = path + ".best"
            if distributed.is_main_process():
                tmp_link = link + ".tmp"
                if os.path.lexists(tmp_link):
                    os.remove(tmp_link)
                os.symlink(os.path.basename(ckpt_path), tmp_link)
                os.replace(tmp_link, link)
            distributed.sync_processes("nm_best_link")
            log(f"New best score {score:.4g}; {link} -> {ckpt_path}",
                color="green")
        return is_better
