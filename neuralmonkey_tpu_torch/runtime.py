"""Runtime manager for one CUDA device (counterpart of
``neuralmonkey_tpu/runtime.py`` ``TPUManager``).

Owns the model parts, their parameters and optimizer state on one
device, batch building, the train step, batched execution of runners
and checkpoints. The reference's ``[tf_manager]`` keyword arguments are
accepted so existing INI files load; the ones that only meant something
to TensorFlow sessions are ignored, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .dataset import BatchingScheme
from .logging import log, warn
from .model.part import (Context, ModelPart, collect_parts, fold_seed,
                         init_all_params)
from .runners.base_runner import ExecutionResult, reduce_execution_results
from .utils.batching import pad_batch
from .utils.saving import (flatten_tree, load_flat, load_meta,
                           params_from_jax, save_tree)


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def resolve_device(device: Optional[str]) -> torch.device:
    """``device``, or the CUDA card when none is named. Without a
    visible card that raises: the port runs on the CPU only when asked
    (``[tf_manager] device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; to run on the CPU, ask for it "
                'with [tf_manager] device="cpu"')
        device = "cuda"
    return torch.device(device)


class CUDAManager:
    """Parameters, optimizer state and execution on one device:
    ``device`` (default ``cuda``; ``cpu`` runs every kernel's plain
    PyTorch version)."""

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
        if num_sessions != 1:
            raise NotImplementedError(
                "checkpoint ensembles (num_sessions > 1) are not ported "
                "to neuralmonkey_tpu_torch yet")
        # TPUManager's mesh options, accepted at their defaults
        for name, value, default, what in (
                ("num_model_shards", num_model_shards, 1,
                 "tensor parallelism"),
                ("sequence_sharding", sequence_sharding, False,
                 "sequence sharding"),
                ("num_pipeline_stages", num_pipeline_stages, 1,
                 "pipeline parallelism"),
                ("num_expert_shards", num_expert_shards, 1,
                 "expert parallelism"),
                ("num_context_shards", num_context_shards, 1,
                 "context parallelism (the ring attention)"),
                ("fsdp", fsdp, False, "fully sharded data parallelism"),
                ("shard_optimizer_state", shard_optimizer_state, False,
                 "optimizer-state sharding")):
            if value != default:
                raise NotImplementedError(
                    f"{what} ({name}={value!r}) is not ported to "
                    "neuralmonkey_tpu_torch yet (ROADMAP queue A15)")
        self.device = resolve_device(device)
        self.seed = random_seed or 0
        self.save_n_best = max(save_n_best, 1)
        self.max_to_keep = max(max_to_keep, self.save_n_best)
        self.minimize_metric = minimize_metric
        self.parts: List[ModelPart] = []
        self.params: Dict[str, Any] = {}
        self.global_step = 0
        self.epoch = 0
        self.best_score: Optional[float] = None
        self.best_score_step = 0
        self.best_score_epoch = 0
        # per trainer: its Update and optimizer state, by stable label
        self._updates: Dict[str, Any] = {}
        self._opt_states: Dict[str, Dict[str, torch.Tensor]] = {}
        # optimizer state read from disk before its trainer's first step
        self._pending_opt_flat: Optional[Dict[str, np.ndarray]] = None
        self._checkpoint_paths: List[str] = []
        # ex-best checkpoints kept from rotation while the .best link
        # pointed at them; swept once the link moves on
        self._protected_paths: List[str] = []
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "host")
        log(f"CUDAManager: device {self.device} [{name}]")

    # ------------------------------------------------------------------ #
    # model lifecycle
    # ------------------------------------------------------------------ #
    def initialize_model_parts(self, roots: Sequence[Any],
                               seed: int = None) -> None:
        """Collect the parts reachable from the trainers and runners and
        initialize their parameters from ``seed``."""
        self.parts = collect_parts(roots)
        if seed is not None:
            self.seed = seed
        params = init_all_params(self.parts, self.seed)
        self.params = _to_device(params, self.device)
        total = sum(v.numel() for v in flatten_tree(self.params).values())
        log(f"Initialized {len(self.parts)} model parts, "
            f"{total:,} parameters")

    def restore(self, paths: Union[str, Sequence[str]]) -> None:
        """Load parameters from one ``.npz`` checkpoint, written by
        either package; its meta, when present, sets the step."""
        if isinstance(paths, str):
            paths = [paths]
        if len(paths) != 1:
            raise NotImplementedError(
                "checkpoint ensembles (several checkpoints) are not "
                "ported to neuralmonkey_tpu_torch yet")
        params = params_from_jax(load_flat(paths[0]), self.params)
        self.params = _to_device(params, self.device)
        meta = load_meta(paths[0])
        if meta:
            self.global_step = meta.get("step", self.global_step)
        log(f"Restored variables from {paths[0]}")

    def restore_best_vars(self, output_dir: str,
                          link_name: str = "variables.data.best") -> None:
        self.restore([os.path.join(output_dir, link_name)])

    # ------------------------------------------------------------------ #
    # batches
    # ------------------------------------------------------------------ #
    def build_batch(self, dataset, batch_size: int, train: bool = False
                    ) -> Tuple[Dict[str, torch.Tensor], int]:
        """Featurize all parts, pad to bucketed shapes, move to the
        device. Returns (batch, real_size)."""
        features: Dict[str, np.ndarray] = {}
        for part in self.parts:
            features.update(part.featurize(dataset, train=train))
        padded, real_size = pad_batch(features, batch_size)
        batch = {key: torch.from_numpy(value).to(self.device)
                 for key, value in padded.items()}
        return batch, real_size

    def iter_prepared_batches(self, dataset, batching_scheme,
                              batch_size: int, train: bool = False):
        """(batch, real_size) for every batch of ``dataset``, shuffled
        when training."""
        for dataset_batch in dataset.batches(batching_scheme,
                                             shuffled=train):
            yield self.build_batch(dataset_batch, batch_size, train=train)

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
        step, from staged state on disk when there is some."""
        label = self._trainer_label(trainer)
        if label not in self._updates:
            update = trainer.make_update()
            state = update.init(flatten_tree(self.params))
            if self._pending_opt_flat is not None:
                prefix = f"{label}/"
                staged = {k[len(prefix):]: v
                          for k, v in self._pending_opt_flat.items()
                          if k.startswith(prefix)}
                if set(staged) == set(state):
                    state = {k: torch.from_numpy(np.array(staged[k])).to(
                        v.device) for k, v in state.items()}
                    log(f"Optimizer state restored for trainer '{label}'")
                else:
                    warn(f"No matching optimizer state for trainer "
                         f"'{label}' in the checkpoint; reinitializing")
            self._updates[label] = update
            self._opt_states[label] = state
        return label, self._updates[label], self._opt_states[label]

    def train_on_batch(self, trainer, dataset_batch,
                       batch_size: int) -> Dict[str, float]:
        """One training step on a dataset batch; losses as floats."""
        batch, _ = self.build_batch(dataset_batch, batch_size, train=True)
        return {name: float(value) for name, value in
                self.train_on_prepared(trainer, batch).items()}

    def train_on_prepared(self, trainer, batch: Dict[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
        """One training step on a device-resident batch: loss, backward,
        clipping and the in-place update (``_get_train_fn``'s step).
        The returned losses, gradient norm and ``target_tokens`` stay
        on the device; the training loop syncs them once per logging
        window."""
        _, update, state = self._optimizer(trainer)
        flat = flatten_tree(self.params)
        for p in flat.values():
            p.grad = None
            p.requires_grad_(True)
        rng = fold_seed(self.seed, self.global_step)
        total, losses = trainer.total_loss(self.params, batch, rng)
        total.backward()
        grads = {name: (p.grad if p.grad is not None and
                        trainer.is_trainable(name)
                        else torch.zeros_like(p))
                 for name, p in flat.items()}
        norm = update.apply(flat, grads, state)
        for p in flat.values():
            p.grad = None
        out = {name: value.detach() for name, value in losses.items()}
        out["loss"] = total.detach()
        out["grad_norm"] = norm
        mask_keys = [k for k in batch if k.endswith("train_mask")]
        if mask_keys:
            out["target_tokens"] = sum(batch[k].sum() for k in mask_keys)
        self.global_step += 1
        return out

    # ------------------------------------------------------------------ #
    # inference
    # ------------------------------------------------------------------ #
    def run_on_batch(self, runners, dataset_batch, batch_size: int
                     ) -> List[ExecutionResult]:
        """Every runner's fetches on one batch, collected on the host."""
        batch, real_size = self.build_batch(dataset_batch, batch_size)
        with torch.inference_mode():
            ctx = Context(self.params, batch, train=False)
            fetched = [runner.fetches(ctx) for runner in runners]
        return [runner.collect_results(
                    {k: v.cpu().numpy() for k, v in out.items()}, real_size)
                for runner, out in zip(runners, fetched)]

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
        on), and write the optimizer state to ``<path>.opt``."""
        step = step if step is not None else self.global_step
        ckpt_path = f"{path}-{step}"
        save_tree(ckpt_path, self.params,
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
        self.save_optimizer_state(path)
        log(f"Checkpoint saved to {ckpt_path}")
        return ckpt_path

    def save_optimizer_state(self, path: str) -> None:
        """Every trainer's optimizer state, in the port's own keys
        (``<trainer label>/<state>/<parameter>``), to ``<path>.opt``."""
        combined = {f"{label}/{name}": value.detach().cpu().numpy()
                    for label, state in self._opt_states.items()
                    for name, value in state.items()}
        if not combined:
            return
        opt_path = f"{path}.opt"
        with open(opt_path + ".tmp", "wb") as f:
            np.savez(f, **combined)
        os.replace(opt_path + ".tmp", opt_path)

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
            tmp_link = link + ".tmp"
            if os.path.lexists(tmp_link):
                os.remove(tmp_link)
            os.symlink(os.path.basename(ckpt_path), tmp_link)
            os.replace(tmp_link, link)
            log(f"New best score {score:.4g}; {link} -> {ckpt_path}",
                color="green")
        return is_better
