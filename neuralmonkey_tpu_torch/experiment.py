"""Experiment orchestration (counterpart of
``neuralmonkey_tpu/experiment.py``): the output directory and its
provenance copies, model building, training and batch inference. The
``[main]`` arguments are the JAX package's, so its experiment INI files
load unchanged."""

from __future__ import annotations

import os
import random
import shutil
from typing import Any, List, Optional

import numpy as np

from .checking import check_dataset_and_coders, check_series_collisions
from .config.configuration import Configuration
from .dataset import BatchingScheme, Dataset
from .learning_utils import (evaluation, normalize_evaluation,
                             print_final_evaluation, run_on_dataset,
                             training_loop)
from .logging import Logging, log, warn
from .parallel import distributed
from .ops.policy import set_compute_dtype
from .runtime import CUDAManager
from .trainers.multitask_trainer import MultitaskTrainer

# the JAX package's [main] arguments (neuralmonkey_tpu/experiment.py
# _TRAIN_ARGS): (name, required when training, default)
_MAIN_ARGS = [
    ("name", False, "translation"),
    ("output", True, None),
    ("epochs", True, None),
    ("batch_size", False, 16),
    ("batching_scheme", False, None),
    ("train_dataset", True, None),
    ("val_dataset", False, None),
    ("val_datasets", False, None),
    ("trainer", True, None),
    ("runners", True, None),
    ("evaluation", False, []),
    ("postprocess", False, None),
    ("runners_batch_size", False, None),
    ("logging_period", False, 20),
    ("validation_period", False, 500),
    ("test_datasets", False, None),
    ("initial_variables", False, None),
    ("overwrite_output_dir", False, False),
    ("random_seed", False, 2574600),
    ("tf_manager", False, None),
    ("visualize_embeddings", False, None),
    ("minimize", False, None),
    ("compute_dtype", False, None),
    ("compilation_cache", False, True),
    ("compilation_cache_dir", False, None),
]


class Experiment:

    def __init__(self, config_path: str,
                 train_mode: bool = True,
                 overwrite_output_dir: bool = False,
                 config_changes: Optional[List[str]] = None) -> None:
        self.config_path = config_path
        self.config_changes = list(config_changes or [])
        self.train_mode = train_mode
        self.cont_index = -1
        self.config = Configuration()
        for name, required, default in _MAIN_ARGS:
            self.config.add_argument(name, required=required and train_mode,
                                     default=default)
        self.config.load_file(config_path, config_changes)
        if overwrite_output_dir:
            self.config.config_dict.setdefault("main", {})
            self.config.config_dict["main"]["overwrite_output_dir"] = True
        self.output_dir = self.config.config_dict.get("main", {}).get(
            "output")
        self.model: Any = None
        self.tf_manager: Optional[CUDAManager] = None

    # ------------------------------------------------------------------ #
    def _setup_output_dir(self) -> None:
        """Make the output directory, or index a continuation run's
        artifacts (``*.cont-N``) when it holds variables and may not be
        overwritten; copy the INI there and log to ``experiment.log``.
        In a process group every rank reads the directory before
        process 0 writes the INI copies; rank ``i > 0`` logs to
        ``experiment.log.p<i>``."""
        if os.path.isdir(self.output_dir):
            has_vars = any(name.startswith("variables.data")
                           for name in os.listdir(self.output_dir))
            overwrite = self.config.config_dict["main"].get(
                "overwrite_output_dir") in (True, "True")
            if has_vars and not overwrite:
                self.cont_index = 1
                while os.path.exists(os.path.join(
                        self.output_dir,
                        f"experiment.ini.cont-{self.cont_index}")):
                    self.cont_index += 1
        else:
            os.makedirs(self.output_dir, exist_ok=True)
        distributed.sync_processes("nm_output_dir")
        suffix = f".cont-{self.cont_index}" if self.cont_index > 0 else ""
        if distributed.is_main_process():
            ini_copy = os.path.join(self.output_dir,
                                    f"experiment.ini{suffix}")
            if self.config_changes:
                # the effective config, with the command line's overrides
                from .config.parsing import write_file
                write_file(self.config.raw_config, ini_copy)
                shutil.copyfile(self.config_path, os.path.join(
                    self.output_dir, f"experiment.orig.ini{suffix}"))
            else:
                shutil.copyfile(self.config_path, ini_copy)
        rank = distributed.process_index()
        Logging.set_log_file(os.path.join(
            self.output_dir,
            f"experiment.log{suffix}" + (f".p{rank}" if rank else "")))

    # ------------------------------------------------------------------ #
    def build_model(self) -> None:
        if self.model is not None:
            return
        self.config.build_model(warn_unused=self.train_mode)
        model = self.config.model
        # the compute-precision policy (ops/policy.py): the INI's key, or
        # NM_COMPUTE_DTYPE when the INI has none
        set_compute_dtype(getattr(model, "compute_dtype", None))
        seed = getattr(model, "random_seed", None) or 2574600
        random.seed(seed)
        np.random.seed(seed)
        self.tf_manager = getattr(model, "tf_manager", None) or CUDAManager()
        if getattr(model, "minimize", None) is not None:
            self.tf_manager.minimize_metric = bool(model.minimize)
        roots: List[Any] = []
        trainer = getattr(model, "trainer", None)
        if trainer is not None:
            roots.extend(trainer if isinstance(trainer, list) else [trainer])
        roots.extend(model.runners or [])
        self.tf_manager.initialize_model_parts(roots, seed=seed)
        if getattr(model, "initial_variables", None):
            self.tf_manager.restore(model.initial_variables)
        check_series_collisions(model.runners)
        self.model = model

    # ------------------------------------------------------------------ #
    def train(self) -> None:
        if not self.train_mode:
            raise RuntimeError("train() needs train_mode=True")
        self._setup_output_dir()
        self.build_model()
        model = self.model
        trainer = model.trainer
        if isinstance(trainer, list):
            trainer = (MultitaskTrainer(trainer) if len(trainer) > 1
                       else trainer[0])
        if self.cont_index > 0:
            latest = self._latest_checkpoint()
            if latest:
                self.tf_manager.restore([latest])
                self.tf_manager.load_optimizer_state(
                    os.path.join(self.output_dir, "variables.data"))
                log(f"Continuation run: restored {latest}")

        val_datasets: List[Dataset] = []
        if model.val_dataset is not None:
            vd = model.val_dataset
            val_datasets.extend(vd if isinstance(vd, list) else [vd])
        if model.val_datasets:
            val_datasets.extend(model.val_datasets)
        check_dataset_and_coders(model.train_dataset, self.tf_manager.parts)
        for vd in val_datasets:
            check_dataset_and_coders(vd, self.tf_manager.parts)

        training_loop(
            tf_manager=self.tf_manager,
            epochs=model.epochs,
            trainer=trainer,
            batching_scheme=model.batching_scheme or BatchingScheme(
                batch_size=model.batch_size),
            runners_batching_scheme=BatchingScheme(
                batch_size=model.runners_batch_size or model.batch_size),
            train_dataset=model.train_dataset,
            val_datasets=val_datasets,
            evaluation_spec=model.evaluation,
            runners=model.runners,
            test_datasets=model.test_datasets,
            logging_period=model.logging_period,
            validation_period=model.validation_period,
            postprocess=model.postprocess,
            output_dir=self.output_dir)

        if model.visualize_embeddings:
            self._write_embedding_projections(model.visualize_embeddings)

    def _write_embedding_projections(self, sequences) -> None:
        """``[main] visualize_embeddings``: for each embedded sequence,
        ``<output>/<name>_embeddings.tsv`` (one vector a row) and
        ``<name>_metadata.tsv`` (the vocabulary's tokens), the files
        TensorBoard's embedding projector loads; the same files as the
        JAX package's. Written by process 0 (under fsdp or model shards
        every rank gathers the tables)."""
        sequences = (sequences if isinstance(sequences, list)
                     else [sequences])
        manager = self.tf_manager
        split = (getattr(manager, "fsdp", False)
                 or getattr(manager, "mesh", None) is not None
                 and manager.mesh.size("model") > 1)
        params = manager.whole_params() if split else manager.params
        if not distributed.is_main_process():
            return
        for seq in sequences:
            table = params.get(seq.param_key, {}).get("embeddings")
            if table is None:
                warn(f"visualize_embeddings: part '{seq.name}' has no "
                     "embeddings table; skipped")
                continue
            table = table.detach().float().cpu().numpy()
            vec_path = os.path.join(self.output_dir,
                                    f"{seq.name}_embeddings.tsv")
            meta_path = os.path.join(self.output_dir,
                                     f"{seq.name}_metadata.tsv")
            with open(vec_path, "w", encoding="utf-8") as f:
                for row in table:
                    f.write("\t".join(f"{x:.6g}" for x in row) + "\n")
            with open(meta_path, "w", encoding="utf-8") as f:
                for token in seq.vocabulary.index_to_word:
                    f.write(token + "\n")
            log(f"Embedding projection for '{seq.name}' written to "
                f"{vec_path}")

    # ------------------------------------------------------------------ #
    def restore_variables(self, paths: Optional[List[str]] = None,
                          average: bool = False) -> None:
        """Load checkpoints (several: a logit ensemble, or with
        ``average`` their averaged parameters); with no path, the newest
        ``variables.data*`` of the output directory."""
        self.build_model()
        if not paths:
            latest = self._latest_checkpoint()
            if latest is None:
                raise FileNotFoundError(
                    f"No checkpoint found in {self.output_dir}")
            paths = [latest]
        self.tf_manager.restore(paths, average=average)

    def _latest_checkpoint(self) -> Optional[str]:
        if not self.output_dir or not os.path.isdir(self.output_dir):
            return None
        steps = sorted(
            (name for name in os.listdir(self.output_dir)
             if name.startswith("variables.data-")
             and not name.endswith(".json")),
            key=lambda n: int(n.rsplit("-", 1)[-1]))
        if steps:
            return os.path.join(self.output_dir, steps[-1])
        best = os.path.join(self.output_dir, "variables.data.best")
        return best if os.path.exists(best) else None

    def run_model(self, dataset: Dataset, write_out: bool = False,
                  batch_size: int = None):
        """Batch inference over ``dataset``; returns (results, outputs)."""
        self.build_model()
        model = self.model
        check_dataset_and_coders(dataset, self.tf_manager.parts)
        scheme = BatchingScheme(
            batch_size=batch_size or model.runners_batch_size
            or model.batch_size or 16)
        results, outputs = run_on_dataset(
            self.tf_manager, model.runners, dataset,
            postprocess=model.postprocess, batching_scheme=scheme,
            write_out=write_out)
        eval_result = evaluation(normalize_evaluation(model.evaluation),
                                 dataset, results, outputs)
        if eval_result:
            print_final_evaluation(dataset.name, eval_result)
        return results, outputs
