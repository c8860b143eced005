"""The training loop, batched inference and evaluation (counterpart of
``neuralmonkey_tpu/learning_utils.py``).

``training_loop`` runs epochs of train steps with periodic logging and
validation: every runner over the validation set(s), postprocessing,
evaluators, the best-checkpoint link and, for runners with
``visualize_attention``, attention maps at each new best. Metrics go to
``<output>/metrics.jsonl`` and a TensorBoard events file. In a process
group every rank trains and validates (validation reaches collectives);
process 0 alone writes the metrics, outputs and maps."""

from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .dataset import BatchingScheme, Dataset
from .logging import log, log_print, warn
from .parallel.distributed import (broadcast_flags, is_main_process,
                                   process_count)
from .runners.base_runner import ExecutionResult
from .utils.png import png_bytes, write_png

_TIME_PERIOD = re.compile(r"^(\d+(\.\d+)?)([smhd])$")
_UNIT_SECONDS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def _sync_losses(step_losses: List[Dict[str, torch.Tensor]]
                 ) -> List[Dict[str, float]]:
    """A logging window's device-scalar losses as host floats, from one
    stacked device-to-host copy rather than one wait per scalar."""
    flat = [value for losses in step_losses for value in losses.values()]
    if not flat:
        return [{} for _ in step_losses]
    values = torch.stack([v.float().reshape(()) for v in flat]).tolist()
    out, i = [], 0
    for losses in step_losses:
        out.append(dict(zip(losses, values[i:i + len(losses)])))
        i += len(losses)
    return out


def _parse_period(period) -> Tuple[Optional[int], Optional[float]]:
    """(steps, seconds) of a period; exactly one is set."""
    if period is None:
        return None, None
    if isinstance(period, int):
        return period, None
    match = _TIME_PERIOD.match(str(period))
    if not match:
        raise ValueError(f"Cannot parse period '{period}'")
    return None, float(match.group(1)) * _UNIT_SECONDS[match.group(3)]


class MetricsWriter:
    """``metrics.jsonl`` records, mirrored to a TensorBoard events file
    (``utils/tensorboard.py``)."""

    def __init__(self, output_dir: Optional[str]) -> None:
        self.output_dir = output_dir
        self.path = (os.path.join(output_dir, "metrics.jsonl")
                     if output_dir else None)
        self._events = None

    def write(self, kind: str, step: int, values: Dict[str, float]
              ) -> None:
        if self.path is None or not is_main_process():
            return
        record = {"kind": kind, "step": step, "time": time.time()}
        record.update({k: float(v) for k, v in values.items()})
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
        self._event_writer().add_scalars(
            step, {f"{kind}/{k}": float(v) for k, v in values.items()})

    def _event_writer(self):
        if self._events is None:
            from .utils.tensorboard import EventFileWriter
            self._events = EventFileWriter(self.output_dir)
        return self._events

    def write_image(self, step: int, tag: str, matrix) -> None:
        """A 2-D array as a TensorBoard image summary (a PNG heatmap)."""
        if self.output_dir is None or not is_main_process():
            return
        data, height, width = png_bytes(np.asarray(matrix))
        self._event_writer().add_image(step, tag, data, height, width)


def normalize_evaluation(evaluation: Optional[Sequence]
                         ) -> List[Tuple[str, str, Any]]:
    """[main] evaluation entries as (hypothesis series, reference
    series, evaluator)."""
    normalized = []
    for entry in evaluation or []:
        if not isinstance(entry, (tuple, list)) or len(entry) not in (2, 3):
            raise ValueError(f"Bad evaluation entry: {entry!r}")
        if len(entry) == 2:
            series, evaluator = entry
            normalized.append((series, series, evaluator))
        else:
            normalized.append(tuple(entry))
    return normalized


def run_on_dataset(tf_manager, runners, dataset: Dataset,
                   postprocess=None,
                   batching_scheme: BatchingScheme = None,
                   write_out: bool = False
                   ) -> Tuple[List[ExecutionResult], Dict[str, List]]:
    """Run all runners over a dataset; returns (results, outputs)."""
    if batching_scheme is None:
        batching_scheme = BatchingScheme(batch_size=16)
    results = tf_manager.execute(
        dataset, runners, batch_size=batching_scheme.batch_size or 16,
        batching_scheme=batching_scheme)
    outputs: Dict[str, List] = {
        runner.output_series: result.outputs
        for runner, result in zip(runners, results)}

    for series_name, function in postprocess or []:
        source = outputs.get(series_name)
        if source is None:
            warn(f"Postprocess source series '{series_name}' "
                 "not produced by any runner")
            continue
        # dataset-aware postprocessors declare a source_id and receive
        # (dataset item, output) pairs; plain ones the output list
        src_id = getattr(function, "source_id", None)
        if src_id is not None:
            outputs[series_name] = [
                function((src, out)) for src, out
                in zip(dataset.get_series(src_id), source)]
        else:
            outputs[series_name] = function(source)

    if write_out and is_main_process():
        for series_name, data in outputs.items():
            if series_name not in dataset.series_outputs:
                log(f"No output file for series '{series_name}'")
                continue
            path = dataset.series_outputs[series_name]
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                for item in data:
                    if isinstance(item, list):
                        f.write(" ".join(str(t) for t in item) + "\n")
                    else:
                        f.write(str(item) + "\n")
            log(f"Series '{series_name}' written to {path}")
    return results, outputs


def evaluation(evaluators: List[Tuple[str, str, Any]], dataset: Dataset,
               execution_results: List[ExecutionResult],
               outputs: Dict[str, List]) -> Dict[str, float]:
    """Compute all metrics; also surfaces runner losses."""
    eval_result: Dict[str, float] = {}
    for result in execution_results:
        eval_result.update(result.losses)
    for hyp_series, ref_series, evaluator in evaluators:
        if hyp_series in outputs and dataset.has_series(ref_series):
            eval_result[f"{hyp_series}/{evaluator.name}"] = evaluator(
                outputs[hyp_series], dataset.get_series(ref_series))
    return eval_result


def _main_metric_name(evaluation) -> Optional[str]:
    if not evaluation:
        return None
    hyp, _, evaluator = evaluation[-1]
    return f"{hyp}/{evaluator.name}"


def validation_score(eval_result: Dict[str, float],
                     main_metric: Optional[str],
                     minimize_metric: bool) -> Optional[float]:
    """The score the best checkpoint is tracked by: the main metric, or
    the runtime cross-entropy in the manager's direction, or None."""
    score = eval_result.get(main_metric) if main_metric else None
    if score is not None:
        return score
    xent = eval_result.get("runtime_xent")
    if xent is None:
        return None
    return xent if minimize_metric else -xent


def _format_eval(eval_result: Dict[str, float]) -> str:
    return "    ".join(f"{name}: {value:.4g}"
                       for name, value in sorted(eval_result.items()))


def training_loop(tf_manager,
                  epochs: int,
                  trainer,
                  batching_scheme: BatchingScheme,
                  runners_batching_scheme: BatchingScheme,
                  train_dataset: Dataset,
                  val_datasets: List[Dataset],
                  evaluation_spec,
                  runners,
                  test_datasets: List[Dataset] = None,
                  logging_period=20,
                  validation_period=500,
                  postprocess=None,
                  output_dir: str = None) -> None:
    """The main training driver (``learning_utils.training_loop``)."""
    evaluators = normalize_evaluation(evaluation_spec)
    main_metric = _main_metric_name(evaluators)
    metrics = MetricsWriter(output_dir)
    if output_dir is None:
        raise ValueError("training needs [main] output")
    var_path = os.path.join(output_dir, "variables.data")
    log_steps, log_seconds = _parse_period(logging_period)
    val_steps, val_seconds = _parse_period(validation_period)
    last_log_time = last_val_time = time.time()
    interrupted = False
    # wall-clock periods differ between processes, and validation
    # reaches collectives: process 0's decisions are broadcast each step
    # (step periods agree everywhere on their own)
    sync_periods = process_count() > 1 and bool(log_seconds or val_seconds)
    if sync_periods:
        warn("Time-based logging/validation periods under multi-process "
             "execution broadcast process 0's decision every step; "
             "prefer step-count periods")
    log(f"Starting training: {epochs} epochs, main metric: "
        f"{main_metric or 'loss'}")

    def validate(step: int, epoch: int) -> None:
        for vi, val_dataset in enumerate(val_datasets):
            results, outputs = run_on_dataset(
                tf_manager, runners, val_dataset, postprocess,
                batching_scheme=runners_batching_scheme)
            eval_result = evaluation(evaluators, val_dataset, results,
                                     outputs)
            tag = "val" if len(val_datasets) == 1 else f"val{vi}"
            log(f"Validation ({tag}) step {step}: "
                f"{_format_eval(eval_result)}", color="blue")
            metrics.write(tag, step, eval_result)
            if vi < len(val_datasets) - 1:
                continue
            score = validation_score(eval_result, main_metric,
                                     tf_manager.minimize_metric)
            if score is None:
                warn(f"Validation produced neither '{main_metric}' nor "
                     "'runtime_xent'; best-checkpoint tracking skipped")
                continue
            if tf_manager.validation_hook(score, step, epoch, var_path):
                _log_examples(val_dataset, outputs, evaluators)
                _write_attention_maps(results, output_dir, step,
                                      metrics=metrics)

    step_losses: List[Dict[str, torch.Tensor]] = []
    window_start = time.time()
    window_examples = 0

    def flush_log_window(epoch: int, step: int) -> None:
        """Sync the window's losses in one transfer and log one train
        record (tokens/s from the steps' device-side token counts)."""
        nonlocal step_losses, window_start, window_examples
        if not step_losses:
            return
        synced = _sync_losses(step_losses)
        tokens = sum(losses.pop("target_tokens", 0.0)
                     for losses in synced)
        mean_losses = {
            key: float(np.mean([losses[key] for losses in synced
                                if key in losses]))
            for key in synced[-1]}
        elapsed = max(time.time() - window_start, 1e-6)
        mean_losses["examples_per_sec"] = window_examples / elapsed
        mean_losses["tokens_per_sec"] = float(tokens) / elapsed
        log(f"Epoch {epoch} step {step}: {_format_eval(mean_losses)}")
        metrics.write("train", step, mean_losses)
        step_losses = []
        window_start = time.time()
        window_examples = 0

    try:
        for epoch in range(1, epochs + 1):
            tf_manager.epoch = epoch
            log_print("")
            log(f"Epoch {epoch} begins", color="red")
            batch_size = batching_scheme.batch_size or 16
            for batch, real_size in tf_manager.iter_prepared_batches(
                    train_dataset, batching_scheme, batch_size,
                    train=True):
                # losses stay on the device until the window is logged
                step_losses.append(
                    tf_manager.train_on_prepared(trainer, batch))
                step = tf_manager.global_step
                window_examples += real_size
                now = time.time()
                should_log = bool(
                    (log_steps and step % log_steps == 0)
                    or (log_seconds and now - last_log_time > log_seconds))
                should_val = bool(
                    (val_steps and step % val_steps == 0)
                    or (val_seconds and now - last_val_time > val_seconds))
                if sync_periods:
                    should_log, should_val = broadcast_flags(
                        (should_log, should_val))
                if should_log:
                    flush_log_window(epoch, step)
                    last_log_time = time.time()
                if val_datasets and should_val:
                    validate(step, epoch)
                    last_val_time = time.time()
    except KeyboardInterrupt:
        interrupted = True
        warn("Training interrupted by user; saving variables")

    flush_log_window(tf_manager.epoch, tf_manager.global_step)
    if val_datasets and not interrupted:
        validate(tf_manager.global_step, tf_manager.epoch)
    tf_manager.save(var_path)  # also writes the optimizer state
    log(f"Training finished. Best score: {tf_manager.best_score} "
        f"(step {tf_manager.best_score_step}, "
        f"epoch {tf_manager.best_score_epoch})", color="green")

    if test_datasets:
        if os.path.exists(var_path + ".best"):
            tf_manager.restore_best_vars(output_dir)
        for test_dataset in test_datasets:
            results, outputs = run_on_dataset(
                tf_manager, runners, test_dataset, postprocess,
                batching_scheme=runners_batching_scheme, write_out=True)
            print_final_evaluation(test_dataset.name, evaluation(
                evaluators, test_dataset, results, outputs))


def _log_examples(dataset: Dataset, outputs: Dict[str, List],
                  evaluators, limit: int = 5) -> None:
    if not evaluators:
        return
    hyp_series, ref_series, _ = evaluators[-1]
    if hyp_series not in outputs or not dataset.has_series(ref_series):
        return
    refs = dataset.get_series(ref_series)
    log_print("Examples:")
    for i, hyp in enumerate(outputs[hyp_series][:limit]):
        ref = refs[i]
        log_print("  [{}] out: {}".format(
            i, " ".join(hyp) if isinstance(hyp, list) else hyp))
        log_print("      ref: {}".format(
            " ".join(ref) if isinstance(ref, list) else ref))


def _write_attention_maps(results: List[ExecutionResult],
                          output_dir: Optional[str], step: int,
                          limit: int = 3,
                          metrics: Optional[MetricsWriter] = None) -> None:
    """The first examples' attention maps of the first runner that
    fetched them (``visualize_attention``), as PNG heatmaps in
    ``<output>/attention_maps/step<step>_ex<i>.png`` and, with
    ``metrics``, as image summaries in the events file."""
    if output_dir is None or not is_main_process():
        return
    for result in results:
        maps = (result.aux or {}).get("attention")
        if maps is None:
            continue
        directory = os.path.join(output_dir, "attention_maps")
        os.makedirs(directory, exist_ok=True)
        for i, matrix in enumerate(maps[:limit]):
            write_png(os.path.join(directory, f"step{step}_ex{i}.png"),
                      np.asarray(matrix))
            if metrics is not None:
                metrics.write_image(step, f"attention/ex{i}", matrix)
        log(f"Attention maps written to {directory}")
        break


def print_final_evaluation(name: str,
                           eval_result: Dict[str, float]) -> None:
    log_print("")
    log(f"Evaluating model on '{name}'")
    for metric, value in sorted(eval_result.items()):
        log_print(f"... {metric:<25} {value:.4g}")
    log_print("")
