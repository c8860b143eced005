"""Batch inference CLI (counterpart of ``neuralmonkey_tpu/run.py``).

Usage: python -m neuralmonkey_tpu_torch.run exp.ini data.ini [ckpt ...]
           [--average] [--grid]

The data INI declares datasets (series and output files) under
``[main] test_datasets``. A checkpoint is an ``.npz`` file written by
either package; without one, the newest ``variables.data*`` of the
experiment's output directory is used. Several checkpoints decode as a
logit ensemble (each step's distributions averaged), or with
``--average`` as one parameter set, their average. On a machine with an
NVIDIA card the model runs there, through the hand-written kernels.

``--grid`` decodes token-aligned models (sequence labeling) over inputs
longer than the encoder's ``max_input_len``: each input is cut into
half-overlapping windows, each window is decoded, and every position
takes its label from the window whose center is nearest.

Under the launch contract of ``parallel/distributed.py`` every process
decodes its rows of each batch and process 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, List, Optional, Tuple

from .logging import log

from .config.configuration import Configuration
from .dataset import Dataset
from .experiment import Experiment
from .parallel import distributed


def load_data_config(path: str) -> List:
    config = Configuration()
    config.add_argument("test_datasets", required=False, default=None)
    config.add_argument("eval_datasets", required=False, default=None)
    config.load_file(path)
    config.build_model()
    datasets = (getattr(config.model, "test_datasets", None)
                or getattr(config.model, "eval_datasets", None))
    if datasets is None:
        raise ValueError(
            f"Data config {path} must define [main] test_datasets")
    return datasets if isinstance(datasets, list) else [datasets]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="neuralmonkey_tpu_torch.run",
        description="Run a trained model over datasets.")
    parser.add_argument("config", help="experiment INI file")
    parser.add_argument("datasets", help="data INI file")
    parser.add_argument("checkpoints", nargs="*",
                        help="checkpoint path(s); several = ensemble")
    parser.add_argument("--grid", action="store_true",
                        help="sliding-window grid decoding "
                             "(long inputs)")
    parser.add_argument("--average", action="store_true",
                        help="average the checkpoints into one "
                             "parameter set instead of running a "
                             "logit ensemble (1 forward pass vs K)")
    args = parser.parse_args(argv)

    # a process of a data-parallel run joins its group before anything
    # touches a device (a no-op without NM_COORDINATOR_ADDRESS or
    # NM_DISTRIBUTED)
    distributed.maybe_initialize()
    exp = Experiment(args.config, train_mode=False)
    exp.build_model()
    exp.restore_variables(args.checkpoints, average=args.average)
    for dataset in load_data_config(args.datasets):
        if args.grid:
            grid_decode(exp, dataset)
        else:
            exp.run_model(dataset, write_out=True)
    log("Done.")
    return 0


def _grid_windows(length: int, window: int
                  ) -> List[Tuple[int, int, int, int]]:
    """Half-overlapping windows covering [0, length), each with the span
    it labels: every position belongs to the window whose center is
    nearest. Returns (start, end, claim_start, claim_end) tuples."""
    if length <= window:
        return [(0, length, 0, length)]
    stride = max(window // 2, 1)
    starts = list(range(0, length - window + stride, stride))
    if starts[-1] + window < length:
        starts.append(length - window)
    starts[-1] = min(starts[-1], length - window)
    spans = []
    for i, start in enumerate(starts):
        end = min(start + window, length)
        claim_start = 0 if i == 0 else (start + starts[i - 1]
                                        + window) // 2
        claim_end = (length if i == len(starts) - 1
                     else (end + starts[i + 1]) // 2)
        spans.append((start, end, claim_start, claim_end))
    return spans


def grid_decode(exp: Experiment, dataset: Dataset) -> None:
    """Sliding-window decoding of a token-aligned (labeling) model: the
    windows of every sentence decode as one dataset, and each sentence's
    labels are stitched from its windows' claimed spans and written to
    the dataset's output file of the runner's series."""
    runners = exp.model.runners
    if len(runners) != 1:
        raise ValueError("--grid needs exactly one runner")
    runner = runners[0]
    encoder = getattr(runner.decoder, "encoder", None)
    window = getattr(encoder, "max_input_len", None)
    data_id = getattr(encoder, "data_id", None)
    if window is None or data_id is None:
        raise ValueError(
            "--grid needs a decoder whose encoder sets max_input_len "
            "and data_id (token-aligned labeling models)")

    sentences = dataset.get_series(data_id)
    window_items: List[List[str]] = []
    # per sentence: (window index, claimed span within the window)
    claims: List[List[Tuple[int, int, int]]] = []
    for sentence in sentences:
        claims.append([])
        for start, end, claim_start, claim_end in _grid_windows(
                len(sentence), window):
            claims[-1].append((len(window_items), claim_start - start,
                               claim_end - start))
            window_items.append(list(sentence[start:end]))

    _, outputs = exp.run_model(
        Dataset(f"{dataset.name}.grid", {data_id: window_items}),
        write_out=False)
    window_outputs = outputs[runner.output_series]
    stitched: List[List[Any]] = []
    for sentence, claim in zip(sentences, claims):
        merged: List[Any] = []
        for index, claim_start, claim_end in claim:
            merged.extend(window_outputs[index][claim_start:claim_end])
        stitched.append(merged[:len(sentence)])

    path = dataset.series_outputs.get(runner.output_series)
    if path is None:
        log(f"No output file for series '{runner.output_series}'")
        return
    with open(path, "w", encoding="utf-8") as f:
        for item in stitched:
            f.write(" ".join(str(t) for t in item) + "\n")
    log(f"Series '{runner.output_series}' (grid-decoded) written to {path}")


if __name__ == "__main__":
    sys.exit(main())
