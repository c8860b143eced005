"""Post-build model sanity checks (reference nm/checking.py)."""

from __future__ import annotations

from typing import List

from .dataset import Dataset
from .logging import warn


class CheckingException(Exception):
    pass


def check_dataset_and_coders(dataset: Dataset, parts) -> None:
    """Every part that reads a dataset series must find it."""
    missing = []
    for part in parts:
        if getattr(part, "table_only", False):
            continue  # embedding tables never read dataset series
        data_ids: List[str] = []
        if hasattr(part, "data_id") and part.data_id:
            data_ids.append(part.data_id)
        if hasattr(part, "data_ids") and part.data_ids:
            data_ids.extend(part.data_ids)
        for data_id in data_ids:
            if not dataset.has_series(data_id):
                missing.append((part.name, data_id))
    if missing:
        # decoders' target series may legitimately be absent at
        # inference; warn rather than fail for those
        hard = [(n, s) for n, s in missing
                if not hasattr_decoder(n, parts)]
        for name, series in missing:
            warn(f"Part '{name}' expects series '{series}' missing from "
                 f"dataset '{dataset.name}'")
        if hard:
            raise CheckingException(
                f"Dataset '{dataset.name}' is missing series required "
                f"by: {hard}")


def hasattr_decoder(name: str, parts) -> bool:
    """True for parts that can produce outputs without their target
    series (anything with a decode path) — their data_id is a TARGET,
    legitimately absent at inference time."""
    for part in parts:
        if part.name == name:
            return (hasattr(part, "train_logits")
                    or hasattr(part, "decode_step")
                    or hasattr(part, "decoded"))
    return False


def check_series_collisions(runners, dataset: Dataset = None) -> None:
    """No two runners may write the same output series."""
    series = set()
    for runner in runners:
        out = runner.output_series
        if out in series:
            raise CheckingException(
                f"Output series '{out}' is produced by two runners")
        series.add(out)
