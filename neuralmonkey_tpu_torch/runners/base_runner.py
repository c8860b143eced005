"""Runner protocol (counterpart of
``neuralmonkey_tpu/runners/base_runner.py``).

A runner declares *fetches* over a forward Context, computed on the
device, and a host-side *collect* that turns the fetched arrays into
output series items. Decoding loops run on the device, so one fetch
per batch suffices.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..model.part import Context


class ExecutionResult(NamedTuple):
    """Per-batch result."""
    outputs: List[Any]                 # one item per example
    losses: Dict[str, float]           # name -> scalar (batch mean)
    size: int                          # number of real examples
    aux: Optional[Dict[str, np.ndarray]] = None


def reduce_execution_results(results: List[ExecutionResult]
                             ) -> ExecutionResult:
    """Concatenate outputs, size-weighted-average losses."""
    outputs: List[Any] = []
    total = 0
    loss_sums: Dict[str, float] = {}
    aux_items: Dict[str, List[Any]] = {}
    for result in results:
        outputs.extend(result.outputs)
        total += result.size
        for name, value in result.losses.items():
            loss_sums[name] = loss_sums.get(name, 0.0) \
                + float(value) * result.size
        for name, value in (result.aux or {}).items():
            aux_items.setdefault(name, []).append(value)
    losses = {name: value / max(total, 1)
              for name, value in loss_sums.items()}
    # aux arrays may have batch-dependent trailing shapes (bucketed time
    # axes), so they stay lists of per-example rows
    aux = ({name: [row for chunk in chunks for row in chunk]
            for name, chunks in aux_items.items()}
           if aux_items else None)
    return ExecutionResult(outputs=outputs, losses=losses, size=total,
                           aux=aux)


class BaseRunner:
    """Base runner bound to one decoder-like part."""

    def __init__(self, output_series: str, decoder) -> None:
        self.output_series = output_series
        self.decoder = decoder

    @property
    def all_parts(self):
        return [self.decoder]

    @property
    def loss_names(self) -> List[str]:
        return []

    def fetches(self, ctx: Context) -> Dict[str, torch.Tensor]:
        """Tensors to fetch for one batch."""
        raise NotImplementedError

    def collect_results(self, fetched: Dict[str, np.ndarray],
                        num_examples: int) -> ExecutionResult:
        """Host side: fetched numpy arrays -> outputs and losses."""
        raise NotImplementedError
