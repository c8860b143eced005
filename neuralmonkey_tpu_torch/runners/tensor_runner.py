"""Tensor runner (counterpart of
``neuralmonkey_tpu/runners/tensor_runner.py``, reference
nm/runners/tensor_runner.py): named model tensors for debugging and
analysis. A tensor is named ``part_name.method`` (a Context method of
the part; ``part_name`` alone is its ``output``) or
``part_name.params.sub.path`` (one of its parameters)."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..model.part import Context, ModelPart
from .base_runner import BaseRunner, ExecutionResult


class TensorRunner(BaseRunner):

    def __init__(self, output_series: str,
                 modelparts: List[ModelPart],
                 tensors: List[str],
                 batch_dims: List[int] = None,
                 tensors_by_name: List[str] = None,
                 batch_dims_by_name: List[int] = None,
                 single_tensor: bool = False) -> None:
        super().__init__(output_series,
                         modelparts[0] if modelparts else None)
        self.modelparts = modelparts
        self.tensor_names = list(tensors) + list(tensors_by_name or [])
        self.batch_dims = (list(batch_dims or [])
                           + list(batch_dims_by_name or []))
        if not self.batch_dims:
            self.batch_dims = [0] * len(self.tensor_names)
        self.single_tensor = single_tensor
        self._parts_by_name = {p.name: p for p in modelparts}

    @property
    def all_parts(self):
        return list(self.modelparts)

    def _resolve(self, ctx: Context, name: str):
        part_name, _, rest = name.partition(".")
        part = self._parts_by_name.get(part_name)
        if part is None:
            raise KeyError(f"TensorRunner: unknown part '{part_name}'")
        if rest.startswith("params"):
            node = ctx.get_params(part)
            for key in rest.split(".")[1:]:
                node = node[int(key) if key.isdigit() else key]
            return node
        return getattr(part, rest or "output")(ctx)

    @property
    def fetch_batch_dims(self) -> Dict[str, int]:
        """Each fetch's batch axis, along which a batch split over
        data-parallel ranks is gathered."""
        return dict(zip(self.tensor_names, self.batch_dims))

    def fetches(self, ctx: Context) -> Dict:
        return {name: self._resolve(ctx, name)
                for name in self.tensor_names}

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        outputs = []
        for i in range(num_examples):
            item = {name: np.take(np.asarray(fetched[name]), i,
                                  axis=batch_dim)
                    for name, batch_dim in zip(self.tensor_names,
                                               self.batch_dims)}
            if self.single_tensor and len(item) == 1:
                outputs.append(next(iter(item.values())))
            else:
                outputs.append(item)
        return ExecutionResult(outputs=outputs, losses={},
                               size=num_examples)
