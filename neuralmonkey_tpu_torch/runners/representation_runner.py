"""Representation runner (counterpart of
``neuralmonkey_tpu/runners/representation_runner.py``, reference
nm/runners/representation_runner.py): an encoder's output vectors
(sentence embeddings).

``used_session`` picked one model of the reference's TensorFlow
sessions. The JAX package accepts it and ignores it, so with a
checkpoint ensemble it reads the first parameter set whatever the value;
the port reads the first set too and refuses any other value rather
than ignoring it."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..model.part import Context
from .base_runner import BaseRunner, ExecutionResult


class RepresentationRunner(BaseRunner):

    def __init__(self, output_series: str, encoder,
                 used_session: int = 0) -> None:
        super().__init__(output_series, encoder)
        if used_session != 0:
            raise ValueError(
                f"used_session={used_session!r}: the representation runner "
                "reads the first parameter set only (used_session=0)")
        self.encoder = encoder

    def fetches(self, ctx: Context) -> Dict:
        return {"representation": self.encoder.output(ctx)}

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        vectors = np.asarray(fetched["representation"])[:num_examples]
        return ExecutionResult(outputs=list(vectors), losses={},
                               size=num_examples)
