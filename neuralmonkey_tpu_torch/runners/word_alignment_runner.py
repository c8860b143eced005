"""Word-alignment runner (counterpart of
``neuralmonkey_tpu/runners/word_alignment_runner.py``, reference
nm/runners/word_alignment_runner.py): dumps attention/alignment
matrices."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..model.part import Context
from .base_runner import BaseRunner, ExecutionResult


class WordAlignmentRunner(BaseRunner):

    def __init__(self, output_series: str, attention=None,
                 decoder=None, alignment_decoder=None) -> None:
        target = alignment_decoder if alignment_decoder is not None \
            else decoder
        super().__init__(output_series, target)
        self.attention = attention

    def fetches(self, ctx: Context) -> Dict:
        if hasattr(self.decoder, "alignment"):
            matrix = self.decoder.alignment(ctx)
        else:
            matrix = self.decoder.train_attention_weights(ctx)[0]
        return {"alignment": matrix}

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        matrices = np.asarray(fetched["alignment"])[:num_examples]
        return ExecutionResult(outputs=list(matrices), losses={},
                               size=num_examples)
