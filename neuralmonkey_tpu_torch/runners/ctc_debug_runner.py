"""CTC debug runner (counterpart of
``neuralmonkey_tpu/runners/ctc_debug_runner.py``, reference
nm/runners/ctc_debug_runner.py): each frame's most likely symbol before
repeats and blanks collapse, the blank written as '_', up to the
encoder's temporal mask."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ..model.part import Context
from ..vocabulary import PAD_TOKEN_INDEX
from .base_runner import BaseRunner, ExecutionResult


class CTCDebugRunner(BaseRunner):

    def fetches(self, ctx: Context) -> Dict:
        return {"frames": self.decoder.logits(ctx).argmax(dim=-1),
                "mask": self.decoder.encoder.temporal_mask(ctx)}

    def collect_results(self, fetched: Dict[str, Any],
                        num_examples: int) -> ExecutionResult:
        frames = np.asarray(fetched["frames"])[:num_examples]
        mask = np.asarray(fetched["mask"])[:num_examples]
        vocabulary = self.decoder.vocabulary
        outputs = [["_" if int(i) == PAD_TOKEN_INDEX
                    else vocabulary.index_to_word[int(i)]
                    for i in row[:int(m.sum())]]
                   for row, m in zip(frames, mask)]
        return ExecutionResult(outputs=outputs, losses={},
                               size=num_examples)
