"""Word-alignment decoder (counterpart of
``neuralmonkey_tpu/models/decoders/word_alignment_decoder.py``,
reference nm/decoders/word_alignment_decoder.py): trains a parent
decoder's attention matrix against reference alignments with a
cross-entropy objective over per-target-token source distributions."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ...model.part import Context, ModelPart, tensor
from ...processors.alignment import WordAlignmentPreprocessor


class WordAlignmentDecoder(ModelPart):

    def __init__(self, name: str,
                 encoder,
                 decoder,
                 data_id: str,
                 attention_index: int = 0,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        self.encoder = encoder
        self.decoder = decoder
        self.data_id = data_id
        self.attention_index = attention_index
        src_len = getattr(encoder, "max_input_len", None)
        if src_len is None:
            raise ValueError(
                "WordAlignmentDecoder needs an encoder with "
                "max_input_len set (static alignment matrix shape)")
        # +1: decoder targets include </s>
        self._preprocessor = WordAlignmentPreprocessor(
            source_len=src_len, target_len=decoder.max_output_len + 1)

    @property
    def matrix_key(self) -> str:
        return f"{self.name}.alignment"

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if not dataset.has_series(self.data_id):
            return {}
        matrices = np.stack([self._preprocessor(item)
                             for item in dataset.get_series(self.data_id)])
        return {self.matrix_key: matrices}

    @tensor
    def alignment_target(self, ctx: Context):
        return ctx.batch[self.matrix_key]

    @tensor
    def train_loss(self, ctx: Context):
        """Cross-entropy of the target alignments against the attention
        weights (floored at 1e-9), averaged over the aligned tokens."""
        weights = self.alignment(ctx)  # (B, Tq, Tk)
        target = self.alignment_target(ctx)
        tq = min(weights.shape[1], target.shape[1])
        tk = min(weights.shape[2], target.shape[2])
        weights = weights[:, :tq, :tk]
        target = target[:, :tq, :tk]
        xent = -target * torch.log(weights.clamp_min(1e-9))
        return xent.sum() / target.sum().clamp_min(1.0)

    def cost(self, ctx: Context):
        return self.train_loss(ctx)

    runtime_loss = train_loss

    @tensor
    def alignment(self, ctx: Context):
        """The decoder's (B, Tq, Tk) attention matrix for dumping."""
        return self.decoder.train_attention_weights(
            ctx)[self.attention_index]
