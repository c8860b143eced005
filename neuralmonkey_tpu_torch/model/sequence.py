"""Embedded input sequences (counterpart of
``neuralmonkey_tpu/model/sequence.py``, ``EmbeddedSequence`` only)."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..vocabulary import Vocabulary
from .part import Context, ModelPart, tensor
from .stateful import TemporalStateful


class EmbeddedSequence(ModelPart, TemporalStateful):
    """Token ids -> embedding vectors, plus mask.

    ``scale_embeddings_by_depth`` multiplies by sqrt(embedding_size).
    ``embeddings_init`` may carry a pretrained ``(vocab, dim)`` array.
    ``table_only`` parts provide an embedding table (a decoder's output
    side) but never read input data."""

    def __init__(self, name: str,
                 vocabulary: Vocabulary,
                 data_id: str,
                 embedding_size: int,
                 max_length: int = None,
                 add_start_symbol: bool = False,
                 add_end_symbol: bool = False,
                 scale_embeddings_by_depth: bool = False,
                 embeddings_init: Optional[np.ndarray] = None,
                 table_only: bool = False,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if embedding_size <= 0:
            raise ValueError("Embedding size must be positive")
        self.vocabulary = vocabulary
        self.data_id = data_id
        self.embedding_size = embedding_size
        self.max_length = max_length
        self.add_start_symbol = add_start_symbol
        self.add_end_symbol = add_end_symbol
        self.scale_embeddings_by_depth = scale_embeddings_by_depth
        self.embeddings_init = embeddings_init
        self.table_only = table_only

    @property
    def state_dim(self) -> int:
        return self.embedding_size

    @property
    def ids_key(self) -> str:
        return f"{self.name}.ids"

    @property
    def mask_key(self) -> str:
        return f"{self.name}.mask"

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        shape = (len(self.vocabulary), self.embedding_size)
        if self.embeddings_init is not None:
            table = torch.as_tensor(np.asarray(self.embeddings_init),
                                    dtype=torch.float32)
            if tuple(table.shape) != shape:
                raise ValueError(
                    f"Pretrained embeddings shape {tuple(table.shape)} "
                    f"!= {shape}")
        else:
            table = torch.randn(shape, generator=gen) * 0.01
        return {"embeddings": table}

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        if self.table_only or not dataset.has_series(self.data_id):
            return {}
        ids, mask = self.vocabulary.sentences_to_tensor(
            dataset.get_series(self.data_id), max_len=self.max_length,
            train_mode=train, add_start_symbol=self.add_start_symbol,
            add_end_symbol=self.add_end_symbol)
        return {self.ids_key: ids, self.mask_key: mask}

    @tensor
    def data(self, ctx: Context):
        return ctx.batch[self.ids_key]

    @tensor
    def temporal_mask(self, ctx: Context):
        return ctx.batch[self.mask_key]

    def embed(self, ctx: Context, ids: torch.Tensor) -> torch.Tensor:
        """Embed any id tensor with this sequence's table (decoders
        feeding back their own predictions)."""
        embedded = F.embedding(ids, ctx.get_params(self)["embeddings"])
        if self.scale_embeddings_by_depth:
            embedded = embedded * math.sqrt(self.embedding_size)
        return embedded

    @tensor
    def temporal_states(self, ctx: Context):
        return self.embed(ctx, self.data(ctx))
