"""Embedded input sequences (counterpart of
``neuralmonkey_tpu/model/sequence.py``): ``EmbeddedSequence`` maps a
tokenized series to embeddings; ``EmbeddedFactorSequence`` concatenates
the embeddings of several aligned series (words and their factors)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..ops.nn import depth_scale
from ..parallel import tensor as tp
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

    def param_partition_specs(self) -> Dict[str, tuple]:
        # the vocabulary's rows split over the model axis
        return {"embeddings": ("model", None)}

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
        embedded = tp.embedding(ids, ctx.get_params(self)["embeddings"])
        if self.scale_embeddings_by_depth:
            embedded = embedded * depth_scale(self.embedding_size,
                                              embedded)
        return embedded

    @tensor
    def temporal_states(self, ctx: Context):
        return self.embed(ctx, self.data(ctx))


class EmbeddedFactorSequence(ModelPart, TemporalStateful):
    """Concatenation of per-factor embeddings over aligned series."""

    def __init__(self, name: str,
                 vocabularies: List[Vocabulary],
                 data_ids: List[str],
                 embedding_sizes: List[int],
                 max_length: int = None,
                 add_start_symbol: bool = False,
                 add_end_symbol: bool = False,
                 reuse: ModelPart = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        ModelPart.__init__(self, name, reuse, save_checkpoint,
                           load_checkpoint)
        if not (len(vocabularies) == len(data_ids)
                == len(embedding_sizes)):
            raise ValueError(
                "vocabularies, data_ids and embedding_sizes must have "
                "the same length")
        self.vocabularies = vocabularies
        self.data_ids = data_ids
        self.embedding_sizes = embedding_sizes
        self.max_length = max_length
        self.add_start_symbol = add_start_symbol
        self.add_end_symbol = add_end_symbol

    @property
    def state_dim(self) -> int:
        return sum(self.embedding_sizes)

    def _ids_key(self, factor: int) -> str:
        return f"{self.name}.{factor}.ids"

    @property
    def mask_key(self) -> str:
        return f"{self.name}.mask"

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        return {f"embeddings_{i}": torch.randn((len(vocab), size),
                                               generator=gen) * 0.01
                for i, (vocab, size) in enumerate(
                    zip(self.vocabularies, self.embedding_sizes))}

    def param_partition_specs(self) -> Dict[str, tuple]:
        return {f"embeddings_{i}": ("model", None)
                for i in range(len(self.vocabularies))}

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        """Each factor's ids; the mask of the longest factor."""
        out: Dict[str, np.ndarray] = {}
        mask = None
        for i, (vocab, data_id) in enumerate(
                zip(self.vocabularies, self.data_ids)):
            ids, m = vocab.sentences_to_tensor(
                dataset.get_series(data_id), max_len=self.max_length,
                train_mode=train, add_start_symbol=self.add_start_symbol,
                add_end_symbol=self.add_end_symbol)
            out[self._ids_key(i)] = ids
            if mask is None or m.shape[1] > mask.shape[1]:
                mask = m
        out[self.mask_key] = mask
        return out

    @tensor
    def temporal_mask(self, ctx: Context):
        return ctx.batch[self.mask_key]

    @tensor
    def temporal_states(self, ctx: Context):
        params = ctx.get_params(self)
        time = ctx.batch[self.mask_key].shape[1]
        return torch.cat(
            [tp.embedding(ctx.batch[self._ids_key(i)][:, :time],
                          params[f"embeddings_{i}"])
             for i in range(len(self.data_ids))], dim=-1)
