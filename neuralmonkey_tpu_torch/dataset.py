"""Dataset: named parallel series + batching.

Rebuild of the reference dataset (SURVEY.md §3.1, reference:
nm/dataset.py). A dataset is a dictionary of named *series* — parallel
sequences (tokenized sentences, feature arrays, image tensors). Config
factories keep the reference signatures: ``load_dataset_from_files`` with
``s_<series>=path`` kwargs (value may be a path string or a
``(path, reader)`` tuple), ``preprocessors``, ``lazy``.

TPU-specific: :class:`BatchingScheme` supports length-bucketed batching
into a small set of static shapes so jitted steps don't recompile per
batch (SURVEY.md §8.3 item 2).
"""

from __future__ import annotations

import glob as _glob
import os
import random
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np

from .logging import log, warn
from .readers.plain_text_reader import UtfPlainTextReader

# A series reader takes a list of file paths and yields items.
Reader = Callable[[List[str]], Iterable[Any]]

SERIES_OUTPUT_PREFIX = "s_"
OUTPUT_SUFFIX = "_out"


class BatchingScheme:
    """How to cut a dataset into batches.

    - ``batch_size``: number of examples per batch, or when
      ``token_level_batching`` is on, the per-batch token budget.
    - ``bucket_boundaries``: sorted max-lengths defining length buckets;
      with buckets, each batch comes from a single bucket and is padded
      to that bucket's boundary → a *static* set of shapes for XLA.
    - ``bucket_batch_sizes``: per-bucket batch sizes
      (len = len(boundaries)+1); defaults to ``batch_size`` everywhere.
    """

    def __init__(self,
                 batch_size: int = None,
                 batch_bucket_span: int = None,
                 token_level_batching: bool = False,
                 bucketing_ignore_series: List[str] = None,
                 bucket_boundaries: List[int] = None,
                 bucket_batch_sizes: List[int] = None,
                 ignore_series: List[str] = None) -> None:
        if batch_size is None and bucket_boundaries is None:
            raise ValueError(
                "BatchingScheme needs batch_size or bucket_boundaries")
        self.batch_size = batch_size
        self.batch_bucket_span = batch_bucket_span
        self.token_level_batching = token_level_batching
        self.bucketing_ignore_series = (
            bucketing_ignore_series or ignore_series or [])
        self.bucket_boundaries = bucket_boundaries
        self.bucket_batch_sizes = bucket_batch_sizes
        if bucket_boundaries is not None and bucket_batch_sizes is None:
            if batch_size is None:
                raise ValueError("Need bucket_batch_sizes or batch_size")
            self.bucket_batch_sizes = (
                [batch_size] * (len(bucket_boundaries) + 1))


class Dataset:
    """An in-memory dataset of named parallel series."""

    def __init__(self, name: str,
                 series: Dict[str, List[Any]],
                 outputs: Dict[str, str] = None,
                 preprocessors: List[Tuple[str, str, Callable]] = None,
                 shuffled: bool = False) -> None:
        self.name = name
        self._series = dict(series)
        self.series_outputs = dict(outputs or {})
        self.shuffled = shuffled

        for source, target, func in (preprocessors or []):
            if isinstance(source, (tuple, list)):
                # multi-series preprocessor (e.g. editops over
                # (source, target) pairs): items are zipped tuples
                for name in source:
                    if name not in self._series:
                        raise ValueError(
                            f"Preprocessor source series '{name}' "
                            "not in dataset")
                items = zip(*(self._series[name] for name in source))
                self._series[target] = [func(item) for item in items]
            else:
                if source not in self._series:
                    raise ValueError(
                        f"Preprocessor source series '{source}' not "
                        "in dataset")
                self._series[target] = [func(item)
                                        for item in self._series[source]]

        lengths = {k: len(v) for k, v in self._series.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(
                f"Series of dataset '{name}' have different lengths: "
                f"{lengths}")

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        if not self._series:
            return 0
        return len(next(iter(self._series.values())))

    @property
    def series_ids(self) -> List[str]:
        return list(self._series.keys())

    def has_series(self, name: str) -> bool:
        return name in self._series

    def get_series(self, name: str) -> List[Any]:
        return self._series[name]

    def maybe_get_series(self, name: str) -> Optional[List[Any]]:
        return self._series.get(name)

    def add_series(self, name: str, values: List[Any]) -> None:
        if len(values) != len(self):
            raise ValueError("New series has wrong length")
        self._series[name] = values

    def subset(self, start: int, length: int) -> "Dataset":
        return Dataset(
            name=f"{self.name}.{start}",
            series={k: v[start:start + length]
                    for k, v in self._series.items()},
            outputs={k: f"{v}.{start}"
                     for k, v in self.series_outputs.items()})

    # ------------------------------------------------------------------ #
    def batches(self, scheme: BatchingScheme,
                shuffled: Optional[bool] = None) -> Iterator["Dataset"]:
        """Yield batch sub-datasets according to *scheme*.

        ``shuffled`` overrides the dataset's own flag — evaluation code
        passes False so outputs stay aligned with reference series even
        when the same Dataset object is used for training."""
        order = list(range(len(self)))
        if self.shuffled if shuffled is None else shuffled:
            random.shuffle(order)

        if scheme.bucket_boundaries is not None:
            yield from self._bucketed_batches(scheme, order)
            return

        if scheme.token_level_batching:
            yield from self._token_batches(scheme, order)
            return

        bs = scheme.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            yield self._take(idx)

    def _take(self, indices: List[int]) -> "Dataset":
        return Dataset(
            name=f"{self.name}.batch",
            series={k: [v[i] for i in indices]
                    for k, v in self._series.items()})

    def _example_len(self, index: int,
                     ignore: Sequence[str]) -> int:
        max_len = 0
        for key, series in self._series.items():
            if key in ignore:
                continue
            item = series[index]
            if hasattr(item, "__len__") and not isinstance(item, str):
                max_len = max(max_len, len(item))
        return max_len

    def _bucketed_batches(self, scheme: BatchingScheme,
                          order: List[int]) -> Iterator["Dataset"]:
        boundaries = scheme.bucket_boundaries
        sizes = scheme.bucket_batch_sizes
        buckets: List[List[int]] = [[] for _ in range(len(boundaries) + 1)]
        for i in order:
            length = self._example_len(i, scheme.bucketing_ignore_series)
            bucket_id = len(boundaries)
            for b, bound in enumerate(boundaries):
                if length <= bound:
                    bucket_id = b
                    break
            buckets[bucket_id].append(i)
            if len(buckets[bucket_id]) >= sizes[bucket_id]:
                yield self._take(buckets[bucket_id])
                buckets[bucket_id] = []
        for bucket in buckets:
            if bucket:
                yield self._take(bucket)

    def _token_batches(self, scheme: BatchingScheme,
                       order: List[int]) -> Iterator["Dataset"]:
        budget = scheme.batch_size
        batch: List[int] = []
        max_len = 0
        for i in order:
            length = max(1, self._example_len(
                i, scheme.bucketing_ignore_series))
            new_max = max(max_len, length)
            if batch and new_max * (len(batch) + 1) > budget:
                yield self._take(batch)
                batch, max_len = [], 0
                new_max = length
            batch.append(i)
            max_len = new_max
        if batch:
            yield self._take(batch)


def _shuffle_stream(stream: Iterator[Any], buffer_size: int,
                    rng: random.Random) -> Iterator[Any]:
    """Reservoir-style shuffle buffer: hold `buffer_size` items, emit a
    random one per incoming item (the standard streaming shuffle)."""
    buf: List[Any] = []
    for item in stream:
        if len(buf) < buffer_size:
            buf.append(item)
            continue
        j = rng.randrange(buffer_size)
        out, buf[j] = buf[j], item
        yield out
    rng.shuffle(buf)
    yield from buf


class LazyDataset(Dataset):
    """Streaming dataset: series are re-read from their files on every
    pass instead of being materialized (reference nm/dataset.py
    LazyDataset). Corpora larger than host RAM train fine; shuffling
    uses a bounded buffer, and length bucketing falls back to
    within-stream accumulation (each bucket fills and flushes as
    examples arrive).

    Batches materialize as plain in-memory :class:`Dataset` objects, so
    everything downstream (featurize, padding, prefetch) is unchanged.
    """

    def __init__(self, name: str,
                 series_specs: Dict[str, Tuple[List[str], Reader]],
                 outputs: Dict[str, str] = None,
                 preprocessors: List[Tuple] = None,
                 buffer_size: int = 10000,
                 shuffled: bool = False,
                 seed: int = None) -> None:
        # deliberately NOT calling Dataset.__init__ — no materialized
        # series exist
        self.name = name
        self._specs = dict(series_specs)
        self.series_outputs = dict(outputs or {})
        self.preprocessors = list(preprocessors or [])
        self.buffer_size = max(int(buffer_size or 10000), 2)
        self.shuffled = shuffled
        self._rng = random.Random(seed if seed is not None else 1234)
        self._count: Optional[int] = None
        self._derived = [t for _, t, _ in self.preprocessors]

    # -- streaming core ------------------------------------------------ #
    def _examples(self) -> Iterator[Dict[str, Any]]:
        iterators = {key: iter(reader(paths))
                     for key, (paths, reader) in self._specs.items()}
        keys = list(iterators)
        count = 0
        while True:
            example: Dict[str, Any] = {}
            done = []
            for key in keys:
                try:
                    example[key] = next(iterators[key])
                except StopIteration:
                    done.append(key)
            if done:
                if len(done) != len(keys):
                    raise ValueError(
                        f"Series of dataset '{self.name}' have "
                        f"different lengths (exhausted: {done})")
                break
            for source, target, func in self.preprocessors:
                if isinstance(source, (tuple, list)):
                    example[target] = func(
                        tuple(example[s] for s in source))
                else:
                    example[target] = func(example[source])
            count += 1
            yield example
        self._count = count

    def _make_batch(self, examples: List[Dict[str, Any]]) -> Dataset:
        keys = list(self._specs) + self._derived
        return Dataset(
            name=f"{self.name}.batch",
            series={k: [ex[k] for ex in examples] for k in keys})

    @staticmethod
    def _item_len(example: Dict[str, Any], ignore: Sequence[str]) -> int:
        max_len = 0
        for key, item in example.items():
            if key in ignore:
                continue
            if hasattr(item, "__len__") and not isinstance(item, str):
                max_len = max(max_len, len(item))
        return max_len

    # -- Dataset interface --------------------------------------------- #
    def __len__(self) -> int:
        if self._count is None:
            warn(f"len() of lazy dataset '{self.name}' requires a "
                 "full pass over the data")
            self._count = sum(1 for _ in self._examples())
        return self._count

    @property
    def series_ids(self) -> List[str]:
        return list(self._specs) + self._derived

    def has_series(self, name: str) -> bool:
        return name in self._specs or name in self._derived

    def get_series(self, name: str) -> List[Any]:
        if not self.has_series(name):
            raise KeyError(name)
        warn(f"Materializing series '{name}' of lazy dataset "
             f"'{self.name}' in memory")
        return [ex[name] for ex in self._examples()]

    def maybe_get_series(self, name: str) -> Optional[List[Any]]:
        return self.get_series(name) if self.has_series(name) else None

    def add_series(self, name: str, values: List[Any]) -> None:
        raise NotImplementedError(
            "Cannot add a series to a lazy dataset")

    def subset(self, start: int, length: int) -> Dataset:
        it = self._examples()
        collected = []
        for i, ex in enumerate(it):
            if i >= start + length:
                break
            if i >= start:
                collected.append(ex)
        return self._make_batch(collected)

    def batches(self, scheme: BatchingScheme,
                shuffled: Optional[bool] = None) -> Iterator[Dataset]:
        stream = self._examples()
        if self.shuffled if shuffled is None else shuffled:
            stream = _shuffle_stream(stream, self.buffer_size,
                                     self._rng)

        if scheme.bucket_boundaries is not None:
            yield from self._bucketed_stream(stream, scheme)
            return
        if scheme.token_level_batching:
            yield from self._token_stream(stream, scheme)
            return
        batch: List[Dict[str, Any]] = []
        for example in stream:
            batch.append(example)
            if len(batch) >= scheme.batch_size:
                yield self._make_batch(batch)
                batch = []
        if batch:
            yield self._make_batch(batch)

    def _bucketed_stream(self, stream, scheme) -> Iterator[Dataset]:
        boundaries = scheme.bucket_boundaries
        sizes = scheme.bucket_batch_sizes
        buckets: List[List[Dict[str, Any]]] = [
            [] for _ in range(len(boundaries) + 1)]
        for example in stream:
            length = self._item_len(example,
                                    scheme.bucketing_ignore_series)
            bucket_id = len(boundaries)
            for b, bound in enumerate(boundaries):
                if length <= bound:
                    bucket_id = b
                    break
            buckets[bucket_id].append(example)
            if len(buckets[bucket_id]) >= sizes[bucket_id]:
                yield self._make_batch(buckets[bucket_id])
                buckets[bucket_id] = []
        for bucket in buckets:
            if bucket:
                yield self._make_batch(bucket)

    def _token_stream(self, stream, scheme) -> Iterator[Dataset]:
        budget = scheme.batch_size
        batch: List[Dict[str, Any]] = []
        max_len = 0
        for example in stream:
            length = max(1, self._item_len(
                example, scheme.bucketing_ignore_series))
            new_max = max(max_len, length)
            if batch and new_max * (len(batch) + 1) > budget:
                yield self._make_batch(batch)
                batch, max_len = [], 0
                new_max = length
            batch.append(example)
            max_len = new_max
        if batch:
            yield self._make_batch(batch)


# ---------------------------------------------------------------------- #
# config-visible factories (reference names preserved)
# ---------------------------------------------------------------------- #
def _expand_paths(spec: str) -> List[str]:
    paths: List[str] = []
    for part in spec.split(","):
        part = part.strip()
        matched = sorted(_glob.glob(part))
        if matched:
            paths.extend(matched)
        else:
            paths.append(part)
    return paths


def load_dataset_from_files(name: str = None,
                            lazy: bool = False,
                            preprocessors: List[Tuple] = None,
                            buffer_size: int = 10000,
                            **kwargs) -> Dataset:
    """Build a dataset from ``s_<series>=...`` keyword arguments.

    Values may be a path string (read with the plain-text reader), a
    ``(path, reader)`` tuple, or for ``s_<series>_out=`` keys an output
    path. With ``lazy=True`` the series stream from disk on every pass
    (corpora larger than host RAM train fine); shuffling then uses a
    ``buffer_size``-bounded shuffle buffer and bucketing accumulates
    within the stream.
    """
    specs: Dict[str, Tuple[List[str], Reader]] = {}
    outputs: Dict[str, str] = {}

    for key, value in kwargs.items():
        if not key.startswith(SERIES_OUTPUT_PREFIX):
            raise ValueError(f"Unexpected dataset argument: {key}")
        series_name = key[len(SERIES_OUTPUT_PREFIX):]
        if series_name.endswith(OUTPUT_SUFFIX):
            outputs[series_name[: -len(OUTPUT_SUFFIX)]] = value
            continue
        if isinstance(value, tuple) and len(value) == 2:
            path_spec, reader = value
        else:
            path_spec, reader = value, UtfPlainTextReader
        paths = _expand_paths(path_spec)
        for p in paths:
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"File not found for series '{series_name}': {p}")
        specs[series_name] = (paths, reader)

    if name is None:
        name = "dataset"
    if lazy:
        ds: Dataset = LazyDataset(
            name=name, series_specs=specs, outputs=outputs,
            preprocessors=preprocessors, buffer_size=buffer_size)
        log(f"Dataset '{name}' opened lazily, "
            f"series {ds.series_ids}")
        return ds
    series = {key: list(reader(paths))
              for key, (paths, reader) in specs.items()}
    ds = Dataset(name=name, series=series, outputs=outputs,
                 preprocessors=preprocessors)
    log(f"Dataset '{name}' loaded: {len(ds)} examples, "
        f"series {ds.series_ids}")
    return ds


def load(name: str = None,
         series: List[str] = None,
         data: List[Any] = None,
         outputs: List[Tuple[str, str]] = None,
         preprocessors: List[Tuple] = None,
         lazy: bool = False,
         buffer_size: int = None,
         shuffled: bool = False) -> Dataset:
    """Newer-style reference factory: parallel ``series``/``data``
    lists. ``lazy=True`` streams file-backed series from disk with a
    ``buffer_size``-bounded shuffle buffer."""
    series = series or []
    data = data or []
    if len(series) != len(data):
        raise ValueError("series and data must have the same length")
    specs: Dict[str, Tuple[List[str], Reader]] = {}
    series_dict: Dict[str, List[Any]] = {}
    for series_name, spec in zip(series, data):
        if isinstance(spec, tuple) and len(spec) == 2 \
                and not isinstance(spec[0], str):
            # (reader, path) or (path, reader)
            spec = (spec[1], spec[0])
        if isinstance(spec, tuple):
            path_spec, reader = spec
        elif isinstance(spec, str):
            path_spec, reader = spec, UtfPlainTextReader
        elif isinstance(spec, list):
            series_dict[series_name] = spec
            continue
        else:
            raise ValueError(f"Cannot interpret data spec {spec!r}")
        specs[series_name] = (_expand_paths(path_spec), reader)
    out_dict = {k: v for k, v in (outputs or [])}
    if lazy:
        if series_dict:
            raise ValueError(
                "lazy=True cannot mix in-memory series lists")
        ds: Dataset = LazyDataset(
            name=name or "dataset", series_specs=specs,
            outputs=out_dict, preprocessors=preprocessors,
            buffer_size=buffer_size or 10000, shuffled=shuffled)
        log(f"Dataset '{ds.name}' opened lazily, "
            f"series {ds.series_ids}")
        return ds
    for series_name, (paths, reader) in specs.items():
        series_dict[series_name] = list(reader(paths))
    ds = Dataset(name=name or "dataset", series=series_dict,
                 outputs=out_dict, preprocessors=preprocessors,
                 shuffled=shuffled)
    log(f"Dataset '{ds.name}' loaded: {len(ds)} examples, "
        f"series {ds.series_ids}")
    return ds


def from_dict(series: Dict[str, List[Any]],
              name: str = "runtime_dataset") -> Dataset:
    """In-memory dataset (used by the REST server)."""
    return Dataset(name=name, series=series)


# reference-era alias
from_files = load_dataset_from_files
