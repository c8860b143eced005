"""ModelPart base and the forward-pass Context.

Counterpart of ``neuralmonkey_tpu/model/part.py``. A part method takes
a :class:`Context` (parameters, featurized batch, train flag, dropout
seed) and
returns tensors. The :func:`tensor` decorator memoizes per Context, so
a sub-result shared by several consumers (an encoder feeding two
attentions) is computed once per pass.

Parameters live in one dict keyed by part name (``param_key``), each
entry a nested dict of tensors with the JAX package's names, so the
flat ``part/sub/leaf`` checkpoint keys of both packages agree. Parts
are plain objects rather than ``nn.Module``s: they hold references to
each other (a decoder to its encoder and attentions, a beam search to
its decoder), which module registration would turn into nested,
duplicated parameter trees.
"""

from __future__ import annotations

import functools
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..logging import debug
from ..ops.nn import dropout as nn_dropout


class Context:
    """One forward pass: memoization plus params, batch and dropout
    generators. ``rng`` is the pass's integer seed (the run seed folded
    with the step, see :func:`fold_seed`); train-mode dropout draws
    from a generator per (part, site) seeded from it, as the JAX
    ``Context.make_rng`` folds its key."""

    def __init__(self, params: Dict[str, Any], batch: Dict[str, Any],
                 train: bool = False, rng: Optional[int] = None) -> None:
        self.params = params
        self.batch = batch
        self.train = train
        self.rng = rng
        self._cache: Dict = {}
        # auxiliary losses parts register during the forward pass;
        # GenericTrainer.total_loss folds them into the objective
        self.aux_losses: Dict[str, Any] = {}

    def cached(self, part: "ModelPart", attr: str, fn: Callable) -> Any:
        key = (id(part), attr)
        if key not in self._cache:
            self._cache[key] = fn(part, self)
        return self._cache[key]

    def get_params(self, part: "ModelPart") -> Any:
        key = part.param_key
        if key not in self.params:
            raise KeyError(
                f"No parameters for part '{key}' (have "
                f"{sorted(self.params.keys())})")
        return self.params[key]

    def add_aux_loss(self, part: "ModelPart", name: str, value) -> None:
        """Register an auxiliary loss term (already weighted by the
        owning part); repeated adds under one key accumulate."""
        key = f"{part.name}/{name}"
        if key in self.aux_losses:
            self.aux_losses[key] = self.aux_losses[key] + value
        else:
            self.aux_losses[key] = value

    def make_rng(self, part: "ModelPart", site: str,
                 device: torch.device) -> torch.Generator:
        """A generator on ``device`` for one (part, site) of this pass."""
        if self.rng is None:
            raise ValueError(
                "Context has no rng (pass one for train-mode dropout)")
        salt = zlib.crc32(f"{part.name}/{site}".encode()) & 0x7FFFFFFF
        return torch.Generator(device=device).manual_seed(
            fold_seed(self.rng, salt))

    def dropout(self, part: "ModelPart", x: torch.Tensor,
                keep_prob: float, site: str = "dropout") -> torch.Tensor:
        """Part-scoped inverted dropout; identity at inference."""
        if not self.train or keep_prob >= 1.0:
            return x
        return nn_dropout(x, keep_prob,
                          self.make_rng(part, site, x.device), True)


def fold_seed(seed: int, salt: int) -> int:
    """A 63-bit seed from ``seed`` and ``salt`` (splitmix64 finalizer of
    their combination): distinct salts give unrelated streams, like
    ``jax.random.fold_in``."""
    z = (seed * 0x9E3779B97F4A7C15 + salt + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & 0x7FFFFFFFFFFFFFFF


def tensor(fn: Callable) -> Callable:
    """Per-Context memoizing method decorator (the reference's @tensor)."""
    @functools.wraps(fn)
    def wrapper(self, ctx: Context):
        return ctx.cached(self, fn.__name__, fn)
    return wrapper


class ModelPart:
    """Base class for model parts.

    Subclasses implement ``init_params(generator) -> params`` for their
    own parameters, ``featurize(dataset, train) -> {key: np.ndarray}``
    for their inputs, and interface methods taking a Context."""

    def __init__(self, name: str,
                 reuse: "ModelPart" = None,
                 save_checkpoint: str = None,
                 load_checkpoint: str = None) -> None:
        if not name:
            raise ValueError("Model part name cannot be empty")
        if save_checkpoint or load_checkpoint:
            raise NotImplementedError(
                f"per-part checkpoints ({name}) are not ported to "
                "neuralmonkey_tpu_torch yet")
        self.name = name
        self.reuse = reuse

    @property
    def param_key(self) -> str:
        """Name under which this part's params live (shared if reuse)."""
        return self.reuse.param_key if self.reuse is not None else self.name

    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        """Initialize this part's own parameters. Default: none."""
        del gen
        return {}

    def featurize(self, dataset, train: bool = False
                  ) -> Dict[str, np.ndarray]:
        """Build input arrays for a dataset batch. Default: none."""
        del dataset, train
        return {}

    def children(self) -> List["ModelPart"]:
        """Direct child parts (auto-discovered from attributes)."""
        found: List[ModelPart] = []
        seen = set()

        def visit(value):
            if isinstance(value, ModelPart):
                if id(value) not in seen:
                    seen.add(id(value))
                    found.append(value)
            elif isinstance(value, (list, tuple)):
                for item in value:
                    visit(item)

        for attr, value in self.__dict__.items():
            if attr != "reuse":
                visit(value)
        if self.reuse is not None:
            visit(self.reuse)
        return found

    def __repr__(self) -> str:
        return f"<{type(self).__name__} '{self.name}'>"


def collect_parts(roots: Sequence[Any]) -> List[ModelPart]:
    """All ModelParts reachable from ``roots`` (depth-first, by id).
    Runners contribute through their ``all_parts``/``decoder``."""
    result: List[ModelPart] = []
    seen = set()

    def visit(obj):
        if obj is None:
            return
        if isinstance(obj, (list, tuple)):
            for item in obj:
                visit(item)
            return
        if isinstance(obj, ModelPart):
            if id(obj) in seen:
                return
            seen.add(id(obj))
            result.append(obj)
            for child in obj.children():
                visit(child)
            return
        for attr in ("all_parts", "parts", "decoder", "decoders",
                     "encoders", "attentions"):
            if hasattr(obj, attr):
                visit(getattr(obj, attr))

    visit(list(roots))
    return result


def part_generator(seed: int, key: str) -> torch.Generator:
    """The CPU generator a part initializes from: ``seed`` salted with
    the part's name (stable across part order, like ``fold_in``)."""
    salt = zlib.crc32(key.encode()) & 0x7FFFFFFF
    return torch.Generator().manual_seed((seed << 31) ^ salt)


def init_all_params(parts: Sequence[ModelPart],
                    seed: int) -> Dict[str, Any]:
    """Initialize the full parameter tree on the CPU, one entry per
    ``param_key``. Parts sharing parameters through ``reuse``
    initialize once."""
    params: Dict[str, Any] = {}
    owners: Dict[str, ModelPart] = {}
    for part in parts:
        key = part.param_key
        owner = part
        while owner.reuse is not None:
            owner = owner.reuse
        if key in params:
            if owners[key] is not owner:
                raise ValueError(
                    f"Two different model parts are named '{key}'. "
                    "Part names must be unique; use reuse= for "
                    "parameter sharing.")
            continue
        owners[key] = owner
        params[key] = owner.init_params(part_generator(seed, key))
        debug(f"Initialized params for '{key}'", "model")
    return params
