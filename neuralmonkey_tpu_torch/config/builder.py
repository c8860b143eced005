"""Object-graph construction from parsed INI configs, into this port.

Counterpart of ``neuralmonkey_tpu/config/builder.py``: each
``[section]`` with a ``class=`` key becomes one object; ``<section>``
references resolve recursively with memoization and cycle detection.
Reference-era class names (bare ``encoders.recurrent.SentenceEncoder``,
``neuralmonkey.encoders...``, or the JAX package's
``neuralmonkey_tpu.`` paths) resolve through :data:`MODULE_ALIASES`
and :data:`CLASS_ALIASES` into ``neuralmonkey_tpu_torch`` and nowhere
else. A symbol the port lacks (an unported encoder, say) raises; the
builder reports it as a ConfigBuildException naming the section.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict, List, Set

from ..logging import debug, warn
from .exceptions import ConfigBuildException, ConfigInvalidValueException
from .parsing import ClassSymbol, ObjectRef

_PORT = "neuralmonkey_tpu_torch"

# reference-relative module prefix -> module of the port
MODULE_ALIASES = {
    "encoders": f"{_PORT}.models.encoders",
    "decoders": f"{_PORT}.models.decoders",
    "attention": f"{_PORT}.models.attention",
    "model": f"{_PORT}.model",
    "trainers": f"{_PORT}.trainers",
    "runners": f"{_PORT}.runners",
    "evaluators": f"{_PORT}.evaluators",
    "readers": f"{_PORT}.readers",
    "dataset": f"{_PORT}.dataset",
    "vocabulary": f"{_PORT}.vocabulary",
    "functions": f"{_PORT}.functions",
    "tf_manager": f"{_PORT}.runtime",
    "config": f"{_PORT}.config",
}

# class renames a module alias cannot express; TF optimizer names map
# to the port's optimizers so reference [optimizer] sections load
_OPT = f"{_PORT}.trainers.optimizers."
CLASS_ALIASES = {
    "tf_manager.TensorFlowManager": f"{_PORT}.runtime.CUDAManager",
    "neuralmonkey.tf_manager.TensorFlowManager":
        f"{_PORT}.runtime.CUDAManager",
    "tf.train.AdamOptimizer": _OPT + "AdamOptimizer",
    "tf.train.GradientDescentOptimizer":
        _OPT + "GradientDescentOptimizer",
    "tf.train.MomentumOptimizer": _OPT + "MomentumOptimizer",
    "tf.train.AdadeltaOptimizer": _OPT + "AdadeltaOptimizer",
    "tf.train.RMSPropOptimizer": _OPT + "RMSPropOptimizer",
    "tf.contrib.opt.LazyAdamOptimizer": _OPT + "LazyAdamOptimizer",
    "tensorflow.train.AdamOptimizer": _OPT + "AdamOptimizer",
}


def _import_symbol(dotted: str) -> Any:
    """Import ``pkg.module.Symbol`` (a class or a function)."""
    parts = dotted.split(".")
    for split in range(len(parts) - 1, 0, -1):
        try:
            module = importlib.import_module(".".join(parts[:split]))
        except ModuleNotFoundError:
            continue
        obj: Any = module
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    raise ImportError(f"Cannot import symbol '{dotted}'")


def resolve_class_symbol(clazz: str) -> Any:
    """Resolve a class symbol into the port."""
    stripped = clazz
    for prefix in (_PORT + ".", "neuralmonkey_tpu.", "neuralmonkey."):
        if stripped.startswith(prefix):
            stripped = stripped[len(prefix):]
            break
    if clazz in CLASS_ALIASES:
        return _import_symbol(CLASS_ALIASES[clazz])
    if stripped in CLASS_ALIASES:
        return _import_symbol(CLASS_ALIASES[stripped])

    candidates: List[str] = []
    head = stripped.split(".", 1)[0]
    if head in MODULE_ALIASES:
        candidates.append(MODULE_ALIASES[head] + stripped[len(head):])
    candidates.append(f"{_PORT}.{stripped}")
    for cand in candidates:
        try:
            return _import_symbol(cand)
        except ImportError:
            continue
    raise ImportError(
        f"'{clazz}' is not ported to {_PORT} (tried {candidates})")


def build_object(value: Any, all_dicts: Dict[str, Any],
                 existing_objects: Dict[str, Any], depth: int) -> Any:
    """Recursively build the object a config value describes."""
    if depth > 40:
        raise AssertionError(
            "Config object nesting too deep (cycle in <references>?)")
    if isinstance(value, ObjectRef):
        if value.name not in all_dicts:
            raise ConfigInvalidValueException(
                value, f"Undefined section <{value.name}>")
        obj = build_section(value.name, all_dicts, existing_objects,
                            depth + 1)
        value.bind(obj)
        return obj
    if isinstance(value, ClassSymbol):
        return resolve_class_symbol(value.clazz)
    if isinstance(value, list):
        return [build_object(v, all_dicts, existing_objects, depth + 1)
                for v in value]
    if isinstance(value, tuple):
        return tuple(build_object(v, all_dicts, existing_objects, depth + 1)
                     for v in value)
    return value


_BUILDING = object()


def build_section(name: str, all_dicts: Dict[str, Any],
                  existing_objects: Dict[str, Any], depth: int = 0) -> Any:
    """Build (or fetch memoized) the object for section ``name``."""
    if name in existing_objects:
        if existing_objects[name] is _BUILDING:
            raise ConfigInvalidValueException(
                name, f"Circular reference involving section [{name}]")
        return existing_objects[name]

    section = all_dicts[name]
    if "class" not in section:
        raise ConfigInvalidValueException(
            name, f"Section [{name}] has no 'class' key")
    clazz = section["class"]
    if not isinstance(clazz, ClassSymbol):
        raise ConfigInvalidValueException(
            name, f"Section [{name}]: 'class' must be a class symbol")

    existing_objects[name] = _BUILDING
    try:
        ctor = resolve_class_symbol(clazz.clazz)
        kwargs = {key: build_object(value, all_dicts, existing_objects,
                                    depth + 1)
                  for key, value in section.items() if key != "class"}
        # parts built from a [section] take the section name as their
        # default `name` (their parameter-tree / checkpoint key)
        try:
            if "name" in inspect.signature(ctor).parameters \
                    and "name" not in kwargs:
                kwargs["name"] = name
        except (TypeError, ValueError):
            pass
        debug(f"Building [{name}] as {clazz.clazz}", "config")
        obj = ctor(**kwargs)
    except Exception as exc:
        existing_objects.pop(name, None)
        if isinstance(exc, (ConfigBuildException,
                            ConfigInvalidValueException)):
            raise
        raise ConfigBuildException(name, exc) from exc
    existing_objects[name] = obj
    return obj


def build_config(config_dicts: Dict[str, Any], ignore_names: Set[str],
                 warn_unused: bool = False) -> Dict[str, Any]:
    """Build the whole object graph rooted at the [main] section."""
    if "main" not in config_dicts:
        raise ConfigInvalidValueException(
            "main", "Configuration does not contain the [main] block")
    existing_objects: Dict[str, Any] = {}
    configuration: Dict[str, Any] = {}
    for key, value in config_dicts["main"].items():
        if key in ignore_names:
            continue
        configuration[key] = build_object(value, config_dicts,
                                          existing_objects, 0)
    if warn_unused:
        unused = (set(config_dicts) - set(existing_objects) - {"main"})
        if unused:
            warn(f"Unused config sections: {sorted(unused)}")
    return configuration
