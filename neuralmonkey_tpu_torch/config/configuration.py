"""Configuration: declared arguments + INI loading + model building.

The port's own copy of ``neuralmonkey_tpu/config/configuration.py``;
objects are built by this port's builder. As in the reference
(nm/config/configuration.py, SURVEY.md §3.1) the
experiment declares its expected ``[main]`` arguments with types/defaults,
loads an INI file (with CLI ``section.key=value`` overrides), and builds
the object graph on demand. Unknown ``[main]`` keys in *data* configs are
ignored (matching the reference, so run-time data INIs can carry extra
keys).
"""

from __future__ import annotations

from argparse import Namespace
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Set

from ..logging import log, warn
from .builder import build_config
from .exceptions import ConfigInvalidValueException
from .parsing import parse_file


class Configuration:
    """Declared-argument configuration loader."""

    def __init__(self) -> None:
        self.data_types: Dict[str, type] = {}
        self.defaults: Dict[str, Any] = {}
        self.conditions: Dict[str, Callable[[Any], bool]] = {}
        self.ignored: Set[str] = set()
        self.required: Set[str] = set()
        self.raw_config: "OrderedDict[str, Any]" = OrderedDict()
        self.config_dict: "OrderedDict[str, Any]" = OrderedDict()
        self.objects: Optional[Namespace] = None
        self.args: Optional[Namespace] = None
        self.model: Optional[Namespace] = None

    # ------------------------------------------------------------------ #
    def add_argument(self, name: str,
                     required: bool = False,
                     default: Any = None,
                     cond: Callable[[Any], bool] = None) -> None:
        if name in self.data_types:
            raise ValueError(f"Data filed defined twice: {name}")
        if required:
            self.required.add(name)
        else:
            self.defaults[name] = default
        if cond is not None:
            self.conditions[name] = cond

    def ignore_argument(self, name: str) -> None:
        self.ignored.add(name)

    # ------------------------------------------------------------------ #
    def load_file(self, path: str,
                  changes: Optional[List[str]] = None) -> None:
        log(f"Loading INI file: '{path}'", color="blue")
        overrides: Dict[str, str] = {}
        for change in changes or []:
            if "=" not in change:
                raise ValueError(
                    f"Invalid override '{change}' (expected key=value)")
            key, value = change.split("=", 1)
            overrides[key.strip()] = value.strip()
        with open(path, encoding="utf-8") as f:
            lines = f.readlines()
        self.raw_config, self.config_dict = parse_file(lines, overrides)
        self._check_loaded_conf()
        log("INI file loaded.", color="blue")

    def _check_loaded_conf(self) -> None:
        """Validate [main] against declared arguments."""
        main = self.config_dict.get("main", {})
        for name in self.required:
            if name not in main:
                raise ConfigInvalidValueException(
                    name, f"Missing required field in [main]: {name}")
        for name, value in main.items():
            cond = self.conditions.get(name)
            if cond is not None and not cond(value):
                raise ConfigInvalidValueException(
                    value, f"Value of [main] {name} failed its condition")

    # ------------------------------------------------------------------ #
    def build_model(self, warn_unused: bool = False) -> None:
        if not self.config_dict:
            raise RuntimeError("Load the configuration file first.")
        config = build_config(self.config_dict, self.ignored, warn_unused)
        model_dict = dict(self.defaults)
        model_dict.update(config)
        self.model = Namespace(**model_dict)
        self.args = self.model  # reference exposes both names

    def make_namespace(self, d: Dict[str, Any]) -> Namespace:
        return Namespace(**d)

    def save_file(self, path: str) -> None:
        from .parsing import write_file
        write_file(self.raw_config, path)
