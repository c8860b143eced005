"""Colored, file-mirrored logging.

TPU-native rebuild of the reference's custom logger (see SURVEY.md §3.1,
reference: nm/logging.py). Provides ``log``, ``log_print``, ``warn``,
``debug``, ``notice`` and a ``Logging`` singleton that can mirror console
output to an experiment log file and gate named debug streams.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, List, Optional, TextIO

_COLORS = {
    "default": "",
    "black": "\033[30m",
    "red": "\033[31m",
    "green": "\033[32m",
    "yellow": "\033[33m",
    "blue": "\033[34m",
    "magenta": "\033[35m",
    "cyan": "\033[36m",
    "white": "\033[37m",
}
_RESET = "\033[0m"


class Logging:
    """Singleton-ish logging state (mirrors reference nm/logging.py)."""

    log_file: Optional[TextIO] = None
    # Debug streams enabled via NM_DEBUG env var (comma-separated) or flag.
    debug_enabled_streams: List[str] = os.environ.get(
        "NM_DEBUG", ""
    ).split(",") if os.environ.get("NM_DEBUG") else []
    strict_mode: bool = bool(os.environ.get("NM_STRICT"))
    use_color: bool = sys.stdout.isatty()

    @staticmethod
    def set_log_file(path: str) -> None:
        """Mirror all subsequent log output into *path* (append mode)."""
        if Logging.log_file is not None:
            Logging.log_file.close()
        Logging.log_file = open(path, "a", encoding="utf-8", buffering=1)

    @staticmethod
    def print_header(title: str, path: str = "") -> None:
        log_print("=" * 72)
        log_print(f"  {title}")
        if path:
            log_print(f"  output: {path}")
        log_print("=" * 72)


def log_print(text: str = "") -> None:
    """Print raw text to stdout and the log file (no timestamp)."""
    print(text, flush=True)
    if Logging.log_file is not None:
        Logging.log_file.write(text + "\n")


def log(message: Any, color: str = "yellow") -> None:
    """Timestamped log line, colored on TTYs, mirrored to the log file."""
    timestamp = time.strftime("%Y-%m-%d %H:%M:%S")
    text = str(message)
    if Logging.use_color and color in _COLORS and _COLORS[color]:
        line = f"{timestamp}: {_COLORS[color]}{text}{_RESET}"
    else:
        line = f"{timestamp}: {text}"
    print(line, flush=True)
    if Logging.log_file is not None:
        Logging.log_file.write(f"{timestamp}: {text}\n")


def warn(message: Any) -> None:
    """Warning (red). In strict mode, raises instead."""
    if Logging.strict_mode:
        raise RuntimeError(f"Warning in strict mode: {message}")
    log(f"WARNING: {message}", color="red")


def notice(message: Any) -> None:
    log(message, color="cyan")


def debug(message: Any, stream: Optional[str] = None) -> None:
    """Debug line, only shown if *stream* is enabled (or no stream given
    and any debugging is on)."""
    streams = Logging.debug_enabled_streams
    if not streams:
        return
    if stream is not None and stream not in streams and "all" not in streams:
        return
    prefix = f"DEBUG ({stream}): " if stream else "DEBUG: "
    log(prefix + str(message), color="magenta")
