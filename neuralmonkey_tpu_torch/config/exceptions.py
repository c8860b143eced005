"""Config-system exceptions (reference: nm/config/exceptions.py)."""

from __future__ import annotations


class IniError(Exception):
    """Syntax error in an INI experiment file."""

    def __init__(self, line: int, message: str,
                 original_exc: Exception = None) -> None:
        self.line = line
        self.message = message
        self.original_exc = original_exc
        super().__init__(f"Error on line {line}: {message}")


class ConfigInvalidValueException(Exception):
    def __init__(self, value, message: str) -> None:
        self.value = value
        self.message = message
        super().__init__(f"Error in configuration of {value!r}: {message}")


class ConfigBuildException(Exception):
    """Error when building an object from a config section."""

    def __init__(self, object_name: str, original_exception: Exception) -> None:
        self.object_name = object_name
        self.original_exception = original_exception
        super().__init__(
            f"Error while loading '{object_name}': {original_exception!r}")
