"""INI experiment-file grammar.

Rebuild of the reference config parser (SURVEY.md §3.1, reference:
nm/config/parsing.py). The grammar is preserved so existing experiment
files run unchanged:

- ``[section]`` headers; ``key=value`` pairs; ``;`` / ``#`` comments.
- Scalars: integers (incl. exponents), floats, ``True``/``False``,
  ``None``, double-quoted strings.
- ``<section_name>`` object references.
- Dotted (or bare) identifiers → :class:`ClassSymbol`, resolved at build
  time against the class alias table (``neuralmonkey.`` names map to this
  package).
- Lists ``[a, b, c]`` and tuples ``(a, b)``, arbitrarily nested.
- ``[vars]`` section with ``$variable`` / ``{$variable}`` substitution.
- Time specs like ``30m`` / ``2h`` parse to strings (the training loop
  interprets them as wall-clock periods, ints as step periods).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Tuple

from .exceptions import IniError

SECTION_HEADER = re.compile(r"^\[([a-zA-Z][a-zA-Z0-9_]*)\]\s*$")
KEY_VALUE_PAIR = re.compile(r"^([a-zA-Z][a-zA-Z0-9_]*)\s*=\s*(.*)$")
COMMENT = re.compile(r"^\s*[;#].*$")

INTEGER = re.compile(r"^[+-]?[0-9]+$")
FLOAT = re.compile(
    r"^[+-]?((\d+(\.\d*)?)|(\.\d+))([eE][+-]?\d+)?$")
INT_EXPONENT = re.compile(r"^[+-]?[0-9]+[eE][+]?[0-9]+$")
STRING = re.compile(r'^"(.*)"$')
VAR_REF = re.compile(r"\{?\$([a-zA-Z][a-zA-Z0-9_]*)\}?")
OBJECT_REF = re.compile(r"^<([a-zA-Z][a-zA-Z0-9_]*)>$")
CLASS_NAME = re.compile(
    r"^[a-zA-Z_][a-zA-Z0-9_]*(\.[a-zA-Z_][a-zA-Z0-9_]*)*$")
TIME_SPEC = re.compile(r"^\d+(\.\d+)?[smhd]$")


class ObjectRef:
    """A ``<section>`` reference, resolved by the builder."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.target: Any = None

    def bind(self, value: Any) -> None:
        self.target = value

    def __repr__(self) -> str:
        return f"<ObjectRef {self.name}>"

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other.name == self.name

    def __hash__(self) -> int:
        return hash(("ObjectRef", self.name))


class ClassSymbol:
    """A dotted class/function name, imported at build time."""

    def __init__(self, clazz: str) -> None:
        self.clazz = clazz

    def create(self) -> Any:
        from .builder import resolve_class_symbol
        return resolve_class_symbol(self.clazz)

    def __repr__(self) -> str:
        return f"<ClassSymbol {self.clazz}>"

    def __eq__(self, other) -> bool:
        return isinstance(other, ClassSymbol) and other.clazz == self.clazz

    def __hash__(self) -> int:
        return hash(("ClassSymbol", self.clazz))


def _split_top_level(text: str) -> List[str]:
    """Split on commas not nested inside brackets/parens/quotes."""
    items: List[str] = []
    depth = 0
    in_string = False
    current = ""
    i = 0
    while i < len(text):
        char = text[i]
        if in_string:
            current += char
            if char == '"':
                in_string = False
        elif char == '"':
            in_string = True
            current += char
        elif char in "[(":
            depth += 1
            current += char
        elif char in ")]":
            depth -= 1
            current += char
        elif char == "," and depth == 0:
            items.append(current.strip())
            current = ""
        else:
            current += char
        i += 1
    last = current.strip()
    if last or items:
        items.append(last)
    return items


def parse_value(string: str) -> Any:
    """Parse a single right-hand-side value."""
    string = string.strip()
    if string == "":
        raise ValueError("Empty value")
    if string == "None":
        return None
    if string == "True":
        return True
    if string == "False":
        return False
    if INTEGER.match(string):
        return int(string)
    if INT_EXPONENT.match(string):
        return int(float(string))
    if FLOAT.match(string):
        return float(string)
    match = STRING.match(string)
    if match:
        return match.group(1)
    if TIME_SPEC.match(string):
        return string  # interpreted as a wall-clock period downstream
    match = OBJECT_REF.match(string)
    if match:
        return ObjectRef(match.group(1))
    if string.startswith("[") and string.endswith("]"):
        inner = string[1:-1].strip()
        if not inner:
            return []
        return [parse_value(item) for item in _split_top_level(inner)]
    if string.startswith("(") and string.endswith(")"):
        inner = string[1:-1].strip()
        if not inner:
            return ()
        items = _split_top_level(inner)
        return tuple(parse_value(item) for item in items)
    if CLASS_NAME.match(string):
        return ClassSymbol(string)
    raise ValueError(f"Cannot parse value: '{string}'")


def _substitute_vars(value: str, variables: Dict[str, str],
                     lineno: int) -> str:
    def repl(match: "re.Match") -> str:
        name = match.group(1)
        if name not in variables:
            raise IniError(lineno, f"Undefined variable ${name}")
        return variables[name]
    return VAR_REF.sub(repl, value)


def parse_file(
    lines: Iterable[str],
    overrides: Dict[str, str] = None,
) -> Tuple["OrderedDict[str, Any]", "OrderedDict[str, Any]"]:
    """Parse an INI file into (raw_config, parsed_config).

    ``raw_config`` maps section → key → raw string (after variable
    substitution); ``parsed_config`` maps section → key → parsed value.
    ``overrides`` uses the CLI syntax ``section.key=value``.
    """
    raw_config: "OrderedDict[str, OrderedDict[str, str]]" = OrderedDict()
    current_section = None
    variables: Dict[str, str] = {}
    current_key = None

    for lineno, line in enumerate(lines, start=1):
        line = line.rstrip()
        if not line.strip() or COMMENT.match(line):
            continue

        # line continuation: indented lines extend the previous value
        if line[0] in " \t" and current_section is not None \
                and current_key is not None:
            raw_config[current_section][current_key] += line.strip()
            continue

        header = SECTION_HEADER.match(line)
        if header:
            current_section = header.group(1)
            if current_section in raw_config:
                raise IniError(lineno,
                               f"Duplicate section [{current_section}]")
            raw_config[current_section] = OrderedDict()
            current_key = None
            continue

        pair = KEY_VALUE_PAIR.match(line)
        if pair:
            if current_section is None:
                raise IniError(lineno, "Key-value pair outside a section")
            key, value = pair.group(1), pair.group(2).strip()
            value = _substitute_vars(value, variables, lineno)
            if current_section == "vars":
                # store the bare text so vars compose inside quoted strings
                stripped = value
                if len(stripped) >= 2 and stripped[0] == '"' \
                        and stripped[-1] == '"':
                    stripped = stripped[1:-1]
                variables[key] = stripped
            raw_config[current_section][key] = value
            current_key = key
            continue

        raise IniError(lineno, f"Cannot parse line: '{line}'")

    # apply CLI overrides (section.key=value)
    if overrides:
        for spec, value in overrides.items():
            if "." not in spec:
                raise ValueError(
                    f"Override '{spec}' must have the form section.key")
            section, key = spec.split(".", 1)
            if section not in raw_config:
                raw_config[section] = OrderedDict()
            raw_config[section][key] = value

    raw_config.pop("vars", None)

    parsed_config: "OrderedDict[str, OrderedDict[str, Any]]" = OrderedDict()
    for section, items in raw_config.items():
        parsed_config[section] = OrderedDict()
        for key, value in items.items():
            try:
                parsed_config[section][key] = parse_value(value)
            except ValueError as exc:
                raise IniError(
                    0, f"[{section}] {key}: {exc}", exc) from exc
    return raw_config, parsed_config


def write_file(raw_config: Dict[str, Dict[str, str]], path: str) -> None:
    """Serialize a raw config back to an INI file (provenance copies)."""
    with open(path, "w", encoding="utf-8") as f:
        for section, items in raw_config.items():
            f.write(f"[{section}]\n")
            for key, value in items.items():
                f.write(f"{key}={value}\n")
            f.write("\n")
