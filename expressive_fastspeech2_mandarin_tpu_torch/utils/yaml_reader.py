"""A reader for the subset of YAML that the repo's configuration files use,
for machines without PyYAML.

The subset: block mappings nested by indentation (spaces only), flow lists
of scalars on one line (``[9, 1]``), single- and double-quoted scalars,
plain scalars, and ``#`` comments. Plain scalars resolve as PyYAML's
``safe_load`` resolves them, by YAML 1.1 rules: ``yes``/``no``/``on``/
``off``/``true``/``false`` in their three spellings are booleans, ``~``,
``null`` and an empty value are None, ``0x``/``0b``/leading-zero octal and
``_`` separators are integers, and a float needs a dot (``1e-4`` stays a
string; ``1.0e-4`` is a float, and so only with a signed exponent).
Anything else — block sequences, flow mappings, anchors, tags, block
scalars, multi-line scalars, documents, timestamps — raises ``ValueError``
with its line number; the reader never guesses.
"""

from __future__ import annotations

import math
import re
from typing import Any

# PyYAML's implicit resolvers (resolver.py), in the order it tries them.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_UNSUPPORTED = re.compile(r"""^(?:<<|=
                          |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                          (?:(?:[Tt]|[\ \t]+)[0-9][0-9]?.*)?)$""", re.X)
_BOOL_TRUE = ("yes", "true", "on")
# Characters that start a YAML construct outside the subset.
_INDICATORS = "&*!|>%@`{}?:-,]"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _error(line: int, what: str) -> ValueError:
    return ValueError(f"line {line}: {what} (outside the YAML subset this "
                      f"reader takes)")


def _sexagesimal(value: str, cast) -> Any:
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _resolve_plain(value: str, line: int = 0) -> Any:
    """A plain scalar's value as PyYAML's ``safe_load`` resolves it."""
    if _BOOL.match(value):
        return value.lower() in _BOOL_TRUE
    if _FLOAT.match(value):
        return _to_float(value)
    if _INT.match(value):
        return _to_int(value)
    if _NULL.match(value):
        return None
    if _UNSUPPORTED.match(value):
        raise _error(line, f"merge key, value key or timestamp {value!r}")
    return value


def _quoted(s: str, pos: int, line: int) -> tuple[str, int]:
    """The quoted scalar starting at ``s[pos]``; returns it and the index
    past its closing quote."""
    quote, out, i = s[pos], [], pos + 1
    while i < len(s):
        c = s[i]
        if c == quote:
            if quote == "'" and s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if c == "\\" and quote == '"':
            esc = s[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
            elif esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = s[i + 2:i + 2 + n]
                if not re.fullmatch(f"[0-9a-fA-F]{{{n}}}", digits):
                    raise _error(line, f"bad escape \\{esc}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                raise _error(line, f"unknown escape \\{esc}")
            continue
        out.append(c)
        i += 1
    raise _error(line, "a quoted scalar that does not end on its line")


def _rest_is_comment(s: str, line: int) -> None:
    """What follows a complete value: nothing, or whitespace and a
    comment."""
    if s.strip() and not re.match(r"\s+#", s):
        raise _error(line, f"unexpected {s.strip()!r} after a value")


def _plain(s: str, line: int) -> str:
    """A plain scalar up to a comment (a ``#`` after whitespace)."""
    m = re.search(r"\s#", s)
    text = (s[:m.start()] if m else s).strip()
    if text[0] in _INDICATORS and not (
            text[0] in "-?:" and len(text) > 1 and text[1] != " "):
        raise _error(line, f"a value starting with {text[0]!r}")
    if ": " in text or text.endswith(":"):
        raise _error(line, f"a nested mapping on one line in {text!r}")
    return text


def _flow_list(s: str, line: int) -> list:
    """A one-line flow list of scalars, ``s`` starting at its ``[``."""
    items: list = []
    i = 1
    while True:
        while i < len(s) and s[i] in " \t":
            i += 1
        if i >= len(s):
            raise _error(line, "a flow list that does not end on its line")
        c = s[i]
        if c == "]":  # an empty list, or a trailing comma
            _rest_is_comment(s[i + 1:], line)
            return items
        if c in "'\"":
            value, i = _quoted(s, i, line)
            items.append(value)
        elif c in "[{":
            raise _error(line, "a nested flow collection")
        elif c in ",]":
            raise _error(line, "an empty item in a flow list")
        else:
            m = re.compile(r"[^,\]\[{}]*").match(s, i)
            text = m.group().strip()
            if "#" in text or ": " in text or text.endswith(":"):
                raise _error(line, f"{text!r} in a flow list")
            items.append(_resolve_plain(text, line))
            i = m.end()
        while i < len(s) and s[i] in " \t":
            i += 1
        if i < len(s) and s[i] == ",":
            i += 1
            continue
        if i < len(s) and s[i] == "]":
            _rest_is_comment(s[i + 1:], line)
            return items
        raise _error(line, "a flow list item not followed by ',' or ']'")


def _value(s: str, line: int) -> Any:
    """The value after ``key:`` on one line (not empty, not a comment)."""
    if s[0] == "[":
        return _flow_list(s, line)
    if s[0] in "'\"":
        value, end = _quoted(s, 0, line)
        _rest_is_comment(s[end:], line)
        return value
    return _resolve_plain(_plain(s, line), line)


def _key_and_rest(content: str, line: int) -> tuple[Any, str]:
    """``key: rest`` → (key, rest with a lone comment taken away)."""
    if content[0] in "'\"":
        key, end = _quoted(content, 0, line)
        m = re.compile(r" *:(?: +|$)").match(content, end)
        if m is None:
            raise _error(line, "a quoted key without ':'")
        rest = content[m.end():]
    else:
        if content.startswith("- ") or content == "-":
            raise _error(line, "a block sequence")
        m = re.search(r":(?: |$)", content)
        if m is None:
            raise _error(line, f"{content!r} is not 'key: value'")
        key = _resolve_plain(_plain(content[:m.start()], line), line)
        rest = content[m.end():]
    rest = rest.strip()
    return key, "" if rest.startswith("#") else rest


def _lines(text: str) -> list[tuple[int, int, str]]:
    """(line number, indentation, content) of every line that holds more
    than whitespace and a comment."""
    out = []
    for n, raw in enumerate(text.splitlines(), start=1):
        stripped = raw.lstrip(" ")
        if not stripped.strip() or stripped.lstrip().startswith("#"):
            continue
        if stripped[0] == "\t":
            raise _error(n, "a tab in the indentation")
        if n == 1 and stripped.startswith("﻿"):
            stripped = stripped[1:]
        if stripped.startswith(("---", "...")) and raw == stripped:
            raise _error(n, "a document marker")
        if stripped.startswith("%"):
            raise _error(n, "a directive")
        out.append((n, len(raw) - len(stripped), stripped.rstrip()))
    return out


def _block(lines, i: int, indent: int) -> tuple[dict, int]:
    out: dict = {}
    while i < len(lines):
        n, ind, content = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise _error(n, "unexpected indentation")
        key, rest = _key_and_rest(content, n)
        i += 1
        if rest:
            out[key] = _value(rest, n)
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _block(lines, i, lines[i][1])
        elif i < len(lines) and lines[i][1] == indent and (
                lines[i][2].startswith("- ") or lines[i][2] == "-"):
            raise _error(lines[i][0], "a block sequence")
        else:
            out[key] = None
    return out, i


def loads(text: str) -> dict | None:
    """The mapping that ``yaml.safe_load(text)`` gives for ``text`` in the
    subset (None for an empty document)."""
    lines = _lines(text)
    if not lines:
        return None
    out, i = _block(lines, 0, lines[0][1])
    if i < len(lines):
        raise _error(lines[i][0], "indentation that closes no block")
    return out


def load(path: str) -> dict | None:
    """``loads`` of the UTF-8 file at ``path``."""
    with open(path, encoding="utf-8") as f:
        return loads(f.read())
