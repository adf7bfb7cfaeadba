"""A reader and writer for the YAML subset of the port's configs, so that
no YAML library is needed (the card's installation has none).

The subset: block maps and block lists (``- item``, ``- key: value`` maps
as items), flow lists ``[a, b]`` and flow maps ``{a: 1}``, single- and
double-quoted strings, comments, and plain scalars resolved as PyYAML's
``safe_load`` resolves them (YAML 1.1): ``null``/``~``/empty, booleans
(``true``, ``yes``, ``on``, ...), integers (decimal, ``0x``, ``0o``-style
``0``-octal, ``0b``, sexagesimal), floats (with a dot; an exponent needs
its sign, so ``1e-3`` stays a string as in PyYAML; ``.inf``, ``.nan``)
and strings (``???`` and ``${...}`` among them).  Not in the subset:
anchors, aliases, tags, block scalars (``|``, ``>``), multi-line plain
scalars, dates and multiple documents; they raise ``ValueError`` or read
as strings.
"""
from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_UNSUPPORTED = ("|", ">", "&", "*", "!")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _sexagesimal(s: str, conv) -> Any:
    sign = -1 if s[0] == "-" else 1
    value = 0
    for part in s.lstrip("+-").split(":"):
        value = value * 60 + conv(part)
    return sign * value


def _int(s: str) -> int:
    s = s.replace("_", "")
    sign = -1 if s[0] == "-" else 1
    body = s.lstrip("+-")
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if ":" in body:
        return _sexagesimal(s, int)
    if len(body) > 1 and body[0] == "0":
        return sign * int(body, 8)
    return sign * int(body)


def _float(s: str) -> float:
    s = s.replace("_", "").lower()
    if s.endswith(".inf"):
        return -math.inf if s[0] == "-" else math.inf
    if s.endswith(".nan"):
        return math.nan
    if ":" in s:
        return float(_sexagesimal(s, float))
    return float(s)


def parse_scalar(s: str) -> Any:
    """A plain scalar as PyYAML's ``safe_load`` resolves it."""
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return _int(s)
    if _FLOAT.match(s):
        return _float(s)
    if s.startswith(_UNSUPPORTED):
        raise ValueError(f"YAML outside the port's subset: {s!r}")
    return s


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """The quoted string starting at s[i]; (value, index after it)."""
    q = s[i]
    out = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if j + 1 < len(s) and s[j + 1] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = s[j + 1]
            if e in "xuU":
                n = {"x": 2, "u": 4, "U": 8}[e]
                out.append(chr(int(s[j + 2:j + 2 + n], 16)))
                j += 2 + n
                continue
            if e not in _ESCAPES:
                raise ValueError(f"unknown escape \\{e} in {s!r}")
            out.append(_ESCAPES[e])
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted string: {s!r}")


def _split_flow(s: str) -> List[str]:
    """The comma-separated items of a flow collection's body."""
    items, depth, start, i = [], 0, 0, 0
    while i < len(s):
        c = s[i]
        if c in "'\"":
            i = _quoted(s, i)[1]
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == "," and depth == 0:
            items.append(s[start:i])
            start = i + 1
        i += 1
    items.append(s[start:])
    items = [t.strip() for t in items]
    if items and items[-1] == "":       # a trailing comma
        items.pop()
    return items


def _key_split(s: str):
    """(key, rest) of a ``key: value`` text, or None when ``s`` holds no
    mapping colon (outside quotes and brackets, followed by a space or the
    end)."""
    depth, i = 0, 0
    while i < len(s):
        c = s[i]
        if c in "'\"" and (i == 0 or depth):
            i = _quoted(s, i)[1]
            continue
        if c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        elif c == ":" and depth == 0 and (i + 1 == len(s)
                                          or s[i + 1] in " \t"):
            return s[:i].strip(), s[i + 1:].strip()
        i += 1
    return None


def _key(s: str) -> Any:
    return parse_value(s) if s[:1] and s[0] in "'\"" else parse_scalar(s)


def parse_value(s: str) -> Any:
    """A value on one line: a flow list or map, a quoted string or a plain
    scalar."""
    s = s.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"unterminated flow list: {s!r}")
        return [parse_value(t) for t in _split_flow(s[1:-1])]
    if s.startswith("{"):
        if not s.endswith("}"):
            raise ValueError(f"unterminated flow map: {s!r}")
        out = {}
        for t in _split_flow(s[1:-1]):
            kv = _key_split(t)
            k, v = (t, "") if kv is None else kv
            out[_key(k)] = parse_value(v)
        return out
    if s[:1] and s[0] in "'\"":
        value, end = _quoted(s, 0)
        if s[end:].strip():
            raise ValueError(f"text after a quoted string: {s!r}")
        return value
    return parse_scalar(s)


def _strip_comment(line: str) -> str:
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            try:
                i = _quoted(line, i)[1]
            except ValueError:
                i += 1
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


class _Lines:
    def __init__(self, text: str):
        self.lines = []
        for raw in text.splitlines():
            if raw.strip() in ("---", "..."):
                continue
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError(f"tab in indentation: {raw!r}")
            body = _strip_comment(raw)
            if body.strip():
                self.lines.append([len(body) - len(body.lstrip()),
                                   body.strip()])

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        if _is_item(self.lines[i][1]):
            return self.sequence(i, indent)
        return self.mapping(i, indent)

    def _nested(self, i: int, indent: int, in_list: bool) -> Tuple[Any, int]:
        """The block under the entry at line i (or None)."""
        if i + 1 < len(self.lines):
            nxt, text = self.lines[i + 1]
            if nxt > indent or (nxt == indent and _is_item(text)
                                and not in_list):
                return self.block(i + 1, nxt)
        return None, i + 1

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines):
            ind, text = self.lines[i]
            if ind < indent or _is_item(text) and ind == indent:
                break
            if ind > indent:
                raise ValueError(f"bad indentation at {text!r}")
            kv = _key_split(text)
            if kv is None:
                raise ValueError(f"expected 'key: value', got {text!r}")
            k, rest = kv
            if rest:
                out[_key(k)] = parse_value(rest)
                i += 1
            else:
                out[_key(k)], i = self._nested(i, indent, False)
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines):
            ind, text = self.lines[i]
            if ind != indent or not _is_item(text):
                if ind > indent:
                    raise ValueError(f"bad indentation at {text!r}")
                break
            rest = text[1:].lstrip()
            if not rest:
                value, i = self._nested(i, indent, True)
            elif _is_item(rest) or (rest[0] not in "[{'\""
                                    and _key_split(rest) is not None):
                # a list or map whose first entry shares the item's line
                self.lines[i] = [indent + len(text) - len(rest), rest]
                value, i = self.block(i, self.lines[i][0])
            else:
                value, i = parse_value(rest), i + 1
            out.append(value)
        return out, i


def loads(text: str) -> Any:
    """The document in ``text`` (None when empty)."""
    lines = _Lines(text)
    if not lines.lines:
        return None
    ind, first = lines.lines[0]
    if len(lines.lines) == 1 and not _is_item(first) and (
            first[0] in "[{'\"" or _key_split(first) is None):
        return parse_value(first)
    value, i = lines.block(0, ind)
    if i != len(lines.lines):
        raise ValueError(f"unexpected text at {lines.lines[i][1]!r}")
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")


def _str(s: str) -> str:
    plain = (s and s[0] not in _INDICATORS and s == s.strip()
             and ": " not in s and " #" not in s and not s.endswith(":")
             and all(c.isprintable() for c in s))
    try:
        plain = plain and parse_scalar(s) == s
    except ValueError:
        plain = False
    if plain:
        return s
    if all(c.isprintable() for c in s):
        return "'" + s.replace("'", "''") + "'"
    return '"' + "".join(
        c if c.isprintable() and c not in '"\\'
        else "\\" + c if c in '"\\'
        else f"\\x{ord(c):02x}" if ord(c) < 256 else f"\\u{ord(c):04x}"
        for c in s) + '"'


def _scalar(v: Any) -> str:
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        v = v.item()                          # numpy scalars
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r:
            mant, exp = r.split("e")
            if "." not in mant:
                mant += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            r = f"{mant}e{exp}"
        return r
    if isinstance(v, str):
        return _str(v)
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def _is_block(v: Any) -> bool:
    return isinstance(v, (dict, list, tuple)) and len(v) > 0


def _inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def _dump(v: Any, indent: int, out: List[str]) -> None:
    """Append the block of a non-empty map or list at ``indent``."""
    pad = " " * indent
    if isinstance(v, dict):
        for k, x in v.items():
            key = _scalar(k) + ":"
            if _is_block(x):
                out.append(pad + key)
                _dump(x, indent + 2, out)
            else:
                out.append(f"{pad}{key} {_inline(x)}")
        return
    for x in v:
        if _is_block(x):
            sub: List[str] = []
            _dump(x, 0, sub)
            out.append(pad + "- " + sub[0])
            out.extend(pad + "  " + line for line in sub[1:])
        else:
            out.append(f"{pad}- {_inline(x)}")


def dumps(value: Any) -> str:
    out: List[str] = []
    if _is_block(value):
        _dump(value, 0, out)
    else:
        out.append(_inline(value))
    return "\n".join(out) + "\n"


def dump(value: Any, path: str) -> None:
    with open(path, "w") as f:
        f.write(dumps(value))
