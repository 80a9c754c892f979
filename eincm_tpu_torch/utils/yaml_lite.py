"""A reader for the subset of YAML that the experiment configs use.

The card's machine has no PyYAML. This reader gives what `yaml.safe_load`
gives (YAML 1.1 resolution) for what `configs/*.yaml`, command-line
overrides and DSEC's `cam_to_cam.yaml` use: nested block mappings, block
sequences (`- x`, nested as `- - x`, holding mappings as `- k: v`, and at
their key's indent as `yaml.safe_dump` writes them), `#` comments,
one-line flow lists (`[480, 640]`) and flow maps (`{0: 2, 1: 2}`), plain
and quoted scalars resolved as ints, floats, bools (`on`/`off`/`yes`/`no`
too), `null`/`~` and strings. It never guesses: valid YAML outside the
subset (anchors, aliases, tags, block scalars `|` and `>`, multi-line flow
collections or plain scalars, several documents, timestamps, merge keys)
raises `UnsupportedYAML`, and input that `yaml.safe_load` rejects too
raises `YAMLSyntaxError`; both are `ValueError`s naming the line.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple


class YAMLSyntaxError(ValueError):
    """Input that is not YAML (`yaml.safe_load` rejects it too)."""


class UnsupportedYAML(ValueError):
    """YAML outside the subset this reader takes."""


# the implicit resolvers of PyYAML's SafeLoader (resolver.py)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)

_SPACE = " \t"
_FLOW = ",[]{}"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\"}


def _sexagesimal(text: str, cast):
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _resolve(text: str, lineno: int) -> Any:
    """A plain scalar's value, as SafeLoader constructs it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if text == "<<" or text == "=" or _TIMESTAMP.match(text):
        raise UnsupportedYAML(f"line {lineno}: {text!r} (merge key, value key or "
                              "timestamp) is not supported")
    return text


class _Line:
    """One scalar or flow node on one line: `text[pos:]` is left to read."""

    def __init__(self, text: str, lineno: int, more_lines: bool):
        self.text, self.pos, self.lineno, self.more = text, 0, lineno, more_lines

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.text[i] if i < len(self.text) else "\0"

    def skip_space(self):
        while self.peek() in _SPACE and self.peek() != "\0":
            self.pos += 1

    def syntax(self, what: str):
        return YAMLSyntaxError(f"line {self.lineno}: {what}: {self.text!r}")

    def unsupported(self, what: str):
        return UnsupportedYAML(f"line {self.lineno}: {what} is not supported: "
                               f"{self.text!r}")

    def node(self, flow: bool) -> Any:
        """A flow collection, a quoted scalar or a plain scalar at `pos`."""
        self.skip_space()
        ch = self.peek()
        if ch in "&*!":
            raise self.unsupported("an anchor, alias or tag")
        if ch in "|>" and not flow:
            raise self.unsupported("a block scalar")
        if ch in "[{":
            return self.collection()
        if ch in "'\"":
            return self.quoted()
        if ch in "-?:" and self.peek(1) in _SPACE + "\0" + (_FLOW if flow else ""):
            if ch == "-" and not flow:
                raise self.unsupported("a block sequence")
            raise self.unsupported(f"the indicator {ch!r}")
        if ch in _FLOW + "#%@`" + ("|>" if flow else ""):
            raise self.syntax(f"{ch!r} cannot start a scalar")
        return _resolve(self.plain(flow), self.lineno)

    def plain(self, flow: bool) -> str:
        """PyYAML's scan_plain on one line: words up to ': ', ' #' or, in a
        flow collection, a flow indicator."""
        start = end = self.pos
        while True:
            ch = self.peek()
            stop = ch in _SPACE + "\0" or (
                ch == ":" and self.peek(1) in _SPACE + "\0" + (_FLOW if flow else "")
            ) or (flow and ch in _FLOW + "?")
            if stop:
                if ch not in _SPACE:
                    break
                self.skip_space()
                if self.peek() in "#\0":
                    break
                continue
            self.pos += 1
            end = self.pos
        self.pos = end
        return self.text[start:end]

    def quoted(self) -> str:
        quote, out = self.peek(), []
        self.pos += 1
        while True:
            ch = self.peek()
            if ch == "\0":
                if self.more:
                    raise self.unsupported("a quoted scalar over several lines")
                raise self.syntax("unclosed quoted scalar")
            self.pos += 1
            if quote == "'" and ch == "'":
                if self.peek() != "'":
                    return "".join(out)
                out.append("'")
                self.pos += 1
            elif quote == '"' and ch == '"':
                return "".join(out)
            elif quote == '"' and ch == "\\":
                esc = self.peek()
                if esc not in _ESCAPES:
                    raise self.unsupported(f"the escape \\{esc}")
                out.append(_ESCAPES[esc])
                self.pos += 1
            else:
                out.append(ch)

    def collection(self) -> Any:
        opening = self.peek()
        closing = "]" if opening == "[" else "}"
        self.pos += 1
        out: Any = [] if opening == "[" else {}
        while True:
            self.skip_space()
            ch = self.peek()
            if ch == "\0":
                raise self.unclosed(opening)
            if ch == closing:
                self.pos += 1
                return out
            if opening == "[":
                item = self.node(flow=True)
                self.skip_space()
                if self.peek() == ":":
                    raise self.unsupported("a mapping inside a flow list")
                out.append(item)
            else:
                key = self.node(flow=True)
                if isinstance(key, (list, dict)):
                    raise self.unsupported("a collection as a key")
                self.skip_space()
                value = None
                if self.peek() == ":":
                    self.pos += 1
                    self.skip_space()
                    if self.peek() not in ",}":
                        value = self.node(flow=True)
                out[key] = value
            self.skip_space()
            ch = self.peek()
            if ch == ",":
                self.pos += 1
            elif ch == "\0":
                raise self.unclosed(opening)
            elif ch != closing:
                raise self.syntax(f"expected ',' or {closing!r}")

    def unclosed(self, opening: str):
        if self.more:
            return self.unsupported("a flow collection over several lines")
        return self.syntax(f"unclosed {opening!r}")

    def rest(self, what: str):
        """Only a comment may follow a node on its line."""
        self.skip_space()
        if self.peek() not in "#\0":
            raise self.syntax(f"unexpected text after {what}")


def _strip(raw: str, lineno: int) -> Tuple[int, str]:
    """(indent, content without its comment) of one line."""
    body = raw.lstrip(" ")
    indent = len(raw) - len(body)
    if body[:1] == "\t":
        raise YAMLSyntaxError(f"line {lineno}: a tab in the indentation")
    quote, i = None, 0
    while i < len(body):
        ch = body[i]
        if quote == "'" and ch == "'" and body[i + 1 : i + 2] == "'":
            i += 1  # an escaped quote
        elif quote == '"' and ch == "\\":
            i += 1  # an escape
        elif quote:
            quote = None if ch == quote else quote
        elif ch in "'\"" and (i == 0 or body[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or body[i - 1] in _SPACE):
            body = body[:i]
            break
        i += 1
    return indent, body.rstrip()


def _key_split(content: str) -> int:
    """Index of the ':' that ends a block mapping key, or -1."""
    quote, depth = None, 0
    for i, ch in enumerate(content):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and content[i + 1 : i + 2] in ("", " ", "\t"):
            return i
    return -1


def loads(text: str) -> Any:
    """`yaml.safe_load(text)` for the subset the module docstring names."""
    lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
    for lineno, raw in enumerate(text.splitlines(), 1):
        if raw.startswith(("---", "...", "%")):
            raise UnsupportedYAML(f"line {lineno}: document markers and directives "
                                  f"are not supported: {raw!r}")
        indent, content = _strip(raw, lineno)
        if content:
            lines.append((lineno, indent, content))
    if not lines:
        return None
    node, i = _block(lines, 0, lines[0][1])
    if i < len(lines):
        lineno, _, content = lines[i]
        raise YAMLSyntaxError(f"line {lineno}: bad indentation: {content!r}")
    return node


def _is_item(content: str) -> bool:
    """Whether a line's content is a block sequence entry ('- ...')."""
    return content == "-" or content[:2] in ("- ", "-\t")


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    lineno, _, content = lines[i]
    if _is_item(content):
        return _sequence(lines, i, indent)
    if _key_split(content) >= 0:
        return _mapping(lines, i, indent)
    line = _Line(content, lineno, more_lines=i + 1 < len(lines))
    node = line.node(flow=False)
    line.rest("a node")
    if i + 1 < len(lines) and lines[i + 1][1] >= indent:
        raise UnsupportedYAML(f"line {lines[i + 1][0]}: a scalar over several lines "
                              "is not supported")
    return node, i + 1


def _sequence(lines, i: int, indent: int) -> Tuple[list, int]:
    """A block sequence whose '-' stand at `indent`. An entry's node starts
    after its '- ' and is read as a block at that column, so '- - x' nests a
    sequence and '- k: v' (with its further keys below 'k') holds a mapping."""
    out: list = []
    while i < len(lines) and lines[i][1] == indent and _is_item(lines[i][2]):
        lineno, _, content = lines[i]
        rest = content[1:].lstrip(_SPACE)
        if not rest:  # '-' alone: the entry is the block below it, or null
            i += 1
            if i < len(lines) and lines[i][1] > indent:
                value, i = _block(lines, i, lines[i][1])
            else:
                value = None
        else:
            column = indent + len(content) - len(rest)
            lines[i] = (lineno, column, rest)
            value, i = _block(lines, i, column)
        out.append(value)
    if i < len(lines) and lines[i][1] > indent:
        raise YAMLSyntaxError(f"line {lines[i][0]}: bad indentation: {lines[i][2]!r}")
    return out, i


def _mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines):
        lineno, ind, content = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YAMLSyntaxError(f"line {lineno}: bad indentation: {content!r}")
        colon = _key_split(content)
        if _is_item(content):
            raise YAMLSyntaxError(f"line {lineno}: a block sequence entry among "
                                  f"a mapping's keys: {content!r}")
        if colon < 0:
            raise YAMLSyntaxError(f"line {lineno}: expected 'key: value': {content!r}")
        key_line = _Line(content[:colon].rstrip(), lineno, more_lines=False)
        if key_line.peek() in "[{?":
            raise key_line.unsupported("a complex key")
        key = key_line.node(flow=False)
        key_line.rest("a key")
        value_text = content[colon + 1 :].strip()
        nested = i + 1 < len(lines) and lines[i + 1][1] > indent
        # a block sequence may stand at its key's indent ('key:' then '- x')
        sequence = (i + 1 < len(lines) and lines[i + 1][1] == indent
                    and _is_item(lines[i + 1][2]))
        i += 1
        if not value_text:
            value = None
            if nested or sequence:
                value, i = _block(lines, i, lines[i][1])
        else:
            line = _Line(value_text, lineno, more_lines=i < len(lines))
            value = line.node(flow=False)
            line.rest("a value")
            if nested and _key_split(lines[i][2]) >= 0:
                raise YAMLSyntaxError(f"line {lines[i][0]}: a mapping inside a "
                                      f"scalar: {lines[i][2]!r}")
            if nested:
                raise UnsupportedYAML(f"line {lines[i][0]}: a value continued on "
                                      "the next line is not supported")
        out[key] = value
    return out, i


def load(path) -> Any:
    """`loads` of a file's text."""
    with open(path) as f:
        return loads(f.read())
