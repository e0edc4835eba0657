"""A reader for the subset of YAML the port's configs use, standard library only.

The JAX package reads configs with ``yaml.safe_load``; the port reads them
with :func:`safe_load`, which gives the same Python values for:

* block maps and block lists (a list may sit at its key's indent);
* flow lists ``[a, b]`` and flow maps ``{1: 0.01, 2: 0.003}``, nested, on
  one line or continued over several;
* ``#`` comments, blank lines and one leading ``---``;
* single- and double-quoted scalars, and plain scalars typed as PyYAML's
  YAML 1.1 resolver types them: ``null``/``~``/empty, the bools
  (``yes``/``no``/``on``/``off`` included), ints (``0x``/``0b``/octal/
  ``_``), floats (``1.0e-3`` is a float, ``1e-3`` stays a string, as in
  PyYAML), ``.inf``/``.nan``; anything else, ``1981/10/01`` included, is a
  string.

Everything outside that subset raises :class:`YamlSubsetError` rather than
read differently from PyYAML: anchors and aliases, tags, block scalars
(``|``, ``>``), merge keys, timestamps (``1981-10-01``, which PyYAML turns
into a date), sexagesimal numbers, duplicate keys, several documents.
"""

from __future__ import annotations

import re
from typing import Any

__all__ = ["YamlSubsetError", "safe_load"]


class YamlSubsetError(ValueError):
    """The text is not in the YAML subset this reader covers."""


_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_BOOL_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+)$""",
    re.X,
)
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    re.X,
)
# Forms PyYAML resolves to types this reader does not build: refuse them.
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:(?:[Tt]|[ \t]+)[0-9].*)?$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _plain(text: str, where: str) -> Any:
    """Type one plain scalar as PyYAML's YAML 1.1 resolver does."""
    if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise YamlSubsetError(f"{where}: {text!r} uses a YAML feature outside the subset "
                              "(anchors, aliases, tags, block scalars, directives)")
    if text == "<<" or text == "=":
        raise YamlSubsetError(f"{where}: merge and value keys are outside the subset")
    if _NULL.match(text):
        return None
    if text in _BOOL_TRUE:
        return True
    if text in _BOOL_FALSE:
        return False
    if _INT.match(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if len(s) > 1 and s[0] == "0":
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(text):
        s = text.replace("_", "").lower()
        if s.endswith(".inf"):
            return float("-inf") if s[0] == "-" else float("inf")
        if s == ".nan":
            return float("nan")
        return float(s)
    if _SEXAGESIMAL.match(text) or _TIMESTAMP.match(text):
        raise YamlSubsetError(f"{where}: {text!r} is a sexagesimal number or a timestamp; "
                              "quote it to keep it a string")
    return text


def _double_quoted(body: str, where: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        nxt = body[i + 1 : i + 2]
        if nxt in _ESCAPES:
            out.append(_ESCAPES[nxt])
            i += 2
        elif nxt in ("x", "u", "U"):
            width = {"x": 2, "u": 4, "U": 8}[nxt]
            out.append(chr(int(body[i + 2 : i + 2 + width], 16)))
            i += 2 + width
        else:
            raise YamlSubsetError(f"{where}: unknown escape \\{nxt} in a double-quoted scalar")
    return "".join(out)


def _quoted_end(text: str, start: int, where: str) -> int:
    """Index just past the quoted scalar that opens at ``text[start]``."""
    q = text[start]
    i = start + 1
    while i < len(text):
        if q == "'" and text[i] == "'":
            if text[i + 1 : i + 2] == "'":
                i += 2
                continue
            return i + 1
        if q == '"' and text[i] == "\\":
            i += 2
            continue
        if q == '"' and text[i] == '"':
            return i + 1
        i += 1
    raise YamlSubsetError(f"{where}: unterminated quoted scalar")


def _unquote(token: str, where: str) -> str:
    if token[0] == "'":
        return token[1:-1].replace("''", "'")
    return _double_quoted(token[1:-1], where)


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at the line start or after whitespace) that is
    not inside a quoted scalar."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in ("'", '"') and (i == 0 or line[i - 1] in " \t[{,:-"):
            try:
                i = _quoted_end(line, i, "comment scan")
            except YamlSubsetError:
                return line
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _scalar(text: str, where: str) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        end = _quoted_end(text, 0, where)
        if text[end:].strip():
            raise YamlSubsetError(f"{where}: text after a quoted scalar: {text!r}")
        return _unquote(text, where)
    if re.search(r":(?:[ \t]|$)", text) or text == "-" or text.startswith("- "):
        raise YamlSubsetError(f"{where}: {text!r} is no plain scalar (PyYAML refuses it too)")
    return _plain(text, where)


class _Flow:
    """Recursive-descent reader of one flow collection."""

    def __init__(self, text: str, where: str) -> None:
        self.text, self.i, self.where = text, 0, where

    def _ws(self) -> None:
        while self.i < len(self.text) and self.text[self.i] in " \t\n":
            self.i += 1

    def _peek(self) -> str:
        self._ws()
        return self.text[self.i : self.i + 1]

    def _expect(self, c: str) -> None:
        if self._peek() != c:
            raise YamlSubsetError(f"{self.where}: expected {c!r} in flow {self.text!r}")
        self.i += 1

    def node(self) -> Any:
        c = self._peek()
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in ("'", '"'):
            end = _quoted_end(self.text, self.i, self.where)
            token, self.i = self.text[self.i : end], end
            return _unquote(token, self.where)
        start = self.i
        while self.i < len(self.text):
            ch = self.text[self.i]
            if ch in ",[]{}":
                break
            if ch == ":" and self.text[self.i + 1 : self.i + 2] in ("", " ", "\t", "\n", ",", "}", "]"):
                break
            self.i += 1
        return _plain(self.text[start : self.i].strip(), self.where)

    def _seq(self) -> list:
        self._expect("[")
        out: list = []
        while self._peek() != "]":
            item = self.node()
            if self._peek() == ":":
                raise YamlSubsetError(f"{self.where}: single-pair maps inside a flow list "
                                      "are outside the subset")
            out.append(item)
            if self._peek() == ",":
                self.i += 1
            elif self._peek() != "]":
                raise YamlSubsetError(f"{self.where}: expected ',' or ']' in {self.text!r}")
        self.i += 1
        return out

    def _map(self) -> dict:
        self._expect("{")
        out: dict = {}
        while self._peek() != "}":
            key = self.node()
            value = None
            if self._peek() == ":":
                self.i += 1
                value = None if self._peek() in (",", "}") else self.node()
            _put(out, key, value, self.where)
            if self._peek() == ",":
                self.i += 1
            elif self._peek() != "}":
                raise YamlSubsetError(f"{self.where}: expected ',' or '}}' in {self.text!r}")
        self.i += 1
        return out

    def document(self) -> Any:
        value = self.node()
        if self._peek():
            raise YamlSubsetError(f"{self.where}: text after a flow collection: {self.text!r}")
        return value


def _put(out: dict, key: Any, value: Any, where: str) -> None:
    if isinstance(key, (dict, list)):
        raise YamlSubsetError(f"{where}: collection keys are outside the subset")
    if key in out:
        raise YamlSubsetError(f"{where}: duplicate key {key!r}")
    out[key] = value


def _split_key(text: str, where: str) -> tuple[str, str] | None:
    """``key: rest`` -> (key token, rest), or None when ``text`` is no map entry."""
    if text[:1] in ("'", '"'):
        end = _quoted_end(text, 0, where)
        rest = text[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return text[:end], rest[1:].strip()
        return None
    if text[:1] in ("[", "{"):
        return None
    for m in re.finditer(r":(?:[ \t]|$)", text):
        return text[: m.start()].rstrip(), text[m.end() :].strip()
    return None


class _Block:
    def __init__(self, lines: list[tuple[int, int, str]]) -> None:
        self.lines = lines  # (line number, indent, content)
        self.i = 0

    def _where(self) -> str:
        return f"line {self.lines[min(self.i, len(self.lines) - 1)][0]}"

    def _flow_value(self, text: str, indent: int) -> Any:
        """A flow collection, joining continuation lines until it closes."""
        where = self._where()
        while True:
            try:
                return _Flow(text, where).document()
            except YamlSubsetError:
                if self.i >= len(self.lines) or self.lines[self.i][1] <= indent:
                    raise
                text += "\n" + self.lines[self.i][2]
                self.i += 1

    def _value(self, rest: str, indent: int, in_list_item: bool = False) -> Any:
        """The value after ``key:`` (or ``-``) on a line at ``indent``."""
        if rest:
            if rest[0] in ("[", "{"):
                return self._flow_value(rest, indent)
            return _scalar(rest, self._where())
        if self.i < len(self.lines):
            nxt = self.lines[self.i][1]
            content = self.lines[self.i][2]
            if nxt > indent or (nxt == indent and not in_list_item and content.startswith("-")
                                and content[1:2] in ("", " ")):
                return self.block(nxt)
        return None

    def block(self, indent: int) -> Any:
        content = self.lines[self.i][2]
        if content == "-" or content.startswith("- "):
            return self._seq(indent)
        if _split_key(content, self._where()) is not None:
            return self._map(indent)
        # a lone scalar or flow collection as the whole node
        self.i += 1
        if content[0] in ("[", "{"):
            return self._flow_value(content, indent)
        value = _scalar(content, self._where())
        if self.i < len(self.lines) and self.lines[self.i][1] >= indent:
            raise YamlSubsetError(f"{self._where()}: multi-line plain scalars are outside the subset")
        return value

    def _seq(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            _, ind, content = self.lines[self.i]
            if ind < indent or not (content == "-" or content.startswith("- ")):
                break  # a map entry at the list's indent: the list sat at its key's indent
            if ind > indent:
                raise YamlSubsetError(f"{self._where()}: bad indentation in a block list")
            rest = content[1:].lstrip()
            if rest and _split_key(rest, self._where()) is not None and rest[0] not in "[{":
                # "- key: value" opens a map whose entries sit at the item's column
                col = ind + (len(content) - len(rest))
                self.lines[self.i] = (self.lines[self.i][0], col, rest)
                out.append(self._map(col))
            else:
                self.i += 1
                out.append(self._value(rest, ind, in_list_item=True))
        return out

    def _map(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            _, ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"{self._where()}: bad indentation in a block map")
            split = _split_key(content, self._where())
            if split is None:
                if content == "-" or content.startswith("- "):
                    break  # a list at its parent key's indent ends here
                raise YamlSubsetError(f"{self._where()}: expected 'key: value', got {content!r}")
            key_tok, rest = split
            where = self._where()
            if key_tok[:1] == "?":
                raise YamlSubsetError(f"{where}: complex keys are outside the subset")
            key = _scalar(key_tok, where)
            self.i += 1
            _put(out, key, self._value(rest, ind), where)
        return out


def safe_load(text: str) -> Any:
    """Read one YAML document of the subset: the value ``yaml.safe_load``
    gives for it. Raises :class:`YamlSubsetError` outside the subset."""
    lines: list[tuple[int, int, str]] = []
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"line {no}: tabs in indentation")
        stripped = _strip_comment(raw)
        if not stripped.strip():
            continue
        content = stripped.strip()
        if content.startswith("%") or content == "...":
            raise YamlSubsetError(f"line {no}: directives and document ends are outside the subset")
        if content == "---" or content.startswith("--- "):
            if lines:
                raise YamlSubsetError(f"line {no}: several documents are outside the subset")
            content = content[3:].strip()
            if not content:
                continue
        lines.append((no, len(stripped) - len(stripped.lstrip()), content))
    if not lines:
        return None
    reader = _Block(lines)
    value = reader.block(lines[0][1])
    if reader.i != len(lines):
        raise YamlSubsetError(f"line {lines[reader.i][0]}: unexpected content {lines[reader.i][2]!r}")
    return value
