"""A small YAML reader for mapper configuration files.

Reads the block-style subset the reference's configs use — nested
mappings, sequences (of scalars or of single-key mappings), plain and quoted
scalars, inline ``[a, b]`` lists and ``{k: v}`` mappings (which may span
lines), and ``#`` comments — and resolves plain scalars with YAML 1.1's
rules (as PyYAML's ``SafeLoader`` does: ``1.0`` is a float, ``1e-3`` a
string, ``yes`` a bool).  Duplicate keys are an error, as in the reference's
``validateYamlKeys`` (``Mapper.cpp:44-50``).  Anchors, tags, multi-document
streams and block scalars (``|``, ``>``) are not supported and raise.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

__all__ = ["YAMLError", "load_yaml"]


class YAMLError(ValueError):
    pass


_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")


def _scalar(text: str, line: int) -> Any:
    s = text.strip()
    if s[:1] in ("'", '"'):
        if len(s) < 2 or s[-1] != s[0]:
            raise YAMLError(f"unterminated quoted scalar (line {line})")
        return s[1:-1]
    if s[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
        raise YAMLError(f"unsupported YAML construct {s!r} (line {line})")
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s.lower() in _BOOL and s in (s.lower(), s.capitalize(), s.upper()):
        return _BOOL[s.lower()]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s.startswith("-") else float("inf")
    if _NAN.match(s):
        return float("nan")
    return s


def _split_top(text: str, sep: str) -> List[str]:
    """Split on ``sep`` outside brackets and quotes."""
    out, depth, quote, cur = [], 0, "", []
    for ch in text:
        if quote:
            quote = "" if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    out.append("".join(cur))
    return out


def _key_value(text: str):
    """``key: value`` -> (key, value text) or None when ``text`` is not a
    mapping entry."""
    parts = _split_top(text + " ", ":")
    for i in range(1, len(parts)):
        # a mapping colon is followed by a space (or ends the line)
        if parts[i][:1] in (" ", "\t"):
            key = ":".join(parts[:i]).strip()
            return key, ":".join(parts[i:]).strip()
    return None


def _unique(pairs, line: int) -> dict:
    out = {}
    for key, value in pairs:
        if key in out:
            raise YAMLError(f"Duplicated key: {key} (line {line})")
        out[key] = value
    return out


def _flow(text: str, line: int) -> Any:
    s = text.strip()
    if s.startswith("[") or s.startswith("{"):
        close = "]" if s[0] == "[" else "}"
        if not s.endswith(close):
            raise YAMLError(f"unbalanced flow collection {s!r} (line {line})")
        body = s[1:-1].strip()
        items = [t for t in _split_top(body, ",") if t.strip()] if body \
            else []
        if close == "]":
            return [_flow(t, line) for t in items]
        pairs = []
        for t in items:
            kv = _key_value(t)
            if kv is None:
                raise YAMLError(f"expected 'key: value' in {s!r} "
                                f"(line {line})")
            pairs.append((_scalar(kv[0], line), _flow(kv[1], line)))
        return _unique(pairs, line)
    return _scalar(s, line)


def _strip_comment(line: str) -> str:
    quote = ""
    for i, ch in enumerate(line):
        if quote:
            quote = "" if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _lines(text: str) -> List[Tuple[int, str, int]]:
    """(indent, content, line number) per logical line: comments and blank
    lines dropped, lines of an open flow collection joined."""
    out: List[Tuple[int, str, int]] = []
    pending = None
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YAMLError(f"tab in indentation (line {no})")
        body = _strip_comment(raw).rstrip()
        if body.strip() in ("---", "...") and not raw.startswith(" "):
            if out or pending:
                raise YAMLError(f"multiple documents (line {no})")
            continue
        if not body.strip():
            continue
        if pending is not None:
            pending[1] += " " + body.strip()
        else:
            pending = [len(body) - len(body.lstrip()), body.strip(), no]
        depth = sum(pending[1].count(c) for c in "[{") \
            - sum(pending[1].count(c) for c in "]}")
        if depth <= 0:
            out.append(tuple(pending))
            pending = None
    if pending is not None:
        raise YAMLError(f"unbalanced flow collection (line {pending[2]})")
    return out


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    """Parse the block starting at ``lines[i]`` (indent ``indent``)."""
    text = lines[i][1]
    if text.startswith("- ") or text == "-":
        return _sequence(lines, i, indent)
    if text[:1] in "[{":
        return _flow(text, lines[i][2]), i + 1
    return _mapping(lines, i, indent)


def _value(lines, i: int, indent: int, text: str, no: int,
           seq_same_indent: bool) -> Tuple[Any, int]:
    """Value of an entry whose inline text is ``text``; nested blocks start
    on the next line."""
    if text:
        return _flow(text, no), i + 1
    if i + 1 < len(lines):
        nxt_indent, nxt, _ = lines[i + 1]
        if nxt_indent > indent:
            return _block(lines, i + 1, nxt_indent)
        if (seq_same_indent and nxt_indent == indent
                and (nxt.startswith("- ") or nxt == "-")):
            return _sequence(lines, i + 1, indent)
    return None, i + 1


def _mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        _, text, no = lines[i]
        if text.startswith("- ") or text == "-":
            break
        kv = _key_value(text)
        if kv is None:
            raise YAMLError(f"expected 'key: value', got {text!r} "
                            f"(line {no})")
        key = _scalar(kv[0], no)
        if key in out:
            raise YAMLError(f"Duplicated key: {key} (line {no})")
        out[key], i = _value(lines, i, indent, kv[1], no, True)
    if i < len(lines) and lines[i][0] > indent:
        raise YAMLError(f"bad indentation (line {lines[i][2]})")
    return out, i


def _sequence(lines, i: int, indent: int) -> Tuple[list, int]:
    items = []
    while i < len(lines) and lines[i][0] == indent and (
            lines[i][1].startswith("- ") or lines[i][1] == "-"):
        _, text, no = lines[i]
        rest = text[1:].lstrip()
        if not rest:
            value, i = _value(lines, i, indent, "", no, False)
        elif _key_value(rest) is not None and rest[0] not in "[{'\"":
            # "- key: value" opens a mapping whose keys sit at the column
            # of "key"
            col = indent + len(text) - len(rest)
            lines[i] = (col, rest, no)
            value, i = _mapping(lines, i, col)
        else:
            value, i = _flow(rest, no), i + 1
        items.append(value)
    if i < len(lines) and lines[i][0] > indent:
        raise YAMLError(f"bad indentation (line {lines[i][2]})")
    return items, i


def load_yaml(stream) -> Any:
    """Parse a YAML document from a string or a text file object."""
    text = stream if isinstance(stream, str) else stream.read()
    lines = _lines(text)
    if not lines:
        return None
    indent, first, no = lines[0]
    if _key_value(first) is None and not (first.startswith("- ")
                                          or first == "-"):
        if len(lines) > 1:
            raise YAMLError(f"unexpected content (line {lines[1][2]})")
        return _flow(first, no)
    value, i = _block(lines, 0, indent)
    if i < len(lines):
        raise YAMLError(f"unexpected content (line {lines[i][2]})")
    return value
