"""Spec files: ``--spec runs/<name>.json`` / ``.toml`` -> :class:`RunSpec`.

The port's copy of ``repro.run.specfile``, so that a file loads, and
fails, as it does there. JSON is parsed with the stdlib. TOML uses
:mod:`tomllib` when the interpreter ships it (3.11+); on older
interpreters a minimal built-in parser covers the subset a run spec
needs — ``[section]`` /
``[section.sub]`` tables, ``key = value`` with strings, ints, floats,
booleans and flat arrays, and ``#`` comments. No new dependency either
way.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

from repro_torch.run.overrides import SpecError
from repro_torch.run.spec import RunSpec


def load_spec_file(path: str) -> RunSpec:
    """Parse a .json/.toml spec file into a validated RunSpec."""
    if not os.path.exists(path):
        raise SpecError(f"spec file not found: {path}")
    with open(path) as f:
        text = f.read()
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"{path}: invalid JSON: {e}") from None
    elif ext == ".toml":
        data = _load_toml(text, path)
    else:
        raise SpecError(
            f"{path}: unsupported spec extension {ext!r} (use .json or .toml)"
        )
    try:
        return RunSpec.from_dict(data)
    except SpecError as e:
        raise SpecError(f"{path}: {e}") from None


def _load_toml(text: str, path: str) -> Dict[str, Any]:
    try:
        import tomllib  # Python 3.11+
    except ImportError:
        return _parse_toml_minimal(text, path)
    try:
        return tomllib.loads(text)
    except tomllib.TOMLDecodeError as e:
        raise SpecError(f"{path}: invalid TOML: {e}") from None


# --------------------------------------------------------------------------- #
# Minimal TOML subset parser (pre-3.11 fallback).
# --------------------------------------------------------------------------- #
_SECTION_RE = re.compile(r"^\[([A-Za-z0-9_.\-]+)\]$")
_KEY_RE = re.compile(r"^([A-Za-z0-9_\-]+)\s*=\s*(.+)$")


def _strip_comment(line: str) -> str:
    out, in_str, quote = [], False, ""
    for ch in line:
        if in_str:
            out.append(ch)
            if ch == quote:
                in_str = False
        elif ch in "\"'":
            in_str, quote = True, ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out).strip()


def _parse_scalar(tok: str, where: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] in "\"'" and tok[-1] == tok[0]:
        return tok[1:-1]
    if tok == "true":
        return True
    if tok == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    raise SpecError(f"{where}: cannot parse TOML value {tok!r} "
                    "(bare strings must be quoted)")


def _parse_value(tok: str, where: str) -> Any:
    tok = tok.strip()
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        if not inner:
            return []
        return [_parse_scalar(t, where) for t in inner.split(",") if t.strip()]
    return _parse_scalar(tok, where)


def _parse_toml_minimal(text: str, path: str) -> Dict[str, Any]:
    data: Dict[str, Any] = {}
    table = data
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw)
        if not line:
            continue
        where = f"{path}:{lineno}"
        m = _SECTION_RE.match(line)
        if m:
            table = data
            for part in m.group(1).split("."):
                table = table.setdefault(part, {})
                if not isinstance(table, dict):
                    raise SpecError(f"{where}: [{m.group(1)}] collides with "
                                    "a non-table key")
            continue
        m = _KEY_RE.match(line)
        if not m:
            raise SpecError(f"{where}: cannot parse TOML line {raw.strip()!r}")
        table[m.group(1)] = _parse_value(m.group(2), where)
    return data
