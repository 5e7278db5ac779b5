"""The dotted-key override grammar behind ``--set`` (the port's copy of
``repro.run.overrides``; its messages are the reference's word for word).

One assignment is ``<dotted.path>=<value>``:

    --set trainer.total_steps=50
    --set serve.max_batch=8
    --set model.param_sharding=wus
    --set model.moe.top_k=1
    --set reduced=false

Values are coerced against the *declared type* of the targeted dataclass
field (``int``/``float``/``bool``/``str``/``Optional[T]``/``Tuple[T, ...]``),
so a typo'd value fails loudly at spec-build time, not as a shape error
three layers down. Unknown keys fail with a did-you-mean suggestion over
the legal field names at that level.

``model.*`` paths are special: they are validated and coerced against
``ModelConfig`` (via ``configs.base.override_paths``) but *stored* as a
pending-override dict on the spec — the concrete config they apply to
only exists at dispatch time (after ``reduced()``), see
``repro_torch.run.dispatch.resolve_config``.
"""
from __future__ import annotations

import dataclasses
import difflib
import typing
import warnings
from typing import Any, Dict, Mapping, Sequence

from repro_torch.configs import base as config_base
from repro_torch.configs.base import ModelConfig


class SpecError(ValueError):
    """A run-spec key or value the grammar rejects (bad key, bad type)."""


def did_you_mean(name: str, candidates) -> str:
    """'; did you mean <m>?' suffix (empty when nothing is close)."""
    close = difflib.get_close_matches(name, list(candidates), n=1)
    return f"; did you mean {close[0]!r}?" if close else ""


# --------------------------------------------------------------------------- #
# Typed coercion.
# --------------------------------------------------------------------------- #
_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def coerce_value(raw: Any, typ: Any, *, where: str) -> Any:
    """Coerce ``raw`` (a CLI string or a JSON/TOML-native value) to ``typ``.

    Raises :class:`SpecError` naming ``where`` on any mismatch.
    """
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[T]
        inner = [a for a in typing.get_args(typ) if a is not type(None)]
        if raw is None or (isinstance(raw, str) and raw.lower() in ("none", "null")):
            return None
        return coerce_value(raw, inner[0], where=where)
    if origin in (tuple, typing.Tuple):
        items = raw
        if isinstance(raw, str):
            items = [s.strip() for s in raw.split(",") if s.strip()]
        if not isinstance(items, (list, tuple)):
            raise SpecError(f"{where}: expected a list, got {raw!r}")
        args = typing.get_args(typ)
        elt = args[0] if args else str
        return tuple(coerce_value(v, elt, where=where) for v in items)
    if typ is bool:
        if isinstance(raw, bool):
            return raw
        if isinstance(raw, str) and raw.lower() in _TRUE:
            return True
        if isinstance(raw, str) and raw.lower() in _FALSE:
            return False
        raise SpecError(f"{where}: expected a bool "
                        f"(true/false), got {raw!r}")
    if typ is int:
        if isinstance(raw, bool):
            raise SpecError(f"{where}: expected an int, got {raw!r}")
        if isinstance(raw, int):
            return raw
        try:
            return int(str(raw))
        except ValueError:
            raise SpecError(f"{where}: expected an int, got {raw!r}") from None
    if typ is float:
        if isinstance(raw, bool):
            raise SpecError(f"{where}: expected a float, got {raw!r}")
        if isinstance(raw, (int, float)):
            return float(raw)
        try:
            return float(str(raw))
        except ValueError:
            raise SpecError(f"{where}: expected a float, got {raw!r}") from None
    if typ is str:
        if not isinstance(raw, str):
            raise SpecError(f"{where}: expected a string, got {raw!r}")
        return raw
    if dataclasses.is_dataclass(typ):
        raise SpecError(
            f"{where}: is a section; set one of its fields "
            f"({', '.join(f.name for f in dataclasses.fields(typ))})"
        )
    return raw  # permissive for Any / Mapping fields


# --------------------------------------------------------------------------- #
# Model-config overrides (validated now, applied at dispatch).
# --------------------------------------------------------------------------- #
def model_override_paths() -> Dict[str, Any]:
    return config_base.override_paths(ModelConfig)


def coerce_model_override(dotted: str, raw: Any) -> Any:
    """Validate+coerce one ``model.<dotted>`` override value."""
    paths = model_override_paths()
    if dotted not in paths:
        raise SpecError(
            f"model has no overridable field {dotted!r}"
            + did_you_mean(dotted, paths)
        )
    return coerce_value(raw, paths[dotted], where=f"model.{dotted}")


def normalize_model_overrides(mapping: Mapping[str, Any]) -> Dict[str, Any]:
    """Flatten a (possibly nested) spec-file ``model`` section into the
    dotted-key dict RunSpec stores, validating every leaf."""
    flat: Dict[str, Any] = {}

    def walk(prefix: str, m: Mapping[str, Any]):
        for k, v in m.items():
            dotted = f"{prefix}{k}"
            if isinstance(v, Mapping):
                walk(f"{dotted}.", v)
            else:
                flat[dotted] = coerce_model_override(dotted, v)

    walk("", mapping)
    return flat


# --------------------------------------------------------------------------- #
# Assignment parsing + application to a RunSpec.
# --------------------------------------------------------------------------- #
def parse_assignment(text: str):
    """``'a.b=c'`` -> ``('a.b', 'c')``; reject assignment-free tokens."""
    key, eq, value = text.partition("=")
    key = key.strip()
    if not eq or not key:
        raise SpecError(
            f"--set expects <dotted.key>=<value>, got {text!r}"
        )
    return key, value.strip()


def apply_assignments(spec, assignments: Sequence[str]):
    """Apply ``--set`` strings to a RunSpec, returning the new spec."""
    for text in assignments:
        dotted, raw = parse_assignment(text)
        spec = set_path(spec, dotted, raw)
    return spec


def set_path(spec, dotted: str, raw: Any, *, _where: str = ""):
    """Set one dotted path on a RunSpec (sections — arbitrarily nested —
    plus ``model.*`` and top-level scalars). Deprecated flat spellings
    declared in a section's ``LEGACY_KEYS`` warn and forward to their
    nested home (``serve.kv_layout`` -> ``serve.kv.layout``)."""
    head, _, rest = dotted.partition(".")
    fields = config_base.resolved_field_types(type(spec))
    legacy = getattr(type(spec), "LEGACY_KEYS", {})
    level = _where or "run spec"
    if head in legacy and head not in fields:
        target = legacy[head]
        warnings.warn(
            f"{level}.{head} is deprecated; use {level}.{target}"
            if _where else f"{head} is deprecated; use {target}",
            DeprecationWarning, stacklevel=2)
        if rest:
            raise SpecError(
                f"{head!r} is scalar; {dotted!r} does not exist")
        return set_path(spec, target, raw, _where=_where)
    if head not in fields:
        raise SpecError(
            f"{level} has no field {head!r}"
            + did_you_mean(head, list(fields) + list(legacy))
        )
    if head == "model" and not _where:
        if not rest:
            raise SpecError(
                "set a concrete model field, e.g. model.param_sharding=wus"
            )
        value = coerce_model_override(rest, raw)
        merged = dict(getattr(spec, "model"))
        merged[rest] = value
        return dataclasses.replace(spec, model=merged)
    typ = fields[head]
    if dataclasses.is_dataclass(typ):
        if not rest:
            raise SpecError(
                f"{head!r} is a section; set one of its fields "
                f"({', '.join(f.name for f in dataclasses.fields(typ))})"
            )
        section = getattr(spec, head)
        sub = set_path(section, rest, raw,
                       _where=f"{_where}.{head}" if _where else head)
        return dataclasses.replace(spec, **{head: sub})
    if rest:
        raise SpecError(f"{head!r} is scalar; {dotted!r} does not exist")
    where = f"{_where}.{head}" if _where else head
    return dataclasses.replace(
        spec, **{head: coerce_value(raw, typ, where=where)}
    )
