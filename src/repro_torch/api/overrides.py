"""Dotted-path overrides for frozen nested config dataclasses — a copy of
``repro.api.overrides`` over the port's config.

The CLI's ``--set flow.eta=0.5 --set flow.num_steps=4`` flags are applied
here: the path walks nested dataclass fields, the raw value is parsed as
JSON when possible (so lists/dicts/bools work) and then coerced against the
declared field type by :func:`repro_torch.config.coerce`.  Frozen
dataclasses are rebuilt bottom-up with :func:`dataclasses.replace`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, Mapping, Sequence

from repro_torch.config import ConfigError, coerce, field_types


def parse_value(raw: Any) -> Any:
    """JSON-decode a CLI value when possible, else keep it as a string."""
    if not isinstance(raw, str):
        return raw
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return raw


def parse_assignments(pairs: Iterable[str]) -> Dict[str, Any]:
    """``["flow.eta=0.5", ...]`` -> ``{"flow.eta": 0.5, ...}``."""
    out: Dict[str, Any] = {}
    for pair in pairs:
        path, sep, raw = pair.partition("=")
        if not sep or not path:
            raise ConfigError(
                f"bad override {pair!r}: expected DOTTED.PATH=VALUE")
        out[path.strip()] = parse_value(raw)
    return out


def _set_path(cfg: Any, parts: Sequence[str], value: Any, full: str) -> Any:
    if not dataclasses.is_dataclass(cfg):
        raise ConfigError(
            f"override {full!r}: {type(cfg).__name__} has no nested field "
            f"{parts[0]!r}")
    names = {f.name for f in dataclasses.fields(cfg)}
    head = parts[0]
    if head not in names:
        raise ConfigError(
            f"override {full!r}: unknown field {head!r} on "
            f"{type(cfg).__name__}; valid fields: {sorted(names)}")
    if len(parts) == 1:
        new = coerce(value, field_types(type(cfg))[head], full)
    else:
        sub = getattr(cfg, head)
        if sub is None:
            raise ConfigError(
                f"override {full!r}: field {head!r} is None — set it to a "
                "full object first (e.g. via the config file)")
        new = _set_path(sub, parts[1:], value, full)
    return dataclasses.replace(cfg, **{head: new})


def apply_overrides(cfg: Any,
                    overrides: Mapping[str, Any] | Iterable[str]) -> Any:
    """Return a copy of ``cfg`` with every dotted override applied.

    ``overrides`` is either a mapping ``{"flow.eta": 0.5}`` or an iterable of
    ``"flow.eta=0.5"`` assignment strings.
    """
    if not isinstance(overrides, Mapping):
        overrides = parse_assignments(overrides)
    for path, value in overrides.items():
        cfg = _set_path(cfg, path.split("."), value, path)
    return cfg


def replace_fields(obj: Any, mapping: Mapping[str, Any]) -> Any:
    """Typed ``dataclasses.replace`` from a plain dict (used for
    ``RunConfig.arch_overrides`` on the resolved ArchConfig)."""
    if not mapping:
        return obj
    hints = field_types(type(obj))
    names = {f.name for f in dataclasses.fields(obj)}
    unknown = sorted(set(mapping) - names)
    if unknown:
        raise ConfigError(
            f"arch_overrides: unknown field(s) {unknown} on "
            f"{type(obj).__name__}; valid fields: {sorted(names)}")
    coerced = {k: coerce(parse_value(v), hints[k], k)
               for k, v in mapping.items()}
    return dataclasses.replace(obj, **coerced)
