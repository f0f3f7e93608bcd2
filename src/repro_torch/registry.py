"""Component registry of the port — the paper's §2.1 contribution.

The same API as ``repro.registry`` (``register``/``lookup``/``build``/
``names``/``items``/``is_registered``/``build_from_config``/``describe``)
over its own table, so a name registered by the JAX package never shadows
or collides with one of the port.  Components register themselves under a
(kind, name) key and are built from configuration alone.
"""
from __future__ import annotations

import importlib
import inspect
from typing import Any, Callable, Dict, Iterable, Mapping, Tuple, Union

# kind -> name -> class/factory
_REGISTRY: Dict[str, Dict[str, Any]] = {}

KINDS = ("adapter", "trainer", "reward", "scheduler", "arch", "frontend",
         "aggregator", "optimizer", "dataset")

# the port's registering modules (the reference's registering modules'
# counterparts)
AUTOLOAD = ("repro_torch.core.schedulers", "repro_torch.models.flow",
            "repro_torch.models.frontends",
            "repro_torch.configs", "repro_torch.core.rewards",
            "repro_torch.optim", "repro_torch.data.prompts",
            "repro_torch.core.trainers")


class RegistryError(KeyError):
    pass


def register(kind: str, name: str, *, override: bool = False) -> Callable:
    """Class decorator registering ``cls`` under ``(kind, name)``."""
    if kind not in KINDS:
        raise RegistryError(f"unknown registry kind {kind!r}; kinds={KINDS}")

    def deco(obj: Any) -> Any:
        bucket = _REGISTRY.setdefault(kind, {})
        if name in bucket and not override and bucket[name] is not obj:
            raise RegistryError(f"{kind}:{name} already registered")
        bucket[name] = obj
        try:
            obj.registry_kind = kind
            obj.registry_name = name
        except (AttributeError, TypeError):  # e.g. functools.partial
            pass
        return obj

    return deco


_AUTOLOADED = False


def _autoload() -> None:
    """Import every registering module (lazily, on the first lookup)."""
    global _AUTOLOADED
    if _AUTOLOADED:
        return
    _AUTOLOADED = True
    for mod in AUTOLOAD:
        importlib.import_module(mod)


def lookup(kind: str, name: str) -> Any:
    if name not in _REGISTRY.get(kind, {}):
        _autoload()
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        avail = sorted(_REGISTRY.get(kind, {}))
        raise RegistryError(
            f"no {kind!r} named {name!r}; available: {avail}") from None


def build(kind: str, name: str, *args: Any, **kwargs: Any) -> Any:
    """Instantiate a registered component."""
    return lookup(kind, name)(*args, **kwargs)


def names(kind: str) -> Tuple[str, ...]:
    _autoload()
    return tuple(sorted(_REGISTRY.get(kind, {})))


def items(kind: str) -> Iterable[Tuple[str, Any]]:
    _autoload()
    return sorted(_REGISTRY.get(kind, {}).items())


def is_registered(kind: str, name: str) -> bool:
    return name in _REGISTRY.get(kind, {})


#: a component spec: either a bare registry name or a nested dict
#:   {"type": <name>, "args": {<kwarg>: <value-or-nested-spec>, ...}}
Spec = Union[str, Mapping[str, Any]]


def _normalize_spec(kind: str, spec: Spec) -> Tuple[str, Dict[str, Any]]:
    if isinstance(spec, str):
        return spec, {}
    if isinstance(spec, Mapping):
        extra = set(spec) - {"type", "name", "args", "kind"}
        if extra:
            raise RegistryError(
                f"bad {kind} spec: unknown key(s) {sorted(extra)}; a spec is "
                "a name or {'type': <name>, 'args': {...}}")
        name = spec.get("type") or spec.get("name")
        if not isinstance(name, str):
            raise RegistryError(f"bad {kind} spec {spec!r}: missing 'type'")
        args = spec.get("args", {})
        if not isinstance(args, Mapping):
            raise RegistryError(f"bad {kind} spec {name!r}: 'args' must be a "
                                f"dict, got {type(args).__name__}")
        return name, dict(args)
    raise RegistryError(f"bad {kind} spec {spec!r}: expected a registry name "
                        "or a {'type': ..., 'args': {...}} dict")


def _is_nested_spec(v: Any) -> bool:
    return isinstance(v, Mapping) and "kind" in v and ("type" in v
                                                       or "name" in v)


def _validate_call(kind: str, name: str, obj: Any, args: Tuple,
                   kwargs: Dict[str, Any]) -> None:
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):      # builtins / C callables: skip
        return
    try:
        sig.bind(*args, **kwargs)
    except TypeError as e:
        accepted = [p.name for p in sig.parameters.values()
                    if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
        raise RegistryError(
            f"invalid arguments for {kind}:{name}: {e}; accepted "
            f"parameters: {accepted}") from None


def build_from_config(kind: str, spec: Spec, *args: Any, **extra: Any) -> Any:
    """Instantiate a component from a declarative spec, validating the
    arguments against its signature (nested ``{"kind": ...}`` specs are
    built recursively)."""
    name, kwargs = _normalize_spec(kind, spec)
    kwargs = {k: (build_from_config(v["kind"], v) if _is_nested_spec(v)
                  else v) for k, v in kwargs.items()}
    overlap = sorted(set(kwargs) & set(extra))
    if overlap:
        raise RegistryError(
            f"{kind}:{name}: argument(s) {overlap} given both in the spec "
            "and by the caller")
    kwargs.update(extra)
    obj = lookup(kind, name)
    _validate_call(kind, name, obj, args, kwargs)
    return obj(*args, **kwargs)


def describe(kind: str, name: str = None) -> Dict[str, Any]:
    """Constructor signature + one-line doc for one registered component
    (or, with ``name=None``, for every one of ``kind``)."""
    if name is None:
        return {n: describe(kind, n) for n in names(kind)}
    obj = lookup(kind, name)
    doc = (inspect.getdoc(obj) or "").split("\n", 1)[0]
    params: Dict[str, Any] = {}
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        sig = None
    if sig is not None:
        for p in sig.parameters.values():
            if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
                continue
            params[p.name] = {
                "default": (None if p.default is p.empty
                            else repr(p.default)),
                "required": p.default is p.empty,
                "annotation": (None if p.annotation is p.empty
                               else str(p.annotation)),
            }
    return {"kind": kind, "name": name, "doc": doc, "params": params}
