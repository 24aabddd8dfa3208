"""One typed config system (dataclass + YAML/JSON file + CLI dot-overrides).

The port's own copy of the JAX package's loader: the same field names and
the same parsing, so one file under `configs/` loads into both packages.
`yaml` is imported only when a YAML file is read.

Usage:
    cfg = load_config(PerActConfig, path="configs/serve.yaml",
                      overrides=["model.depth=4"])
"""
from __future__ import annotations

import dataclasses
import json
import typing
from typing import Any, Iterable, Optional, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def _coerce(value: Any, typ: Any) -> Any:
    origin = get_origin(typ)
    if dataclasses.is_dataclass(typ) and isinstance(value, dict):
        return from_dict(typ, value)
    if origin in (tuple, list) and isinstance(value, (list, tuple)):
        args = get_args(typ)
        if origin is tuple and len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(v, args[0]) for v in value)
        if origin is tuple and args:
            return tuple(_coerce(v, a) for v, a in zip(value, args))
        return type(value)(value) if origin is list else tuple(value)
    if typ is float and isinstance(value, (int, str)):
        return float(value)
    if typ is int and isinstance(value, str):
        return int(value)
    if typ is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    if origin is not None and type(None) in get_args(typ) and value is not None:
        inner = [a for a in get_args(typ) if a is not type(None)]
        return _coerce(value, inner[0]) if inner else value
    return value


def from_dict(cls: Type[T], data: dict) -> T:
    """Build a (possibly nested) frozen dataclass from a plain dict."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in names:
            raise KeyError(f"{cls.__name__}: unknown config key {k!r}")
        kwargs[k] = _coerce(v, hints[k])
    return cls(**kwargs)


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def apply_override(cfg: T, path: str, value: str) -> T:
    """Immutably set a dot-path field, parsing the value as JSON when it
    looks structured, else as the declared type."""
    keys = path.split(".")
    try:
        parsed = json.loads(value)
    except (json.JSONDecodeError, TypeError):
        parsed = value

    def rec(node, ks):
        if len(ks) == 1:
            hints = typing.get_type_hints(type(node))
            return dataclasses.replace(
                node, **{ks[0]: _coerce(parsed, hints[ks[0]])})
        child = getattr(node, ks[0])
        return dataclasses.replace(node, **{ks[0]: rec(child, ks[1:])})

    return rec(cfg, keys)


def load_config(cls: Type[T], path: Optional[str] = None,
                overrides: Iterable[str] = ()) -> T:
    data: dict = {}
    if path:
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                import yaml
                data = yaml.safe_load(f) or {}
            else:
                data = json.load(f)
    cfg = from_dict(cls, data)
    for ov in overrides:
        k, _, v = ov.partition("=")
        cfg = apply_override(cfg, k.strip(), v.strip())
    return cfg
