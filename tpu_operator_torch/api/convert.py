"""Dataclass <-> Kubernetes-JSON conversion machinery (the port's own copy
of ``tpu_operator/api/convert.py``).

The reference gets typed CRD structs, deepcopy, and JSON tags from Go
codegen (api/nvidia/v1/zz_generated.deepcopy.go etc.). In Python we derive
all of it from the dataclass definitions themselves:

- field names are snake_case in Python, camelCase on the wire;
- ``to_dict`` drops None fields (omitempty semantics);
- ``from_dict`` ignores unknown keys (forward compatibility) and recurses
  into nested dataclasses, lists and dicts via type hints;
- ``schema_of`` emits an openAPIV3Schema fragment for CRD generation.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Optional, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T")


def camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(p.capitalize() for p in parts[1:])


def wire_name(field: dataclasses.Field) -> str:
    return field.metadata.get("name", camel(field.name))


def _unwrap_optional(tp):
    if get_origin(tp) is typing.Union:
        args = [a for a in get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def to_dict(obj: Any) -> Any:
    """Recursively convert a dataclass to wire-format dict, omitting Nones."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            out[wire_name(f)] = to_dict(v)
        return out
    if isinstance(obj, list):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def from_dict(cls: Type[T], data: Any) -> T:
    """Build ``cls`` from wire-format ``data``; unknown keys are ignored."""
    if data is None:
        return None  # type: ignore[return-value]
    if not dataclasses.is_dataclass(cls):
        return data  # plain value / dict passthrough
    hints = get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = wire_name(f)
        if key not in data:
            continue
        raw = data[key]
        tp = _unwrap_optional(hints.get(f.name, Any))
        kwargs[f.name] = _coerce(tp, raw)
    return cls(**kwargs)  # type: ignore[call-arg]


def _coerce(tp, raw):
    if raw is None:
        return None
    if dataclasses.is_dataclass(tp):
        return from_dict(tp, raw)
    origin = get_origin(tp)
    if origin is list:
        (item_tp,) = get_args(tp) or (Any,)
        return [_coerce(_unwrap_optional(item_tp), v) for v in raw]
    if origin is dict:
        args = get_args(tp)
        val_tp = _unwrap_optional(args[1]) if len(args) == 2 else Any
        return {k: _coerce(val_tp, v) for k, v in raw.items()}
    if tp is bool and isinstance(raw, str):
        return raw.lower() in ("true", "1", "yes")
    return raw


_SCALAR_SCHEMA = {
    str: {"type": "string"},
    int: {"type": "integer"},
    float: {"type": "number"},
    bool: {"type": "boolean"},
}


def schema_of(tp, description: Optional[str] = None) -> dict:
    """openAPIV3Schema for a (possibly nested) dataclass or hinted type.

    ``Any``-typed fields map to x-kubernetes-preserve-unknown-fields, which
    we use for embedded core/v1 shapes (resources, tolerations, env) the
    same way the reference embeds corev1 types it doesn't re-schematize.
    """
    tp = _unwrap_optional(tp)
    if tp in _SCALAR_SCHEMA:
        out = dict(_SCALAR_SCHEMA[tp])
    elif dataclasses.is_dataclass(tp):
        hints = get_type_hints(tp)
        props = {}
        for f in dataclasses.fields(tp):
            fdesc = f.metadata.get("description")
            props[wire_name(f)] = schema_of(hints.get(f.name, Any), fdesc)
        out = {"type": "object", "properties": props}
    else:
        origin = get_origin(tp)
        if origin is list:
            (item_tp,) = get_args(tp) or (Any,)
            out = {"type": "array", "items": schema_of(item_tp)}
        elif origin is dict:
            args = get_args(tp)
            val_tp = args[1] if len(args) == 2 else Any
            out = {"type": "object",
                   "additionalProperties": schema_of(val_tp)}
        else:  # Any / unhinted: free-form object or scalar
            out = {"x-kubernetes-preserve-unknown-fields": True}
    if description:
        out["description"] = description
    return out


def field(*, name: Optional[str] = None, description: Optional[str] = None,
          default: Any = None, default_factory: Any = dataclasses.MISSING):
    """Dataclass field with wire-name / description metadata."""
    metadata = {}
    if name:
        metadata["name"] = name
    if description:
        metadata["description"] = description
    if default_factory is not dataclasses.MISSING:
        return dataclasses.field(default_factory=default_factory, metadata=metadata)
    return dataclasses.field(default=default, metadata=metadata)
