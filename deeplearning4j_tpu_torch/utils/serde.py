"""JSON serialization registry for configuration dataclasses.

The reference serializes typed builder configs to JSON/YAML with polymorphic
subtype discovery via classpath scanning (reference:
deeplearning4j-nn/.../nn/conf/NeuralNetConfiguration.java:434,472-574).
Here the equivalent is an explicit registry: every config dataclass registers
under a stable type name, and nested configs round-trip through ``to_dict`` /
``from_dict`` with an ``@type`` discriminator key. Custom user layers call
``register_serializable`` exactly like DL4J's ``registerSubtypes``.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}
_TYPE_KEY = "@type"


def register_serializable(cls=None, *, name: str | None = None):
    """Class decorator: register a dataclass for polymorphic JSON serde."""

    def wrap(c):
        key = name or c.__name__
        if key in _REGISTRY and _REGISTRY[key] is not c:
            raise ValueError(f"serde type name already registered: {key}")
        _REGISTRY[key] = c
        c._serde_name = key
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def registered_types() -> Dict[str, Type]:
    return dict(_REGISTRY)


def to_dict(obj: Any) -> Any:
    """Recursively convert registered dataclasses to JSON-safe dicts."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = getattr(obj, "_serde_name", None)
        if name is None:
            raise TypeError(
                f"{type(obj).__name__} is not registered for serde; "
                "decorate it with @register_serializable"
            )
        out = {_TYPE_KEY: name}
        for f in dataclasses.fields(obj):
            if not f.metadata.get("serde_skip", False):
                out[f.name] = to_dict(getattr(obj, f.name))
        return out
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def from_dict(data: Any) -> Any:
    """Inverse of :func:`to_dict`; resolves ``@type`` via the registry."""
    if isinstance(data, list):
        return [from_dict(v) for v in data]
    if isinstance(data, dict):
        if _TYPE_KEY in data:
            name = data[_TYPE_KEY]
            cls = _REGISTRY.get(name)
            if cls is None:
                raise KeyError(f"unknown serde type: {name}")
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in data.items():
                if k == _TYPE_KEY or k not in fields:
                    continue
                f = fields[k]
                val = from_dict(v)
                # Re-hydrate enums declared by annotation.
                val = _coerce(f.type, val)
                kwargs[k] = val
            return cls(**kwargs)
        return {k: from_dict(v) for k, v in data.items()}
    return data


def _base_name(annotation) -> str:
    """'Optional[L.LossFunction]' → 'LossFunction'; 'Tuple[int, int]' →
    'Tuple'. Handles string annotations (from __future__ annotations)."""
    if not isinstance(annotation, str):
        annotation = getattr(annotation, "__name__", str(annotation))
    s = annotation.strip().strip('"\'')
    for wrapper in ("Optional[", "typing.Optional["):
        if s.startswith(wrapper) and s.endswith("]"):
            s = s[len(wrapper):-1].strip()
    s = s.split("[")[0].strip()
    return s.split(".")[-1]


def _coerce(annotation, val):
    """Best-effort coercion of primitives back to enums / tuples."""
    base = _base_name(annotation)
    if isinstance(val, str):
        cls = _ENUM_REGISTRY.get(base)
        if cls is not None and val in cls.__members__:
            return cls[val]
    if isinstance(val, list):
        if base in ("tuple", "Tuple"):
            return tuple(val)
    return val


_ENUM_REGISTRY: Dict[str, Type[enum.Enum]] = {}


def register_enum(cls: Type[enum.Enum]):
    """Register an enum so string values re-hydrate on deserialization."""
    _ENUM_REGISTRY[cls.__name__] = cls
    return cls


def to_json(obj: Any, *, indent: int | None = 2) -> str:
    return json.dumps(to_dict(obj), indent=indent)


def from_json(s: str) -> Any:
    return from_dict(json.loads(s))
