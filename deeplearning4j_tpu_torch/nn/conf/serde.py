"""JSON serialization registry for configuration objects.

A copy of deeplearning4j_tpu/nn/conf/serde.py (it holds no JAX); the
port registers its own classes under the same names, so a configuration
written by either package reads back in the other.

Plays the role of the reference's Jackson polymorphic-subtype machinery
(reference: deeplearning4j-nn/.../nn/conf/MultiLayerConfiguration.java:108-126
`toJson`/`fromJson`, NeuralNetConfiguration.mapper:123, ReflectionsHelper
subtype scanning). Every serializable config class registers under its class
name; ``to_dict``/``from_dict`` recurse over dataclass fields, tagging each
object with ``"@class"`` so round-trips reconstruct exact subtypes. Custom
user layers register the same way (the reference's custom-layer story).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}


def register(cls):
    """Class decorator: make a dataclass JSON round-trippable by name."""
    _REGISTRY[cls.__name__] = cls
    return cls


def get_registered(name: str):
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown config class '{name}'. Registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def to_dict(obj: Any) -> Any:
    """Recursively convert a (possibly nested) config object to plain JSON
    types, tagging registered dataclasses with @class."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"@class": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, dict):
        return {str(k): to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item"):  # numpy / torch scalar
        return obj.item()
    raise TypeError(f"Cannot serialize {type(obj)} to config JSON")


def from_dict(data: Any) -> Any:
    """Inverse of :func:`to_dict`."""
    if isinstance(data, dict):
        if "@class" in data:
            cls = get_registered(data["@class"])
            kwargs = {}
            names = {f.name for f in dataclasses.fields(cls)}
            for k, v in data.items():
                if k == "@class":
                    continue
                if k in names:
                    kwargs[k] = from_dict(v)
            obj = cls(**kwargs)
            return obj
        return {k: from_dict(v) for k, v in data.items()}
    if isinstance(data, list):
        return [from_dict(v) for v in data]
    return data


def to_yaml(obj: Any) -> str:
    """YAML face of the registry — the reference's config DSL is
    dual-format (reference: MultiLayerConfiguration.java:79 `toYaml` /
    :108-126 both formats share one object mapper pipeline); here both
    formats share to_dict/from_dict, so the @class-tagged document is
    identical modulo syntax."""
    import yaml

    return yaml.safe_dump(to_dict(obj), sort_keys=False,
                          default_flow_style=False)


def from_yaml(s: str) -> Any:
    """Inverse of :func:`to_yaml`."""
    import yaml

    return from_dict(yaml.safe_load(s))
