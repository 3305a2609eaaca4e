"""Config-dict coercion shared by optimizer/initializer factories (copy of
``openembedding_tpu/utils/config.py``).

The reference passes per-variable config as YAML string dicts
(exb.py:25-86); values may arrive as strings ("true", "0.1"), numbers, or
bools. Coerce by the dataclass field's declared type, resolved via
typing.get_type_hints (field.type is a string under PEP 563).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any

_TRUE = {"true", "1", "yes", "on"}
_FALSE = {"false", "0", "no", "off"}


def to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, str):
        s = v.strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise ValueError(f"cannot interpret {v!r} as a boolean")
    if isinstance(v, (int, float)):
        return bool(v)
    raise ValueError(f"cannot interpret {v!r} as a boolean")


def coerce_fields(cls, config: dict) -> dict:
    """Coerce config values to the dataclass field types of ``cls``.

    Raises ValueError on unknown keys, naming the offending options.
    """
    hints = typing.get_type_hints(cls)
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(config) - fields
    if unknown:
        raise ValueError(
            f"unknown {getattr(cls, 'category', cls.__name__)} options "
            f"{sorted(unknown)}; known: {sorted(fields)}")
    out = {}
    for k, v in config.items():
        t = hints.get(k, float)
        out[k] = to_bool(v) if t is bool else float(v)
    return out
