"""A small YAML writer for the flat files the training stage leaves.

The training stage writes two YAML files a fold: ``args.yaml`` (the run's
options, keys sorted, as PyYAML's ``safe_dump(sort_keys=True)`` writes them)
and the dataset file ``<model_string>.yaml`` (keys in insertion order). Both
are flat mappings of scalars (None, booleans, integers, floats, strings) and
lists of scalars, so this writer covers exactly that and raises on anything
else; PyYAML is not needed to write them. Strings are always quoted, and
floats always carry a point (``1.0e-12``), so YAML 1.1 readers load every
value back with its type.
"""

from __future__ import annotations

import math
from pathlib import Path


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "e" in text and "." not in text.split("e")[0]:
            mant, exp = text.split("e")
            text = f"{mant}.0e{exp}"
        return text
    if isinstance(v, (str, Path)):
        return "'" + str(v).replace("'", "''") + "'"
    raise TypeError(f"not a YAML scalar this writer takes: {type(v).__name__}")


def dumps(mapping: dict, sort_keys: bool = False) -> str:
    """`mapping` (str keys; scalar, list or tuple values) as YAML text."""
    lines = []
    for key in (sorted(mapping) if sort_keys else mapping):
        v = mapping[key]
        if not isinstance(key, str):
            raise TypeError(f"key {key!r} is not a string")
        if isinstance(v, (list, tuple)):
            if not v:
                lines.append(f"{key}: []")
            else:
                lines.append(f"{key}:")
                lines.extend(f"- {_scalar(x)}" for x in v)
        else:
            lines.append(f"{key}: {_scalar(v)}")
    return "\n".join(lines) + "\n"


def write(path, mapping: dict, sort_keys: bool = False) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(dumps(mapping, sort_keys=sort_keys))
