"""Dot-path extraction over parsed JSON, ``items[0].name`` (a copy of the
JAX package's ``utils/paths.py``)."""

from __future__ import annotations

from typing import Any


def extract_path(data: Any, path: str) -> Any:
    """Walk a dot-path with [i] list indexing; None when unresolvable."""
    current = data
    for part in path.replace("]", "").split("."):
        if not part:
            continue
        key, _, index = part.partition("[")
        if key:
            if not isinstance(current, dict) or key not in current:
                return None
            current = current[key]
        if index:
            try:
                current = current[int(index)]
            except (ValueError, IndexError, TypeError, KeyError):
                return None
    return current
