"""ID and slug helpers (a copy of the JAX package's ``utils/ids.py``)."""

from __future__ import annotations

import re
import uuid


def new_id() -> str:
    return uuid.uuid4().hex


_slug_re = re.compile(r"[^a-z0-9]+")


def slugify(name: str) -> str:
    s = _slug_re.sub("-", name.lower()).strip("-")
    return s or new_id()[:8]
