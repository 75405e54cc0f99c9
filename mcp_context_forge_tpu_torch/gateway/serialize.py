"""SSE framing and the compact JSON encoder of the /v1 surface (copies of
the JAX package's ``gateway/serialize.py``; stdlib only)."""

from __future__ import annotations

import json
from typing import Any

# SSE framing fragments (the wire grammar around every event)
SSE_DATA = b"data: "
SSE_END = b"\n\n"
SSE_DONE = b"data: [DONE]\n\n"


def encode_json(obj: Any) -> bytes:
    """Compact separators, UTF-8 text as is (no ``\\uXXXX`` escapes)."""
    return json.dumps(obj, separators=(",", ":"),
                      ensure_ascii=False).encode()


def sse_event(event: Any) -> bytes:
    """One SSE ``data:`` frame for ``event``."""
    return b"".join((SSE_DATA, encode_json(event), SSE_END))
