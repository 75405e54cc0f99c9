"""SSE framing, the compact JSON encoder and the JSON-RPC response bytes of
the /v1 surface and the MCP transports (copies of the JAX package's
``gateway/serialize.py``; stdlib only)."""

from __future__ import annotations

import json
from typing import Any

# SSE framing fragments (the wire grammar around every event)
SSE_DATA = b"data: "
SSE_END = b"\n\n"
SSE_DONE = b"data: [DONE]\n\n"

# the JSON-RPC 2.0 result envelope (jsonrpc.result_response) as fragments
_ENV_HEAD = b'{"jsonrpc":"2.0","id":'
_ENV_RESULT = b',"result":'
_ENV_TAIL = b'}'


def encode_json(obj: Any) -> bytes:
    """Compact separators, UTF-8 text as is (no ``\\uXXXX`` escapes)."""
    return json.dumps(obj, separators=(",", ":"),
                      ensure_ascii=False).encode()


def sse_event(event: Any) -> bytes:
    """One SSE ``data:`` frame for ``event``."""
    return b"".join((SSE_DATA, encode_json(event), SSE_END))


def jsonrpc_result_bytes(request_id: Any, result: Any) -> bytes:
    """``encode_json(result_response(request_id, result))``, byte for byte,
    with only the id and the result encoded."""
    return b"".join((_ENV_HEAD, encode_json(request_id),
                     _ENV_RESULT, encode_json(result), _ENV_TAIL))


def jsonrpc_response_bytes(response: dict[str, Any]) -> bytes:
    """The bytes of a built JSON-RPC response: a canonical result takes the
    fragment path, anything else (errors, extra keys) ``encode_json``."""
    if (len(response) == 3 and "result" in response
            and response.get("jsonrpc") == "2.0" and "id" in response):
        return jsonrpc_result_bytes(response["id"], response["result"])
    return encode_json(response)
