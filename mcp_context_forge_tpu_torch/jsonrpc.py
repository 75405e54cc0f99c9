"""JSON-RPC 2.0 framing and the MCP method registry (a copy of the JAX
package's ``jsonrpc.py``; stdlib only): the error codes, ``RPCRequest.parse``,
``parse_body``, the response constructors and ``method_registry``, which
``gateway/rpc.py`` consumes."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

# Standard JSON-RPC 2.0 error codes
PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603
# MCP-specific
REQUEST_CANCELLED = -32800
CONTENT_TOO_LARGE = -32801
# server-range: upstream temporarily unavailable (degradation ladder —
# open federation breaker; error.data carries retry_after_s)
UPSTREAM_UNAVAILABLE = -32003


class JSONRPCError(Exception):
    """Raised by handlers; rendered into a JSON-RPC error response."""

    def __init__(self, code: int, message: str, data: Any = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.data = data

    def to_dict(self, request_id: Any = None) -> dict[str, Any]:
        err: dict[str, Any] = {"code": self.code, "message": self.message}
        if self.data is not None:
            err["data"] = self.data
        return {"jsonrpc": "2.0", "id": request_id, "error": err}


@dataclass
class RPCRequest:
    method: str
    params: dict[str, Any] = field(default_factory=dict)
    id: Any = None
    is_notification: bool = False

    @classmethod
    def parse(cls, payload: Any) -> "RPCRequest":
        if not isinstance(payload, dict):
            raise JSONRPCError(INVALID_REQUEST, "Request must be an object")
        if payload.get("jsonrpc") != "2.0":
            raise JSONRPCError(INVALID_REQUEST, "jsonrpc must be '2.0'")
        method = payload.get("method")
        if not isinstance(method, str) or not method:
            raise JSONRPCError(INVALID_REQUEST, "method must be a non-empty string")
        params = payload.get("params", {})
        if params is None:
            params = {}
        if not isinstance(params, (dict, list)):
            raise JSONRPCError(INVALID_REQUEST, "params must be an object or array")
        if isinstance(params, list):
            params = {"__args__": params}
        has_id = "id" in payload
        rid = payload.get("id")
        if has_id and (isinstance(rid, bool) or not isinstance(rid, (str, int, float, type(None)))):
            raise JSONRPCError(INVALID_REQUEST, "id must be a string, number or null")
        return cls(method=method, params=params, id=rid, is_notification=not has_id)


def parse_body(raw: bytes, max_size: int = 0) -> Any:
    if max_size and len(raw) > max_size:
        raise JSONRPCError(CONTENT_TOO_LARGE, f"Request exceeds {max_size} bytes")
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise JSONRPCError(PARSE_ERROR, f"Parse error: {exc}") from exc


def is_response_message(message: Any) -> bool:
    """True for client→server RESPONSE messages (result/error, no method) —
    e.g. elicitation replies riding the POST channel."""
    return (isinstance(message, dict) and "method" not in message
            and ("result" in message or "error" in message))


def result_response(request_id: Any, result: Any) -> dict[str, Any]:
    return {"jsonrpc": "2.0", "id": request_id, "result": result}


def error_response(request_id: Any, code: int, message: str, data: Any = None) -> dict[str, Any]:
    return JSONRPCError(code, message, data).to_dict(request_id)


# --- the MCP method registry ---

CORE_METHODS: frozenset[str] = frozenset({
    "initialize",
    "ping",
    "tools/list",
    "tools/call",
    "resources/list",
    "resources/templates/list",
    "resources/read",
    "resources/subscribe",
    "resources/unsubscribe",
    "prompts/list",
    "prompts/get",
    "roots/list",
    "completion/complete",
    "sampling/createMessage",
    "elicitation/create",
    "logging/setLevel",
})

NOTIFICATION_METHODS: frozenset[str] = frozenset({
    "notifications/initialized",
    "notifications/cancelled",
    "notifications/progress",
    "notifications/message",
    "notifications/roots/list_changed",
    "notifications/tools/list_changed",
    "notifications/resources/list_changed",
    "notifications/resources/updated",
    "notifications/prompts/list_changed",
})


class MCPMethodRegistry:
    """Known-method validation with extension registration."""

    def __init__(self) -> None:
        self._extra: set[str] = set()

    def register(self, method: str) -> None:
        self._extra.add(method)

    def is_known(self, method: str) -> bool:
        return method in CORE_METHODS or method in NOTIFICATION_METHODS or method in self._extra

    def is_notification(self, method: str) -> bool:
        return method.startswith("notifications/")


method_registry = MCPMethodRegistry()
