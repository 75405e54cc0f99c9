"""SDK for writing external plugin servers (a copy of the JAX package's
``plugins/servers/sdk.py``).

A plugin server is a stdio MCP server whose tools are named after the
framework hooks it implements (see `plugins/external.py` for the host side
and the verdict wire contract). Usage:

    server = PluginServer("my-policy")

    @server.hook("tool_pre_invoke")
    def check(name, arguments, headers, context):
        if name in DENYLIST:
            return violation("tool denied", code="DENY")
        return ok()

    server.run()
"""

from __future__ import annotations

import asyncio
import inspect
import json
import sys
from typing import Any, Callable


def ok() -> dict[str, Any]:
    """No change; let the request continue."""
    return {"continue": True}


def modified(**fields: Any) -> dict[str, Any]:
    """Rewrite hook payload fields (e.g. arguments={...})."""
    return {"modified": fields}


def violation(reason: str, code: str = "EXTERNAL_POLICY",
              details: dict[str, Any] | None = None) -> dict[str, Any]:
    """Block the request."""
    return {"violation": {"reason": reason, "code": code,
                          "details": details or {}}}


class PluginServer:
    def __init__(self, name: str, version: str = "0.1.0"):
        self.name = name
        self.version = version
        self._hooks: dict[str, Callable[..., dict[str, Any]]] = {}

    def hook(self, hook_name: str):
        def decorator(fn: Callable[..., dict[str, Any]]) -> Callable:
            self._hooks[hook_name] = fn
            return fn
        return decorator

    # ------------------------------------------------------------- protocol

    def _handle(self, message: dict[str, Any]) -> dict[str, Any] | None:
        method = message.get("method", "")
        if "id" not in message:
            return None
        result: Any
        if method == "initialize":
            result = {"protocolVersion": "2025-06-18",
                      "capabilities": {"tools": {}},
                      "serverInfo": {"name": self.name, "version": self.version}}
        elif method == "ping":
            result = {}
        elif method == "tools/list":
            result = {"tools": [
                {"name": hook_name, "description": f"plugin hook {hook_name}",
                 "inputSchema": {"type": "object"}}
                for hook_name in self._hooks]}
        elif method == "tools/call":
            # execution lives in _dispatch (async, overlapped); a
            # tools/call only reaches here when the hook is unknown
            params = message.get("params", {})
            return {"jsonrpc": "2.0", "id": message["id"],
                    "error": {"code": -32602,
                              "message": f"Unknown hook {params.get('name')!r}"}}
        else:
            return {"jsonrpc": "2.0", "id": message["id"],
                    "error": {"code": -32601,
                              "message": f"Unknown method {method!r}"}}
        return {"jsonrpc": "2.0", "id": message["id"], "result": result}

    # The host multiplexes hook calls by JSON-RPC id, so the server must
    # actually OVERLAP them or concurrency dies here: every tools/call runs
    # as its own task, sync hooks hop to a worker thread (a blocking scanner
    # must not convoy the pipe), and responses stream back in completion
    # order — ids, not ordering, correlate them.

    async def _call_hook(self, fn: Callable[..., dict[str, Any]],
                         arguments: dict[str, Any]) -> dict[str, Any]:
        if inspect.iscoroutinefunction(fn):
            return await fn(**arguments)
        return await asyncio.to_thread(fn, **arguments)

    async def _dispatch(self, message: dict[str, Any]) -> None:
        method = message.get("method", "")
        params = message.get("params", {})
        fn = self._hooks.get(params.get("name", "")) \
            if method == "tools/call" else None
        if fn is not None:
            try:
                verdict = await self._call_hook(fn, params.get("arguments") or {})
                result = {"content": [{"type": "text",
                                       "text": json.dumps(verdict)}],
                          "isError": False}
            except Exception as exc:
                result = {"content": [{"type": "text",
                                       "text": f"{type(exc).__name__}: {exc}"}],
                          "isError": True}
            response: dict[str, Any] | None = {
                "jsonrpc": "2.0", "id": message["id"], "result": result}
        else:
            response = self._handle(message)
        if response is not None:
            # single-threaded loop + no await between write and flush:
            # whole lines only, tasks can't interleave bytes
            sys.stdout.write(json.dumps(response) + "\n")
            sys.stdout.flush()

    async def _run_async(self) -> None:  # pragma: no cover - subprocess entry
        loop = asyncio.get_running_loop()
        # a tool_post_invoke frame carries the full tool result on one
        # line — the default 64 KiB StreamReader limit would kill the
        # server on big payloads (the old sync loop was unlimited)
        reader = asyncio.StreamReader(limit=64 * 1024 * 1024)
        await loop.connect_read_pipe(
            lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
        tasks: set[asyncio.Task] = set()
        while True:
            line = await reader.readline()
            if not line:
                break
            line = line.strip()
            if not line:
                continue
            try:
                message = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "id" not in message:
                continue
            task = asyncio.ensure_future(self._dispatch(message))
            tasks.add(task)
            task.add_done_callback(tasks.discard)

    def run(self) -> None:  # pragma: no cover - subprocess entry
        asyncio.run(self._run_async())
