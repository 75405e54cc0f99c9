"""An MCP client over streamable HTTP and legacy SSE (a copy of the JAX
package's ``clients/mcp_client.py``), the gateway's side of federation:

- streamable HTTP: JSON-RPC POSTed to the endpoint; the answer is
  ``application/json`` or an SSE stream whose events carry JSON-RPC
  messages; the ``Mcp-Session-Id`` header binds the session;
- legacy SSE: a GET opens an event stream whose first ``endpoint`` event
  names the POST-back URL; answers arrive as ``message`` events.

httpx is imported when a session is made (``utils/outbound.py``), not in
the methods that post.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

from .. import PROTOCOL_VERSION
from ..jsonrpc import JSONRPCError, INTERNAL_ERROR
from ..utils.outbound import httpx_module, verified_context


class MCPClientError(Exception):
    pass


@dataclass
class SSEEvent:
    event: str = "message"
    data: str = ""
    id: str | None = None


async def iter_sse(response: "httpx.Response") -> AsyncIterator[SSEEvent]:
    """Parse an SSE byte stream into events."""
    event = SSEEvent()
    data_lines: list[str] = []
    async for line in response.aiter_lines():
        if line == "":
            if data_lines:
                event.data = "\n".join(data_lines)
                yield event
            event = SSEEvent()
            data_lines = []
            continue
        if line.startswith(":"):
            continue
        key, _, value = line.partition(":")
        value = value.removeprefix(" ")
        if key == "event":
            event.event = value
        elif key == "data":
            data_lines.append(value)
        elif key == "id":
            event.id = value
    if data_lines:
        event.data = "\n".join(data_lines)
        yield event


@dataclass
class MCPSession:
    """A logical MCP session with one upstream server."""

    url: str
    transport: str = "streamablehttp"  # streamablehttp | sse
    headers: dict[str, str] = field(default_factory=dict)
    timeout: float = 30.0
    verify_ssl: bool = True
    client: "httpx.AsyncClient | None" = None  # external shared pool (not closed)

    _client: "httpx.AsyncClient | None" = None
    _owns_client: bool = True
    _session_id: str | None = None
    _next_id: int = 1
    # legacy-SSE state
    _post_url: str | None = None
    _stream_task: asyncio.Task | None = None
    _pending: dict[Any, asyncio.Future] = field(default_factory=dict)
    server_info: dict[str, Any] = field(default_factory=dict)
    capabilities: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self._httpx = httpx_module()

    async def __aenter__(self) -> "MCPSession":
        await self.connect()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def connect(self) -> None:
        if self.client is not None:
            self._client = self.client
            self._owns_client = False
        else:
            self._client = self._httpx.AsyncClient(
                timeout=self.timeout, verify=verified_context() if self.verify_ssl else False)
            self._owns_client = True
        if self.transport == "sse":
            await self._open_sse_stream()
        result = await self.request("initialize", {
            "protocolVersion": PROTOCOL_VERSION,
            "capabilities": {},
            "clientInfo": {"name": "mcpforge-gateway", "version": "0.1.0"},
        })
        self.server_info = result.get("serverInfo", {})
        self.capabilities = result.get("capabilities", {})
        await self.notify("notifications/initialized", {})

    async def close(self) -> None:
        if self._stream_task is not None:
            self._stream_task.cancel()
            try:
                await self._stream_task
            except (asyncio.CancelledError, Exception):
                pass
            self._stream_task = None
        if self._client is not None:
            if self._session_id:
                try:
                    await self._client.delete(self.url, headers=self._base_headers())
                except Exception:
                    pass
            if self._owns_client:
                await self._client.aclose()
            self._client = None

    # ------------------------------------------------------------------ wire

    def _base_headers(self) -> dict[str, str]:
        headers = {
            "content-type": "application/json",
            "accept": "application/json, text/event-stream",
            "mcp-protocol-version": PROTOCOL_VERSION,
            **self.headers,
        }
        if self._session_id:
            headers["mcp-session-id"] = self._session_id
        return headers

    async def request(self, method: str, params: dict[str, Any] | None = None) -> dict[str, Any]:
        rid = self._next_id
        self._next_id += 1
        payload = {"jsonrpc": "2.0", "id": rid, "method": method, "params": params or {}}
        if self.transport == "sse":
            return await self._sse_request(rid, payload)
        return await self._http_request(rid, payload)

    async def notify(self, method: str, params: dict[str, Any] | None = None) -> None:
        payload = {"jsonrpc": "2.0", "method": method, "params": params or {}}
        assert self._client is not None
        if self.transport == "sse":
            if self._post_url is None:
                raise MCPClientError("SSE session not connected")
            await self._client.post(self._post_url, json=payload,
                                    headers=self._base_headers(), timeout=self.timeout)
            return
        resp = await self._client.post(self.url, json=payload,
                                       headers=self._base_headers(), timeout=self.timeout)
        resp.raise_for_status()

    async def _http_request(self, rid: Any, payload: dict[str, Any]) -> dict[str, Any]:
        assert self._client is not None
        # per-session timeout must hold even on a shared injected client
        req = self._client.build_request("POST", self.url, json=payload,
                                         headers=self._base_headers(),
                                         timeout=self.timeout)
        resp = await self._client.send(req, stream=True)
        try:
            if resp.status_code >= 400:
                body = (await resp.aread())[:2048]
                raise MCPClientError(f"HTTP {resp.status_code} from {self.url}: {body!r}")
            sid = resp.headers.get("mcp-session-id")
            if sid:
                self._session_id = sid
            ctype = resp.headers.get("content-type", "")
            if ctype.startswith("text/event-stream"):
                async for event in iter_sse(resp):
                    if event.event != "message" or not event.data:
                        continue
                    msg = json.loads(event.data)
                    if msg.get("id") == rid and ("result" in msg or "error" in msg):
                        return self._unwrap(msg)
                raise MCPClientError("SSE stream ended without a response")
            body = await resp.aread()
            msg = json.loads(body)
            if isinstance(msg, list):  # batch — find ours
                msg = next((m for m in msg if m.get("id") == rid), None) or {}
            return self._unwrap(msg)
        finally:
            await resp.aclose()

    def _unwrap(self, msg: dict[str, Any]) -> dict[str, Any]:
        if "error" in msg:
            err = msg["error"] or {}
            raise JSONRPCError(err.get("code", INTERNAL_ERROR),
                               err.get("message", "upstream error"), err.get("data"))
        return msg.get("result", {})

    # ------------------------------------------------------------- legacy SSE

    async def _open_sse_stream(self) -> None:
        assert self._client is not None
        connected: asyncio.Future[str] = asyncio.get_running_loop().create_future()

        async def _run() -> None:
            assert self._client is not None
            try:
                async with self._client.stream(
                    "GET", self.url,
                    headers={"accept": "text/event-stream", **self.headers},
                    timeout=self._httpx.Timeout(self.timeout, read=None),
                ) as resp:
                    if resp.status_code >= 400:
                        raise MCPClientError(f"SSE connect failed: HTTP {resp.status_code}")
                    async for event in iter_sse(resp):
                        if event.event == "endpoint":
                            if not connected.done():
                                connected.set_result(event.data)
                        elif event.event == "message" and event.data:
                            try:
                                msg = json.loads(event.data)
                            except json.JSONDecodeError:
                                continue
                            fut = self._pending.pop(msg.get("id"), None)
                            if fut is not None and not fut.done():
                                fut.set_result(msg)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                if not connected.done():
                    connected.set_exception(exc)
                for fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(exc)
                self._pending.clear()

        self._stream_task = asyncio.create_task(_run())
        endpoint = await asyncio.wait_for(connected, timeout=self.timeout)
        self._post_url = str(self._httpx.URL(self.url).join(endpoint))

    async def _sse_request(self, rid: Any, payload: dict[str, Any]) -> dict[str, Any]:
        assert self._client is not None
        if self._post_url is None:
            raise MCPClientError("SSE session not connected")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        resp = await self._client.post(self._post_url, json=payload, headers=self._base_headers())
        if resp.status_code >= 400:
            self._pending.pop(rid, None)
            raise MCPClientError(f"SSE POST failed: HTTP {resp.status_code}")
        msg = await asyncio.wait_for(fut, timeout=self.timeout)
        return self._unwrap(msg)

    # ------------------------------------------------------------ operations

    async def list_tools(self) -> list[dict[str, Any]]:
        result = await self.request("tools/list")
        return result.get("tools", [])

    async def list_resources(self) -> list[dict[str, Any]]:
        result = await self.request("resources/list")
        return result.get("resources", [])

    async def list_prompts(self) -> list[dict[str, Any]]:
        result = await self.request("prompts/list")
        return result.get("prompts", [])

    async def call_tool(self, name: str, arguments: dict[str, Any]) -> dict[str, Any]:
        return await self.request("tools/call", {"name": name, "arguments": arguments})

    async def read_resource(self, uri: str) -> dict[str, Any]:
        return await self.request("resources/read", {"uri": uri})

    async def get_prompt(self, name: str, arguments: dict[str, Any] | None = None) -> dict[str, Any]:
        return await self.request("prompts/get", {"name": name, "arguments": arguments or {}})

    async def ping(self) -> bool:
        try:
            await self.request("ping")
            return True
        except Exception:
            return False
