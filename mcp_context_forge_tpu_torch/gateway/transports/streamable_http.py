"""The streamable-HTTP transport, MCP 2025-03-26 and later (a copy of the JAX
package's ``gateway/transports/streamable_http.py``):

- ``POST``: JSON-RPC message(s) in, ``application/json`` (or an SSE stream)
  out; notifications alone answer 202;
- stateful mode: ``initialize`` mints an ``Mcp-Session-Id``; ``GET`` opens
  the server-to-client SSE stream, resumed from the event store after a
  ``Last-Event-ID``; ``DELETE`` ends the session;
- stateless mode (the default): every POST stands alone.

Sessions live in this worker alone: the cross-worker session owner (the
JAX package's ``affinity``) is not ported yet. ``elicitation`` stays None
until the app sets it (``build_llm_app`` sets its ``ElicitationService``,
which then receives the clients' responses).
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass, field
from typing import Any

from aiohttp import web

from ...jsonrpc import (JSONRPCError, RPCRequest, error_response, is_response_message,
                        INVALID_REQUEST, PARSE_ERROR)
from ...utils.ids import new_id
from ..serialize import encode_json


@dataclass
class EventStoreEntry:
    event_id: str
    message: dict[str, Any]


class InMemoryEventStore:
    """Per-session replay buffer for SSE resume (Last-Event-ID)."""

    def __init__(self, max_events_per_session: int = 512) -> None:
        self._events: dict[str, list[EventStoreEntry]] = {}
        self._max = max_events_per_session
        self._counter = 0

    def append(self, session_id: str, message: dict[str, Any]) -> str:
        self._counter += 1
        event_id = f"{session_id}-{self._counter}"
        bucket = self._events.setdefault(session_id, [])
        bucket.append(EventStoreEntry(event_id, message))
        if len(bucket) > self._max:
            del bucket[: len(bucket) - self._max]
        return event_id

    def replay_after(self, session_id: str, last_event_id: str) -> list[EventStoreEntry]:
        bucket = self._events.get(session_id, [])
        out, seen = [], False
        for entry in bucket:
            if seen:
                out.append(entry)
            elif entry.event_id == last_event_id:
                seen = True
        return out if seen else list(bucket)

    def drop(self, session_id: str) -> None:
        self._events.pop(session_id, None)


@dataclass
class StreamSession:
    id: str
    created_at: float = field(default_factory=time.time)
    last_seen: float = field(default_factory=time.time)
    queue: asyncio.Queue = field(default_factory=lambda: asyncio.Queue(maxsize=256))
    initialized: bool = False


class SessionManager:
    SWEEP_INTERVAL = 60.0

    def __init__(self, ttl: float = 3600.0) -> None:
        self.sessions: dict[str, StreamSession] = {}
        self.events = InMemoryEventStore()
        self.ttl = ttl
        self._sweeper: asyncio.Task | None = None
        self.metrics = None  # PrometheusRegistry, set by app wiring

    def _sync_gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.sessions_active.set(len(self.sessions))

    async def start_sweeper(self) -> None:
        if self._sweeper is None:
            async def _loop() -> None:
                while True:
                    await asyncio.sleep(self.SWEEP_INTERVAL)
                    self.sweep()
            self._sweeper = asyncio.create_task(_loop())

    async def stop_sweeper(self) -> None:
        if self._sweeper is not None:
            self._sweeper.cancel()
            try:
                await self._sweeper
            except asyncio.CancelledError:
                pass
            self._sweeper = None

    def create(self) -> StreamSession:
        session = StreamSession(id=new_id())
        self.sessions[session.id] = session
        self._sync_gauge()
        return session

    def get(self, session_id: str) -> StreamSession | None:
        session = self.sessions.get(session_id)
        if session is not None:
            session.last_seen = time.time()
        return session

    def drop(self, session_id: str) -> None:
        self.sessions.pop(session_id, None)
        self.events.drop(session_id)
        self._sync_gauge()

    def sweep(self) -> None:
        cutoff = time.time() - self.ttl
        for sid in [s for s, sess in self.sessions.items() if sess.last_seen < cutoff]:
            self.drop(sid)

    async def send_to_session(self, session_id: str, message: dict[str, Any]) -> bool:
        """Queue a server-initiated message (notifications fanout)."""
        session = self.sessions.get(session_id)
        if session is None:
            return False
        event_id = self.events.append(session_id, message)
        try:
            session.queue.put_nowait((event_id, message))
            return True
        except asyncio.QueueFull:
            return False

    async def broadcast(self, message: dict[str, Any]) -> int:
        """Send a notification to every live session (listChanged fanout)."""
        count = 0
        for session_id in list(self.sessions):
            if await self.send_to_session(session_id, message):
                count += 1
        return count


_FRAME_EVENT = b"event: message\ndata: "


def _sse_frame(event_id: str | None, data: Any) -> bytes:
    # the shared compact encoder and pre-built framing; a replayed frame is
    # byte-equal to the live one because both writers go through THIS function
    if event_id:
        return b"".join((b"id: ", event_id.encode(), b"\n",
                         _FRAME_EVENT, encode_json(data), b"\n\n"))
    return b"".join((_FRAME_EVENT, encode_json(data), b"\n\n"))


class StreamableHTTPTransport:
    """Bound to a dispatcher; mounted at /mcp and /servers/{id}/mcp."""

    def __init__(self, dispatcher, settings, session_manager: SessionManager | None = None):
        self.dispatcher = dispatcher
        self.settings = settings
        self.sessions = session_manager or SessionManager(ttl=settings.session_ttl)
        self.elicitation = None  # ElicitationService, set by app

    # ------------------------------------------------------------------ POST

    async def handle_post(self, request: web.Request) -> web.StreamResponse:
        auth = request["auth"]
        server_id = request.match_info.get("server_id")
        stateful = self.settings.streamable_http_stateful
        try:
            raw = await request.read()
            payload = json.loads(raw) if raw else None
        except json.JSONDecodeError:
            return web.json_response(error_response(None, PARSE_ERROR, "Parse error"),
                                     status=400)
        if payload is None:
            return web.json_response(error_response(None, INVALID_REQUEST, "Empty body"),
                                     status=400)

        messages = payload if isinstance(payload, list) else [payload]
        if not messages:
            return web.json_response(error_response(None, INVALID_REQUEST, "Empty batch"),
                                     status=400)

        session: StreamSession | None = None
        session_id = request.headers.get("mcp-session-id")
        if stateful:
            is_initialize = any(
                isinstance(m, dict) and m.get("method") == "initialize" for m in messages)
            if session_id:
                session = self.sessions.get(session_id)
                if session is None:
                    return web.json_response(
                        error_response(None, INVALID_REQUEST, "Unknown session"), status=404)
            elif is_initialize:
                session = self.sessions.create()
            else:
                return web.json_response(
                    error_response(None, INVALID_REQUEST, "Missing Mcp-Session-Id"),
                    status=400)

        headers = {k.lower(): v for k, v in request.headers.items()}
        if session is not None:
            headers["mcp-session-id"] = session.id

        responses: list[dict[str, Any]] = []
        for message in messages:
            # client→server RESPONSE messages (no method): elicitation replies
            if is_response_message(message):
                if self.elicitation is not None:
                    self.elicitation.resolve(message,
                                             session_id=headers.get("mcp-session-id"))
                continue
            try:
                rpc_request = RPCRequest.parse(message)
            except JSONRPCError as exc:
                responses.append(exc.to_dict(message.get("id") if isinstance(message, dict)
                                             else None))
                continue
            try:
                response = await self.dispatcher.dispatch(rpc_request, auth,
                                                          headers=headers,
                                                          server_id=server_id)
            except JSONRPCError as exc:
                response = exc.to_dict(rpc_request.id)
            if response is not None:
                responses.append(response)
            if session is not None and rpc_request.method == "initialize":
                session.initialized = True

        response_headers = {"mcp-protocol-version": self.settings.protocol_version}
        if session is not None:
            response_headers["mcp-session-id"] = session.id
        if not responses:  # notifications only
            return web.Response(status=202, headers=response_headers)

        accept = request.headers.get("accept", "application/json")
        body = responses if isinstance(payload, list) else responses[0]
        if "text/event-stream" in accept and "application/json" not in accept.split(",")[0]:
            # client prefers a stream: emit response(s) as SSE then close
            resp = web.StreamResponse(headers={
                **response_headers, "content-type": "text/event-stream",
                "cache-control": "no-store"})
            await resp.prepare(request)
            for item in responses:
                await resp.write(_sse_frame(None, item))
            await resp.write_eof()
            return resp
        return web.json_response(body, headers=response_headers)

    # ------------------------------------------------------------------- GET

    async def handle_get(self, request: web.Request) -> web.StreamResponse:
        """Server→client SSE stream (stateful mode) with resume."""
        if not self.settings.streamable_http_stateful:
            return web.json_response({"detail": "Stateless mode: no server stream"},
                                     status=405)
        session_id = request.headers.get("mcp-session-id")
        session = self.sessions.get(session_id) if session_id else None
        if session is None:
            return web.json_response({"detail": "Unknown or missing session"}, status=404)
        resp = web.StreamResponse(headers={
            "content-type": "text/event-stream", "cache-control": "no-store",
            "mcp-session-id": session.id})
        await resp.prepare(request)
        last_event_id = request.headers.get("last-event-id")
        if last_event_id:
            for entry in self.sessions.events.replay_after(session.id, last_event_id):
                await resp.write(_sse_frame(entry.event_id, entry.message))
        keepalive = self.settings.sse_keepalive_interval
        try:
            while True:
                try:
                    event_id, message = await asyncio.wait_for(session.queue.get(),
                                                               timeout=keepalive)
                    await resp.write(_sse_frame(event_id, message))
                except asyncio.TimeoutError:
                    await resp.write(b": keepalive\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        return resp

    # ---------------------------------------------------------------- DELETE

    async def handle_delete(self, request: web.Request) -> web.StreamResponse:
        session_id = request.headers.get("mcp-session-id")
        if session_id:
            self.sessions.drop(session_id)
        return web.Response(status=204)
