"""Elicitation: a server-initiated request to a connected client (a copy of
the JAX package's ``services/elicitation_service.py``). The gateway pushes
an ``elicitation/create`` request onto the session's server-to-client SSE
stream (stateful streamable HTTP) and matches the client's response, which
arrives as a response message POSTed to ``/mcp`` on the same session."""

from __future__ import annotations

import asyncio
from typing import Any

from ..utils.ids import new_id
from .base import AppContext, NotFoundError


class ElicitationService:
    MAX_TIMEOUT = 600.0

    def __init__(self, ctx: AppContext, session_manager):
        self.ctx = ctx
        self.sessions = session_manager
        self._pending: dict[str, tuple[str, asyncio.Future]] = {}   # id -> (sid, future)

    async def elicit(self, session_id: str, message: str,
                     requested_schema: dict[str, Any] | None = None,
                     timeout: float = 120.0) -> dict[str, Any]:
        """Ask the client connected on ``session_id``; returns its response
        ({action: accept|decline|cancel, content?})."""
        timeout = min(max(timeout, 1.0), self.MAX_TIMEOUT)   # client-supplied: clamped
        request_id = f"elicit-{new_id()[:12]}"
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[request_id] = (session_id, future)
        try:
            sent = await self.sessions.send_to_session(session_id, {
                "jsonrpc": "2.0", "id": request_id, "method": "elicitation/create",
                "params": {"message": message,
                           "requestedSchema": requested_schema
                           or {"type": "object", "properties": {}}}})
            if not sent:
                raise NotFoundError(f"Session {session_id!r} has no connected stream")
            try:
                response = await asyncio.wait_for(future, timeout=timeout)
            except asyncio.TimeoutError:
                # a silent client is an expected outcome, not a server error
                return {"action": "cancel", "reason": "timeout"}
            if "error" in response:
                return {"action": "cancel", "error": response["error"]}
            return response.get("result", {"action": "cancel"})
        finally:
            self._pending.pop(request_id, None)

    def resolve(self, message: dict[str, Any], session_id: str | None = None) -> bool:
        """Route a client-to-server response; True if it matched. The reply
        must arrive on the session the request went to: an id alone must not
        let another principal forge an answer."""
        entry = self._pending.get(str(message.get("id", "")))
        if entry is None:
            return False
        expected_session, future = entry
        if session_id != expected_session:
            return False
        if not future.done():
            future.set_result(message)
            return True
        return False

    @property
    def pending_count(self) -> int:
        return len(self._pending)
