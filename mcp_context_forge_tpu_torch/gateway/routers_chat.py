"""The ``/llmchat`` routes of the JAX gateway's ``gateway/routers_chat.py``,
with its permissions, status codes and bodies, over ``app["chat_service"]``:

- ``POST /llmchat/connect`` (``llm.chat``; 201 ``{"session_id"}``; the body
  may name ``model``, ``server_id`` and ``max_steps``);
- ``POST /llmchat/{session_id}/chat`` (``llm.chat``; ``{"message", "stream"}``:
  the service's events as SSE ending ``data: [DONE]``, or
  ``{"events": [...]}`` with ``stream`` false; an unknown session answers 404
  before the stream starts);
- ``DELETE /llmchat/{session_id}`` (204).

The same JAX file's teams routes wait for the database-backed auth, and its
catalog, rollup and timeseries routes for the catalog and metrics services;
neither is ported yet."""

from __future__ import annotations

from aiohttp import web

from ..observability import phases
from .serialize import SSE_DONE, sse_event


def setup_routes(app: web.Application) -> None:
    routes = web.RouteTableDef()

    @routes.post("/llmchat/connect")
    async def connect(request: web.Request) -> web.Response:
        request["auth"].require("llm.chat")
        try:
            body = await request.json()
        except Exception:
            body = {}
        session = await request.app["chat_service"].connect(
            user=request["auth"].user, model=body.get("model"),
            server_id=body.get("server_id"),
            max_steps=(int(body["max_steps"]) if body.get("max_steps") is not None else None))
        return web.json_response({"session_id": session.id}, status=201)

    @routes.post("/llmchat/{session_id}/chat")
    async def chat(request: web.Request) -> web.StreamResponse:
        request["auth"].require("llm.chat")
        body = await request.json()
        text = body.get("message", "")
        stream = bool(body.get("stream", True))
        service = request.app["chat_service"]
        # refused before the SSE response starts: a generator raises only at
        # its first step, after the 200 headers
        await service.get_session(request.match_info["session_id"], request["auth"].user)
        if request.app["ctx"].llm_registry is None:
            return web.json_response({"detail": "tpu_local engine disabled"}, status=422)
        events = service.chat(request.match_info["session_id"], request["auth"].user, text,
                              auth_teams=request["auth"].teams)
        if not stream:
            return web.json_response({"events": [event async for event in events]})
        resp = web.StreamResponse(headers={"content-type": "text/event-stream",
                                           "cache-control": "no-store"})
        await resp.prepare(request)
        async for event in events:
            with phases.phase("serialize"):
                await resp.write(sse_event(event))
        await resp.write(SSE_DONE)
        await resp.write_eof()
        return resp

    @routes.delete("/llmchat/{session_id}")
    async def disconnect(request: web.Request) -> web.Response:
        await request.app["chat_service"].disconnect(request.match_info["session_id"],
                                                     request["auth"].user)
        return web.Response(status=204)

    app.add_routes(routes)
