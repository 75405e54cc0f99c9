"""The ``/llmchat`` routes of the JAX gateway's ``gateway/routers_chat.py``,
with its permissions, status codes and bodies, over ``app["chat_service"]``:

- ``POST /llmchat/connect`` (``llm.chat``; 201 ``{"session_id"}``; the body
  may name ``model``, ``server_id`` and ``max_steps``);
- ``POST /llmchat/{session_id}/chat`` (``llm.chat``; ``{"message", "stream"}``:
  the service's events as SSE ending ``data: [DONE]``, or
  ``{"events": [...]}`` with ``stream`` false; an unknown session answers 404
  before the stream starts);
- ``DELETE /llmchat/{session_id}`` (204);
- the teams over ``app["team_service"]``: ``GET /teams`` (``teams.read``;
  the caller's teams, every team for an admin with ``?all=true``), ``POST
  /teams`` (``teams.create``, 201), ``GET /teams/{id}`` (``teams.read``; a
  private team only to its members and admins), ``DELETE /teams/{id}``,
  ``POST /teams/{id}/members``, ``DELETE /teams/{id}/members/{email}``,
  ``POST /teams/{id}/invitations`` (201; the mail in the background) and
  ``POST /teams/invitations/accept`` (owners act; admins may act on any).

The same JAX file's catalog, rollup and timeseries routes wait for the
catalog and metrics services."""

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

    # ----------------------------------------------------------------- teams
    @routes.get("/teams")
    async def list_teams(request: web.Request) -> web.Response:
        auth = request["auth"]
        auth.require("teams.read")
        user = None if auth.is_admin and request.query.get("all") == "true" else auth.user
        return web.json_response(await request.app["team_service"].list_teams(user))

    @routes.post("/teams")
    async def create_team(request: web.Request) -> web.Response:
        auth = request["auth"]
        auth.require("teams.create")  # a write: read-scoped tokens may not
        body = await request.json()
        team = await request.app["team_service"].create_team(
            name=body.get("name", ""), created_by=auth.user,
            description=body.get("description", ""),
            visibility=body.get("visibility", "private"), is_admin=auth.is_admin)
        return web.json_response(team, status=201)

    @routes.get("/teams/{team_id}")
    async def get_team(request: web.Request) -> web.Response:
        auth = request["auth"]
        auth.require("teams.read")
        return web.json_response(await request.app["team_service"].get_team(
            request.match_info["team_id"], actor=auth.user, is_admin=auth.is_admin))

    @routes.delete("/teams/{team_id}")
    async def delete_team(request: web.Request) -> web.Response:
        auth = request["auth"]
        await request.app["team_service"].delete_team(
            request.match_info["team_id"], auth.user, auth.is_admin)
        return web.Response(status=204)

    @routes.post("/teams/{team_id}/members")
    async def add_member(request: web.Request) -> web.Response:
        auth = request["auth"]
        body = await request.json()
        await request.app["team_service"].add_member(
            request.match_info["team_id"], auth.user, body.get("email", ""),
            role=body.get("role") or None, is_admin=auth.is_admin)
        return web.Response(status=204)

    @routes.delete("/teams/{team_id}/members/{email}")
    async def remove_member(request: web.Request) -> web.Response:
        auth = request["auth"]
        await request.app["team_service"].remove_member(
            request.match_info["team_id"], auth.user, request.match_info["email"],
            is_admin=auth.is_admin)
        return web.Response(status=204)

    @routes.post("/teams/{team_id}/invitations")
    async def invite(request: web.Request) -> web.Response:
        auth = request["auth"]
        body = await request.json()
        invitation = await request.app["team_service"].invite(
            request.match_info["team_id"], auth.user, body.get("email", ""),
            role=body.get("role") or None, is_admin=auth.is_admin)
        return web.json_response(invitation, status=201)

    @routes.post("/teams/invitations/accept")
    async def accept(request: web.Request) -> web.Response:
        body = await request.json()
        team = await request.app["team_service"].accept_invitation(
            body.get("token", ""), request["auth"].user)
        return web.json_response(team)

    app.add_routes(routes)
