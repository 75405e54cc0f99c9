"""The catalog routes of the JAX gateway's ``gateway/routers.py`` that the
tools/call path needs, with its permissions, status codes and bodies:

- ``GET /.well-known/mcp`` (public: the auth middleware passes
  ``/.well-known/*``);
- ``/tools``: list (``tools.read``, team-scoped), create (``tools.create``,
  201; the caller owns it unless the body names an owner), get, put
  (``tools.update``), delete (``tools.delete``, 204) and
  ``POST /tools/{tool_id}/toggle`` (``{"enabled": b}``, or a bare POST
  flips);
- ``/gateways``: list, create (201: the peer's catalog is synced before the
  answer), ``POST /gateways/test`` (the wizard's dry run, never a 500), get,
  put, delete, ``POST /gateways/{gateway_id}/refresh``;
- ``/servers``: list, create (201), get, put, delete.

A body the schema refuses answers 422 with the schema's error text under
``detail`` (``ValidationFailure``), as does one past the ``validation_max_*``
field limits. Lists answer the whole list: the JAX gateway's cursor pages
(``?limit``/``?cursor``) and its registry cache are not ported yet."""

from __future__ import annotations

import json
from typing import Any

from aiohttp import web

from ..schemas import (GatewayCreate, GatewayUpdate, SchemaError, ServerCreate, ServerUpdate,
                       ToolCreate, ToolUpdate)
from ..services.base import ValidationFailure


def _dump(model) -> Any:
    if isinstance(model, list):
        return [_dump(m) for m in model]
    return model.model_dump()


async def _body(request: web.Request, schema):
    try:
        model = schema.model_validate(await request.json())
    except json.JSONDecodeError as exc:
        raise ValidationFailure(f"Invalid JSON body: {exc}") from exc
    except SchemaError as exc:
        raise ValidationFailure(str(exc)) from exc
    _check_field_limits(model, request.app["ctx"].settings)
    return model


def _check_field_limits(model, settings) -> None:
    """The central create/update field limits (the ``validation_max_*``
    settings), one enforcement point for every entity schema."""
    checks = (("name", settings.validation_max_name_length),
              ("description", settings.validation_max_description_length),
              ("url", settings.validation_max_url_length))
    for field_name, limit in checks:
        value = getattr(model, field_name, None)
        if isinstance(value, str) and limit and len(value) > limit:
            raise ValidationFailure(f"{field_name} exceeds {limit} characters")
    tags = getattr(model, "tags", None)
    if tags:
        if settings.validation_max_tags and len(tags) > settings.validation_max_tags:
            raise ValidationFailure(f"More than {settings.validation_max_tags} tags")
        for tag in tags:
            if settings.validation_max_tag_length and \
                    len(tag) > settings.validation_max_tag_length:
                raise ValidationFailure(
                    f"Tag exceeds {settings.validation_max_tag_length} characters")


def _include_inactive(request: web.Request) -> bool:
    return request.query.get("include_inactive") == "true"


def setup_routes(app: web.Application) -> None:
    routes = web.RouteTableDef()

    @routes.get("/.well-known/mcp")
    async def well_known(request: web.Request) -> web.Response:
        settings = request.app["ctx"].settings
        return web.json_response({
            "name": settings.app_name,
            "protocolVersion": settings.protocol_version,
            "endpoints": {"mcp": "/mcp", "rpc": "/rpc"},
        })

    # ---------------------------------------------------------------- tools
    @routes.get("/tools")
    async def list_tools(request: web.Request) -> web.Response:
        request["auth"].require("tools.read")
        tools = await request.app["tool_service"].list_tools(
            include_inactive=_include_inactive(request), team_ids=request["auth"].teams)
        return web.json_response(_dump(tools))

    @routes.post("/tools")
    async def create_tool(request: web.Request) -> web.Response:
        request["auth"].require("tools.create")
        tool = await _body(request, ToolCreate)
        if not tool.owner_email:
            tool.owner_email = request["auth"].user
        created = await request.app["tool_service"].register_tool(tool)
        return web.json_response(_dump(created), status=201)

    @routes.get("/tools/{tool_id}")
    async def get_tool(request: web.Request) -> web.Response:
        request["auth"].require("tools.read")
        tool = await request.app["tool_service"].get_tool(request.match_info["tool_id"])
        return web.json_response(_dump(tool))

    @routes.put("/tools/{tool_id}")
    async def update_tool(request: web.Request) -> web.Response:
        request["auth"].require("tools.update")
        update = await _body(request, ToolUpdate)
        tool = await request.app["tool_service"].update_tool(
            request.match_info["tool_id"], update)
        return web.json_response(_dump(tool))

    @routes.delete("/tools/{tool_id}")
    async def delete_tool(request: web.Request) -> web.Response:
        request["auth"].require("tools.delete")
        await request.app["tool_service"].delete_tool(request.match_info["tool_id"])
        return web.Response(status=204)

    @routes.post("/tools/{tool_id}/toggle")
    async def toggle_tool(request: web.Request) -> web.Response:
        request["auth"].require("tools.update")
        body = {}
        if request.can_read_body and (await request.read()):
            # malformed JSON is a 422, never flip mode: a client that meant
            # {"enabled": false} must not re-enable the tool
            body = json.loads(await request.text())
        tool_id = request.match_info["tool_id"]
        if "enabled" in body:
            enabled = bool(body["enabled"])
        else:  # a bare POST flips the current state
            current = await request.app["tool_service"].get_tool(tool_id)
            enabled = not current.enabled
        tool = await request.app["tool_service"].toggle_tool(tool_id, enabled)
        return web.json_response(_dump(tool))

    # -------------------------------------------------------------- gateways
    @routes.get("/gateways")
    async def list_gateways(request: web.Request) -> web.Response:
        request["auth"].require("gateways.read")
        gateways = await request.app["gateway_service"].list_gateways(
            _include_inactive(request))
        return web.json_response(_dump(gateways))

    @routes.post("/gateways")
    async def register_gateway(request: web.Request) -> web.Response:
        request["auth"].require("gateways.create")
        gateway = await _body(request, GatewayCreate)
        created = await request.app["gateway_service"].register_gateway(gateway)
        return web.json_response(_dump(created), status=201)

    @routes.post("/gateways/test")
    async def test_gateway(request: web.Request) -> web.Response:
        """The registration wizard's dry run: probe a peer before it is
        persisted."""
        request["auth"].require("gateways.create")
        body = await request.json()
        result = await request.app["gateway_service"].test_gateway(
            str(body.get("url", "")),
            transport=str(body.get("transport") or "streamablehttp"),
            auth_type=body.get("auth_type"),
            auth_value=body.get("auth_value"))
        return web.json_response(result)

    @routes.get("/gateways/{gateway_id}")
    async def get_gateway(request: web.Request) -> web.Response:
        request["auth"].require("gateways.read")
        gateway = await request.app["gateway_service"].get_gateway(
            request.match_info["gateway_id"])
        return web.json_response(_dump(gateway))

    @routes.put("/gateways/{gateway_id}")
    async def update_gateway(request: web.Request) -> web.Response:
        request["auth"].require("gateways.update")
        update = await _body(request, GatewayUpdate)
        gateway = await request.app["gateway_service"].update_gateway(
            request.match_info["gateway_id"], update)
        return web.json_response(_dump(gateway))

    @routes.delete("/gateways/{gateway_id}")
    async def delete_gateway(request: web.Request) -> web.Response:
        request["auth"].require("gateways.delete")
        await request.app["gateway_service"].delete_gateway(request.match_info["gateway_id"])
        return web.Response(status=204)

    @routes.post("/gateways/{gateway_id}/refresh")
    async def refresh_gateway(request: web.Request) -> web.Response:
        request["auth"].require("gateways.update")
        gateway = await request.app["gateway_service"].refresh_gateway(
            request.match_info["gateway_id"])
        return web.json_response(_dump(gateway))

    # --------------------------------------------------------------- servers
    @routes.get("/servers")
    async def list_servers(request: web.Request) -> web.Response:
        request["auth"].require("servers.read")
        servers = await request.app["server_service"].list_servers(_include_inactive(request))
        return web.json_response(_dump(servers))

    @routes.post("/servers")
    async def create_server(request: web.Request) -> web.Response:
        request["auth"].require("servers.create")
        server = await _body(request, ServerCreate)
        created = await request.app["server_service"].register_server(server)
        return web.json_response(_dump(created), status=201)

    @routes.get("/servers/{server_id}")
    async def get_server(request: web.Request) -> web.Response:
        request["auth"].require("servers.read")
        server = await request.app["server_service"].get_server(request.match_info["server_id"])
        return web.json_response(_dump(server))

    @routes.put("/servers/{server_id}")
    async def update_server(request: web.Request) -> web.Response:
        request["auth"].require("servers.update")
        update = await _body(request, ServerUpdate)
        server = await request.app["server_service"].update_server(
            request.match_info["server_id"], update)
        return web.json_response(_dump(server))

    @routes.delete("/servers/{server_id}")
    async def delete_server(request: web.Request) -> web.Response:
        request["auth"].require("servers.delete")
        await request.app["server_service"].delete_server(request.match_info["server_id"])
        return web.Response(status=204)

    app.add_routes(routes)
