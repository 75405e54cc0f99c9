"""The catalog routes of the JAX gateway's ``gateway/routers.py``, with its
permissions, status codes and bodies:

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
- ``/resources``: list, create (201), put, delete, and ``POST
  /resources/read`` (``{"uri"}``; local or federated);
- ``/prompts``: list, create (201), put, delete, and ``POST
  /prompts/{name}/render`` (the body is the arguments);
- ``/servers``: list, create (201), get, put, delete.

A body the schema refuses answers 422 with the schema's error text under
``detail`` (``ValidationFailure``), as does one past the ``validation_max_*``
field limits. Every list answers through ``paginate`` (``gateway/
pagination.py``: the whole list without ``limit`` and ``cursor``, else a
keyset page) over ``_cached_list``: with ``app["registry_cache"]`` the
loaded list is cached under a key of the query's flags (and, for tools, the
viewer's teams), never of ``limit`` or ``cursor``, so every page is cut from
one cached list. The auth, users, tokens, metrics and admin routes of the
JAX module are not ported."""

from __future__ import annotations

import json
from typing import Any

from aiohttp import web

from ..schemas import (GatewayCreate, GatewayUpdate, PromptCreate, PromptUpdate, ResourceCreate,
                       ResourceUpdate, SchemaError, ServerCreate, ServerUpdate, ToolCreate,
                       ToolUpdate)
from ..services.base import ValidationFailure
from .pagination import paginate


def _dump(model) -> Any:
    if isinstance(model, list):
        return [_dump(m) for m in model]
    return model.model_dump()


async def _cached_list(request: web.Request, entity: str, key: str, loader):
    """The list of ``entity`` from the registry cache, or ``loader``'s on a
    miss; without a cache, always the loader's."""
    cache = request.app.get("registry_cache")
    if cache is None:
        return await loader()
    items = cache.get(entity, key)
    if items is None:
        # the generation before the load: an invalidation that fires while
        # the read runs makes this snapshot stale, and put() then drops it
        generation = cache.generation(entity)
        items = await loader()
        cache.put(entity, key, items, generation)
    return items


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
        include_inactive = _include_inactive(request)
        # the tool list is team-scoped: the key carries the viewer's teams
        teams = ",".join(sorted(request["auth"].teams or []))
        tools = await _cached_list(
            request, "tools", f"{include_inactive}:{teams}",
            lambda: request.app["tool_service"].list_tools(
                include_inactive=include_inactive, team_ids=request["auth"].teams))
        return paginate(request, tools, _dump)

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
        include_inactive = _include_inactive(request)
        gateways = await _cached_list(
            request, "gateways", str(include_inactive),
            lambda: request.app["gateway_service"].list_gateways(include_inactive))
        return paginate(request, gateways, _dump)

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

    # ------------------------------------------------------------- resources
    @routes.get("/resources")
    async def list_resources(request: web.Request) -> web.Response:
        request["auth"].require("resources.read")
        include_inactive = _include_inactive(request)
        resources = await _cached_list(
            request, "resources", str(include_inactive),
            lambda: request.app["resource_service"].list_resources(include_inactive))
        return paginate(request, resources, _dump)

    @routes.post("/resources")
    async def create_resource(request: web.Request) -> web.Response:
        request["auth"].require("resources.create")
        resource = await _body(request, ResourceCreate)
        created = await request.app["resource_service"].register_resource(resource)
        return web.json_response(_dump(created), status=201)

    @routes.put("/resources/{resource_id}")
    async def update_resource(request: web.Request) -> web.Response:
        request["auth"].require("resources.update")
        update = await _body(request, ResourceUpdate)
        resource = await request.app["resource_service"].update_resource(
            request.match_info["resource_id"], update)
        return web.json_response(_dump(resource))

    @routes.delete("/resources/{resource_id}")
    async def delete_resource(request: web.Request) -> web.Response:
        request["auth"].require("resources.delete")
        await request.app["resource_service"].delete_resource(
            request.match_info["resource_id"])
        return web.Response(status=204)

    @routes.post("/resources/read")
    async def read_resource(request: web.Request) -> web.Response:
        request["auth"].require("resources.read")
        body = await request.json()
        result = await request.app["resource_service"].read_resource(body.get("uri", ""))
        return web.json_response(result)

    # --------------------------------------------------------------- prompts
    @routes.get("/prompts")
    async def list_prompts(request: web.Request) -> web.Response:
        request["auth"].require("prompts.read")
        include_inactive = _include_inactive(request)
        prompts = await _cached_list(
            request, "prompts", str(include_inactive),
            lambda: request.app["prompt_service"].list_prompts(include_inactive))
        return paginate(request, prompts, _dump)

    @routes.post("/prompts")
    async def create_prompt(request: web.Request) -> web.Response:
        request["auth"].require("prompts.create")
        prompt = await _body(request, PromptCreate)
        created = await request.app["prompt_service"].register_prompt(prompt)
        return web.json_response(_dump(created), status=201)

    @routes.put("/prompts/{prompt_id}")
    async def update_prompt(request: web.Request) -> web.Response:
        request["auth"].require("prompts.update")
        update = await _body(request, PromptUpdate)
        prompt = await request.app["prompt_service"].update_prompt(
            request.match_info["prompt_id"], update)
        return web.json_response(_dump(prompt))

    @routes.delete("/prompts/{prompt_id}")
    async def delete_prompt(request: web.Request) -> web.Response:
        request["auth"].require("prompts.delete")
        await request.app["prompt_service"].delete_prompt(request.match_info["prompt_id"])
        return web.Response(status=204)

    @routes.post("/prompts/{name}/render")
    async def render_prompt(request: web.Request) -> web.Response:
        request["auth"].require("prompts.read")
        try:
            args = await request.json()
        except Exception:
            args = {}
        result = await request.app["prompt_service"].render_prompt(
            request.match_info["name"], args)
        return web.json_response(result)

    # --------------------------------------------------------------- servers
    @routes.get("/servers")
    async def list_servers(request: web.Request) -> web.Response:
        request["auth"].require("servers.read")
        include_inactive = _include_inactive(request)
        servers = await _cached_list(
            request, "servers", str(include_inactive),
            lambda: request.app["server_service"].list_servers(include_inactive))
        return paginate(request, servers, _dump)

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
