"""The JAX gateway's A2A, LLM-admin and plugin routes
(``gateway/routers_extra.py`` there) and its toolops routes (mounted by its
``gateway/app.py``), with its permissions, status codes and bodies. Handlers
raise the services' domain errors; ``error_middleware`` maps them (404, 409,
422).

- ``GET /a2a`` (``a2a.read``; through ``paginate``: the whole list, or a
  cursor page with ``limit``/``cursor``), ``POST /a2a`` (``a2a.create``,
  201; a body the schema refuses is a 422 in pydantic's layout),
  ``DELETE /a2a/{agent_id}``
  (``a2a.delete``, 204) and ``POST /a2a/{name}/invoke`` (``a2a.invoke``; the
  inbound ``x-contextforge-uaid-hop`` is the hop) over ``app["a2a_service"]``;
- ``POST``/``GET /a2a/{name}/tasks``, ``GET /a2a/tasks/{task_id}`` (an
  unknown id that names an agent lists that agent's tasks) and
  ``POST /a2a/tasks/{task_id}/cancel``;
- ``GET /toolops/{name}/cases`` (``tools.read``; ``?use_llm=true`` adds the
  engine's cases) and ``POST /toolops/{name}/run`` (``tools.invoke``; the
  body's ``cases``, else the generated ones) over ``app["toolops_service"]``;
- ``GET``/``POST /llm/providers``, ``DELETE /llm/providers/{provider_id}``,
  ``GET /llm/models``, ``POST /llm/providers/{provider_id}/models``
  (``llm.admin``) over ``app["llm_provider_service"]``;
- ``GET /plugins`` (the loaded plugins, ``[]`` without a manager),
  ``POST /plugins/{name}/mode`` (over the ``plugins.control`` topic; a
  binding's mode is stored), ``GET``/``POST /plugins/bindings`` and
  ``DELETE /plugins/bindings/{binding_id}`` (rows of ``plugin_bindings``;
  a change publishes ``plugins.bindings.changed``), all ``plugins.manage``,
  over ``app["ctx"]``."""

from __future__ import annotations

import json

from aiohttp import web

from ..db.core import to_json
from ..plugins.framework import PluginMode
from ..schemas import A2AAgentCreate, SchemaError
from ..services.base import NotFoundError, ValidationFailure, now
from ..utils.ids import new_id
from .pagination import paginate


def setup_routes(app: web.Application) -> None:
    routes = web.RouteTableDef()

    # ------------------------------------------------------------------- A2A
    @routes.get("/a2a")
    async def list_agents(request: web.Request) -> web.Response:
        request["auth"].require("a2a.read")
        agents = await request.app["a2a_service"].list_agents(
            request.query.get("include_inactive") == "true")
        return paginate(request, agents, lambda page: [a.model_dump() for a in page])

    @routes.post("/a2a")
    async def register_agent(request: web.Request) -> web.Response:
        request["auth"].require("a2a.create")
        try:
            agent = A2AAgentCreate.model_validate(await request.json())
        except (json.JSONDecodeError, SchemaError) as exc:
            raise ValidationFailure(str(exc)) from exc
        created = await request.app["a2a_service"].register_agent(agent)
        return web.json_response(created.model_dump(), status=201)

    @routes.delete("/a2a/{agent_id}")
    async def delete_agent(request: web.Request) -> web.Response:
        request["auth"].require("a2a.delete")
        await request.app["a2a_service"].delete_agent(request.match_info["agent_id"])
        return web.Response(status=204)

    @routes.post("/a2a/{name}/invoke")
    async def invoke_agent(request: web.Request) -> web.Response:
        request["auth"].require("a2a.invoke")
        try:
            payload = await request.json()
        except Exception:
            payload = {}
        hop = int(request.headers.get("x-contextforge-uaid-hop", "0"))
        result = await request.app["a2a_service"].invoke_agent(
            request.match_info["name"], payload, user=request["auth"].user, hop=hop)
        return web.json_response(result)

    @routes.post("/a2a/{name}/tasks")
    async def create_task(request: web.Request) -> web.Response:
        request["auth"].require("a2a.invoke")
        try:
            payload = await request.json()
        except Exception:
            payload = {}
        task = await request.app["a2a_service"].create_task(
            request.match_info["name"], payload, user=request["auth"].user)
        return web.json_response(task, status=201)

    @routes.get("/a2a/{name}/tasks")
    async def list_tasks(request: web.Request) -> web.Response:
        request["auth"].require("a2a.read")
        return web.json_response(
            await request.app["a2a_service"].list_tasks(request.match_info["name"]))

    @routes.get("/a2a/tasks/{task_id}")
    async def get_task(request: web.Request) -> web.Response:
        request["auth"].require("a2a.read")
        task_id = request.match_info["task_id"]
        service = request.app["a2a_service"]
        try:
            return web.json_response(await service.get_task(task_id))
        except NotFoundError:
            # this route also matches /a2a/{name}/tasks for an agent named
            # "tasks": an unknown task id that names an agent lists its tasks
            agent = await request.app["ctx"].db.fetchone(
                "SELECT id FROM a2a_agents WHERE name=? OR slug=?", (task_id, task_id))
            if agent:
                return web.json_response(await service.list_tasks(task_id))
            raise

    @routes.post("/a2a/tasks/{task_id}/cancel")
    async def cancel_task(request: web.Request) -> web.Response:
        request["auth"].require("a2a.invoke")
        return web.json_response(
            await request.app["a2a_service"].cancel_task(request.match_info["task_id"]))

    # --------------------------------------------------------------- toolops
    @routes.get("/toolops/{name}/cases")
    async def toolops_generate(request: web.Request) -> web.Response:
        request["auth"].require("tools.read")
        cases = await request.app["toolops_service"].generate(
            request.match_info["name"], use_llm=request.query.get("use_llm") == "true")
        return web.json_response({"cases": cases})

    @routes.post("/toolops/{name}/run")
    async def toolops_run(request: web.Request) -> web.Response:
        request["auth"].require("tools.invoke")
        try:
            body = await request.json()
        except Exception:
            body = {}
        if not isinstance(body, dict):
            return web.json_response({"detail": "body must be a JSON object"}, status=422)
        report = await request.app["toolops_service"].run(
            request.match_info["name"], cases=body.get("cases"), user=request["auth"].user)
        return web.json_response(report)

    # ------------------------------------------------------------- LLM admin
    @routes.get("/llm/providers")
    async def list_providers(request: web.Request) -> web.Response:
        request["auth"].require("llm.admin")
        return web.json_response(await request.app["llm_provider_service"].list_providers())

    @routes.post("/llm/providers")
    async def create_provider(request: web.Request) -> web.Response:
        request["auth"].require("llm.admin")
        body = await request.json()
        provider = await request.app["llm_provider_service"].create_provider(
            name=body.get("name", ""), provider_type=body.get("provider_type", ""),
            api_base=body.get("api_base", ""), config=body.get("config"))
        return web.json_response(provider, status=201)

    @routes.delete("/llm/providers/{provider_id}")
    async def delete_provider(request: web.Request) -> web.Response:
        request["auth"].require("llm.admin")
        await request.app["llm_provider_service"].delete_provider(
            request.match_info["provider_id"])
        return web.Response(status=204)

    @routes.get("/llm/models")
    async def list_models(request: web.Request) -> web.Response:
        request["auth"].require("llm.admin")
        return web.json_response(await request.app["llm_provider_service"].list_models())

    @routes.post("/llm/providers/{provider_id}/models")
    async def add_model(request: web.Request) -> web.Response:
        request["auth"].require("llm.admin")
        body = await request.json()
        model = await request.app["llm_provider_service"].add_model(
            request.match_info["provider_id"], model_id=body.get("model_id", ""),
            alias=body.get("alias", ""),
            supports_chat=bool(body.get("supports_chat", True)),
            supports_embeddings=bool(body.get("supports_embeddings", False)))
        return web.json_response(model, status=201)

    # ---------------------------------------------------------------- plugins
    @routes.get("/plugins")
    async def list_plugins(request: web.Request) -> web.Response:
        request["auth"].require("plugins.manage")
        pm = request.app.get("plugin_manager")
        if pm is None:
            return web.json_response([])
        return web.json_response([{
            "name": p.config.name, "kind": p.config.kind,
            "mode": p.config.mode.value, "priority": p.config.priority,
            "tools": p.config.tools,
        } for p in pm.plugins])

    @routes.post("/plugins/{name}/mode")
    async def set_plugin_mode(request: web.Request) -> web.Response:
        request["auth"].require("plugins.manage")
        body = await request.json()
        ctx = request.app["ctx"]
        name = request.match_info["name"]
        mode = body.get("mode", "enforce")
        if mode not in {m.value for m in PluginMode}:
            raise ValidationFailure(
                f"mode must be one of {sorted(m.value for m in PluginMode)}")
        # a binding's mode is stored, so that a reload cannot revert it
        if name.startswith("binding:"):
            await ctx.db.execute("UPDATE plugin_bindings SET mode=? WHERE id=?",
                                 (mode, name.split(":", 1)[1]))
        # every worker's manager applies it (this one by local delivery)
        await ctx.bus.publish("plugins.control", {"name": name, "mode": mode})
        return web.Response(status=204)

    @routes.post("/plugins/bindings")
    async def create_binding(request: web.Request) -> web.Response:
        request["auth"].require("plugins.manage")
        body = await request.json()
        ctx = request.app["ctx"]
        binding_id = new_id()
        await ctx.db.execute(
            "INSERT INTO plugin_bindings (id, plugin_name, scope_type, scope_id,"
            " mode, config, enabled, created_at) VALUES (?,?,?,?,?,?,?,?)",
            (binding_id, body.get("plugin_name", ""),
             body.get("scope_type", "tool"), body.get("scope_id"),
             body.get("mode", "enforce"),
             to_json(body.get("config", {})), 1, now()))
        await ctx.bus.publish("plugins.bindings.changed", {"id": binding_id})
        return web.json_response({"id": binding_id}, status=201)

    @routes.get("/plugins/bindings")
    async def list_bindings(request: web.Request) -> web.Response:
        request["auth"].require("plugins.manage")
        rows = await request.app["ctx"].db.fetchall(
            "SELECT * FROM plugin_bindings ORDER BY created_at")
        return web.json_response(rows)

    @routes.delete("/plugins/bindings/{binding_id}")
    async def delete_binding(request: web.Request) -> web.Response:
        request["auth"].require("plugins.manage")
        await request.app["ctx"].db.execute(
            "DELETE FROM plugin_bindings WHERE id=?",
            (request.match_info["binding_id"],))
        await request.app["ctx"].bus.publish("plugins.bindings.changed",
                                             {"id": request.match_info["binding_id"]})
        return web.Response(status=204)

    app.add_routes(routes)
