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
- ``/servers``: list, create (201), get, put, delete;
- the auth surface over ``app["auth_service"]``: ``POST /auth/login``
  (public; one argon2 verify, then a JWT), ``/auth/tokens`` (mint 201, list,
  ``DELETE`` revokes, ``GET /auth/tokens/{id}/usage``: ``tokens.manage``),
  ``POST /auth/password`` (rotation), ``POST /auth/password/reset-request``
  (public, always 202 after ``password_reset_min_response_ms``, the mail
  sent in the background), ``GET``/``POST /auth/password/reset`` (the page
  and the reset; both 404 unless ``password_reset_enabled``);
- the admin's users: ``POST``/``GET /admin/users``,
  ``POST /admin/users/{email}/require-password-change``,
  ``POST /admin/users/{email}/toggle`` (``admin.all``) and ``GET
  /admin/config`` (the effective settings, secrets redacted).

A body the schema refuses answers 422 with the schema's error text under
``detail`` (``ValidationFailure``), as does one past the ``validation_max_*``
field limits. Every list answers through ``paginate`` (``gateway/
pagination.py``: the whole list without ``limit`` and ``cursor``, else a
keyset page) over ``_cached_list``: with ``app["registry_cache"]`` the
loaded list is cached under a key of the query's flags (and, for tools, the
viewer's teams), never of ``limit`` or ``cursor``, so every page is cut from
one cached list. The metrics routes of the JAX module are not ported."""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any

from aiohttp import web

from ..schemas import (GatewayCreate, GatewayUpdate, PromptCreate, PromptUpdate, ResourceCreate,
                       ResourceUpdate, SchemaError, ServerCreate, ServerUpdate, ToolCreate,
                       ToolUpdate)
from ..services.base import NotFoundError, ValidationFailure, now
from .auth import AuthError, PermissionDenied
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

    # ----------------------------------------------------------------- auth
    @routes.post("/auth/login")
    async def login(request: web.Request) -> web.Response:
        body = await request.json()
        auth_service = request.app["auth_service"]
        email = body.get("email") or body.get("username") or ""
        password = body.get("password") or ""
        if not await auth_service.verify_password(email, password):
            raise AuthError("Invalid credentials")
        token = auth_service.issue_jwt(email)
        return web.json_response({"access_token": token, "token_type": "bearer"})

    @routes.post("/auth/tokens")
    async def create_token(request: web.Request) -> web.Response:
        auth = request["auth"]
        auth.require("tokens.manage")
        body = await request.json()
        token, token_id = await request.app["auth_service"].create_api_token(
            auth.user, body.get("name", "api-token"), server_id=body.get("server_id"),
            permissions=body.get("permissions"), expires_minutes=body.get("expires_minutes"),
            grantor=auth)
        return web.json_response({"token": token, "id": token_id}, status=201)

    @routes.get("/auth/tokens")
    async def list_tokens(request: web.Request) -> web.Response:
        auth = request["auth"]
        auth.require("tokens.manage")
        return web.json_response(await request.app["auth_service"].list_api_tokens(auth.user))

    @routes.delete("/auth/tokens/{token_id}")
    async def revoke_token(request: web.Request) -> web.Response:
        request["auth"].require("tokens.manage")
        await request.app["auth_service"].revoke_token(request.match_info["token_id"])
        return web.Response(status=204)

    @routes.get("/auth/tokens/{token_id}/usage")
    async def token_usage(request: web.Request) -> web.Response:
        """One API token's usage rows, to its owner or an admin."""
        auth = request["auth"]
        auth.require("tokens.manage")
        db = request.app["ctx"].db
        row = await db.fetchone("SELECT jti, user_email FROM api_tokens WHERE id=?",
                                (request.match_info["token_id"],))
        if row is None:
            raise NotFoundError("Token not found")
        if row["user_email"] != auth.user and not auth.can("admin.all"):
            raise PermissionDenied("Not your token")
        logs = await db.fetchall(
            "SELECT ts, method, path, status, response_ms, client_ip,"
            " user_agent, blocked, block_reason FROM token_usage_logs"
            " WHERE token_jti=? ORDER BY ts DESC LIMIT 500", (row["jti"],))
        return web.json_response({"token_id": request.match_info["token_id"], "entries": logs})

    @routes.post("/auth/password")
    async def change_password(request: web.Request) -> web.Response:
        auth = request["auth"]
        body = await request.json()
        await request.app["auth_service"].change_password(
            auth.user, body.get("old_password", ""), body.get("new_password", ""))
        return web.json_response({"status": "changed"})

    def _background(request: web.Request, coro) -> None:
        # held in the app's drained task set: a mail must not outlive the db
        tasks = request.app["_token_usage_tasks"]
        task = asyncio.get_running_loop().create_task(coro)
        tasks.add(task)
        task.add_done_callback(tasks.discard)

    @routes.post("/auth/password/reset-request")
    async def password_reset_request(request: web.Request) -> web.Response:
        """Always 202 with one body, no sooner than the minimum response
        time, whether or not the account exists (no user enumeration)."""
        settings = request.app["settings"]
        if not settings.password_reset_enabled:
            raise NotFoundError("password reset is disabled")
        started = time.monotonic()

        async def _floor() -> None:
            # on every exit: a fast 400 beside a padded 202 would be a
            # timing side channel of its own
            remaining = (settings.password_reset_min_response_ms / 1e3
                         - (time.monotonic() - started))
            if remaining > 0:
                await asyncio.sleep(remaining)

        try:
            body = await request.json()
        except Exception:
            await _floor()
            return web.json_response({"detail": "Invalid JSON body"}, status=400)
        if not isinstance(body, dict):
            await _floor()
            return web.json_response({"detail": "body must be a JSON object"}, status=400)
        email = str(body.get("email", "")).strip().lower()
        if email:
            token = await request.app["auth_service"].request_password_reset(email)
            email_service = request.app.get("email_service")
            if token and email_service is not None:
                # in the background: an inline send would make a real
                # account answer slower than an unknown one
                _background(request, email_service.send_password_reset(
                    email, token, settings.password_reset_token_expiry_minutes))
        await _floor()
        return web.json_response(
            {"status": "accepted", "detail": "If the account exists, a reset link was sent."},
            status=202)

    @routes.get("/auth/password/reset")
    async def password_reset_page(request: web.Request) -> web.Response:
        """The page the mailed link lands on: a form that POSTs the token
        and the new password back here. The token is never put into the
        page; its script reads it from the query."""
        if not request.app["settings"].password_reset_enabled:
            raise NotFoundError("password reset is disabled")
        return web.Response(content_type="text/html", text=_RESET_PAGE)

    @routes.post("/auth/password/reset")
    async def password_reset(request: web.Request) -> web.Response:
        if not request.app["settings"].password_reset_enabled:
            raise NotFoundError("password reset is disabled")
        try:
            body = await request.json()
        except Exception:
            return web.json_response({"detail": "Invalid JSON body"}, status=400)
        if not isinstance(body, dict):
            return web.json_response({"detail": "body must be a JSON object"}, status=400)
        email = await request.app["auth_service"].reset_password(
            str(body.get("token", "")), str(body.get("new_password", "")))
        email_service = request.app.get("email_service")
        if email_service is not None:
            _background(request, email_service.send_password_reset_confirmation(email))
        audit = request.app.get("audit_service")
        if audit is not None:
            await audit.record(email, "auth.password_reset")
        return web.json_response({"status": "reset"})

    # ----------------------------------------------------- the admin's users
    @routes.post("/admin/users")
    async def create_user(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        body = await request.json()
        await request.app["auth_service"].create_user(
            body.get("email", ""), body.get("password", ""),
            full_name=body.get("full_name", ""), is_admin=bool(body.get("is_admin")),
            enforce_policy=True,
            require_password_change=bool(body.get("require_password_change")))
        return web.json_response({"email": body.get("email")}, status=201)

    @routes.get("/admin/config")
    async def effective_config(request: web.Request) -> web.Response:
        """The settings this worker runs with, secrets redacted."""
        request["auth"].require("admin.all")
        from ..utils.redact import redact_settings
        return web.json_response(redact_settings(request.app["settings"]))

    @routes.post("/admin/users/{email}/require-password-change")
    async def require_password_change(request: web.Request) -> web.Response:
        """Flag a user for forced rotation; ``/auth/password`` clears it."""
        request["auth"].require("admin.all")
        await request.app["auth_service"].set_password_change_required(
            request.match_info["email"], True)
        return web.json_response({"email": request.match_info["email"],
                                  "password_change_required": True})

    @routes.get("/admin/users")
    async def list_users(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        rows = await request.app["ctx"].db.fetchall(
            "SELECT email, full_name, is_admin, is_active, auth_provider,"
            " last_login, created_at FROM users ORDER BY email")
        return paginate(request, rows, lambda page: list(page), key=lambda row: row["email"])

    @routes.post("/admin/users/{email}/toggle")
    async def toggle_user(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        email = request.match_info["email"]
        db = request.app["ctx"].db
        await db.execute("UPDATE users SET is_active=1-is_active, updated_at=? WHERE email=?",
                         (now(), email))
        request.app["auth_service"].invalidate_user(email)
        row = await db.fetchone("SELECT email, is_active FROM users WHERE email=?", (email,))
        if row is None:
            raise NotFoundError(f"User {email} not found")
        return web.json_response(row)

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


_RESET_PAGE = """<!doctype html>
<title>Password reset</title>
<h3>Choose a new password</h3>
<form id="f"><input type="password" id="p" placeholder="new password"
  autocomplete="new-password" minlength="8" required>
<button>Reset</button></form><p id="out"></p>
<script>
document.getElementById("f").onsubmit = async (e) => {
  e.preventDefault();
  const token = new URLSearchParams(location.search).get("token") || "";
  const r = await fetch("/auth/password/reset", {method: "POST",
    headers: {"content-type": "application/json"},
    body: JSON.stringify({token, new_password:
      document.getElementById("p").value})});
  document.getElementById("out").textContent = r.ok
    ? "Password reset. You can sign in now."
    : "Reset failed: " + (await r.json()).detail;
};
</script>"""
