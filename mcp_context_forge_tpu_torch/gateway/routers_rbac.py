"""The RBAC, compliance, SSO, OAuth and audit routes of the JAX gateway
(``gateway/routers_rbac.py``, and the routes ``gateway/app.py`` adds
itself), with their permissions, status codes and bodies:

- ``setup_rbac_routes`` over ``app["role_service"]`` (``admin.all``):
  ``/rbac/roles`` CRUD, ``/rbac/users/{email}/roles`` (list, assign 201,
  revoke 204; both bust the user's cached resolution),
  ``GET /rbac/permissions/user/{email}`` and ``POST
  /rbac/permissions/check`` through ``auth_service.effective_permissions``,
  so the inspector cannot drift from enforcement;
- ``setup_compliance_routes`` over ``app["compliance_service"]``
  (``admin.all``): ``GET /compliance/frameworks``, ``POST
  /compliance/reports`` (201; ``period_days``, ``period_end``,
  ``period_start`` finite numbers), ``GET /compliance/reports[/{id}]`` and
  ``GET /compliance/reports/{id}/export`` (``?format=markdown``);
- ``setup_identity_routes``: ``GET /auth/sso/providers``, ``GET
  /auth/sso/{provider}/login`` (302 to the IdP) and ``/callback`` (public:
  the auth middleware passes ``/auth/sso/*``); ``POST /oauth/dcr/register``
  (201), ``GET /oauth/dcr/clients``, ``DELETE /oauth/dcr/clients/{id}``
  and ``POST /oauth/exchange`` (``gateways.update``, the list
  ``gateways.read``); ``GET /admin/audit`` (``observability.read``;
  ``actor``, ``action`` prefix, ``limit`` up to 1000).
"""

from __future__ import annotations

import math
import time

from aiohttp import web

from ..services.base import ValidationFailure
from ..services.compliance_service import (CONTROLS, FRAMEWORK_TITLES, FRAMEWORKS,
                                           ComplianceService)
from ..services.role_service import RoleService
from .pagination import paginate


def setup_rbac_routes(app: web.Application) -> None:
    routes = web.RouteTableDef()
    service: RoleService = app["role_service"]

    # ------------------------------------------------------------ role CRUD
    @routes.get("/rbac/roles")
    async def list_roles(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        rows = await service.list_roles()
        return paginate(request, rows, lambda page: list(page),
                        key=lambda row: row["id"])

    @routes.post("/rbac/roles")
    async def create_role(request: web.Request) -> web.Response:
        auth = request["auth"]
        auth.require("admin.all")
        body = await request.json()
        role = await service.create_role(
            body.get("name", ""), body.get("permissions") or [],
            description=body.get("description", ""),
            scope=body.get("scope", "global"), created_by=auth.user)
        return web.json_response(role, status=201)

    @routes.get("/rbac/roles/{role_id}")
    async def get_role(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        return web.json_response(
            await service.get_role(request.match_info["role_id"]))

    @routes.put("/rbac/roles/{role_id}")
    async def update_role(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        body = await request.json()
        role = await service.update_role(
            request.match_info["role_id"], name=body.get("name"),
            description=body.get("description"),
            permissions=body.get("permissions"))
        return web.json_response(role)

    @routes.delete("/rbac/roles/{role_id}")
    async def delete_role(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        await service.delete_role(request.match_info["role_id"])
        return web.Response(status=204)

    # ----------------------------------------------------------- assignment
    @routes.get("/rbac/users/{email}/roles")
    async def user_roles(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        return web.json_response(
            await service.user_roles(request.match_info["email"]))

    @routes.post("/rbac/users/{email}/roles")
    async def assign_role(request: web.Request) -> web.Response:
        auth = request["auth"]
        auth.require("admin.all")
        body = await request.json()
        grant = await service.assign_role(
            request.match_info["email"], body.get("role_id", ""),
            scope_id=body.get("scope_id", ""), granted_by=auth.user)
        request.app["auth_service"].invalidate_user(
            request.match_info["email"])
        return web.json_response(grant, status=201)

    @routes.delete("/rbac/users/{email}/roles/{role_id}")
    async def revoke_role(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        await service.revoke_role(
            request.match_info["email"], request.match_info["role_id"],
            scope_id=request.query.get("scope_id", ""))
        request.app["auth_service"].invalidate_user(
            request.match_info["email"])
        return web.Response(status=204)

    # ----------------------------------------------------------- inspection
    @routes.get("/rbac/permissions/user/{email}")
    async def user_permissions(request: web.Request) -> web.Response:
        """Effective permission set via the SAME helper resolve_* uses —
        the inspector can never drift from enforcement. Team-scoped
        grants resolve against the user's memberships; per-assignment
        detail lives at /rbac/users/{email}/roles."""
        request["auth"].require("admin.all")
        email = request.match_info["email"]
        perms, is_admin, is_active = \
            await request.app["auth_service"].effective_permissions(email)
        return web.json_response(
            {"user_email": email, "is_admin": is_admin,
             "is_active": is_active, "permissions": sorted(perms)})

    @routes.post("/rbac/permissions/check")
    async def check_permission(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        body = await request.json()
        email = body.get("user_email", "")
        permission = body.get("permission", "")
        perms, is_admin, is_active = \
            await request.app["auth_service"].effective_permissions(email)
        # mirrors AuthContext.can for an unscoped identity — plus the
        # deactivation gate resolve_* applies before permissions matter
        granted = is_active and (is_admin or "admin.all" in perms
                                 or permission in perms)
        return web.json_response({"user_email": email,
                                  "permission": permission,
                                  "is_active": is_active,
                                  "granted": granted})

    app.add_routes(routes)


def setup_compliance_routes(app: web.Application) -> None:
    """The compliance routes: the frameworks' catalog, a report over an
    assessment period, retrieval, and the JSON or markdown export."""

    routes = web.RouteTableDef()
    service: ComplianceService = app["compliance_service"]

    @routes.get("/compliance/frameworks")
    async def frameworks(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        return web.json_response([
            {"id": fw, "title": FRAMEWORK_TITLES[fw],
             "controls": [{"id": c.id, "title": c.title}
                          for c in CONTROLS[fw]]}
            for fw in FRAMEWORKS])

    @routes.post("/compliance/reports")
    async def generate(request: web.Request) -> web.Response:
        auth = request["auth"]
        auth.require("admin.all")
        body = await request.json()
        if not isinstance(body, dict):
            raise ValidationFailure("Body must be a JSON object")

        def number(name: str, default: float) -> float:
            value = body.get(name)
            if value is None:
                return default
            if (not isinstance(value, (int, float))
                    or isinstance(value, bool)
                    or not math.isfinite(value)):
                # json.loads accepts NaN/Infinity literals; NaN bounds
                # would match no rows and serialize as non-standard JSON
                raise ValidationFailure(f"{name} must be a finite number")
            return float(value)

        days = number("period_days", 30.0)
        end = number("period_end", time.time())
        start = number("period_start", end - days * 86400)
        report = await service.generate(body.get("framework", ""),
                                        start, end, generated_by=auth.user)
        return web.json_response(report, status=201)

    @routes.get("/compliance/reports")
    async def list_reports(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        return web.json_response(await service.list_reports())

    @routes.get("/compliance/reports/{report_id}")
    async def get_report(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        return web.json_response(
            await service.get_report(request.match_info["report_id"]))

    @routes.get("/compliance/reports/{report_id}/export")
    async def export_report(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        report_id = request.match_info["report_id"]
        if request.query.get("format", "json") == "markdown":
            text = await service.export_markdown(report_id)
            return web.Response(
                text=text, content_type="text/markdown",
                headers={"Content-Disposition":
                         f'attachment; filename="{report_id}.md"'})
        report = await service.get_report(report_id)
        return web.json_response(
            report, headers={"Content-Disposition":
                             f'attachment; filename="{report_id}.json"'})

    app.add_routes(routes)


def setup_identity_routes(app: web.Application, sso_service, dcr_service,
                          audit_service) -> None:
    """The SSO login flow, OAuth dynamic client registration and token
    exchange, and the audit trail's search."""
    from ..services.oauth_service import exchange_token

    settings = app["settings"]
    ctx = app["ctx"]

    async def sso_providers(request: web.Request) -> web.Response:
        return web.json_response({"providers": sso_service.list_providers()})

    async def sso_login(request: web.Request) -> web.Response:
        name = request.match_info["provider"]
        redirect_uri = f"{settings.app_domain}/auth/sso/{name}/callback"
        raise web.HTTPFound(await sso_service.login_url(name, redirect_uri))

    async def sso_callback(request: web.Request) -> web.Response:
        name = request.match_info["provider"]
        redirect_uri = f"{settings.app_domain}/auth/sso/{name}/callback"
        return web.json_response(await sso_service.handle_callback(
            request.query.get("state", ""), request.query.get("code", ""), redirect_uri))

    async def dcr_register(request: web.Request) -> web.Response:
        request["auth"].require("gateways.update")
        body = await request.json()
        record = await dcr_service.get_or_register(
            body.get("gateway_id", ""), body.get("issuer", ""),
            body.get("redirect_uri", f"{settings.app_domain}/oauth/callback"),
            body.get("scopes"))
        return web.json_response(record, status=201)

    async def dcr_list(request: web.Request) -> web.Response:
        request["auth"].require("gateways.read")
        return web.json_response(await dcr_service.list_clients())

    async def dcr_delete(request: web.Request) -> web.Response:
        request["auth"].require("gateways.update")
        await dcr_service.delete_client(request.match_info["record_id"])
        return web.Response(status=204)

    async def oauth_exchange(request: web.Request) -> web.Response:
        request["auth"].require("gateways.update")
        body = await request.json()
        return web.json_response(await exchange_token(
            ctx, body.get("token_url", ""), body.get("subject_token", ""),
            client_id=body.get("client_id", ""), client_secret=body.get("client_secret", ""),
            audience=body.get("audience", "")))

    async def admin_audit(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        raw_limit = request.query.get("limit", "200")
        if not raw_limit.isdigit():
            return web.json_response({"detail": "limit must be an integer"}, status=400)
        return web.json_response(await audit_service.search(
            actor=request.query.get("actor"), action=request.query.get("action"),
            limit=min(int(raw_limit), 1000)))

    app.router.add_get("/auth/sso/providers", sso_providers)
    app.router.add_get("/auth/sso/{provider}/login", sso_login)
    app.router.add_get("/auth/sso/{provider}/callback", sso_callback)
    app.router.add_post("/oauth/dcr/register", dcr_register)
    app.router.add_get("/oauth/dcr/clients", dcr_list)
    app.router.add_delete("/oauth/dcr/clients/{record_id}", dcr_delete)
    app.router.add_post("/oauth/exchange", oauth_exchange)
    app.router.add_get("/admin/audit", admin_audit)
