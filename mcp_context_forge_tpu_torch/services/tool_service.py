"""The tool registry and tools/call (a copy of the JAX package's
``services/tool_service.py``): CRUD over the ``tools`` table, and
``invoke_tool`` with the plugins' pre and post hooks, the ``tool.invoke``
span, the ``tool_invocations``/``tool_duration`` metrics and a
``tool_metrics`` row per call; the REST branch (the shared aiohttp
session, path templating, retries), the MCP branch (pooled upstream
sessions, the federation breaker, the ``federation.peer.request`` fault
point), header passthrough, the ``jsonpath_filter`` and the output-schema
check. An A2A tool goes to ``ctx.extras["a2a_service"]`` (the app sets it);
a gRPC tool answers the JAX package's "not initialized" error until that
service is ported.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any

from ..clients.mcp_client import MCPClientError, MCPSession
from ..db.core import from_json, to_json
from ..jsonrpc import (JSONRPCError, INVALID_PARAMS, INTERNAL_ERROR,
                       UPSTREAM_UNAVAILABLE)
from ..schemas import ToolCreate, ToolRead, ToolUpdate
from ..utils.crypto import decrypt_field, encrypt_field
from ..utils.ids import new_id
from ..utils.retry import with_retries
from ..utils.outbound import httpx_module
from .base import AppContext, ConflictError, NotFoundError, now


def _row_to_read(row: dict[str, Any]) -> ToolRead:
    return ToolRead(
        id=row["id"],
        name=row["custom_name"] or row["original_name"],
        original_name=row["original_name"],
        display_name=row["display_name"],
        description=row["description"],
        integration_type=row["integration_type"],
        request_type=row["request_type"],
        url=row["url"],
        input_schema=from_json(row["input_schema"], {}),
        output_schema=from_json(row["output_schema"]),
        annotations=from_json(row["annotations"], {}),
        gateway_id=row["gateway_id"],
        enabled=bool(row["enabled"]),
        reachable=bool(row["reachable"]),
        tags=from_json(row["tags"], []),
        team_id=row["team_id"],
        owner_email=row["owner_email"],
        visibility=row["visibility"],
        created_at=row["created_at"],
        updated_at=row["updated_at"],
    )


class ToolService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self._lookup_cache: dict[str, dict[str, Any]] = {}  # name -> row
        # cross-worker invalidation: any tools.changed event (ours or a
        # peer worker's, incl. federation catalog syncs) drops the cache
        self.ctx.bus.subscribe("tools.changed", self._on_tools_changed)

    async def _on_tools_changed(self, topic: str, message: dict[str, Any]) -> None:
        self._lookup_cache.clear()

    # ----------------------------------------------------------------- CRUD

    async def register_tool(self, tool: ToolCreate) -> ToolRead:
        row = await self.ctx.db.fetchone(
            "SELECT id FROM tools WHERE original_name=? AND COALESCE(gateway_id,'')=?",
            (tool.name, tool.gateway_id or ""),
        )
        if row:
            raise ConflictError(f"Tool {tool.name!r} already exists")
        if tool.url:
            from ..utils.ssrf import ensure_url_allowed
            await ensure_url_allowed(self.ctx.settings, tool.url)
        tid = new_id()
        ts = now()
        auth_value = (
            encrypt_field(tool.auth_value, self.ctx.settings.auth_encryption_secret)
            if tool.auth_value else None
        )
        await self.ctx.db.execute(
            "INSERT INTO tools (id, original_name, display_name, description,"
            " integration_type, request_type, url, input_schema, output_schema,"
            " annotations, headers, auth_type, auth_value, jsonpath_filter,"
            " gateway_id, enabled, tags, team_id, owner_email, visibility,"
            " created_at, updated_at) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (tid, tool.name, tool.display_name, tool.description,
             tool.integration_type, tool.request_type, tool.url,
             to_json(tool.input_schema), to_json(tool.output_schema) if tool.output_schema else None,
             to_json(tool.annotations), to_json(tool.headers), tool.auth_type, auth_value,
             tool.jsonpath_filter, tool.gateway_id, int(tool.enabled), to_json(tool.tags),
             tool.team_id, tool.owner_email, tool.visibility, ts, ts),
        )
        self._lookup_cache.clear()
        await self.ctx.bus.publish("tools.changed", {"action": "register", "id": tid})
        return await self.get_tool(tid)

    async def get_tool(self, tool_id: str) -> ToolRead:
        row = await self.ctx.db.fetchone("SELECT * FROM tools WHERE id=?", (tool_id,))
        if not row:
            raise NotFoundError(f"Tool {tool_id} not found")
        return _row_to_read(row)

    async def list_tools(self, include_inactive: bool = False,
                         gateway_id: str | None = None,
                         team_ids: list[str] | None = None) -> list[ToolRead]:
        sql = "SELECT * FROM tools"
        clauses, params = [], []
        if not include_inactive:
            clauses.append("enabled=1")
        if gateway_id is not None:
            clauses.append("gateway_id=?")
            params.append(gateway_id)
        if team_ids is not None:
            marks = ",".join("?" for _ in team_ids)
            clauses.append(f"(visibility='public' OR team_id IN ({marks}))")
            params.extend(team_ids)
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        sql += " ORDER BY original_name"
        return [_row_to_read(r) for r in await self.ctx.db.fetchall(sql, params)]

    async def update_tool(self, tool_id: str, update: ToolUpdate) -> ToolRead:
        row = await self.ctx.db.fetchone("SELECT * FROM tools WHERE id=?", (tool_id,))
        if not row:
            raise NotFoundError(f"Tool {tool_id} not found")
        fields = update.model_dump(exclude_unset=True)
        if fields.get("url"):
            from ..utils.ssrf import ensure_url_allowed
            await ensure_url_allowed(self.ctx.settings, fields["url"])
        sets, params = [], []
        for key, value in fields.items():
            if key == "auth_value" and value is not None:
                value = encrypt_field(value, self.ctx.settings.auth_encryption_secret)
            elif key in ("input_schema", "output_schema", "annotations", "headers", "tags"):
                value = to_json(value)
            elif key == "enabled":
                value = int(value)
            sets.append(f"{key}=?")
            params.append(value)
        if sets:
            sets.append("updated_at=?")
            params.append(now())
            params.append(tool_id)
            # the column names are the schema's own field names
            await self.ctx.db.execute(f"UPDATE tools SET {', '.join(sets)} WHERE id=?", params)
        self._lookup_cache.clear()
        await self.ctx.bus.publish("tools.changed", {"action": "update", "id": tool_id})
        return await self.get_tool(tool_id)

    async def toggle_tool(self, tool_id: str, enabled: bool) -> ToolRead:
        await self.ctx.db.execute("UPDATE tools SET enabled=?, updated_at=? WHERE id=?",
                                  (int(enabled), now(), tool_id))
        self._lookup_cache.clear()
        await self.ctx.bus.publish("tools.changed", {"action": "toggle", "id": tool_id})
        return await self.get_tool(tool_id)

    async def delete_tool(self, tool_id: str) -> None:
        rows = await self.ctx.db.execute("SELECT id FROM tools WHERE id=?", (tool_id,))
        if not rows:
            raise NotFoundError(f"Tool {tool_id} not found")
        await self.ctx.db.execute("DELETE FROM tools WHERE id=?", (tool_id,))
        self._lookup_cache.clear()
        await self.ctx.bus.publish("tools.changed", {"action": "delete", "id": tool_id})

    # ------------------------------------------------------------- invocation

    async def _lookup(self, name: str) -> dict[str, Any]:
        cached = self._lookup_cache.get(name)
        if cached is not None:
            return cached
        row = await self.ctx.db.fetchone(
            "SELECT * FROM tools WHERE (custom_name=? OR original_name=?) AND enabled=1",
            (name, name),
        )
        if not row:
            raise NotFoundError(f"Tool {name!r} not found")
        self._lookup_cache[name] = row
        return row

    async def invoke_tool(self, name: str, arguments: dict[str, Any],
                          request_headers: dict[str, str] | None = None,
                          user: str | None = None) -> dict[str, Any]:
        """Invoke by name with plugin hooks, tracing and metrics.

        Returns an MCP ``tools/call`` result: {content: [...], isError: bool}.
        """
        started = time.monotonic()
        status = "success"
        row = await self._lookup(name)
        tool_id = row["id"]
        pm = self.ctx.plugin_manager
        request_headers = dict(request_headers or {})
        inbound_snapshot = dict(request_headers)
        with self.ctx.tracer.span("tool.invoke", {"tool.name": name, "tool.id": tool_id,
                                                  "tool.type": row["integration_type"]}):
            try:
                plugin_ctx = None
                early = None
                if pm is not None:
                    name, arguments, request_headers, early, plugin_ctx = \
                        await pm.tool_pre_invoke(name, arguments, request_headers,
                                                 user=user)
                    if early is None and name != row["original_name"] \
                            and name != (row["custom_name"] or ""):
                        row = await self._lookup(name)
                # headers a plugin added/changed (vs the inbound snapshot) are
                # forwarded upstream; raw inbound headers are not, except via
                # the per-gateway passthrough allowlist (MCP branch)
                injected_headers = {k: v for k, v in request_headers.items()
                                    if inbound_snapshot.get(k) != v}
                if early is not None:
                    result = early
                else:
                    try:
                        result = await self._dispatch(row, arguments, request_headers,
                                                      injected_headers)
                    except JSONRPCError:
                        raise
                    except Exception as exc:
                        # MCP semantics: execution failures are isError results,
                        # not protocol errors — and post hooks (circuit breaker,
                        # audit) must observe them.
                        status = "error"
                        result = {"content": [{"type": "text",
                                               "text": f"{type(exc).__name__}: {exc}"}],
                                  "isError": True}
                if pm is not None:
                    result = await pm.tool_post_invoke(name, result, user=user,
                                                       context=plugin_ctx)
                if row["jsonpath_filter"]:
                    result = _apply_filter(result, row["jsonpath_filter"])
                if row["output_schema"]:
                    _validate_output(result, from_json(row["output_schema"], {}))
                return result
            except BaseException:
                status = "error"
                raise
            finally:
                elapsed = time.monotonic() - started
                self.ctx.metrics.tool_invocations.labels(tool=name, status=status).inc()
                self.ctx.metrics.tool_duration.labels(tool=name).observe(elapsed)
                asyncio.get_running_loop().create_task(
                    self._record_metric(tool_id, elapsed * 1000, status == "success"))

    async def _record_metric(self, tool_id: str, duration_ms: float, success: bool) -> None:
        try:
            await self.ctx.db.execute(
                "INSERT INTO tool_metrics (tool_id, ts, duration_ms, success) VALUES (?,?,?,?)",
                (tool_id, now(), duration_ms, int(success)),
            )
        except Exception:
            pass

    async def _dispatch(self, row: dict[str, Any], arguments: dict[str, Any],
                        request_headers: dict[str, str],
                        injected_headers: dict[str, str] | None = None) -> dict[str, Any]:
        integration = row["integration_type"]
        injected_headers = injected_headers or {}
        if integration == "REST":
            return await self._invoke_rest(row, arguments, injected_headers,
                                           request_headers)
        if integration == "MCP":
            return await self._invoke_mcp(row, arguments, request_headers,
                                          injected_headers)
        if integration == "A2A":
            a2a = self.ctx.extras.get("a2a_service")
            if a2a is None:
                raise JSONRPCError(INTERNAL_ERROR, "A2A service not initialized")
            agent_name = from_json(row["annotations"], {}).get("a2a_agent") or row["original_name"]
            reply = await a2a.invoke_agent(agent_name, {"message": arguments})
            return _text_result(json.dumps(reply) if not isinstance(reply, str) else reply)
        if integration == "GRPC":
            grpc_service = self.ctx.extras.get("grpc_service")
            if grpc_service is None:
                raise JSONRPCError(INTERNAL_ERROR, "gRPC service not initialized")
            return await grpc_service.invoke(from_json(row["annotations"], {}),
                                             arguments)
        raise JSONRPCError(INVALID_PARAMS, f"Unsupported integration type {integration}")

    def _passthrough(self, headers: dict[str, str],
                     request_headers: dict[str, str],
                     gateway: dict[str, Any] | None) -> None:
        """Copy allowlisted inbound headers onto the upstream call:
        per-gateway list first, else the global default when the feature
        flag is on; sensitive headers never ride the default, only a
        per-gateway allowlist."""
        settings = self.ctx.settings
        allowed = from_json((gateway or {}).get("passthrough_headers"), [])
        if not allowed and settings.enable_header_passthrough:
            allowed = [h.strip() for h in settings.default_passthrough_headers.split(",")
                       if h.strip()]
            if not settings.enable_sensitive_header_passthrough:
                # credentials never ride the GLOBAL default list; a
                # per-gateway allowlist is an explicit operator opt-in
                allowed = [h for h in allowed
                           if h.lower() not in ("authorization", "cookie")]
        # case-insensitive membership: base headers may be stored in any
        # casing ('X-Tenant-Id' vs allowlist 'x-tenant-id') and two
        # differently-cased duplicates must never ride one request
        existing = {k.lower(): k for k in headers}
        for h in allowed:
            value = request_headers.get(h.lower())
            if not value:
                continue
            present = existing.get(h.lower())
            if present is None:
                headers[h] = value
                existing[h.lower()] = h
            elif settings.enable_overwrite_base_headers:
                headers[present] = value

    # the REST branch
    async def _invoke_rest(self, row: dict[str, Any], arguments: dict[str, Any],
                           injected_headers: dict[str, str],
                           request_headers: dict[str, str] | None = None
                           ) -> dict[str, Any]:
        url = row["url"]
        if not url:
            raise JSONRPCError(INVALID_PARAMS, "REST tool has no URL")
        headers = dict(from_json(row["headers"], {}))
        headers.update(injected_headers)
        headers.update(await resolve_auth_headers(self.ctx, row))
        # passthrough runs over the COMPLETE base header set so
        # enable_overwrite_base_headers can actually replace tool-config
        # auth (it is the no-overwrite default that must see auth too,
        # or it would add a duplicate instead of skipping)
        self._passthrough(headers, request_headers or {}, None)
        # URL path templating: {placeholder} substituted from arguments
        body_args = dict(arguments)
        for key in list(body_args):
            token = "{" + key + "}"
            if token in url:
                url = url.replace(token, str(body_args.pop(key)))
        method = row["request_type"].upper()
        client = self.ctx.aiohttp_client  # shared session; never per-call clients

        async def _do() -> str:
            kwargs = ({"params": _query_params(body_args)}
                      if method in ("GET", "DELETE") else {"json": body_args})
            # allow_redirects=False: httpx parity — a 3xx is the tool's
            # result, not an invitation to fetch an unvalidated Location
            async with client.request(method, url, headers=headers,
                                      allow_redirects=False, **kwargs) as resp:
                body = await resp.text()
                resp.raise_for_status()
                return body

        body = await with_retries(_do, attempts=self.ctx.settings.max_tool_retries,
                                  base=self.ctx.settings.retry_base_delay,
                                  cap=self.ctx.settings.retry_max_delay)
        try:
            payload = json.loads(body)
            return _text_result(json.dumps(payload))
        except (json.JSONDecodeError, ValueError):
            return _text_result(body)

    # the MCP branch
    async def _invoke_mcp(self, row: dict[str, Any], arguments: dict[str, Any],
                          request_headers: dict[str, str],
                          injected_headers: dict[str, str] | None = None) -> dict[str, Any]:
        gateway = None
        if row["gateway_id"]:
            gateway = await self.ctx.db.fetchone("SELECT * FROM gateways WHERE id=?",
                                                 (row["gateway_id"],))
        url = (gateway or {}).get("url") or row["url"]
        if not url:
            raise JSONRPCError(INVALID_PARAMS, "MCP tool has no upstream URL")
        # the federation degradation ladder: repeated
        # peer failures open a per-peer breaker — proxied calls then
        # fail FAST with a Retry-After advisory while the locally-synced
        # catalog (tools/resources/prompts rows) keeps serving; once the
        # cooldown elapses, allow() admits one half-open probe call and
        # a success closes the breaker
        breaker = None
        if gateway is not None:
            from ..observability.degradation import get_degradation
            breaker = get_degradation().breaker("federation",
                                                key=gateway["id"])
            if not breaker.allow():
                raise JSONRPCError(
                    UPSTREAM_UNAVAILABLE,
                    f"federated peer {gateway.get('name') or gateway['id']} "
                    "is circuit-open (repeated failures); cached catalog "
                    "still served, proxied calls refused until recovery",
                    data={"retry_after_s": max(1, int(breaker.cooldown_s)),
                          "degraded": "federation"})
        transport = (gateway or {}).get("transport") or "streamablehttp"
        headers = await resolve_auth_headers(self.ctx, gateway or row)
        headers.update(injected_headers or {})
        self._passthrough(headers, request_headers, gateway)

        registry = self.ctx.extras.get("upstream_sessions")
        transport_errors = (httpx_module().TransportError, MCPClientError, ConnectionError,
                            asyncio.TimeoutError, OSError)

        async def _do() -> dict[str, Any]:
            from ..observability.faults import fault_point
            # fault point federation.peer.request, scope = peer URL:
            # fires per attempt so retry behavior is exercised too
            act = fault_point("federation.peer.request", scope=url)
            if act is not None:
                await act.async_apply()
            if registry is not None:
                key, session = await registry.acquire(url, transport, headers)
                try:
                    return await session.call_tool(row["original_name"], arguments)
                except JSONRPCError:
                    raise  # application-level error: the session is healthy
                except transport_errors:
                    await registry.invalidate(key)  # transport broke: reconnect
                    raise
            async with MCPSession(url=url, transport=transport, headers=headers,
                                  timeout=self.ctx.settings.tool_timeout,
                                  verify_ssl=not self.ctx.settings.skip_ssl_verify,
                                  client=self.ctx.http_client) as session:
                return await session.call_tool(row["original_name"], arguments)

        try:
            result = await with_retries(
                _do, attempts=self.ctx.settings.max_tool_retries,
                base=self.ctx.settings.retry_base_delay,
                cap=self.ctx.settings.retry_max_delay)
        except JSONRPCError:
            # application-level error: the peer ANSWERED — healthy. This
            # must count as breaker success, not merely "not a failure":
            # if this call was the half-open probe, skipping the success
            # would strand the breaker half_open (refusing every later
            # call to a recovered peer until a health sweep runs)
            if breaker is not None:
                breaker.record_success()
            raise
        except Exception:
            if breaker is not None:
                breaker.record_failure("federated call failed")
            raise
        if breaker is not None:
            breaker.record_success()
        return result


def _query_params(args: dict[str, Any]) -> list[tuple[str, str]]:
    """JSON arguments -> query params with conventional serialization:
    bools lowercased, lists repeated, None dropped (httpx's behavior, which
    the aiohttp hot path must preserve)."""
    out: list[tuple[str, str]] = []
    for key, value in args.items():
        if value is None:
            continue
        values = value if isinstance(value, (list, tuple)) else [value]
        for item in values:
            if isinstance(item, bool):
                out.append((key, "true" if item else "false"))
            else:
                out.append((key, str(item)))
    return out


def _text_result(text: str) -> dict[str, Any]:
    return {"content": [{"type": "text", "text": text}], "isError": False}


async def resolve_auth_headers(ctx, row: dict[str, Any]) -> dict[str, str]:
    """Static auth headers, and for ``auth_type`` "oauth" a client-credentials
    Bearer from ``ctx.extras["oauth_manager"]`` — the one helper every
    outbound branch (REST / MCP / federation) uses."""
    headers = _auth_headers(row, ctx.settings.auth_encryption_secret)
    if row.get("auth_type") == "oauth":
        oauth = ctx.extras.get("oauth_manager")
        if oauth is not None:
            value = decrypt_field(row.get("auth_value"), ctx.settings.auth_encryption_secret) or {}
            headers.update(await oauth.headers_for(value))
    return headers


def _auth_headers(row: dict[str, Any], secret: str) -> dict[str, str]:
    auth_type = row.get("auth_type")
    if not auth_type or auth_type == "none":
        return {}
    value = decrypt_field(row.get("auth_value"), secret) or {}
    if auth_type == "basic":
        import base64
        creds = base64.b64encode(
            f"{value.get('username', '')}:{value.get('password', '')}".encode()).decode()
        return {"authorization": f"Basic {creds}"}
    if auth_type == "bearer":
        return {"authorization": f"Bearer {value.get('token', '')}"}
    if auth_type == "headers":
        headers = value.get("headers", value)
        return {str(k): str(v) for k, v in headers.items()}
    return {}


def _apply_filter(result: dict[str, Any], path: str) -> dict[str, Any]:
    """Minimal JSONPath subset: $.a.b[0].c over the first text content item."""
    if not path.startswith("$."):
        return result
    try:
        content = result.get("content", [])
        text = next((c.get("text") for c in content if c.get("type") == "text"), None)
        if text is None:
            return result
        node: Any = json.loads(text)
        for part in path[2:].replace("]", "").replace("[", ".").split("."):
            if not part:
                continue
            node = node[int(part)] if part.lstrip("-").isdigit() else node[part]
        return _text_result(json.dumps(node))
    except Exception:
        return result


def _validate_output(result: dict[str, Any], schema: dict[str, Any]) -> None:
    """Light output-schema check: required keys on structuredContent/JSON text."""
    required = schema.get("required", [])
    if not required:
        return
    payload = result.get("structuredContent")
    if payload is None:
        try:
            content = result.get("content", [])
            text = next((c.get("text") for c in content if c.get("type") == "text"), "")
            payload = json.loads(text)
        except Exception:
            return
    if isinstance(payload, dict):
        missing = [k for k in required if k not in payload]
        if missing:
            raise JSONRPCError(INTERNAL_ERROR, f"Tool output missing required keys: {missing}")
