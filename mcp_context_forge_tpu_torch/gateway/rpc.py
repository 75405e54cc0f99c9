"""The JSON-RPC / MCP method dispatcher (a copy of the JAX package's
``gateway/rpc.py``): a handler table over the services, serving ``POST
/rpc``, the ``/mcp`` streamable-HTTP transport and the per-server mounts,
which scope the catalog to a virtual server.

``resources/list``, ``resources/templates/list``, ``resources/read``,
``resources/subscribe`` and ``resources/unsubscribe`` go to the resource
service, ``prompts/list`` and ``prompts/get`` to the prompt service, with
the plugins' ``resource_pre_fetch``/``resource_post_fetch`` and
``prompt_pre_fetch``/``prompt_post_fetch`` hooks around a read and a
render. ``completion/complete`` and ``sampling/createMessage`` go to the
completion service and the sampling handler
(``services/sampling_service.py``, which ``build_llm_app`` passes); a
dispatcher built without them takes the JAX dispatcher's fallbacks.
"""

from __future__ import annotations

import logging
from typing import Any

from .. import PROTOCOL_VERSION, SUPPORTED_PROTOCOL_VERSIONS
from ..jsonrpc import (
    INTERNAL_ERROR,
    INVALID_PARAMS,
    METHOD_NOT_FOUND,
    JSONRPCError,
    RPCRequest,
    method_registry,
    result_response,
)
from ..observability import phases as request_phases
from ..services.base import AppContext, NotFoundError, ValidationFailure
from .auth import AuthContext, PermissionDenied
from .serialize import jsonrpc_response_bytes

logger = logging.getLogger(__name__)


class RPCDispatcher:
    def __init__(self, ctx: AppContext, tool_service, resource_service,
                 prompt_service, server_service, completion_service=None,
                 sampling_handler=None):
        self.ctx = ctx
        self.tools = tool_service
        self.resources = resource_service
        self.prompts = prompt_service
        self.servers = server_service
        self.completion = completion_service
        self.sampling = sampling_handler
        self._log_level = "info"

    async def dispatch(self, request: RPCRequest, auth: AuthContext,
                       headers: dict[str, str] | None = None,
                       server_id: str | None = None) -> dict[str, Any] | None:
        """Handle one JSON-RPC request; returns the response (None for
        notifications). ``server_id`` scopes the catalog to a virtual server
        (also enforced for server-scoped tokens)."""
        method = request.method
        params = request.params
        headers = headers or {}
        # server-scoped token enforcement
        if auth.server_id and server_id and auth.server_id != server_id:
            raise JSONRPCError(INVALID_PARAMS, "Token is scoped to a different server")
        effective_server = server_id or auth.server_id

        if request.is_notification or method_registry.is_notification(method):
            await self._handle_notification(method, params, auth)
            return None

        with self.ctx.tracer.span(f"rpc.{method}", {"rpc.method": method,
                                                    "user": auth.user}):
            try:
                result = await self._route(method, params, auth, headers,
                                           effective_server, rpc_id=request.id)
            except JSONRPCError:
                raise
            except NotFoundError as exc:
                raise JSONRPCError(INVALID_PARAMS, str(exc)) from exc
            except PermissionDenied as exc:
                raise JSONRPCError(-32004, str(exc)) from exc
            except ValidationFailure as exc:
                raise JSONRPCError(INVALID_PARAMS, str(exc)) from exc
            except Exception as exc:
                logger.exception("RPC %s failed", method)
                raise JSONRPCError(INTERNAL_ERROR, f"{type(exc).__name__}: {exc}") from exc
        return result_response(request.id, result)

    async def dispatch_bytes(self, request: RPCRequest, auth: AuthContext,
                             headers: dict[str, str] | None = None,
                             server_id: str | None = None) -> bytes | None:
        """``dispatch`` with the response pre-encoded to wire bytes.

        The zero-copy seam for byte-oriented callers (``POST /rpc``):
        the JSON-RPC envelope is assembled from constant fragments around
        one compact result encode (gateway/serialize.py), and the encode
        cost is charged to the flight recorder's ``serialize`` bucket
        here — per route, not as ``handler`` residue."""
        response = await self.dispatch(request, auth, headers=headers,
                                       server_id=server_id)
        if response is None:
            return None
        with request_phases.phase("serialize"):
            return jsonrpc_response_bytes(response)

    async def _route(self, method: str, params: dict[str, Any], auth: AuthContext,
                     headers: dict[str, str], server_id: str | None,
                     rpc_id: Any = None) -> Any:
        if method == "initialize":
            return await self._initialize(params)
        if method == "ping":
            return {}
        if method == "tools/list":
            auth.require("tools.read")
            tools = await self.tools.list_tools(team_ids=auth.teams)
            if server_id:
                allowed = set(await self.servers.server_tool_names(server_id))
                tools = [t for t in tools if t.name in allowed]
            return {"tools": [{
                "name": t.name,
                "description": t.description or "",
                "inputSchema": t.input_schema or {"type": "object"},
                **({"outputSchema": t.output_schema} if t.output_schema else {}),
                **({"annotations": t.annotations} if t.annotations else {}),
            } for t in tools]}
        if method == "tools/call":
            auth.require("tools.invoke")
            name = params.get("name")
            if not name:
                raise JSONRPCError(INVALID_PARAMS, "tools/call requires 'name'")
            if server_id:
                allowed = set(await self.servers.server_tool_names(server_id))
                if name not in allowed:
                    raise JSONRPCError(INVALID_PARAMS,
                                       f"Tool {name!r} not in server scope")
            import asyncio as _asyncio
            run = _asyncio.ensure_future(self.tools.invoke_tool(
                name, params.get("arguments", {}) or {}, request_headers=headers,
                user=auth.user))
            cancellation = self.ctx.extras.get("cancellation_service")
            if cancellation is not None:
                # keys are scoped by user: raw JSON-RPC ids collide across
                # clients (everyone uses id=1) and an unscoped key would let
                # one user cancel another's run
                for key in (rpc_id, (params.get("_meta") or {}).get("requestId"),
                            headers.get("x-request-id")):
                    if key is not None:
                        cancellation.register(f"{auth.user}:{key}", run)
            try:
                return await run
            except _asyncio.CancelledError:
                if run.cancelled():
                    raise JSONRPCError(-32800, "Request cancelled") from None
                # the HANDLER was cancelled (client disconnect/shutdown):
                # propagate, and don't leak the still-running tool task
                run.cancel()
                raise
        if method == "resources/list":
            auth.require("resources.read")
            resources = await self.resources.list_resources()
            return {"resources": [{
                "uri": r.uri, "name": r.name,
                **({"description": r.description} if r.description else {}),
                **({"mimeType": r.mime_type} if r.mime_type else {}),
            } for r in resources if not r.uri_template]}
        if method == "resources/templates/list":
            auth.require("resources.read")
            return {"resourceTemplates": await self.resources.list_templates()}
        if method == "resources/read":
            auth.require("resources.read")
            uri = params.get("uri")
            if not uri:
                raise JSONRPCError(INVALID_PARAMS, "resources/read requires 'uri'")
            pm = self.ctx.plugin_manager
            if pm is not None:
                uri = await pm.resource_pre_fetch(uri, user=auth.user)
            result = await self.resources.read_resource(uri, request_headers=headers)
            if pm is not None:
                result = await pm.resource_post_fetch(uri, result, user=auth.user)
            return result
        if method == "resources/subscribe":
            auth.require("resources.read")
            await self.resources.subscribe(params.get("uri", ""),
                                           headers.get("mcp-session-id", "anonymous"))
            return {}
        if method == "resources/unsubscribe":
            await self.resources.unsubscribe(params.get("uri", ""),
                                             headers.get("mcp-session-id", "anonymous"))
            return {}
        if method == "prompts/list":
            auth.require("prompts.read")
            prompts = await self.prompts.list_prompts()
            return {"prompts": [{
                "name": p.name,
                **({"description": p.description} if p.description else {}),
                "arguments": [a.model_dump(exclude_none=True) for a in p.arguments],
            } for p in prompts]}
        if method == "prompts/get":
            auth.require("prompts.read")
            name = params.get("name")
            if not name:
                raise JSONRPCError(INVALID_PARAMS, "prompts/get requires 'name'")
            pm = self.ctx.plugin_manager
            args = params.get("arguments", {}) or {}
            if pm is not None:
                name, args = await pm.prompt_pre_fetch(name, args, user=auth.user)
            result = await self.prompts.render_prompt(name, args)
            if pm is not None:
                result = await pm.prompt_post_fetch(name, result, user=auth.user)
            return result
        if method == "roots/list":
            return {"roots": []}
        if method == "completion/complete":
            if self.completion is not None:
                return await self.completion.complete(params)
            return {"completion": {"values": [], "total": 0, "hasMore": False}}
        if method == "sampling/createMessage":
            if self.sampling is not None:
                return await self.sampling.create_message(params, user=auth.user)
            raise JSONRPCError(METHOD_NOT_FOUND, "Sampling not configured")
        if method == "logging/setLevel":
            level = params.get("level", "info")
            self._log_level = level
            return {}
        if method == "elicitation/create":
            raise JSONRPCError(METHOD_NOT_FOUND, "Elicitation requires a connected client")
        if method_registry.is_known(method):
            raise JSONRPCError(METHOD_NOT_FOUND, f"Method {method!r} not implemented")
        raise JSONRPCError(METHOD_NOT_FOUND, f"Unknown method {method!r}")

    async def _initialize(self, params: dict[str, Any]) -> dict[str, Any]:
        client_version = params.get("protocolVersion", PROTOCOL_VERSION)
        version = client_version if client_version in SUPPORTED_PROTOCOL_VERSIONS \
            else PROTOCOL_VERSION
        return {
            "protocolVersion": version,
            "capabilities": {
                "tools": {"listChanged": True},
                "resources": {"subscribe": True, "listChanged": True},
                "prompts": {"listChanged": True},
                "logging": {},
                "completions": {},
            },
            "serverInfo": {"name": self.ctx.settings.app_name, "version": "0.1.0"},
        }

    async def _handle_notification(self, method: str, params: dict[str, Any],
                                   auth: AuthContext | None = None) -> None:
        if method == "notifications/initialized":
            return
        if method == "notifications/cancelled":
            cancellation = self.ctx.extras.get("cancellation_service")
            if cancellation is not None and params.get("requestId") is not None:
                user = auth.user if auth is not None else "anonymous"
                await cancellation.cancel(f"{user}:{params.get('requestId')}")
            return
        # progress/message notifications are accepted and dropped at the edge
        return
