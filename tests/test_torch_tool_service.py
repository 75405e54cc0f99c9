"""The port's ``ToolService`` against the JAX package's, on the CPU, each over
its own migrated database, memory bus and registry, with the same seeded
scripts and one stub upstream on localhost that records every request:

- CRUD: register (with sealed auth), a conflict, get, list (inactive, team
  scope), update, toggle, delete, not-founds: the same outcomes and rows
  (ids, times and the sealed values masked);
- REST tools: path templating, query serialization, JSON bodies, text and
  JSON answers, retries on 503, a 404, the auth kinds, header passthrough
  under four settings combinations, the ``jsonpath_filter`` and the
  output-schema refusal: the same results and the same recorded requests;
- MCP tools through a federated gateway row, pooled sessions or one per
  call: results, JSON-RPC errors, an upstream crash, the passthrough
  allowlist; the federation breaker opening after repeated failures
  (-32003 with ``retry_after_s``);
- the plugin hooks: a recording plugin in each package sees the same pre
  and post calls in the same order, its header reaches the upstream, its
  short-circuit skips it; ``tool_invocations`` and ``tool_metrics`` rows.
Exact equality throughout."""

import asyncio
import json
import re

import pytest
from aiohttp import web
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.coordination import make_bus as jax_make_bus
from mcp_context_forge_tpu.coordination import make_lease_manager as jax_make_leases
from mcp_context_forge_tpu.db import core as jax_core
from mcp_context_forge_tpu.db.schema import MIGRATIONS as JAX_MIGRATIONS
from mcp_context_forge_tpu.observability import PrometheusRegistry as JaxRegistry
from mcp_context_forge_tpu.observability import Tracer as JaxTracer
from mcp_context_forge_tpu.observability import degradation as jax_degradation
from mcp_context_forge_tpu.plugins import framework as jax_fw
from mcp_context_forge_tpu import schemas as jax_schemas
from mcp_context_forge_tpu.services import base as jax_base
from mcp_context_forge_tpu.services import tool_service as jax_tools
from mcp_context_forge_tpu.services import upstream_sessions as jax_upstream
from mcp_context_forge_tpu_torch import schemas
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.coordination.bus import make_bus
from mcp_context_forge_tpu_torch.coordination.leases import make_lease_manager
from mcp_context_forge_tpu_torch.db import MIGRATIONS, core
from mcp_context_forge_tpu_torch.observability import degradation
from mcp_context_forge_tpu_torch.observability.metrics import PrometheusRegistry
from mcp_context_forge_tpu_torch.observability.tracing import Tracer
from mcp_context_forge_tpu_torch.plugins import framework as fw
from mcp_context_forge_tpu_torch.services import base
from mcp_context_forge_tpu_torch.services import tool_service
from mcp_context_forge_tpu_torch.services import upstream_sessions

PACKAGES = {
    "jax": dict(load=lambda env: jax_load_settings(
        env={f"MCPFORGE_{k}": v for k, v in env.items()}, env_file=None),
        core=jax_core, migrations=JAX_MIGRATIONS, base=jax_base, bus=jax_make_bus,
        leases=jax_make_leases, tracer=JaxTracer, registry=JaxRegistry, tools=jax_tools,
        schemas=jax_schemas, fw=jax_fw, upstream=jax_upstream),
    "port": dict(load=lambda env: load_settings(env, env_file=None), core=core,
                 migrations=MIGRATIONS, base=base, bus=make_bus, leases=make_lease_manager,
                 tracer=Tracer, registry=PrometheusRegistry, tools=tool_service,
                 schemas=schemas, fw=fw, upstream=upstream_sessions),
}
FAST = {"RETRY_BASE_DELAY": "0", "RETRY_MAX_DELAY": "0", "TOOL_TIMEOUT": "5"}
HEX = re.compile(r"[0-9a-f]{32}")
PORT = re.compile(r"127\.0\.0\.1:\d+")
RECORDED = ("authorization", "cookie", "x-tenant-id", "x-trace-id", "x-custom", "x-plugin",
            "content-type", "mcp-protocol-version")
MASKED = {"id", "created_at", "updated_at", "auth_value", "ts", "tool_id"}


# -- the stub upstream ---------------------------------------------------------


class Upstream:
    """REST under ``/rest/...`` and an MCP server at ``/mcp`` on 127.0.0.1,
    recording each request's method, path, query, chosen headers and body."""

    def __init__(self):
        self.log: list = []
        self.port = 0
        self._runner = None

    def _record(self, request, body):
        self.log.append((request.method, request.path, sorted(request.query.items()),
                         {h: request.headers.get(h) for h in RECORDED if h in request.headers},
                         body))

    async def rest(self, request: web.Request) -> web.StreamResponse:
        body = await request.text()
        self._record(request, body)
        tail = request.match_info["tail"]
        if tail.startswith("fail"):
            return web.Response(status=int(tail[4:]), text="upstream says no")
        if tail.startswith("text"):
            return web.Response(text="plain answer")
        return web.json_response({"echo": {"path": tail, "body": body},
                                  "nested": {"list": [{"v": 1}, {"v": 2}]}, "ok": True})

    async def mcp(self, request: web.Request) -> web.StreamResponse:
        message = await request.json()
        method = message.get("method")
        if method == "tools/call":
            self._record(request, message["params"])
        if "id" not in message:
            return web.Response(status=202)
        if method == "initialize":
            result = {"protocolVersion": "2025-06-18", "capabilities": {"tools": {}},
                      "serverInfo": {"name": "stub", "version": "1"}}
        elif method == "tools/list":
            result = {"tools": [{"name": "echo", "inputSchema": {"type": "object"}}]}
        elif method == "tools/call":
            name = message["params"]["name"]
            if name == "rpcerr":
                return web.json_response({"jsonrpc": "2.0", "id": message["id"],
                                          "error": {"code": -32602, "message": "bad args",
                                                    "data": {"why": 1}}})
            if name == "crash":
                return web.Response(status=500, text="boom")
            result = {"content": [{"type": "text",
                                   "text": json.dumps(message["params"]["arguments"])}],
                      "isError": False}
        else:
            result = {}
        return web.json_response({"jsonrpc": "2.0", "id": message["id"], "result": result})

    async def __aenter__(self):
        app = web.Application()
        app.router.add_route("*", "/rest/{tail:.*}", self.rest)
        app.router.add_post("/mcp", self.mcp)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        await self._runner.cleanup()

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.port}{path}"


# -- a recording plugin per package --------------------------------------------


def _recorder_kinds():
    calls = {"jax": [], "port": []}
    for name, framework in (("jax", jax_fw), ("port", fw)):
        class Recorder(framework.Plugin):
            log = calls[name]

            async def tool_pre_invoke(self, tool, arguments, headers, context):
                self.log.append(("pre", self.config.name, tool, dict(arguments)))
                if arguments.get("short"):
                    return {"result": {"content": [{"type": "text", "text": "early"}],
                                       "isError": False}}
                return {"headers": {**headers, "x-plugin": self.config.name}}

            async def tool_post_invoke(self, tool, result, context):
                self.log.append(("post", self.config.name, tool, result.get("isError")))
                return {**result, "annotations": {"seen_by": self.config.name}}

        globals()[f"{name.capitalize()}Recorder"] = Recorder
        framework.register_builtin("test_recorder", f"{__name__}.{name.capitalize()}Recorder")
    return calls


CALLS = _recorder_kinds()


async def _context(package: str, env: dict | None = None, plugins: bool = False,
                   pooled: bool = False):
    p = PACKAGES[package]
    db = p["core"].Database(":memory:")
    await db.connect()
    await db.migrate(p["migrations"])
    ctx = p["base"].AppContext(settings=p["load"]({**FAST, **(env or {})}), db=db, bus=p["bus"]("memory"),
                               leases=p["leases"]("memory"), tracer=p["tracer"](exporter="memory"),
                               metrics=p["registry"]())
    if plugins:
        pm = p["fw"].PluginManager(ctx)
        for name, priority in (("second", 20), ("first", 10)):
            await pm.add_plugin(p["fw"].PluginConfig(name=name, kind="test_recorder",
                                                     priority=priority))
        ctx.plugin_manager = pm
    if pooled:
        ctx.extras["upstream_sessions"] = p["upstream"].UpstreamSessionRegistry(ctx)
    return ctx, p["tools"].ToolService(ctx)


async def _close(ctx) -> None:
    registry = ctx.extras.get("upstream_sessions")
    if registry is not None:
        await registry.stop()
    await asyncio.sleep(0)   # the metric rows' tasks
    await ctx.close_http_client()
    await ctx.db.close()


def _mask(value, ids: dict):
    if isinstance(value, list):
        return [_mask(v, ids) for v in value]
    if isinstance(value, tuple):
        return tuple(_mask(v, ids) for v in value)
    if isinstance(value, dict):
        return {k: ("*" if k in MASKED else _mask(v, ids)) for k, v in value.items()}
    if isinstance(value, str):
        value = PORT.sub("127.0.0.1:<port>", value)
        return HEX.sub(lambda m: ids.setdefault(m.group(0), f"<id{len(ids)}>"), value)
    return value


async def _outcome(call, ids):
    try:
        out = await call
        if hasattr(out, "model_dump"):
            out = out.model_dump()
        elif isinstance(out, list) and out and hasattr(out[0], "model_dump"):
            out = [o.model_dump() for o in out]
        return ("ok", _mask(json.loads(json.dumps(out)), ids))
    except Exception as exc:
        return (type(exc).__name__, _mask(str(exc), ids), getattr(exc, "code", None),
                _mask(getattr(exc, "data", None), ids))


def _both(script, **kwargs):
    """``script(package, ctx, svc, upstream)`` per package; (port, jax)."""

    async def run(package):
        async with Upstream() as upstream:
            ctx, svc = await _context(package, **kwargs)
            try:
                return await script(package, ctx, svc, upstream)
            finally:
                await _close(ctx)

    return asyncio.run(run("port")), asyncio.run(run("jax"))


# -- CRUD --------------------------------------------------------------------------


async def _crud(package, ctx, svc, upstream):
    S = PACKAGES[package]["schemas"]
    ids, log = {}, []
    made = await svc.register_tool(S.ToolCreate(
        name="weather", url=upstream.url("/rest/w"), request_type="GET", auth_type="basic",
        auth_value={"username": "u", "password": "p"}, tags=["a"], headers={"x-custom": "1"}))
    log.append(await _outcome(svc.get_tool(made.id), ids))
    log.append(await _outcome(svc.register_tool(S.ToolCreate(name="weather")), ids))
    team = await svc.register_tool(S.ToolCreate(name="private", visibility="team",
                                                team_id="t1", description="d"))
    log.append(await _outcome(svc.list_tools(), ids))
    log.append(await _outcome(svc.list_tools(team_ids=[]), ids))
    log.append(await _outcome(svc.list_tools(team_ids=["t1"]), ids))
    log.append(await _outcome(svc.update_tool(made.id, S.ToolUpdate.model_validate(
        {"custom_name": "forecast", "headers": {"x-custom": "2"}, "enabled": False,
         "auth_value": {"token": "t"}})), ids))
    log.append(await _outcome(svc.list_tools(), ids))
    log.append(await _outcome(svc.list_tools(include_inactive=True), ids))
    log.append(await _outcome(svc.toggle_tool(made.id, True), ids))
    log.append(await _outcome(svc._lookup("forecast"), ids))
    log.append(await _outcome(svc._lookup("weather"), ids))
    log.append(await _outcome(svc.delete_tool(team.id), ids))
    log.append(await _outcome(svc.delete_tool(team.id), ids))
    log.append(await _outcome(svc.get_tool("missing"), ids))
    log.append(await _outcome(svc.update_tool("missing", S.ToolUpdate()), ids))
    log.append(await _outcome(ctx.db.fetchall("SELECT * FROM tools ORDER BY original_name"), ids))
    return log


def test_crud_agrees():
    ours, theirs = _both(_crud)
    assert ours == theirs


# -- REST ----------------------------------------------------------------------------

PASSTHROUGH = [{}, {"ENABLE_HEADER_PASSTHROUGH": "true"},
               {"ENABLE_HEADER_PASSTHROUGH": "true", "ENABLE_OVERWRITE_BASE_HEADERS": "true",
                "DEFAULT_PASSTHROUGH_HEADERS": "X-Tenant-Id,authorization,cookie"},
               {"ENABLE_HEADER_PASSTHROUGH": "true", "ENABLE_SENSITIVE_HEADER_PASSTHROUGH": "true",
                "DEFAULT_PASSTHROUGH_HEADERS": "authorization,x-trace-id"}]
INBOUND = {"x-tenant-id": "t-in", "authorization": "Bearer inbound", "cookie": "c=1",
           "x-trace-id": "tr-1"}


async def _rest(package, ctx, svc, upstream):
    S = PACKAGES[package]["schemas"]
    ids, log = {}, []
    specs = [
        ("get_item", "/rest/items/{item_id}", "GET", {}, None, None),
        ("post_item", "/rest/items", "POST", {"X-Tenant-Id": "base", "x-custom": "1"},
         "bearer", {"token": "tok"}),
        ("text", "/rest/text", "PUT", {}, "headers", {"headers": {"x-custom": "h"}}),
        ("flaky", "/rest/fail503", "POST", {}, "basic", {"username": "a", "password": "b"}),
        ("missing", "/rest/fail404", "DELETE", {}, None, None),
    ]
    for name, path, method, headers, auth_type, auth_value in specs:
        await svc.register_tool(S.ToolCreate(name=name, url=upstream.url(path),
                                             request_type=method, headers=headers,
                                             auth_type=auth_type, auth_value=auth_value))
    await svc.register_tool(S.ToolCreate(name="filtered", url=upstream.url("/rest/f"),
                                         jsonpath_filter="$.nested.list[1].v"))
    await svc.register_tool(S.ToolCreate(name="schema_ok", url=upstream.url("/rest/s"),
                                         output_schema={"required": ["ok", "echo"]}))
    await svc.register_tool(S.ToolCreate(name="schema_bad", url=upstream.url("/rest/s"),
                                         output_schema={"required": ["ok", "absent"]}))
    calls = [("get_item", {"item_id": 7, "q": "x y", "flag": True, "many": [1, 2], "none": None}),
             ("post_item", {"a": 1, "b": [True, None]}), ("text", {}), ("flaky", {"n": 1}),
             ("missing", {"k": False}), ("filtered", {}), ("schema_ok", {}), ("schema_bad", {}),
             ("nonexistent", {})]
    for name, args in calls:
        log.append(await _outcome(svc.invoke_tool(name, args, request_headers=dict(INBOUND),
                                                  user="u@example.com"), ids))
    log.append(_mask(upstream.log, ids))
    rows = await ctx.db.fetchall("SELECT success FROM tool_metrics ORDER BY rowid")
    log.append([r["success"] for r in rows])
    samples = sorted((s.labels["tool"], s.labels["status"], s.value)
                     for m in ctx.metrics.tool_invocations.collect() for s in m.samples
                     if s.name.endswith("_total"))
    log.append(samples)
    return log


@pytest.mark.parametrize("env", range(len(PASSTHROUGH)))
def test_rest_invocation_agrees(env):
    ours, theirs = _both(_rest, env=PASSTHROUGH[env])
    assert ours == theirs


# -- MCP -----------------------------------------------------------------------------


async def _gateway_row(ctx, url: str, passthrough: list) -> str:
    gid = "0123456789abcdef0123456789abcdef"
    await ctx.db.execute(
        "INSERT INTO gateways (id, name, url, transport, auth_type, auth_value, enabled, state,"
        " passthrough_headers, created_at, updated_at) VALUES (?,?,?,?,?,?,?,?,?,?,?)",
        (gid, "peer", url, "streamablehttp", None, None, 1, "active", json.dumps(passthrough),
         0.0, 0.0))
    return gid


async def _mcp(package, ctx, svc, upstream):
    S = PACKAGES[package]["schemas"]
    ids, log = {}, []
    gid = await _gateway_row(ctx, upstream.url("/mcp"), ["x-tenant-id", "Authorization"])
    for name in ("echo", "rpcerr", "crash"):
        await svc.register_tool(S.ToolCreate(name=name, integration_type="MCP", gateway_id=gid))
    for name, args in (("echo", {"a": [1, "é"]}), ("rpcerr", {}), ("crash", {}),
                       ("echo", {"again": True}), ("echo", {"short": True})):
        log.append(await _outcome(svc.invoke_tool(name, args, request_headers=dict(INBOUND),
                                                  user="u@example.com"), ids))
    log.append(_mask(upstream.log, ids))
    log.append(list(CALLS[package]))
    CALLS[package].clear()
    return log


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("plugins", [False, True])
def test_mcp_invocation_agrees(pooled, plugins):
    ours, theirs = _both(_mcp, env={}, pooled=pooled, plugins=plugins)
    assert ours == theirs


@pytest.fixture
def fresh_breakers():
    saved = (degradation._MANAGER, jax_degradation._MANAGER)
    degradation._MANAGER = degradation.DegradationManager(failure_threshold=3, cooldown_s=30.0)
    jax_degradation._MANAGER = jax_degradation.DegradationManager(failure_threshold=3,
                                                                  cooldown_s=30.0)
    yield
    degradation._MANAGER, jax_degradation._MANAGER = saved


async def _breaker(package, ctx, svc, upstream):
    S = PACKAGES[package]["schemas"]
    ids, log = {}, []
    gid = await _gateway_row(ctx, "http://127.0.0.1:1/mcp", [])
    await svc.register_tool(S.ToolCreate(name="echo", integration_type="MCP", gateway_id=gid))
    for _ in range(5):
        log.append(await _outcome(svc.invoke_tool("echo", {}), ids))
    return log


def test_federation_breaker_agrees(fresh_breakers):
    ours, theirs = _both(_breaker, env={"MAX_TOOL_RETRIES": "1"})
    assert ours == theirs
    assert ours[-1][0] == "JSONRPCError" and ours[-1][2] == -32003
    assert ours[-1][3] == {"retry_after_s": 30, "degraded": "federation"}


def test_hooks_run_in_priority_order():
    ours, theirs = _both(_mcp, env={}, plugins=True)
    hooks = ours[-1]
    assert hooks == theirs[-1]
    assert [h[:2] for h in hooks[:4]] == [("pre", "first"), ("pre", "second"),
                                          ("post", "first"), ("post", "second")]
