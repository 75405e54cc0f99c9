"""The port's resource and prompt catalog, cursor pages and registry cache
against the JAX package's, on the CPU, each over its own migrated sqlite
database and memory bus, with the same seeded scripts:

- ``ResourceService``: register (sizes, a conflict, the size cap, the mime
  allowlist), list, update, delete, ``read_resource`` (text, binary, a
  ``{var}`` template, a miss), templates, subscriptions, the
  ``resources.changed`` messages and the ``tool_metrics`` rows;
- ``PromptService``: register (a conflict, the size cap, a template that
  does not compile), render (defaults, missing arguments), update, delete,
  the ``prompts.changed`` messages; jinja2's sandbox refusing attribute
  walks in both packages;
- the create and update schemas' refusals, in pydantic's 422 layout;
- URI templates matched segment-wise;
- a federated ``read_resource`` and ``get_prompt`` through each package's
  MCP client to one stub upstream on localhost, which records what it was
  sent (the sealed bearer among it);
- ``resources/read`` and ``prompts/get`` through each package's
  ``RPCDispatcher`` with two recording plugins on the four fetch hooks:
  the same hook calls in priority order and the same rewritten results;
- ``paginate`` over seeded lists: whole lists, limits and their clamps,
  walks by cursor, a bad cursor or limit (422), links;
- ``RegistryCache``: TTL expiry, invalidation by the bus's
  ``<entity>.changed`` topics, and the generation that drops a load which
  an invalidation overtook.
Exact equality throughout (ids and times masked)."""

import asyncio
import json
import re
import types
from dataclasses import dataclass

import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import make_mocked_request

from mcp_context_forge_tpu import jsonrpc as jax_jsonrpc
from mcp_context_forge_tpu import schemas as jax_schemas
from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.coordination import make_bus as jax_make_bus
from mcp_context_forge_tpu.coordination import make_lease_manager as jax_make_leases
from mcp_context_forge_tpu.db import core as jax_core
from mcp_context_forge_tpu.db.schema import MIGRATIONS as JAX_MIGRATIONS
from mcp_context_forge_tpu.gateway import pagination as jax_pagination
from mcp_context_forge_tpu.gateway import registry_cache as jax_registry_cache
from mcp_context_forge_tpu.gateway import routers as jax_routers
from mcp_context_forge_tpu.gateway import rpc as jax_rpc
from mcp_context_forge_tpu.observability import PrometheusRegistry as JaxRegistry
from mcp_context_forge_tpu.observability import Tracer as JaxTracer
from mcp_context_forge_tpu.plugins import framework as jax_fw
from mcp_context_forge_tpu.services import auth_service as jax_auth
from mcp_context_forge_tpu.services import base as jax_base
from mcp_context_forge_tpu.services import prompt_service as jax_prompts
from mcp_context_forge_tpu.services import resource_service as jax_resources
from mcp_context_forge_tpu.utils import crypto as jax_crypto
from mcp_context_forge_tpu_torch import jsonrpc, schemas
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.coordination.bus import make_bus
from mcp_context_forge_tpu_torch.coordination.leases import make_lease_manager
from mcp_context_forge_tpu_torch.db import MIGRATIONS, core
from mcp_context_forge_tpu_torch.gateway import auth, pagination, registry_cache, routers, rpc
from mcp_context_forge_tpu_torch.observability.metrics import PrometheusRegistry
from mcp_context_forge_tpu_torch.observability.tracing import Tracer
from mcp_context_forge_tpu_torch.plugins import framework as fw
from mcp_context_forge_tpu_torch.services import base, prompt_service, resource_service
from mcp_context_forge_tpu_torch.utils import crypto

PACKAGES = {
    "jax": dict(load=lambda env: jax_load_settings(
        env={f"MCPFORGE_{k}": v for k, v in env.items()}, env_file=None),
        core=jax_core, migrations=JAX_MIGRATIONS, base=jax_base, bus=jax_make_bus,
        leases=jax_make_leases, tracer=JaxTracer, registry=JaxRegistry,
        resources=jax_resources, prompts=jax_prompts, schemas=jax_schemas,
        crypto=jax_crypto, pagination=jax_pagination, cache=jax_registry_cache,
        routers=jax_routers, rpc=jax_rpc, jsonrpc=jax_jsonrpc, fw=jax_fw,
        auth=jax_auth.AuthContext),
    "port": dict(load=lambda env: load_settings(env, env_file=None), core=core,
                 migrations=MIGRATIONS, base=base, bus=make_bus, leases=make_lease_manager,
                 tracer=Tracer, registry=PrometheusRegistry, resources=resource_service,
                 prompts=prompt_service, schemas=schemas, crypto=crypto,
                 pagination=pagination, cache=registry_cache, routers=routers, rpc=rpc,
                 jsonrpc=jsonrpc, fw=fw, auth=auth.AuthContext),
}
HEX = re.compile(r"[0-9a-f]{32}")
TIMES = {"created_at", "updated_at", "ts", "duration_ms"}
SEEDS = range(4)


def _mask(value, ids: dict):
    if isinstance(value, list):
        return [_mask(v, ids) for v in value]
    if isinstance(value, tuple):
        return tuple(_mask(v, ids) for v in value)
    if isinstance(value, dict):
        return {k: ("<t>" if k in TIMES else _mask(v, ids)) for k, v in value.items()}
    if isinstance(value, str):
        return HEX.sub(lambda m: ids.setdefault(m.group(0), f"<id{len(ids)}>"), value)
    return value


async def _context(package: str, env: dict | None = None):
    p = PACKAGES[package]
    db = p["core"].Database(":memory:")
    await db.connect()
    await db.migrate(p["migrations"])
    ctx = p["base"].AppContext(settings=p["load"](env or {}), db=db, bus=p["bus"]("memory"),
                               leases=p["leases"]("memory"), tracer=p["tracer"](exporter="memory"),
                               metrics=p["registry"]())
    published: list = []

    async def record(topic, message):
        published.append((topic, message))

    for topic in ("resources.changed", "prompts.changed"):
        ctx.bus.subscribe(topic, record)
    return ctx, published


async def _outcome(log: list, label: str, coro):
    """Await ``coro``; log its result, or its error's kind and text."""
    try:
        result = await coro
    except Exception as exc:  # the kinds are compared by name across packages
        log.append((label, type(exc).__name__, str(exc)))
        return None
    if hasattr(result, "model_dump"):
        result = result.model_dump()
    elif isinstance(result, list):
        result = [r.model_dump() if hasattr(r, "model_dump") else r for r in result]
    log.append((label, result))
    return result


def _both(script, env: dict | None = None) -> list:
    async def run(package):
        ctx, published = await _context(package, env)
        log: list = []
        try:
            await script(PACKAGES[package], ctx, log)
        finally:
            await ctx.close_http_client()
            await ctx.db.close()
        log.append(("published", published))
        return _mask(log, {})

    return [asyncio.run(run(package)) for package in ("jax", "port")]


def _assert_same(logs: list) -> None:
    theirs, ours = logs
    assert len(theirs) == len(ours)
    for want, got in zip(theirs, ours):
        assert got == want


# -- resources ---------------------------------------------------------------------


def _resources(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(4, 8))):
        body = {"uri": f"file:///data/{seed}/r{i}.txt", "name": f"res-{int(rng.integers(100))}",
                "content": "x" * int(rng.integers(0, 90)),
                "mime_type": str(rng.choice(["text/plain", "application/json"]))}
        if rng.random() < 0.3:
            body["is_binary"] = True
        if rng.random() < 0.3:
            body["tags"] = [f"t{int(t)}" for t in rng.integers(0, 5, size=2)]
        out.append(body)
    out.append({"uri": f"file:///data/{seed}/{{day}}/{{name}}.log", "name": "daily",
                "uri_template": f"file:///data/{seed}/{{day}}/{{name}}.log",
                "content": "templated"})
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_resource_service_agrees(seed):
    bodies = _resources(seed)

    async def script(p, ctx, log):
        service = p["resources"].ResourceService(ctx)
        make = p["schemas"].ResourceCreate.model_validate
        ids = []
        for body in bodies:
            made = await _outcome(log, "register", service.register_resource(make(body)))
            ids.append(made["id"])
        await _outcome(log, "conflict", service.register_resource(make(bodies[0])))
        await _outcome(log, "too_big", service.register_resource(make(
            {"uri": "file:///big", "name": "big", "content": "y" * 300})))
        await _outcome(log, "mime", service.register_resource(make(
            {"uri": "file:///img", "name": "img", "mime_type": "image/png"})))
        await _outcome(log, "list", service.list_resources())
        update = p["schemas"].ResourceUpdate.model_validate(
            {"content": "fresh content", "enabled": False, "tags": ["u"]})
        await _outcome(log, "update", service.update_resource(ids[1], update))
        await _outcome(log, "list_inactive", service.list_resources(include_inactive=True))
        await _outcome(log, "list_active", service.list_resources())
        await _outcome(log, "update_missing", service.update_resource("missing", update))
        for uri in [b["uri"] for b in bodies[:3]] + [
                f"file:///data/{seed}/2026-10-18/gw.log", f"file:///data/{seed}/a/b/c.log",
                "file:///nowhere"]:
            await _outcome(log, "read", service.read_resource(uri))
        await _outcome(log, "templates", service.list_templates())
        await service.subscribe(bodies[0]["uri"], "s1")
        await service.subscribe(bodies[0]["uri"], "s2")
        await service.unsubscribe(bodies[0]["uri"], "s1")
        await _outcome(log, "subscribers", service.subscribers(bodies[0]["uri"]))
        await _outcome(log, "delete", service.delete_resource(ids[0]))
        await _outcome(log, "delete_again", service.delete_resource(ids[0]))
        rows = await ctx.db.fetchall("SELECT tool_id, success, entity_type FROM tool_metrics"
                                     " ORDER BY id")
        log.append(("metrics", [dict(r) for r in rows]))

    _assert_same(_both(script, {"MAX_RESOURCE_SIZE": "200",
                                "ALLOWED_RESOURCE_MIME_TYPES_CSV": "text/plain,application/json"}))


# -- prompts -----------------------------------------------------------------------


def _prompts(seed: int) -> list[dict]:
    rng = np.random.default_rng(100 + seed)
    out = []
    for i in range(int(rng.integers(3, 6))):
        names = [f"a{j}" for j in range(int(rng.integers(1, 4)))]
        required = [bool(rng.random() < 0.6) for _ in names]
        template = " | ".join(f"{n}={{{{ {n} }}}}" if r else f"{n}={{{{ {n} | default('-') }}}}"
                              for n, r in zip(names, required))
        out.append({"name": f"p{seed}-{i}", "template": template, "description": f"d{i}",
                    "arguments": [{"name": n, "required": r} for n, r in zip(names, required)]})
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_prompt_service_agrees(seed):
    bodies = _prompts(seed)

    async def script(p, ctx, log):
        rng = np.random.default_rng(200 + seed)   # the same draws in each package
        service = p["prompts"].PromptService(ctx)
        make = p["schemas"].PromptCreate.model_validate
        ids = []
        for body in bodies:
            made = await _outcome(log, "register", service.register_prompt(make(body)))
            ids.append(made["id"])
        await _outcome(log, "conflict", service.register_prompt(make(bodies[0])))
        await _outcome(log, "too_big", service.register_prompt(make(
            {"name": "big", "template": "z" * 300})))
        await _outcome(log, "no_compile", service.register_prompt(make(
            {"name": "broken", "template": "{% for %}"})))
        for body in bodies:
            given = {a["name"]: f"v{int(rng.integers(1000))}" for a in body["arguments"]
                     if rng.random() < 0.7}
            await _outcome(log, "render", service.render_prompt(body["name"], given))
        await _outcome(log, "render_none", service.render_prompt(bodies[0]["name"]))
        await _outcome(log, "render_missing", service.render_prompt("nope", {}))
        update = p["schemas"].PromptUpdate.model_validate(
            {"template": "only {{ a0 }}", "arguments": [{"name": "a0", "required": True}]})
        await _outcome(log, "update", service.update_prompt(ids[0], update))
        await _outcome(log, "render_updated", service.render_prompt(bodies[0]["name"],
                                                                    {"a0": "x"}))
        await _outcome(log, "update_broken", service.update_prompt(
            ids[0], p["schemas"].PromptUpdate.model_validate({"template": "{{ ("})))
        await _outcome(log, "disable", service.update_prompt(
            ids[1], p["schemas"].PromptUpdate.model_validate({"enabled": False})))
        await _outcome(log, "list", service.list_prompts())
        await _outcome(log, "list_inactive", service.list_prompts(include_inactive=True))
        await _outcome(log, "render_disabled", service.render_prompt(bodies[1]["name"], {}))
        await _outcome(log, "delete", service.delete_prompt(ids[0]))
        await _outcome(log, "delete_again", service.delete_prompt(ids[0]))

    _assert_same(_both(script, {"MAX_PROMPT_SIZE": "200"}))


ESCAPES = ["{{ ''.__class__ }}", "{{ ''.__class__.__mro__[1].__subclasses__() }}",
           "{{ cycler.__init__.__globals__ }}", "{{ self.__init__ }}",
           "{% for c in [].__class__.__base__.__subclasses__() %}{{ c }}{% endfor %}",
           "{{ lipsum.__globals__['os'] }}", "{{ range.__self__ }}",
           "{{ x.__dict__ }}"]


@pytest.mark.parametrize("template", ESCAPES)
def test_sandbox_refuses_attribute_walks(template):
    """A template that walks to a class, a module or globals registers but
    does not render, in both packages (jinja2's sandbox)."""
    async def script(p, ctx, log):
        service = p["prompts"].PromptService(ctx)
        await _outcome(log, "register", service.register_prompt(
            p["schemas"].PromptCreate.model_validate({"name": "escape", "template": template})))
        await _outcome(log, "render", service.render_prompt("escape", {"x": {"k": 1}}))

    logs = _both(script)
    _assert_same(logs)
    assert logs[1][1][1] == "ValidationFailure"


# -- schemas -----------------------------------------------------------------------

BODIES = [
    ("ResourceCreate", {"uri": 1, "is_binary": "x"}),
    ("ResourceCreate", {"uri": "u", "name": "n", "tags": [1, "a", 2], "visibility": "x"}),
    ("ResourceCreate", []),
    ("ResourceUpdate", {"content": 5, "enabled": "maybe", "tags": "t"}),
    ("PromptCreate", {"name": "p", "template": 3, "arguments": [
        {"description": "no name"}, 5, {"name": "x", "required": "maybe"}]}),
    ("PromptCreate", {"name": "p", "template": "t", "arguments": "x"}),
    ("PromptCreate", {"template": "t", "arguments": [{"name": "a", "description": 4}]}),
    ("PromptUpdate", {"arguments": [{"name": 1}, {"name": "b", "required": 2}]}),
    ("PromptUpdate", {"arguments": [{"name": "a", "required": "yes"}], "visibility": "team"}),
    ("PromptArgument", {"name": "a", "required": "off"}),
]


def _layout(text: str) -> list:
    """pydantic's error text as (count line, location, message | kind ...)."""
    out = []
    for line in text.splitlines():
        if line.strip().startswith("For further"):
            continue
        message, _, rest = line.partition(" [type=")
        out.append(f"{message}|{rest.split(',')[0].rstrip(']')}" if rest else line)
    return out


@pytest.mark.parametrize("name,body", BODIES)
def test_schema_refusals_agree(name, body):
    results = []
    for module in (jax_schemas, schemas):
        try:
            results.append(getattr(module, name).model_validate(body).model_dump(
                exclude_unset=True))
        except ValueError as exc:
            results.append(_layout(str(exc)))
    assert results[1] == results[0]


# -- URI templates -----------------------------------------------------------------

TEMPLATES = [("file:///logs/{day}.txt", "file:///logs/2026-10-18.txt", True),
             ("file:///logs/{day}.txt", "file:///logs/a/b.txt", False),
             ("db://{table}/{id}", "db://users/42", True),
             ("db://{table}/{id}", "db://users/", False),
             ("mem://{a}.{b}", "mem://x.y", True),
             ("mem://{a}.{b}", "mem://xzy", False),
             ("s3://bucket/[x]/{k}", "s3://bucket/[x]/key", True),
             ("plain://no/vars", "plain://no/vars", True)]


@pytest.mark.parametrize("template,uri,matches", TEMPLATES)
def test_uri_templates_match_as_jax(template, uri, matches):
    assert resource_service._template_matches(template, uri) is matches
    assert jax_resources._template_matches(template, uri) is matches


# -- federated reads -----------------------------------------------------------------


class Upstream:
    """A stub MCP server on 127.0.0.1 that answers ``resources/read`` and
    ``prompts/get`` and records what it was sent."""

    def __init__(self):
        self.log: list = []
        self._runner = None
        self.url = ""

    async def mcp(self, request: web.Request) -> web.StreamResponse:
        message = await request.json()
        method = message.get("method")
        self.log.append((method, message.get("params"), request.headers.get("authorization")))
        if "id" not in message:
            return web.Response(status=202)
        if method == "initialize":
            result = {"protocolVersion": "2025-06-18", "capabilities": {
                "resources": {}, "prompts": {}}, "serverInfo": {"name": "stub", "version": "1"}}
        elif method == "resources/read":
            uri = message["params"]["uri"]
            if uri.endswith("missing"):
                return web.json_response({"jsonrpc": "2.0", "id": message["id"], "error": {
                    "code": -32002, "message": f"no {uri}"}})
            result = {"contents": [{"uri": uri, "mimeType": "text/plain", "text": "upstream"}]}
        elif method == "prompts/get":
            args = message["params"].get("arguments") or {}
            result = {"description": "remote", "messages": [{"role": "user", "content": {
                "type": "text", "text": f"remote {json.dumps(args, sort_keys=True)}"}}]}
        else:
            result = {}
        return web.json_response({"jsonrpc": "2.0", "id": message["id"], "result": result})

    async def __aenter__(self):
        app = web.Application()
        app.router.add_post("/mcp", self.mcp)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, "127.0.0.1", 0)
        await site.start()
        self.url = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}/mcp"
        return self

    async def __aexit__(self, *exc):
        await self._runner.cleanup()


def test_federated_read_and_get_agree():
    """A resource or prompt row owned by a gateway goes to that gateway
    through each package's MCP client, with the gateway's sealed bearer;
    an upstream error answers alike."""
    async def script(p, ctx, log):
        async with Upstream() as upstream:
            sealed = p["crypto"].encrypt_field({"token": "t0k"},
                                               ctx.settings.auth_encryption_secret)
            await ctx.db.execute(
                "INSERT INTO gateways (id, name, url, auth_type, auth_value, created_at,"
                " updated_at) VALUES (?,?,?,?,?,?,?)",
                ("gw1", "stub", upstream.url, "bearer", sealed, 0, 0))
            for uri in ("remote://doc", "remote://missing"):
                await ctx.db.execute(
                    "INSERT INTO resources (id, uri, name, gateway_id, enabled, created_at,"
                    " updated_at) VALUES (?,?,?,?,1,0,0)", (uri, uri, uri, "gw1"))
            await ctx.db.execute(
                "INSERT INTO prompts (id, name, template, arguments, gateway_id, enabled,"
                " created_at, updated_at) VALUES (?,?,?,?,?,1,0,0)",
                ("p1", "remote-prompt", "", "[]", "gw1"))
            resources = p["resources"].ResourceService(ctx)
            prompts = p["prompts"].PromptService(ctx)
            for uri in ("remote://doc", "remote://missing"):
                await _outcome(log, "read", resources.read_resource(uri))
            await _outcome(log, "get", prompts.render_prompt("remote-prompt", {"k": "v"}))
            log.append(("upstream", upstream.log))

    _assert_same(_both(script))


# -- the plugins' fetch hooks ---------------------------------------------------------


def _fetch_recorders() -> dict:
    """A plugin kind per package on the four fetch hooks, logging each call."""
    calls = {"jax": [], "port": []}
    for name, framework in (("jax", jax_fw), ("port", fw)):
        class FetchRecorder(framework.Plugin):
            log = calls[name]

            async def resource_pre_fetch(self, uri, context):
                self.log.append(("resource_pre", self.config.name, uri))
                return uri.replace("alias://", "file:///") if uri.startswith("alias://") else None

            async def resource_post_fetch(self, uri, result, context):
                self.log.append(("resource_post", self.config.name, uri))
                return {**result, "seen_by": result.get("seen_by", []) + [self.config.name]}

            async def prompt_pre_fetch(self, name, arguments, context):
                self.log.append(("prompt_pre", self.config.name, name, dict(arguments)))
                return {"arguments": {**arguments, "who": self.config.name}}

            async def prompt_post_fetch(self, name, result, context):
                self.log.append(("prompt_post", self.config.name, name))
                return {**result, "seen_by": result.get("seen_by", []) + [self.config.name]}

        globals()[f"{name.capitalize()}FetchRecorder"] = FetchRecorder
        framework.register_builtin("catalog_fetch_recorder",
                                   f"{__name__}.{name.capitalize()}FetchRecorder")
    return calls


FETCHES = _fetch_recorders()


def test_fetch_hooks_wrap_reads_and_renders():
    """The dispatcher runs the plugins' pre hook before a read or a render
    and the post hook after it, in priority order, with their rewrites."""
    async def script(p, ctx, log):
        package = "jax" if p is PACKAGES["jax"] else "port"
        FETCHES[package].clear()
        pm = p["fw"].PluginManager(ctx)
        for name, priority in (("second", 20), ("first", 10)):
            await pm.add_plugin(p["fw"].PluginConfig(name=name, kind="catalog_fetch_recorder",
                                                     priority=priority))
        ctx.plugin_manager = pm
        resources = p["resources"].ResourceService(ctx)
        prompts = p["prompts"].PromptService(ctx)
        await resources.register_resource(p["schemas"].ResourceCreate.model_validate(
            {"uri": "file:///doc", "name": "doc", "content": "body"}))
        await prompts.register_prompt(p["schemas"].PromptCreate.model_validate(
            {"name": "hello", "template": "{{ greeting }} from {{ who }}"}))
        dispatcher = p["rpc"].RPCDispatcher(ctx, None, resources, prompts, None)
        admin = p["auth"](user="admin@example.com", is_admin=True)
        for rid, (method, params) in enumerate((
                ("resources/read", {"uri": "alias://doc"}),
                ("resources/read", {"uri": "file:///doc"}),
                ("prompts/get", {"name": "hello", "arguments": {"greeting": "hi"}}))):
            request = p["jsonrpc"].RPCRequest.parse({"jsonrpc": "2.0", "id": rid,
                                                     "method": method, "params": params})
            log.append(("answer", await dispatcher.dispatch(request, admin)))
        log.append(("hooks", list(FETCHES[package])))

    logs = _both(script)
    _assert_same(logs)
    hooks = logs[1][-2][1]
    assert hooks[:2] == [("resource_pre", "first", "alias://doc"),
                         ("resource_pre", "second", "file:///doc")]
    assert logs[1][2][1]["result"]["messages"][0]["content"]["text"] == "hi from second"


# -- pagination ----------------------------------------------------------------------


@dataclass
class Item:
    id: str
    name: str | None = None
    uri: str | None = None

    def model_dump(self):
        return {"id": self.id, "name": self.name, "uri": self.uri}


def _items(seed: int) -> list[Item]:
    rng = np.random.default_rng(300 + seed)
    out = []
    for i in range(int(rng.integers(0, 23))):
        label = f"n{int(rng.integers(0, 6))}"   # repeated labels: the id breaks ties
        if rng.random() < 0.5:
            out.append(Item(id=f"{i:032x}", name=label))
        else:
            out.append(Item(id=f"{i:032x}", uri=f"file:///{label}"))
    return out


def _page(p, query: str, items, env: dict):
    app = web.Application()
    app["ctx"] = types.SimpleNamespace(settings=p["load"](env))
    request = make_mocked_request("GET", f"/tools{query}", app=app)
    try:
        response = p["pagination"].paginate(request, items, lambda page: [
            i.model_dump() for i in page])
    except Exception as exc:
        return (type(exc).__name__, str(exc))
    return response.status, json.loads(response.body)


QUERIES = ["", "?limit=3", "?limit=0", "?limit=-4", "?limit=100000", "?limit=x", "?cursor=!!",
           "?cursor=", "?limit=1&include_inactive=true", "?cursor=" + "e30"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("links", ["false", "true"])
def test_paginate_agrees(seed, links):
    """Each query answers alike; walking every page by its ``next_cursor``
    (limits 1, 2 and 5) yields every item once, in the keyset order."""
    items = _items(seed)
    env = {"PAGINATION_INCLUDE_LINKS": links, "PAGINATION_MAX_PAGE_SIZE": "7"}
    for query in QUERIES:
        assert _page(PACKAGES["port"], query, items, env) == \
            _page(PACKAGES["jax"], query, items, env), query
    for limit in (1, 2, 5):
        walked, cursor = [], None
        while True:
            query = f"?limit={limit}" + (f"&cursor={cursor}" if cursor else "")
            status, body = _page(PACKAGES["port"], query, items, env)
            assert (status, body) == _page(PACKAGES["jax"], query, items, env)
            assert body["total"] == len(items)
            walked += [i["id"] for i in body["items"]]
            cursor = body["next_cursor"]
            if cursor is None:
                break
        assert sorted(walked) == sorted(i.id for i in items) and len(set(walked)) == len(items)


# -- the registry cache --------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _cache_ctx(p, env: dict):
    return types.SimpleNamespace(settings=p["load"](env), bus=p["bus"]("memory"))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_registry_cache_ttl_and_bus(package, monkeypatch):
    """Entries live their entity's TTL; each ``<entity>.changed`` flushes
    that entity's entries only and bumps its generation; a put carrying an
    old generation is dropped. Counters and contents are JAX's."""
    p = PACKAGES[package]
    clock = _Clock()
    monkeypatch.setattr(p["cache"], "time", clock)
    ctx = _cache_ctx(p, {"REGISTRY_CACHE_TOOLS_TTL_S": "5", "REGISTRY_CACHE_PROMPTS_TTL_S": "0",
                         "REGISTRY_CACHE_DEFAULT_TTL_S": "30"})
    cache = p["cache"].RegistryCache(ctx)
    cache.wire()
    trace = []

    async def run():
        cache.put("tools", "k", [1])
        cache.put("servers", "k", [2])
        cache.put("prompts", "k", [3])           # a zero TTL caches nothing
        trace.append((cache.get("tools", "k"), cache.get("servers", "k"),
                      cache.get("prompts", "k")))
        clock.now += 4.9
        trace.append(cache.get("tools", "k"))
        clock.now += 0.2
        trace.append((cache.get("tools", "k"), ("tools", "k") in cache._store))
        cache.put("tools", "k", [4])
        gen = cache.generation("tools")
        await ctx.bus.publish("tools.changed", {"action": "register"})
        trace.append((cache.get("tools", "k"), cache.get("servers", "k"),
                      cache.generation("tools") - gen, cache.generation("servers")))
        cache.put("tools", "k", [5], gen)        # loaded before the change: dropped
        trace.append(cache.get("tools", "k"))
        cache.put("tools", "k", [6], cache.generation("tools"))
        trace.append(cache.get("tools", "k"))
        cache.invalidate()
        trace.append((cache.get("servers", "k"), dict(cache._gen)))
        trace.append((cache.hits, cache.misses))

    asyncio.run(run())
    assert trace == [([1], [2], None), [1], (None, False), (None, [2], 1, 0), None, [6],
                     (None, {"tools": 2, "resources": 1, "prompts": 1, "servers": 1,
                             "gateways": 1}), (5, 5)]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_cached_list_drops_a_load_the_bus_overtook(package):
    """``_cached_list``: a miss loads, and an invalidation that fires while
    the load runs keeps its stale result out of the cache; the next call
    loads again and is then served from the cache."""
    p = PACKAGES[package]
    ctx = _cache_ctx(p, {})
    cache = p["cache"].RegistryCache(ctx)
    cache.wire()
    request = types.SimpleNamespace(app={"registry_cache": cache})
    loads = []

    async def run():
        release = asyncio.Event()

        async def slow_loader():
            loads.append("slow")
            await release.wait()
            return ["before the write"]

        async def loader():
            loads.append("fresh")
            return ["after the write"]

        pending = asyncio.ensure_future(p["routers"]._cached_list(request, "tools", "k",
                                                                   slow_loader))
        await asyncio.sleep(0)
        await ctx.bus.publish("tools.changed", {"action": "update"})
        release.set()
        first = await pending
        second = await p["routers"]._cached_list(request, "tools", "k", loader)
        third = await p["routers"]._cached_list(request, "tools", "k", loader)
        return first, second, third

    assert asyncio.run(run()) == (["before the write"], ["after the write"],
                                  ["after the write"])
    assert loads == ["slow", "fresh"] and (cache.hits, cache.misses) == (1, 2)
