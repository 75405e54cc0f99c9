"""The port's MCP tools/call path against the JAX gateway's, on the CPU: a
JAX ``build_app`` and the port's ``build_llm_app`` on llama3-test (f32,
stateful streamable HTTP, the port's engine on the JAX engine's weights
through ``params_from_jax``), each federating the text and time sample
servers through its own package's stdio bridge (``translate.py``), answer
the same request sequences with the same statuses and bodies (ids, times
and ports masked):

- ``/gateways`` (register, list, get, test, refresh, update, delete),
  ``/tools`` (list, create, get, update, toggle, delete) and ``/servers``,
  with their 404, 409 and 422 answers (the 422 detail's pydantic layout:
  count, locations, messages and kinds);
- ``/rpc`` and stateless ``/mcp``: ``initialize``, ``ping``,
  ``tools/list``, ``tools/call`` of every federated tool, batches,
  notifications, malformed bodies, unknown methods, ``completion/complete``
  over a prompt row inserted into both databases, ``sampling/createMessage``
  served by each app's engine (the same greedy text), and the fallbacks of a
  dispatcher built without those two services;
- the resource and prompt catalog: ``/resources`` and ``/prompts`` (create,
  list, cursor pages, update, delete, read and render, with their 404, 409,
  422 and 500 answers), and ``resources/*`` and ``prompts/*`` over ``/rpc``
  and a stateful ``/mcp`` session, whose GET stream receives
  ``notifications/prompts/list_changed`` and
  ``notifications/resources/list_changed`` for each write; ``prompts/get``
  of a prompt over a resource's text, then ``sampling/createMessage`` of
  the rendered messages, gives the JAX app's greedy text;
- a stateful session: ``initialize`` mints ``Mcp-Session-Id``, its GET
  stream receives ``notifications/tools/list_changed`` when ``POST /tools``
  adds a tool, DELETE ends it;
- server scoping: ``/servers/{id}/mcp`` lists and calls only its tools;
- 401 without credentials, 403 (a route) and -32004 (a method) under a
  token whose scopes lack the permission;
- the summarizer binding over a tools/call: the greedy summary of the
  ``case`` tool's output is the JAX app's, token for token; another
  ``max_tokens`` is a prefix hit; the repeat through ``/mcp`` comes from
  the summarizer's cache; a short output passes through unsummarized;
- cancellation: ``notifications/cancelled`` for a summarized call in flight
  answers -32800 in both; neither provider aborts the engine request, which
  runs to its end in both (the same tokens), after which no page is held."""

import asyncio
import base64
import dataclasses
import json
import re
import sys

import aiohttp
import jax
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu import jsonrpc as jax_rpc
from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.translate import StdioServerBridge as JaxBridge
from mcp_context_forge_tpu.translate import build_bridge_app as jax_bridge_app
from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models.configs import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app
from mcp_context_forge_tpu_torch.translate import StdioServerBridge
from mcp_context_forge_tpu_torch.translate import build_bridge_app

ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "2",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "512",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "96",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "32,256",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
    "MCPFORGE_STREAMABLE_HTTP_STATEFUL": "true",
    "MCPFORGE_RETRY_BASE_DELAY": "0",
    "MCPFORGE_RETRY_MAX_DELAY": "0",
}
SERVERS = ("text_server", "time_server")
HEX = re.compile(r"[0-9a-f]{32}")
PORT = re.compile(r"127\.0\.0\.1:\d+")
TIMES = {"created_at", "updated_at", "last_seen", "latency_ms", "worker_id"}
CURSOR = re.compile(r"cursor=[^&]+")
# a seeded ~200-character tool output: the summarizer's bar is 150
TEXT = " ".join(f"node-{i:02d} status={'ok' if i % 3 else 'degraded'}" for i in range(9))
SUMMARY = {"threshold_chars": 150, "max_tokens": 8, "prompt": "Summarize:"}
CANCEL_TOKENS = 120   # the cancelled call's budget: it decodes on after the answer


def _run(loop, coro, timeout: float = 180):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout))


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


@pytest.fixture(scope="module")
def pair(loop):
    """(JAX gateway client, port app client) and each package's bridges."""
    settings = load_settings(env=ENV, env_file=None)
    jax_settings = jax_load_settings(env=ENV, env_file=None)

    async def build():
        bridges, sites = {"jax": {}, "port": {}}, []
        for package, bridge_cls, app_fn in (("jax", JaxBridge, jax_bridge_app),
                                            ("port", StdioServerBridge, build_bridge_app)):
            for server in SERVERS:
                bridge = bridge_cls(f"{sys.executable} -m mcp_servers.{server}")
                await bridge.start()
                client = TestClient(TestServer(app_fn(bridge)))
                await client.start_server()
                sites.append((bridge, client))
                bridges[package][server] = str(client.make_url("/mcp"))
        ref_app = await build_app(jax_settings)
        config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu")
        engine = TorchEngine(config, params=params_from_jax(
            jax.device_get(ref_app["tpu_engine"].params), MODEL_CONFIGS[config.model],
            device="cpu", dtype=torch.float32))
        clients = []
        for app in (ref_app, build_llm_app(settings, engine=engine)):
            client = TestClient(TestServer(app))
            await client.start_server()
            clients.append(client)
        return clients, bridges, sites

    clients, bridges, sites = _run(loop, build())
    yield {"clients": clients, "bridges": bridges, "settings": (jax_settings, settings),
           "state": {}}
    for client in clients:
        _run(loop, client.close())
    for bridge, client in sites:
        _run(loop, client.close())
        _run(loop, bridge.stop())


BASIC = {"Authorization": aiohttp.BasicAuth("admin", "changeme").encode()}


def _bearer(settings, scopes: list) -> dict:
    return {"Authorization": "Bearer " + jax_jwt.create_token(
        {"sub": "ci@example.com", "scopes": scopes}, settings.jwt_secret_key,
        audience=settings.jwt_audience, issuer=settings.jwt_issuer)}


def _mask(value, ids: dict):
    if isinstance(value, list):
        return [_mask(v, ids) for v in value]
    if isinstance(value, dict):
        return {k: ("<t>" if k in TIMES else _mask(_cursor(v) if k == "next_cursor" else v, ids))
                for k, v in value.items()}
    if isinstance(value, str):
        value = PORT.sub("127.0.0.1:<port>", value)
        return HEX.sub(lambda m: ids.setdefault(m.group(0), f"<id{len(ids)}>"), value)
    return value


def _cursor(cursor):
    """A page cursor's anchor (its ids are masked like any other)."""
    if not cursor:
        return cursor
    return "cursor:" + json.loads(base64.urlsafe_b64decode(cursor + "=" * (-len(cursor) % 4)))


def _detail(body):
    """A 422 detail as (count line, [location, message | kind ...])."""
    if not (isinstance(body, dict) and isinstance(body.get("detail"), str)
            and "validation error" in body["detail"]):
        return body
    lines = [line for line in body["detail"].splitlines()
             if not line.strip().startswith("For further")]
    out = [lines[0]]
    for line in lines[1:]:
        message, _, rest = line.partition(" [type=")
        out.append(f"{message}|{rest.split(',')[0].rstrip(']')}" if rest else line)
    return {"detail": out}


class Session:
    """One request sequence against one app; ``call`` returns the body and
    logs (method, path, status, masked body)."""

    def __init__(self, client, state: dict, package: str, bridges: dict):
        self.client, self.state, self.package = client, state, package
        self.bridges = bridges[package]
        self.ids: dict = {}
        self.log: list = []

    async def call(self, method, path, headers=None, expect=None, **kwargs):
        path = path.format(**self.state)
        resp = await getattr(self.client, method)(path, headers=BASIC if headers is None
                                                  else headers, **kwargs)
        raw = await resp.read()
        body = json.loads(raw) if resp.content_type == "application/json" and raw else (
            raw.decode() if raw else None)
        self.log.append((method, CURSOR.sub("cursor=<c>", HEX.sub("<id>", path)), resp.status,
                         _mask(_detail(body), self.ids)))
        if expect is not None:
            assert resp.status == expect, (self.package, path, resp.status, body)
        self.last_headers = resp.headers
        return body

    async def rpc(self, method, params=None, rid=1, path="/rpc", headers=None):
        message = {"jsonrpc": "2.0", "method": method, "id": rid}
        if params is not None:
            message["params"] = params
        return await self.call("post", path, headers=headers, json=message)


def _both(loop, pair, script):
    out = []
    for i, package in enumerate(("jax", "port")):
        state = pair["state"].setdefault(package, {})
        session = Session(pair["clients"][i], state, package, pair["bridges"])
        _run(loop, script(session))
        out.append(session.log)
    return out


def _assert_same(logs):
    jax_log, port_log = logs
    assert len(jax_log) == len(port_log)
    for theirs, ours in zip(jax_log, port_log):
        assert ours == theirs


# -- the catalog ---------------------------------------------------------------


async def _federate(s: Session):
    for server, name in zip(SERVERS, ("text", "time")):
        made = await s.call("post", "/gateways", json={"name": name, "url": s.bridges[server]},
                            expect=201)
        s.state[name] = made["id"]
    await s.call("post", "/gateways", json={"name": "text", "url": s.bridges["text_server"]})
    await s.call("post", "/gateways", json={"name": "x", "url": "ftp://h/mcp"})
    await s.call("post", "/gateways", json={"url": 3, "transport": "ws", "enabled": "maybe"})
    await s.call("post", "/gateways", data="{not json")
    await s.call("get", "/gateways")
    await s.call("get", "/gateways/{text}")
    await s.call("get", "/gateways/missing")
    await s.call("post", "/gateways/test", json={"url": s.bridges["time_server"]})
    await s.call("post", "/gateways/test", json={"url": "http://127.0.0.1:1/mcp"})
    await s.call("post", "/gateways/test", json={"url": "file:///etc"})
    await s.call("post", "/gateways/{time}/refresh")
    await s.call("put", "/gateways/{time}", json={"description": "clock", "tags": ["t"]})
    await s.call("put", "/gateways/{time}", json={"enabled": []})
    tools = await s.call("get", "/tools")
    s.state.update({t["name"]: t["id"] for t in tools})
    await s.call("get", "/tools/{word_count}")
    await s.call("get", "/tools/missing")


def test_federation_and_catalog_agree(loop, pair):
    logs = _both(loop, pair, _federate)
    _assert_same(logs)
    tools = [entry for entry in logs[1] if entry[1] == "/tools" and entry[0] == "get"][0][3]
    assert sorted(t["name"] for t in tools) == ["add_days", "case", "checksum", "dedent_trim",
                                                "diff_days", "extract", "now", "word_count"]


async def _tools_and_servers(s: Session):
    made = await s.call("post", "/tools", json={
        "name": "rest_echo", "url": str(s.client.make_url("/version")), "request_type": "GET",
        "tags": ["r"], "jsonpath_filter": "$.version"}, expect=201)
    s.state["rest_echo"] = made["id"]
    await s.call("post", "/tools", json={"name": "rest_echo"})
    await s.call("post", "/tools", json={"name": "", "integration_type": "SOAP",
                                         "headers": {"a": 1}})
    await s.call("post", "/tools", json={"name": "n" * 300})
    await s.call("post", "/tools", json={"name": "many", "tags": ["t"] * 40})
    await s.call("put", "/tools/{rest_echo}", json={"custom_name": "echo_version",
                                                    "description": "d"})
    await s.call("post", "/tools/{rest_echo}/toggle", json={"enabled": False})
    await s.call("get", "/tools")
    await s.call("get", "/tools?include_inactive=true")
    await s.call("post", "/tools/{rest_echo}/toggle")
    await s.call("post", "/tools/{rest_echo}/toggle", data="{oops")
    await s.rpc("tools/call", {"name": "echo_version", "arguments": {}}, rid=5)
    made = await s.call("post", "/servers", json={
        "name": "words", "associated_tools": ["{}".format(s.state["word_count"])]}, expect=201)
    s.state["server"] = made["id"]
    await s.call("post", "/servers", json={"name": "words"})
    await s.call("post", "/servers", json={"name": "bad", "associated_tools": "x"})
    await s.call("get", "/servers")
    await s.call("get", "/servers/{server}")
    await s.rpc("tools/list", path="/servers/{server}/mcp")
    await s.rpc("tools/call", {"name": "word_count", "arguments": {"text": "a b"}},
                path="/servers/{server}/mcp")
    await s.rpc("tools/call", {"name": "case", "arguments": {"text": "a", "mode": "upper"}},
                path="/servers/{server}/mcp")
    await s.call("put", "/servers/{server}", json={"associated_tools": [], "enabled": "no"})
    await s.call("get", "/servers?include_inactive=true")
    await s.call("delete", "/servers/{server}")
    await s.call("delete", "/servers/{server}")
    await s.call("delete", "/tools/{rest_echo}")
    await s.call("delete", "/tools/{rest_echo}")


def test_tools_and_servers_agree(loop, pair):
    if "text" not in pair["state"].get("port", {}):
        _both(loop, pair, _federate)
    _assert_same(_both(loop, pair, _tools_and_servers))


# -- /rpc and stateless /mcp --------------------------------------------------------

CALLS = [("word_count", {"text": "one two\nthree"}), ("case", {"text": "Mixed Case", "mode": "snake"}),
         ("checksum", {"text": "abc", "algorithm": "md5"}), ("dedent_trim", {"text": "  x\n  y "}),
         ("extract", {"text": "a1 b22 c333", "pattern": "[0-9]+", "limit": 2}),
         ("extract", {"text": "x", "pattern": "(a+)+"}),
         ("add_days", {"date": "2026-07-28", "days": 3}),
         ("diff_days", {"a": "2026-01-01", "b": "2026-03-01"}),
         ("case", {"text": "x", "mode": "nope"}), ("missing_tool", {}), (None, {})]


async def _rpc_methods(s: Session):
    await s.rpc("initialize", {"protocolVersion": "2024-11-05"})
    await s.rpc("initialize", {"protocolVersion": "1999-01-01"}, rid="i2")
    await s.rpc("ping")
    listed = await s.rpc("tools/list")
    for rid, (name, args) in enumerate(CALLS):
        await s.rpc("tools/call", {"name": name, "arguments": args} if name else {}, rid=rid)
    for method in ("roots/list", "logging/setLevel", "elicitation/create", "no/such"):
        await s.rpc(method, {"level": "debug"})
    await s.call("post", "/rpc", json={"jsonrpc": "2.0", "method": "notifications/initialized"})
    await s.call("post", "/rpc", data=b"{broken")
    await s.call("post", "/rpc", json={"jsonrpc": "1.0", "id": 4, "method": "ping"})
    await s.call("post", "/rpc", json=[{"jsonrpc": "2.0", "id": 1, "method": "ping"}])
    # stateless /mcp (the transport's own mode switch)
    settings = s.client.app["ctx"].settings
    settings.streamable_http_stateful = False
    try:
        via_mcp = await s.rpc("tools/list", path="/mcp")
        assert via_mcp["result"] == listed["result"]
        await s.call("post", "/mcp", json=[
            {"jsonrpc": "2.0", "id": 1, "method": "tools/call",
             "params": {"name": "word_count", "arguments": {"text": "x y z"}}},
            {"jsonrpc": "2.0", "method": "notifications/initialized"},
            {"jsonrpc": "2.0", "id": 2, "method": "bad/method"}, {"id": 3}])
        await s.call("post", "/mcp", json={"jsonrpc": "2.0", "method": "notifications/x"})
        await s.call("post", "/mcp", data=b"[]")
        await s.call("post", "/mcp", data=b"nope")
        await s.call("post", "/mcp", data=b"")
        await s.call("get", "/mcp")
        await s.call("post", "/mcp", headers={**BASIC, "accept": "text/event-stream"},
                     json={"jsonrpc": "2.0", "id": 9, "method": "ping"})
    finally:
        settings.streamable_http_stateful = True
    await s.rpc("tools/list", path="/mcp")


def test_rpc_and_stateless_mcp_agree(loop, pair):
    if "text" not in pair["state"].get("port", {}):
        _both(loop, pair, _federate)
    _assert_same(_both(loop, pair, _rpc_methods))


PROMPT = {"name": "triage", "description": "Triage a log",
          "template": "Runbook:\n{{ runbook }}\nTeam: {{ team | default('ops') }}",
          "arguments": [{"name": "runbook", "required": True}, {"name": "team"}]}
RESOURCE = {"uri": "file:///logs/gw.txt", "name": "gw log", "mime_type": "text/plain",
            "content": TEXT}


async def _listen(s: Session, headers: dict, events: list, ready: asyncio.Event):
    """Collect the data events of the session's GET stream."""
    resp = await s.client.get("/mcp", headers=headers)
    ready.set()
    async for line in resp.content:
        if line.startswith(b"data: "):
            events.append(json.loads(line[6:]))


async def _catalog(s: Session):
    await _init(s)
    session = {**BASIC, "mcp-session-id": s.state["sid"]}
    events: list = []
    ready = asyncio.Event()
    reader = asyncio.ensure_future(_listen(s, session, events, ready))
    await asyncio.wait_for(ready.wait(), 10)
    made = await s.call("post", "/prompts", json=PROMPT, expect=201)
    s.state["prompt"] = made["id"]
    await s.call("post", "/prompts", json=PROMPT)
    await s.call("post", "/prompts", json={"name": "bad", "template": 3, "arguments": [
        {"description": "no name"}, 5, {"name": "x", "required": "maybe"}]})
    await s.call("post", "/prompts", json={"name": "broken", "template": "{{ x"})
    await s.call("post", "/prompts", json={"name": "escape", "template": "{{ ''.__class__ }}"})
    made = await s.call("post", "/resources", json=RESOURCE, expect=201)
    s.state["resource"] = made["id"]
    await s.call("post", "/resources", json=RESOURCE)
    await s.call("post", "/resources", json={"uri": 1, "is_binary": "x"})
    await s.call("post", "/resources", json={"uri": "file:///logs/{day}.txt", "name": "daily",
                                             "uri_template": "file:///logs/{day}.txt",
                                             "content": "daily log"}, expect=201)
    await s.call("post", "/resources", json={"uri": "mem://blob", "name": "blob",
                                             "is_binary": True, "content": "raw bytes"})
    await s.call("get", "/prompts")
    await s.call("get", "/resources")
    first = await s.call("get", "/resources?limit=2")
    await s.call("get", f"/resources?limit=2&cursor={first['next_cursor']}")
    await s.call("get", "/resources?cursor=!!")
    await s.call("get", "/prompts?limit=x")
    for rid, (path, headers) in enumerate((("/rpc", None), ("/mcp", session))):
        for method, params in (
                ("resources/list", {}), ("resources/templates/list", {}),
                ("resources/read", {"uri": RESOURCE["uri"]}),
                ("resources/read", {"uri": "file:///logs/2026-10-18.txt"}),
                ("resources/read", {"uri": "mem://blob"}),
                ("resources/read", {"uri": "file:///missing"}), ("resources/read", {}),
                ("resources/subscribe", {"uri": RESOURCE["uri"]}),
                ("resources/unsubscribe", {"uri": RESOURCE["uri"]}),
                ("prompts/list", {}),
                ("prompts/get", {"name": "triage", "arguments": {"runbook": "restart gw"}}),
                ("prompts/get", {"name": "triage", "arguments": {"runbook": "r", "team": "db"}}),
                ("prompts/get", {"name": "triage", "arguments": {"team": "db"}}),
                ("prompts/get", {"name": "escape"}), ("prompts/get", {"name": "nope"}),
                ("prompts/get", {})):
            await s.rpc(method, params, rid=rid, path=path, headers=headers)
    await s.call("post", "/resources/read", json={"uri": RESOURCE["uri"]})
    await s.call("post", "/resources/read", json={"uri": "file:///missing"})
    await s.call("post", "/prompts/triage/render", json={"runbook": "r"})
    await s.call("post", "/prompts/triage/render", data="not json")
    await s.call("post", "/prompts/nope/render", json={})
    await s.call("put", "/prompts/{prompt}", json={"description": "Triage", "arguments": [
        {"name": "runbook", "required": True}]})
    await s.call("put", "/prompts/{prompt}", json={"template": "{% if %}"})
    await s.call("put", "/prompts/missing", json={"description": "x"})
    await s.call("put", "/resources/{resource}", json={"content": "short", "tags": ["a"]})
    await s.call("put", "/resources/{resource}", json={"visibility": "x"})
    await s.call("get", "/prompts?include_inactive=true")
    await s.call("delete", "/prompts/{prompt}")
    await s.call("delete", "/prompts/{prompt}")
    await s.call("delete", "/resources/{resource}")
    await s.call("delete", "/resources/{resource}")
    await s.rpc("prompts/list")
    await s.rpc("resources/list")
    # nine writes went in: each broadcast one list_changed to the session
    for _ in range(500):
        if len(events) >= 9:
            break
        await asyncio.sleep(0.01)
    reader.cancel()
    s.log.append(("events", [e["method"] for e in events]))
    await s.call("delete", "/mcp", headers=session)


def test_resources_and_prompts_agree(loop, pair):
    """``/resources``, ``/prompts``, ``resources/*`` and ``prompts/*`` answer
    as the JAX gateway's: the same statuses, bodies and error codes, the
    same ``list_changed`` notifications on a stateful session."""
    logs = _both(loop, pair, _catalog)
    _assert_same(logs)
    prompts, resources = ("notifications/prompts/list_changed",
                          "notifications/resources/list_changed")
    assert ("events", [prompts] * 2 + [resources] * 3
            + [prompts, resources] * 2) in logs[1]


async def _prompt_to_sampling(s: Session):
    await s.call("post", "/resources", json={**RESOURCE, "uri": "file:///logs/sample.txt"},
                 expect=201)
    await s.call("post", "/prompts", json={**PROMPT, "name": "sampled"}, expect=201)
    before = await _stats(s)
    read = await s.rpc("resources/read", {"uri": "file:///logs/sample.txt"})
    text = read["result"]["contents"][0]["text"]
    got = await s.rpc("prompts/get", {"name": "sampled", "arguments": {"runbook": text}})
    await s.rpc("sampling/createMessage", {"messages": got["result"]["messages"],
                                           "maxTokens": 6}, rid=31)
    after = await _stats(s)
    s.log.append(("engine", after["requests"] - before["requests"],
                  after["completion_tokens"] - before["completion_tokens"]))


def test_prompt_to_sampling_agrees(loop, pair):
    """A resource's text rendered through ``prompts/get`` and sampled by
    ``sampling/createMessage``: the JAX app's greedy text, one engine
    request of six tokens in each."""
    logs = _both(loop, pair, _prompt_to_sampling)
    _assert_same(logs)
    assert logs[1][-2][3]["result"]["stopReason"] == "maxTokens"
    assert logs[1][-1] == ("engine", 1, 6)


def test_completion_and_sampling_take_the_none_fallbacks(loop, pair):
    """A dispatcher built without a completion service and a sampling
    handler answers as a JAX dispatcher built without them does."""
    from mcp_context_forge_tpu.gateway.rpc import RPCDispatcher as JaxDispatcher
    from mcp_context_forge_tpu.services.auth_service import AuthContext as JaxAuth
    from mcp_context_forge_tpu_torch.gateway.auth import AuthContext
    from mcp_context_forge_tpu_torch.gateway.rpc import RPCDispatcher
    from mcp_context_forge_tpu_torch.jsonrpc import JSONRPCError, RPCRequest

    ref, app = pair["clients"][0].app, pair["clients"][1].app
    bare = JaxDispatcher(ref["ctx"], ref["tool_service"], ref["resource_service"],
                         ref["prompt_service"], ref["server_service"])
    ours = RPCDispatcher(app["ctx"], app["tool_service"], app["resource_service"],
                         app["prompt_service"], app["server_service"])
    for rid, (method, params) in enumerate((("completion/complete", {"ref": {}}),
                                            ("sampling/createMessage", {"messages": []}))):
        message = {"jsonrpc": "2.0", "id": rid, "method": method, "params": params}
        try:
            want = _run(loop, bare.dispatch(jax_rpc.RPCRequest.parse(message),
                                            JaxAuth(user="admin@example.com", is_admin=True)))
        except jax_rpc.JSONRPCError as exc:
            want = exc.to_dict(rid)
        try:
            got = _run(loop, ours.dispatch(RPCRequest.parse(message),
                                           AuthContext(user="admin@example.com", is_admin=True)))
        except JSONRPCError as exc:
            got = exc.to_dict(rid)
        assert got == want


async def _completion(s: Session):
    await s.client.app["ctx"].db.execute(
        "INSERT INTO prompts (id, name, template, arguments, enabled, created_at, updated_at)"
        " VALUES (?,?,?,?,?,?,?)", ("p-ask", "ask", "Ask {topic}", json.dumps(
            [{"name": "topic", "suggestions": ["gateways", "galaxies", "tools"]}]), 1, 0, 0))
    for rid, params in enumerate((
            {"ref": {}}, {"ref": {"type": "ref/prompt", "name": "ask"},
                          "argument": {"name": "topic", "value": "ga"}},
            {"ref": {"type": "ref/resource"}, "argument": {"value": "file://"}})):
        await s.rpc("completion/complete", params, rid=rid)
        await s.rpc("completion/complete", params, rid=rid, path="/mcp",
                    headers={**BASIC, "mcp-session-id": s.state["sid"]})


def test_completion_agrees(loop, pair):
    """``completion/complete`` reaches the completion service in both."""
    _both(loop, pair, _init)
    logs = _both(loop, pair, _completion)
    _assert_same(logs)
    assert logs[1][2][3]["result"]["completion"]["values"] == ["gateways", "galaxies"]


async def _sampling(s: Session):
    before = await _stats(s)
    params = {"messages": [{"role": "user", "content": {"type": "text", "text": "Count to 3."}}],
              "systemPrompt": "Be brief.", "maxTokens": 6}
    await s.rpc("sampling/createMessage", params, rid=21)
    await s.rpc("sampling/createMessage", {**params, "maxTokens": 4}, rid=22, path="/mcp",
                headers={**BASIC, "mcp-session-id": s.state["sid"]})
    await s.rpc("sampling/createMessage", {"messages": []}, rid=23)
    after = await _stats(s)
    s.log.append(("engine", after["requests"] - before["requests"],
                  after["completion_tokens"] - before["completion_tokens"]))


def test_sampling_agrees(loop, pair):
    """``sampling/createMessage`` is served by each app's engine: the same
    greedy text, model and ``stopReason``."""
    _both(loop, pair, _init)
    logs = _both(loop, pair, _sampling)
    _assert_same(logs)
    assert logs[1][0][3]["result"]["stopReason"] == "maxTokens"
    assert logs[1][-1] == ("engine", 2, 10)


async def _stateful(s: Session):
    body = await s.rpc("initialize", {}, path="/mcp")
    sid = s.last_headers["mcp-session-id"]
    headers = {**BASIC, "mcp-session-id": sid}

    async def first_event():
        resp = await s.client.get("/mcp", headers=headers)
        assert resp.status == 200 and resp.headers["content-type"] == "text/event-stream"
        async for line in resp.content:
            if line.startswith(b"data: "):
                resp.close()
                return json.loads(line[6:])

    reader = asyncio.ensure_future(first_event())
    await asyncio.sleep(0.2)
    made = await s.call("post", "/tools", json={"name": "announced",
                                                "url": "http://127.0.0.1:9/none"}, expect=201)
    event = await asyncio.wait_for(reader, 10)
    s.log.append(("event", event))
    await s.rpc("tools/list", path="/mcp", headers=headers)
    await s.rpc("tools/list", path="/mcp")
    await s.rpc("ping", path="/mcp", headers={**BASIC, "mcp-session-id": "unknown"})
    await s.call("delete", "/mcp", headers=headers)
    await s.rpc("ping", path="/mcp", headers=headers)
    await s.call("get", "/mcp", headers=headers)
    await s.call("delete", f"/tools/{made['id']}")
    assert body["result"]["protocolVersion"] == "2025-06-18"


def test_stateful_session_agrees(loop, pair):
    logs = _both(loop, pair, _stateful)
    _assert_same(logs)
    assert ("event", {"jsonrpc": "2.0", "method": "notifications/tools/list_changed"}) in logs[1]


async def _refusals(s: Session):
    settings = s.client.app["ctx"].settings
    reader = _bearer(settings, ["tools.read"])
    for method, path in (("get", "/tools"), ("post", "/gateways"), ("get", "/servers"),
                         ("post", "/rpc"), ("post", "/mcp"), ("get", "/gateways/x")):
        await s.call(method, path, headers={}, json={"jsonrpc": "2.0", "id": 1, "method": "ping"})
    await s.call("get", "/.well-known/mcp", headers={})
    await s.call("get", "/tools", headers=reader)
    await s.call("post", "/tools", headers=reader, json={"name": "x"})
    await s.call("post", "/gateways", headers=reader, json={"name": "x", "url": "http://h"})
    await s.call("delete", "/servers/x", headers=reader)
    await s.rpc("tools/list", headers=reader)
    await s.rpc("tools/call", {"name": "word_count", "arguments": {"text": "a"}}, headers=reader)


def test_refusals_agree(loop, pair):
    _assert_same(_both(loop, pair, _refusals))


async def _init(s: Session):
    await s.rpc("initialize", {}, path="/mcp")
    s.state["sid"] = s.last_headers["mcp-session-id"]


# -- the summarizer over tools/call, and cancellation -----------------------------------


def _summarizer(app):
    return next(p for p in app["plugin_manager"].plugins if p.config.kind == "summarizer")


async def _stats(s: Session) -> dict:
    resp = await s.client.get("/admin/engine/stats", headers=BASIC)
    return await resp.json()


async def _summaries(s: Session):
    await s.call("post", "/plugins/bindings", expect=201, json={
        "plugin_name": "summarizer", "scope_type": "tool", "scope_id": "case",
        "config": SUMMARY})
    args = {"text": TEXT, "mode": "upper"}
    before = await _stats(s)
    first = await s.rpc("tools/call", {"name": "case", "arguments": args}, rid=11)
    cold = await _stats(s)
    _summarizer(s.client.app).config.config["max_tokens"] = 5
    await s.rpc("tools/call", {"name": "case", "arguments": args}, rid=12)
    hit = await _stats(s)
    _summarizer(s.client.app).config.config["max_tokens"] = 8
    again = await s.rpc("tools/call", {"name": "case", "arguments": args}, rid=13, path="/mcp",
                        headers={**BASIC, "mcp-session-id": s.state["sid"]})
    repeat = await _stats(s)
    await s.rpc("tools/call", {"name": "case", "arguments": {"text": "short", "mode": "upper"}})
    await s.rpc("tools/call", {"name": "word_count", "arguments": {"text": TEXT}})
    assert first["result"]["_summarized"] and again["result"] == first["result"]
    s.log.append(("engine", [cold["requests"] - before["requests"],
                             hit["requests"] - cold["requests"],
                             repeat["requests"] - hit["requests"],
                             cold["completion_tokens"] - before["completion_tokens"],
                             hit["prefix_cache"]["hit_tokens"]
                             - cold["prefix_cache"]["hit_tokens"]]))


def test_summarizer_over_tools_call_agrees(loop, pair):
    if "text" not in pair["state"].get("port", {}):
        _both(loop, pair, _federate)
    _both(loop, pair, _init)
    logs = _both(loop, pair, _summaries)
    _assert_same(logs)
    requests, tokens, hit_tokens = logs[1][-1][1][:3], logs[1][-1][1][3], logs[1][-1][1][4]
    assert requests == [1, 1, 0] and tokens == 8 and hit_tokens > 150


async def _cancel(s: Session):
    await s.call("post", "/plugins/bindings", expect=201, json={
        "plugin_name": "summarizer", "scope_type": "tool", "scope_id": "dedent_trim",
        "config": {**SUMMARY, "max_tokens": CANCEL_TOKENS}})
    before = await _stats(s)
    call = asyncio.ensure_future(s.rpc("tools/call", {
        "name": "dedent_trim", "arguments": {"text": TEXT + " tail"}}, rid=77))
    for _ in range(2000):
        if (await _stats(s))["requests"] > before["requests"]:
            break
        await asyncio.sleep(0.005)
    await s.call("post", "/rpc", json={"jsonrpc": "2.0", "method": "notifications/cancelled",
                                       "params": {"requestId": 77}})
    answer = await call
    for _ in range(2000):
        stats = await _stats(s)
        if stats["kv_pages_in_use"] == 0 and stats["queue_depth"] == 0 and \
                stats["completion_tokens"] - before["completion_tokens"] == CANCEL_TOKENS:
            break
        await asyncio.sleep(0.01)
    s.log.append(("drained", answer["error"]["code"], stats["kv_pages_in_use"],
                  stats["completion_tokens"] - before["completion_tokens"],
                  stats["requests"] - before["requests"]))


def test_cancelled_call_agrees(loop, pair):
    if "text" not in pair["state"].get("port", {}):
        _both(loop, pair, _federate)
    logs = _both(loop, pair, _cancel)
    _assert_same(logs)
    assert logs[1][-1] == ("drained", -32800, 0, CANCEL_TOKENS, 1)
