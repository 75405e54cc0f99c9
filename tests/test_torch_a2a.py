"""The port's A2A service and routes (``services/a2a_service.py``, the ``/a2a``
routes of ``gateway/routers_extra.py``) against the JAX gateway's, on the CPU:
a JAX ``build_app`` and the port's ``build_llm_app`` on llama3-test (f32, the
port's engine on the JAX engine's weights through ``params_from_jax``) answer
the same request sequences with the same statuses and bodies (ids and times
masked), and send a stub upstream the same requests:

- CRUD: register (201), a duplicate (409), bodies the schema refuses (422 in
  pydantic's layout), the ``a2a_max_agents`` cap (422), list, delete (204,
  then 404), and 401/403 without credentials or permission;
- every agent type: ``tpu_local`` through the engine (greedy tokens equal),
  ``openai`` and ``anthropic`` with their decrypted keys, ``jsonrpc`` and
  ``custom`` with the bearer header and the UAID hop one past the inbound
  one, the hop limit and an agent's error;
- the plugins' ``agent_pre_invoke``/``agent_post_invoke`` hooks;
- the task store: a task polled to completion, a failed one, lists by agent
  and of all, an agent literally named "tasks", cancelling a stalled task by
  the route and from a second service over the bus;
- an ``integration_type: "A2A"`` tool through ``tools/call``, answered by
  the engine."""

import asyncio
import dataclasses
import json
import re

import aiohttp
import jax
import pytest
import torch
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.plugins.framework import Plugin as JaxPlugin
from mcp_context_forge_tpu.plugins.framework import PluginConfig as JaxPluginConfig
from mcp_context_forge_tpu.services.a2a_service import A2AService as JaxA2AService
from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.plugins.framework import Plugin, PluginConfig
from mcp_context_forge_tpu_torch.services.a2a_service import A2AService
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models.configs import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app

ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "2",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "256",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "64",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64,256",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
}
BASIC = {"Authorization": aiohttp.BasicAuth("admin", "changeme").encode()}
HEX = re.compile(r"[0-9a-f]{32}")
RPC_ID = re.compile(r"[0-9a-f]{8}")   # message/send's request id
TIMES = {"created_at", "updated_at"}
RECORDED_HEADERS = ("authorization", "x-api-key", "anthropic-version", "x-contextforge-uaid-hop",
                    "content-type")
TERMINAL = {"completed", "failed", "cancelled"}


def _run(loop, coro, timeout: float = 180):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout))


class Upstream:
    """The agents' far end: OpenAI- and Anthropic-shaped chat, A2A
    ``message/send`` (an error for a text with "fail" in it) and a call that
    never answers; it records what each call carried."""

    def __init__(self):
        self.seen: list = []

    def app(self) -> web.Application:
        app = web.Application()

        async def record(request) -> dict:
            body = await request.json()
            self.seen.append((request.path, {h: request.headers.get(h) for h in RECORDED_HEADERS
                                             if h in request.headers}, body))
            return body

        async def openai(request):
            body = await record(request)
            return web.json_response({"choices": [{"message": {
                "content": f"openai:{body['model']}:{body['messages'][-1]['content']}"}}]})

        async def anthropic(request):
            body = await record(request)
            return web.json_response({"content": [
                {"type": "text", "text": f"anthropic:{body['max_tokens']}:"},
                {"type": "text", "text": body["messages"][-1]["content"]}]})

        async def rpc(request):
            body = await record(request)
            message = body["params"]["message"]
            if "fail" in json.dumps(message):
                return web.json_response({"jsonrpc": "2.0", "id": body["id"],
                                          "error": {"code": -32000, "message": "refused"}})
            return web.json_response({"jsonrpc": "2.0", "id": body["id"], "result": {
                "echo": message["parts"], "hop": request.headers["x-contextforge-uaid-hop"]}})

        async def stall(request):
            await record(request)
            await asyncio.sleep(60)
            return web.json_response({})

        app.router.add_post("/openai", openai)
        app.router.add_post("/anthropic", anthropic)
        app.router.add_post("/rpc", rpc)
        app.router.add_post("/stall", stall)
        return app


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


@pytest.fixture(scope="module")
def pair(loop):
    """(JAX gateway client, port app client) and the upstream's client."""
    settings = load_settings(env=ENV, env_file=None)
    jax_settings = jax_load_settings(env=ENV, env_file=None)
    upstream = Upstream()

    async def build():
        ref_app = await build_app(jax_settings)
        config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu")
        engine = TorchEngine(config, params=params_from_jax(
            jax.device_get(ref_app["tpu_engine"].params), MODEL_CONFIGS[config.model],
            device="cpu", dtype=torch.float32))
        clients = []
        for app in (ref_app, build_llm_app(settings, engine=engine), upstream.app()):
            client = TestClient(TestServer(app))
            await client.start_server()
            clients.append(client)
        return clients

    clients = _run(loop, build())
    yield {"clients": clients[:2], "upstream": upstream,
           "url": str(clients[2].make_url("")).rstrip("/")}
    for client in clients:
        _run(loop, client.close())


def _mask(value):
    if isinstance(value, (list, tuple)):
        return type(value)(_mask(v) for v in value)
    if isinstance(value, dict):
        return {k: ("<t>" if k in TIMES else "<id>" if k == "id" and isinstance(v, str)
                    and RPC_ID.fullmatch(v) else _mask(v)) for k, v in value.items()}
    if isinstance(value, str):
        return HEX.sub("<id>", value)
    return value


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
    """One request sequence against one app: ``call`` returns the body and
    logs (method, path, status, masked body)."""

    def __init__(self, client, package: str, upstream: Upstream, url: str):
        self.client, self.package, self.upstream, self.url = client, package, upstream, url
        self.log, self.state = [], {}

    async def call(self, method, path, headers=None, expect=None, **kwargs):
        path = path.format(**self.state)
        resp = await getattr(self.client, method)(path, headers=BASIC if headers is None
                                                  else headers, **kwargs)
        raw = await resp.read()
        body = json.loads(raw) if resp.content_type == "application/json" and raw else (
            raw.decode() if raw else None)
        self.log.append((method, HEX.sub("<id>", path), resp.status, _mask(_detail(body))))
        if expect is not None:
            assert resp.status == expect, (path, resp.status, body)
        return body

    async def task_until_done(self, task_id: str) -> dict:
        for _ in range(2000):
            resp = await self.client.get(f"/a2a/tasks/{task_id}", headers=BASIC)
            task = await resp.json()
            if task["state"] in TERMINAL:
                self.log.append(("task", _mask(task)))
                return task
            await asyncio.sleep(0.01)
        raise AssertionError(f"task {task_id} never ended")


def _both(loop, pair, script) -> list:
    out = []
    for client, package in zip(pair["clients"], ("jax", "port")):
        pair["upstream"].seen.clear()
        session = Session(client, package, pair["upstream"], pair["url"])
        _run(loop, script(session))
        out.append((session.log, _mask(pair["upstream"].seen)))
    assert out[1] == out[0]
    return out[1]


def _agents(url: str) -> list:
    return [
        {"name": "local", "endpoint_url": "local://engine", "agent_type": "tpu_local",
         "config": {"max_tokens": 6}, "tags": ["t"], "description": "the engine"},
        {"name": "Oai Agent", "endpoint_url": f"{url}/openai", "agent_type": "openai",
         "config": {"model": "m1", "max_tokens": 9}, "auth_value": {"api_key": "sk-1"}},
        {"name": "anth", "endpoint_url": f"{url}/anthropic", "agent_type": "anthropic",
         "auth_value": {"api_key": "ak-2"}},
        {"name": "rpc", "endpoint_url": f"{url}/rpc", "auth_type": "bearer",
         "auth_value": {"token": "tok-3"}},
        {"name": "custom", "endpoint_url": f"{url}/rpc", "agent_type": "custom",
         "visibility": "team", "team_id": "t1"},
        {"name": "stall", "endpoint_url": f"{url}/stall"},
        {"name": "tasks", "endpoint_url": f"{url}/rpc"},
    ]


def _bearer(settings, scopes: list) -> dict:
    return {"Authorization": "Bearer " + jax_jwt.create_token(
        {"sub": "ci@example.com", "scopes": scopes}, settings.jwt_secret_key,
        audience=settings.jwt_audience, issuer=settings.jwt_issuer)}


async def _crud(s: Session):
    for agent in _agents(s.url):
        made = await s.call("post", "/a2a", json=agent, expect=201)
        s.state[agent["name"].replace(" ", "_")] = made["id"]
    await s.call("post", "/a2a", json={"name": "rpc", "endpoint_url": "http://h"})
    await s.call("post", "/a2a", json={"name": "bad", "endpoint_url": "http://h",
                                       "agent_type": "grpc", "enabled": "maybe"})
    await s.call("post", "/a2a", json={"endpoint_url": 3, "capabilities": [], "tags": "x"})
    await s.call("post", "/a2a", json=["not", "an", "object"])
    await s.call("post", "/a2a", data=b"{oops")
    settings = s.client.app["ctx"].settings
    cap = settings.a2a_max_agents
    settings.a2a_max_agents = len(_agents(s.url))
    try:
        await s.call("post", "/a2a", json={"name": "one-more", "endpoint_url": "http://h"})
    finally:
        settings.a2a_max_agents = cap
    made = await s.call("post", "/a2a", json={"name": "gone", "endpoint_url": "http://h",
                                              "enabled": False}, expect=201)
    await s.call("get", "/a2a")
    await s.call("get", "/a2a?include_inactive=true")
    await s.call("delete", f"/a2a/{made['id']}")
    await s.call("delete", f"/a2a/{made['id']}")
    await s.call("get", "/a2a?include_inactive=true")
    reader = _bearer(settings, ["tools.read"])
    for method, path in (("get", "/a2a"), ("post", "/a2a"), ("delete", "/a2a/{rpc}"),
                         ("post", "/a2a/rpc/invoke"), ("post", "/a2a/rpc/tasks"),
                         ("get", "/a2a/tasks/x"), ("post", "/a2a/tasks/x/cancel")):
        await s.call(method, path, headers=reader, json={})
        await s.call(method, path, headers={}, json={})


async def _invocations(s: Session):
    engine = s.client.app["tpu_engine"]
    requests0 = engine.stats.requests
    await s.call("post", "/a2a/local/invoke", json={"message": "Name one MCP server."})
    await s.call("post", "/a2a/local/invoke", json={"messages": [
        {"role": "system", "content": "Be brief."}, {"role": "user", "content": "Hi"}]})
    s.log.append(("engine_requests", engine.stats.requests - requests0))
    await s.call("post", "/a2a/oai-agent/invoke", json={"message": {
        "role": "user", "parts": [{"kind": "text", "text": "a"}, {"text": "b"},
                                  {"kind": "file", "text": "c"}]}})
    await s.call("post", "/a2a/anth/invoke", json={"prompt": 42})
    await s.call("post", "/a2a/rpc/invoke", json={"message": "plain"})
    await s.call("post", "/a2a/rpc/invoke", json={"message": {"k": "v"}},
                 headers={**BASIC, "x-contextforge-uaid-hop": "2"})
    await s.call("post", "/a2a/rpc/invoke", json={"other": 1},
                 headers={**BASIC, "x-contextforge-uaid-hop": "3"})
    await s.call("post", "/a2a/rpc/invoke", json={"message": "x"},
                 headers={**BASIC, "x-contextforge-uaid-hop": "4"})
    await s.call("post", "/a2a/custom/invoke", json={"message": {
        "role": "user", "parts": [{"kind": "text", "text": "as is"}], "messageId": "m-1"}})
    await s.call("post", "/a2a/custom/invoke", json={"message": "please fail"})
    await s.call("post", "/a2a/missing/invoke", json={})
    await s.call("post", "/a2a/rpc/invoke", data=b"not json")


class _Tagger:
    """agent_pre_invoke rewrites the payload; agent_post_invoke wraps the
    result (the same class body for both packages' ``Plugin``)."""

    async def agent_pre_invoke(self, agent, payload, context):
        return {"message": f"[{agent}:{context.user}] {payload.get('message')}"}

    async def agent_post_invoke(self, agent, result, context):
        return {"tagged": agent, "result": result}


PLUGINS = {"jax": type("JaxTagger", (_Tagger, JaxPlugin), {}),
           "port": type("PortTagger", (_Tagger, Plugin), {})}
CONFIGS = {"jax": JaxPluginConfig, "port": PluginConfig}


async def _hooks(s: Session):
    pm = s.client.app["plugin_manager"]
    plugin = PLUGINS[s.package](CONFIGS[s.package](name="tagger", kind="tagger"),
                                s.client.app["ctx"])
    pm.plugins.append(plugin)
    pm._reindex()
    try:
        await s.call("post", "/a2a/rpc/invoke", json={"message": "hooked"})
    finally:
        pm.plugins.remove(plugin)
        pm._reindex()
    await s.call("post", "/a2a/rpc/invoke", json={"message": "unhooked"})


async def _tasks(s: Session):
    done = await s.call("post", "/a2a/rpc/tasks", json={"message": "in the background"},
                        expect=201)
    await s.task_until_done(done["id"])
    failed = await s.call("post", "/a2a/custom/tasks", json={"message": "fail me"}, expect=201)
    await s.task_until_done(failed["id"])
    named = await s.call("post", "/a2a/tasks/tasks", json={"message": "named"}, expect=201)
    await s.task_until_done(named["id"])
    await s.call("get", "/a2a/rpc/tasks")
    await s.call("get", "/a2a/tasks/tasks")
    await s.call("get", "/a2a/tasks/missing")
    await s.call("post", "/a2a/missing/tasks", json={})
    stalled = await s.call("post", "/a2a/stall/tasks", json={"message": "never"}, expect=201)
    while not [p for p, _, _ in s.upstream.seen if p == "/stall"]:
        await asyncio.sleep(0.01)
    await s.call("get", f"/a2a/tasks/{stalled['id']}")
    await s.call("post", f"/a2a/tasks/{stalled['id']}/cancel")
    await s.task_until_done(stalled["id"])
    await s.call("post", f"/a2a/tasks/{done['id']}/cancel")
    await s.call("post", "/a2a/tasks/missing/cancel")
    # a second service on the same bus cancels a run that the first owns
    other = {"jax": JaxA2AService, "port": A2AService}[s.package](s.client.app["ctx"])
    runs = s.client.app["a2a_service"]._task_runs
    remote = await s.call("post", "/a2a/stall/tasks", json={"message": "again"}, expect=201)
    while [p for p, _, _ in s.upstream.seen].count("/stall") < 2:
        await asyncio.sleep(0.01)
    run = runs[remote["id"]]
    cancelled = await other.cancel_task(remote["id"])
    await asyncio.sleep(0.05)
    s.log.append(("over_the_bus", _mask(cancelled), run.cancelled(), remote["id"] in runs))
    await s.call("get", "/a2a/tasks/tasks")


async def _a2a_tool(s: Session):
    engine = s.client.app["tpu_engine"]
    await s.call("post", "/tools", expect=201, json={
        "name": "ask_local", "integration_type": "A2A", "annotations": {"a2a_agent": "local"}})
    await s.call("post", "/tools", expect=201, json={"name": "rpc", "integration_type": "A2A"})
    await s.call("post", "/tools", expect=201, json={
        "name": "ghost", "integration_type": "A2A", "annotations": {"a2a_agent": "nobody"}})
    requests0 = engine.stats.requests
    for rid, (name, arguments) in enumerate((
            ("ask_local", {"role": "user", "parts": [{"kind": "text", "text": "Status?"}]}),
            ("rpc", {"q": 1}), ("ghost", {}))):
        await s.call("post", "/rpc", json={"jsonrpc": "2.0", "id": rid, "method": "tools/call",
                                           "params": {"name": name, "arguments": arguments}})
    s.log.append(("engine_requests", engine.stats.requests - requests0))


def _setup(loop, pair):
    if not pair.get("registered"):
        _both(loop, pair, _crud)
        pair["registered"] = True


def test_crud_and_refusals_agree(loop, pair):
    log, _ = _both(loop, pair, _crud)
    pair["registered"] = True
    statuses = [entry[2] for entry in log]
    assert statuses[:7] == [201] * 7 and statuses[7:13] == [409, 422, 422, 422, 422, 422]
    assert [d for d in log[8][3]["detail"] if "literal" in d] == [
        "  Input should be 'jsonrpc', 'openai', 'anthropic', 'custom' or 'tpu_local'"
        "|literal_error"]


def test_agent_types_agree(loop, pair):
    _setup(loop, pair)
    log, seen = _both(loop, pair, _invocations)
    assert ("engine_requests", 2) in log
    hops = [headers.get("x-contextforge-uaid-hop") for path, headers, _ in seen
            if path == "/rpc"]
    assert hops == ["1", "3", "4", "1", "1", "1"]
    assert seen[0][1]["authorization"] == "Bearer sk-1" and seen[1][1]["x-api-key"] == "ak-2"
    assert [entry[2] for entry in log if entry[0] == "post"][-4:] == [200, 422, 404, 200]


def test_plugin_hooks_agree(loop, pair):
    _setup(loop, pair)
    log, seen = _both(loop, pair, _hooks)
    assert log[0][3]["tagged"] == "rpc" and "tagged" not in log[1][3]
    assert seen[0][2]["params"]["message"]["parts"][0]["text"] == \
        "[rpc:admin@example.com] hooked"


def test_task_store_agrees(loop, pair):
    _setup(loop, pair)
    log, _ = _both(loop, pair, _tasks)
    tasks = [entry[1] for entry in log if entry[0] == "task"]
    assert [t["state"] for t in tasks] == ["completed", "failed", "completed", "cancelled"]
    assert tasks[1]["error"] == "ValidationFailure: Agent error: {'code': -32000, 'message': " \
                                "'refused'}"
    assert [entry for entry in log if entry[0] == "over_the_bus"][0][2:] == (True, False)


def test_a2a_tool_agrees(loop, pair):
    _setup(loop, pair)
    log, seen = _both(loop, pair, _a2a_tool)
    assert log[-1] == ("engine_requests", 1)
    answered = log[3][3]["result"]
    assert answered["isError"] is False and json.loads(
        answered["content"][0]["text"])["message"]["role"] == "agent"
