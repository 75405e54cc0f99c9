"""The port's chat agent (``services/chat_service.py``, ``gateway/routers_chat.py``)
against the JAX package's, on the CPU, exactly:

- scripted turns (one parametrised test): each package's ``ChatService`` is
  fed the same OpenAI streaming chunks by a scripted registry and the same
  stub tool and server services; the events, the stored session, the
  registry's requests (messages and the offered tools), the tool calls made
  and the ``llmchat.turn`` span's attributes are equal. The cases: indexed
  argument fragments, an index-less continuation, an index-less fragment
  with a new id, sparse indices, parallel calls (run concurrently in both),
  ``max_steps`` exhaustion, a tool error with unparsable arguments, an
  observation past 4000 characters, ``server_id`` scoping and the usage
  carried to the answer;
- a session started on one worker continues on another over one hub's KV
  (each package's ``TcpKVStore``, in both directions);
- one real turn: a JAX ``build_app`` and the port's ``build_llm_app`` on
  llama3-test (f32, the port's engine on the JAX engine's weights through
  ``params_from_jax``) stream equal SSE events over ``/llmchat`` (greedy
  tokens equal) and store equal sessions;
- the ``/llmchat`` routes answer alike: 201, 401, 403, 404, 422 (no
  registry), 204 and the non-streaming ``{"events"}`` body."""

import asyncio
import dataclasses
import json
import re
from types import SimpleNamespace

import aiohttp
import jax
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.coordination.hub import HubClient as JaxHubClient
from mcp_context_forge_tpu.coordination.kv import TcpKVStore as JaxTcpKVStore
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.services.chat_service import ChatService as JaxChatService
from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.coordination.hub import CoordinationHub, HubClient
from mcp_context_forge_tpu_torch.coordination.kv import TcpKVStore
from mcp_context_forge_tpu_torch.services.chat_service import ChatService
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models.configs import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app

PACKAGES = {"jax": JaxChatService, "port": ChatService}
HEX = re.compile(r"[0-9a-f]{32}")
BASIC = {"Authorization": aiohttp.BasicAuth("admin", "changeme").encode()}
ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "2",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "256",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "160",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64,256",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
}
# a real turn decodes until eos or the context's end: with no tools in the
# catalog its prompt is 192 tokens, the most that leaves the 512-token
# budget cut to the context's last quarter (64 tokens) untruncated
TURN = "Status of node-07, now?"


def _run(loop, coro, timeout: float = 180):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout))


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


# -- scripted turns -------------------------------------------------------------


class ScriptedRegistry:
    """Yields pre-baked OpenAI streaming chunks, one script per step."""

    def __init__(self, scripts):
        self._scripts = iter(scripts)
        self.requests = []

    async def chat_stream(self, request):
        self.requests.append(json.loads(json.dumps(request)))
        for chunk in next(self._scripts):
            yield chunk


class StubTools:
    """The tool service's ``list_tools``/``invoke_tool``; records calls and
    how many ran at once."""

    def __init__(self, delay: float = 0.0):
        self.delay, self.active, self.max_active, self.calls = delay, 0, 0, []

    async def list_tools(self, team_ids=None):
        return [SimpleNamespace(name="lookup", description="Lookup",
                                input_schema={"type": "object"}),
                SimpleNamespace(name="other", description=None, input_schema=None)]

    async def invoke_tool(self, name, arguments, user=None):
        self.calls.append((name, arguments, user))
        self.active += 1
        self.max_active = max(self.max_active, self.active)
        try:
            await asyncio.sleep(self.delay)
            if name == "broken":
                raise RuntimeError("upstream refused")
            if name == "long":
                return {"content": [{"type": "text", "text": "x" * 4500},
                                    {"type": "image", "data": "?"}]}
            return {"content": [{"type": "text", "text": f"result:{arguments.get('q')}"},
                                {"type": "text", "text": "second part"}]}
        finally:
            self.active -= 1


class StubServers:
    async def server_tool_names(self, server_id):
        return ["lookup"] if server_id == "s1" else []


class RecordingTracer:
    def __init__(self):
        self.spans = []

    def span(self, name, attributes):
        tracer = self

        class _Span:
            def __enter__(self):
                self.record = {"name": name, **attributes}
                tracer.spans.append(self.record)
                return self

            def __exit__(self, *exc):
                return False

            def set_attribute(self, key, value):
                self.record[key] = value

        return _Span()


def _ctx(registry, tracer, max_steps=3):
    return SimpleNamespace(llm_registry=registry, tracer=tracer,
                           settings=SimpleNamespace(llmchat_max_steps=max_steps))


def _calls_turn(*deltas):
    return ([{"choices": [{"delta": {"tool_calls": d}, "finish_reason": None}]} for d in deltas]
            + [{"choices": [{"delta": {}, "finish_reason": "tool_calls"}]}])


def _answer(*texts, usage=None):
    chunks = [{"choices": [{"delta": {"content": t}, "finish_reason": None}]} for t in texts]
    last = {"choices": [{"delta": {}, "finish_reason": "stop"}]}
    if usage:
        last["usage"] = usage
    return chunks + [last]


def _call(i, name, args, index=True):
    frag = {"id": f"call_{i}", "type": "function",
            "function": {"name": name, "arguments": json.dumps(args)}}
    if index:
        frag["index"] = i
    return frag


CASES = {
    "indexed_fragments": dict(scripts=[
        _calls_turn([{"index": 0, "id": "call_0", "type": "function",
                      "function": {"name": "lookup", "arguments": '{"q": "sp'}}],
                    [{"index": 0, "function": {"arguments": 'lit"}'}}]),
        _answer("done")]),
    "indexless_continuation": dict(scripts=[
        _calls_turn([{"index": 0, "id": "call_0", "type": "function",
                      "function": {"name": "lookup", "arguments": '{"q": "a'}}],
                    [{"function": {"arguments": 'b"}'}}]),
        _answer("ok")]),
    "indexless_new_id": dict(scripts=[
        _calls_turn([_call(0, "lookup", {"q": "a"}, index=False)],
                    [_call(1, "lookup", {"q": "b"}, index=False)]),
        _answer("both")]),
    "sparse_indices": dict(scripts=[
        _calls_turn([_call(0, "lookup", {"q": "a"}), {**_call(2, "lookup", {"q": "c"})}],
                    [{"id": "call_new", "type": "function",
                      "function": {"name": "lookup", "arguments": '{"q": "n"}'}}]),
        _answer("three")]),
    "parallel_calls": dict(delay=0.05, scripts=[
        _calls_turn([_call(i, "lookup", {"q": q}) for i, q in enumerate("abc")]),
        _answer("Hel", "lo ", "there")]),
    "max_steps": dict(max_steps=2, scripts=[
        _calls_turn([_call(0, "lookup", {"q": "1"})]),
        _calls_turn([_call(0, "lookup", {"q": "2"})])]),
    "tool_error": dict(scripts=[
        [{"choices": [{"delta": {"content": "checking", "tool_calls": [
            {"index": 0, "id": "call_e", "type": "function",
             "function": {"name": "broken", "arguments": "{not json"}}]}}]}],
        _answer("it failed")]),
    "long_observation": dict(scripts=[
        _calls_turn([_call(0, "long", {})]), _answer("long one")]),
    "server_scope": dict(server_id="s1", scripts=[_answer("scoped")]),
    "usage": dict(scripts=[_answer("a", "b", usage={"prompt_tokens": 5,
                                                       "completion_tokens": 2})]),
}


async def _scripted_turn(cls, case: dict) -> dict:
    registry = ScriptedRegistry(case["scripts"])
    tools, tracer = StubTools(case.get("delay", 0.0)), RecordingTracer()
    service = cls(_ctx(registry, tracer), tools, StubServers())
    session = await service.connect("u@x", model="m", server_id=case.get("server_id"),
                                    max_steps=case.get("max_steps"))
    events = [e async for e in service.chat(session.id, "u@x", "go", auth_teams=["t"])]
    stored = dataclasses.asdict(await service.get_session(session.id, "u@x"))
    for key in ("id", "created", "last_used"):
        stored.pop(key)
    for span in tracer.spans:
        span["session"] = "<sid>"
    return {"events": events, "stored": stored, "requests": registry.requests,
            "calls": tools.calls, "spans": tracer.spans, "max_active": tools.max_active}


@pytest.mark.parametrize("name", sorted(CASES))
def test_scripted_turn_agrees(loop, name):
    case = CASES[name]
    jax_out, port_out = (_run(loop, _scripted_turn(cls, case)) for cls in PACKAGES.values())
    for key in ("events", "stored", "requests", "calls", "spans", "max_active"):
        assert port_out[key] == jax_out[key], key
    kinds = [e["type"] for e in port_out["events"]]
    if name == "parallel_calls":
        # three 50 ms calls at once, not one after another (the overlap is
        # counted; the wall would depend on the host's load)
        assert port_out["max_active"] == 3
        assert [m["tool_call_id"] for m in port_out["stored"]["messages"]
                if m["role"] == "tool"] == ["call_0", "call_1", "call_2"]
    if name == "max_steps":
        assert kinds[-1] == "error" and port_out["spans"][0]["llm.steps"] == 2
    if name == "sparse_indices":
        assert sorted(c[1]["q"] for c in port_out["calls"]) == ["a", "c", "n"]
    if name == "tool_error":
        assert port_out["calls"] == [("broken", {}, "u@x")]
        assert port_out["stored"]["messages"][2]["content"].startswith("ERROR: RuntimeError")
    if name == "long_observation":
        assert len(port_out["stored"]["messages"][2]["content"]) == 4000
        assert len(port_out["events"][1]["text"]) == 500
    if name == "server_scope":
        assert [t["function"]["name"] for t in port_out["requests"][0]["tools"]] == ["lookup"]


async def _two_workers(first, second, hub_port: int) -> tuple:
    """A turn on ``first`` (a package name), the next on ``second``, over one hub."""
    clients = {"jax": JaxHubClient("127.0.0.1", hub_port), "port": HubClient("127.0.0.1", hub_port)}
    kvs = {"jax": JaxTcpKVStore(clients["jax"]), "port": TcpKVStore(clients["port"])}
    for client in clients.values():
        await client.start()
    try:
        tools = StubTools()
        reg_a = ScriptedRegistry([_answer("Oslo is in Norway.")])
        reg_b = ScriptedRegistry([_calls_turn([_call(0, "lookup", {"q": "oslo"})]),
                                  _answer("Population 700k.")])
        worker_a = PACKAGES[first](_ctx(reg_a, RecordingTracer()), tools, None, kv=kvs[first])
        worker_b = PACKAGES[second](_ctx(reg_b, RecordingTracer()), tools, None, kv=kvs[second])
        session = await worker_a.connect("u@x")
        one = [e async for e in worker_a.chat(session.id, "u@x", "Where is Oslo?")]
        two = [e async for e in worker_b.chat(session.id, "u@x", "How many people?")]
        stored = await worker_b.get_session(session.id, "u@x")
        sent = [m.get("content") for m in reg_b.requests[0]["messages"]]
        return one, two, stored.messages, sent
    finally:
        for client in clients.values():
            await client.stop()


def test_session_continues_on_another_worker_over_the_hub(loop):
    hub = CoordinationHub("127.0.0.1", 0)
    _run(loop, hub.start())
    try:
        outs = [_run(loop, _two_workers(a, b, hub.bound_port))
                for a, b in (("jax", "port"), ("port", "jax"), ("port", "port"))]
    finally:
        _run(loop, hub.stop())
    for one, two, messages, sent in outs:
        assert (one, two, messages, sent) == outs[0]
    one, two, messages, sent = outs[0]
    assert [e["type"] for e in two] == ["tool_call", "tool_result", "token", "answer"]
    assert "Oslo is in Norway." in sent
    assert [m.get("content") for m in messages][-1] == "Population 700k."


# -- the gateway pair ------------------------------------------------------------


@pytest.fixture(scope="module")
def pair(loop):
    settings = load_settings(env=ENV, env_file=None)
    jax_settings = jax_load_settings(env=ENV, env_file=None)

    async def build():
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
        return clients

    clients = _run(loop, build())
    yield clients
    for client in clients:
        _run(loop, client.close())


def _sse_events(raw: bytes) -> list:
    lines = raw.decode().splitlines()
    assert lines[-2:] == ["data: [DONE]", ""] or lines[-1] == "data: [DONE]"
    return [json.loads(line[6:]) for line in lines
            if line.startswith("data: ") and line != "data: [DONE]"]


async def _real_turn(client) -> dict:
    app = client.app
    resp = await client.post("/llmchat/connect", headers=BASIC, json={})
    sid = (await resp.json())["session_id"]
    resp = await client.post(f"/llmchat/{sid}/chat", headers=BASIC,
                             json={"message": TURN, "stream": True})
    assert resp.status == 200 and resp.headers["content-type"] == "text/event-stream"
    events = _sse_events(await resp.read())
    stats = await (await client.get("/admin/engine/stats", headers=BASIC)).json()
    session = await app["chat_service"].get_session(sid, "admin@example.com")
    return {"events": events, "messages": session.messages,
            "tokens": (stats["requests"], stats["prompt_tokens"], stats["completion_tokens"])}


def test_real_turn_agrees(loop, pair):
    jax_out, port_out = (_run(loop, _real_turn(client), timeout=300) for client in pair)
    assert port_out == jax_out
    events = port_out["events"]
    assert events[-1]["type"] == "answer" and events[-1]["text"] == "".join(
        e["text"] for e in events if e["type"] == "token")
    assert port_out["tokens"] == (1, 192, 64)
    assert [m["role"] for m in port_out["messages"]] == ["user", "assistant"]


def _bearer(settings, scopes: list) -> dict:
    return {"Authorization": "Bearer " + jax_jwt.create_token(
        {"sub": "ci@example.com", "scopes": scopes}, settings.jwt_secret_key,
        audience=settings.jwt_audience, issuer=settings.jwt_issuer)}


async def _routes(client) -> list:
    app, log = client.app, []
    reader = _bearer(app["ctx"].settings, ["tools.read"])

    async def call(method, path, headers=None, **kwargs):
        resp = await getattr(client, method)(path, headers=BASIC if headers is None else headers,
                                             **kwargs)
        raw = await resp.read()
        body = json.loads(raw) if resp.content_type == "application/json" and raw else (
            raw.decode() if raw else None)
        log.append((method, HEX.sub("<id>", path), resp.status,
                    HEX.sub("<id>", json.dumps(body, sort_keys=True))))
        return body

    sid = (await call("post", "/llmchat/connect", json={"max_steps": 2, "model": "m"}))["session_id"]
    await call("post", "/llmchat/connect", data=b"not json")
    await call("post", "/llmchat/connect", headers={}, json={})
    await call("post", "/llmchat/connect", headers=reader, json={})
    await call("post", f"/llmchat/{sid}/chat", headers=reader, json={"message": "x"})
    await call("post", "/llmchat/missing/chat", json={"message": "x"})
    registry = app["ctx"].llm_registry
    app["ctx"].llm_registry = None
    try:
        await call("post", f"/llmchat/{sid}/chat", json={"message": "x"})
    finally:
        app["ctx"].llm_registry = ScriptedRegistry([_answer("Hel", "lo"), _answer("sse")])
    try:
        await call("post", f"/llmchat/{sid}/chat", json={"message": "x", "stream": False})
        resp = await client.post(f"/llmchat/{sid}/chat", headers=BASIC, json={"message": "y"})
        log.append(("sse", resp.status, _sse_events(await resp.read())))
    finally:
        app["ctx"].llm_registry = registry
    await call("delete", f"/llmchat/{sid}")
    await call("delete", f"/llmchat/{sid}")
    await call("post", f"/llmchat/{sid}/chat", json={"message": "x"})
    return log


def test_llmchat_routes_agree(loop, pair):
    jax_log, port_log = (_run(loop, _routes(client)) for client in pair)
    assert port_log == jax_log
    assert [entry[2] if entry[0] != "sse" else entry[1] for entry in port_log] == [
        201, 201, 401, 403, 403, 404, 422, 200, 200, 204, 204, 404]
