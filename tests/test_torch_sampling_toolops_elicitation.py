"""The port's sampling, completion, toolops and elicitation
(``services/sampling_service.py``, ``services/toolops_service.py``,
``services/elicitation_service.py`` and their routes) against the JAX
gateway's, on the CPU: a JAX ``build_app`` (its engine off: the replies come
from a scripted registry put into both apps) and the port's ``build_llm_app``
(stateful streamable HTTP) answer the same request sequences with the same
statuses and bodies (ids and times masked), exactly:

- ``sampling/createMessage`` over ``/rpc`` and a stateful ``/mcp`` session:
  the registry's refusal, missing messages, a bad ``maxTokens``, the chat
  request the handler builds (system prompt, content shapes) and
  ``stopReason`` for each finish reason;
- ``completion/complete`` over prompt and resource rows inserted into both
  databases alike (suggestions by prefix, disabled rows, the 20-row cap);
- ``generate_cases`` over seeded schemas, every ``max_cases``;
- ``GET /toolops/{name}/cases`` (with the registry's lines as cases) and
  ``POST /toolops/{name}/run`` against a REST tool, with their refusals;
- ``POST /sessions/{session_id}/elicit``: an answer read off the session's
  GET stream and POSTed back (accept, then an error), a reply forged on
  another session (ignored: the timeout answers), a session with no stream
  open, the 422 timeouts, an unknown session (404) and a session that
  another worker owns (409)."""

import asyncio
import json
import re

import aiohttp
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.services.toolops_service import generate_cases as jax_generate_cases
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.services.toolops_service import generate_cases
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app

ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_ENABLED": "false",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "2",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "128",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "16",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64,128",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
    "MCPFORGE_STREAMABLE_HTTP_STATEFUL": "true",
}
BASIC = {"Authorization": aiohttp.BasicAuth("admin", "changeme").encode()}
HEX = re.compile(r"[0-9a-f]{32}|elicit-[0-9a-f]{12}")
TIMES = {"created_at", "updated_at"}
SCHEMA = {"type": "object", "required": ["text", "count"], "properties": {
    "text": {"type": "string"}, "count": {"type": "integer", "default": 2},
    "mode": {"type": "string", "enum": ["upper", "lower"]}, "ratio": {"type": "number"},
    "flag": {"type": "boolean"}, "items": {"type": "array"}, "meta": {"type": "object"},
    "blob": {"type": "binary"}}}


def _run(loop, coro, timeout: float = 120):
    return loop.run_until_complete(asyncio.wait_for(coro, timeout))


class ScriptedChat:
    """``chat`` answers from a script of (content, finish_reason), in turn."""

    def __init__(self, script):
        self.script, self.requests = list(script), []

    async def chat(self, request):
        self.requests.append(request)
        content, finish = self.script.pop(0)
        return {"model": "scripted-m", "choices": [{
            "index": 0, "message": {"role": "assistant", "content": content},
            "finish_reason": finish}]}

    async def shutdown(self):
        return None


def _upstream() -> web.Application:
    """A REST tool's far end: ``text`` must be a string, ``count`` an int."""
    app = web.Application()

    async def echo(request):
        args = await request.json()
        if not isinstance(args.get("text"), str) or not isinstance(args.get("count"), int):
            return web.json_response({"error": "bad arguments"}, status=400)
        return web.json_response({"echo": args["text"][:8], "count": args["count"]})

    app.router.add_post("/echo", echo)
    return app


@pytest.fixture(scope="module")
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


@pytest.fixture(scope="module")
def pair(loop):
    async def build():
        apps = (await build_app(jax_load_settings(env=ENV, env_file=None)),
                build_llm_app(load_settings(env=ENV, env_file=None), device="cpu"), _upstream())
        clients = []
        for app in apps:
            client = TestClient(TestServer(app))
            await client.start_server()
            clients.append(client)
        return clients

    clients = _run(loop, build())
    yield {"clients": clients[:2], "url": str(clients[2].make_url("/echo"))}
    for client in clients:
        _run(loop, client.close())


def _mask(value):
    if isinstance(value, (list, tuple)):
        return type(value)(_mask(v) for v in value)
    if isinstance(value, dict):
        return {k: ("<t>" if k in TIMES else _mask(v)) for k, v in value.items()}
    if isinstance(value, str):
        return HEX.sub("<id>", value)
    return value


class Session:
    def __init__(self, client, url: str):
        self.client, self.url, self.log = client, url, []

    async def call(self, method, path, headers=None, **kwargs):
        resp = await getattr(self.client, method)(path, headers=BASIC if headers is None
                                                  else headers, **kwargs)
        raw = await resp.read()
        body = json.loads(raw) if resp.content_type == "application/json" and raw else (
            raw.decode() if raw else None)
        self.log.append((method, HEX.sub("<id>", path), resp.status, _mask(body)))
        self.headers = resp.headers
        return body

    async def rpc(self, method, params, rid=1, path="/rpc", headers=None):
        return await self.call("post", path, headers=headers, json={
            "jsonrpc": "2.0", "id": rid, "method": method, "params": params})

    async def initialize(self) -> dict:
        await self.rpc("initialize", {}, path="/mcp")
        return {**BASIC, "mcp-session-id": self.headers["mcp-session-id"]}


def _both(loop, pair, script) -> list:
    logs = []
    for client in pair["clients"]:
        session = Session(client, pair["url"])
        _run(loop, script(session))
        logs.append(session.log)
    assert logs[1] == logs[0]
    return logs[1]


# -- sampling and completion ---------------------------------------------------------------

SAMPLES = [
    {"messages": [{"role": "user", "content": {"type": "text", "text": "Hi"}}]},
    {"messages": [{"content": "plain string"}, {"role": "assistant", "content": {}}],
     "systemPrompt": "Be brief.", "maxTokens": "7", "temperature": 0.5},
    {"messages": [{"role": "user", "content": {"type": "image", "data": "x"}}],
     "maxTokens": 3},
]


async def _sampling(s: Session):
    ctx = s.client.app["ctx"]
    registry = ctx.llm_registry
    ctx.llm_registry = None
    try:
        await s.rpc("sampling/createMessage", SAMPLES[0])
    finally:
        ctx.llm_registry = ScriptedChat([("one", "stop"), ("two", "length"), ("three", None),
                                         ("four", "stop")])
    try:
        for rid, params in enumerate(SAMPLES):
            await s.rpc("sampling/createMessage", params, rid=rid)
        await s.rpc("sampling/createMessage", {"messages": []})
        await s.rpc("sampling/createMessage", {})
        await s.rpc("sampling/createMessage", {**SAMPLES[0], "maxTokens": "many"})
        session = await s.initialize()
        await s.rpc("sampling/createMessage", SAMPLES[0], rid=9, path="/mcp", headers=session)
        s.log.append(("requests", ctx.llm_registry.requests))
    finally:
        ctx.llm_registry = registry


def test_sampling_agrees(loop, pair):
    log = _both(loop, pair, _sampling)
    results = [entry[3].get("result") for entry in log[:-1] if entry[0] == "post"]
    assert [r["stopReason"] for r in results if r and "stopReason" in r] == [
        "endTurn", "maxTokens", "maxTokens", "endTurn"]
    assert log[0][3]["error"]["message"] == "Sampling unavailable: tpu_local engine disabled"
    assert log[-1][1][1]["messages"][0] == {"role": "system", "content": "Be brief."}


PROMPTS = [("greet", 1, [{"name": "who", "suggestions": ["alice", "albert", "bob", 7]},
                         {"name": "tone", "suggestions": ["warm"]}]),
           ("off", 0, [{"name": "who", "suggestions": ["alice"]}]),
           ("bare", 1, None)]


async def _completion(s: Session):
    db = s.client.app["ctx"].db
    for i, (name, enabled, arguments) in enumerate(PROMPTS):
        await db.execute(
            "INSERT INTO prompts (id, name, template, arguments, enabled, created_at,"
            " updated_at) VALUES (?,?,?,?,?,?,?)",
            (f"p{i}", name, "t", json.dumps(arguments) if arguments else None, enabled, 0, 0))
    for i in range(24):
        await db.execute(
            "INSERT INTO resources (id, uri, name, enabled, created_at, updated_at)"
            " VALUES (?,?,?,?,?,?)",
            (f"r{i}", f"file:///logs/{i:02d}.txt", f"r{i}", int(i != 3), 0, 0))
    for rid, params in enumerate((
            {"ref": {"type": "ref/prompt", "name": "greet"},
             "argument": {"name": "who", "value": "al"}},
            {"ref": {"type": "ref/prompt", "name": "greet"}, "argument": {"name": "who"}},
            {"ref": {"type": "ref/prompt", "name": "greet"},
             "argument": {"name": "nope", "value": ""}},
            {"ref": {"type": "ref/prompt", "name": "off"}, "argument": {"name": "who"}},
            {"ref": {"type": "ref/prompt", "name": "bare"}, "argument": {"name": "who"}},
            {"ref": {"type": "ref/resource"}, "argument": {"value": "file:///logs/0"}},
            {"ref": {"type": "ref/resource"}, "argument": {"value": "file:///"}},
            {"ref": {"type": "ref/other"}}, {})):
        await s.rpc("completion/complete", params, rid=rid)


def test_completion_agrees(loop, pair):
    log = _both(loop, pair, _completion)
    first = log[0][3]["result"]["completion"]
    assert first == {"values": ["alice", "albert"], "total": 2, "hasMore": False}
    assert log[6][3]["result"]["completion"]["total"] == 20


# -- toolops -------------------------------------------------------------------------------


def _schema(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    kinds = ["string", "integer", "number", "boolean", "array", "object", "null"]
    properties = {}
    for i in range(int(rng.integers(0, 7))):
        spec = {"type": kinds[int(rng.integers(len(kinds)))]}
        if rng.random() < 0.2:
            spec["enum"] = [f"e{int(rng.integers(9))}", "z"]
        if rng.random() < 0.2:
            spec["default"] = int(rng.integers(100))
        properties[f"f{i}"] = spec
    required = [k for k in properties if rng.random() < 0.5] + (["ghost"] if seed % 3 == 0 else [])
    return {"type": "object", "properties": properties, "required": required}


@pytest.mark.parametrize("seed", range(8))
def test_generate_cases_agree(seed):
    schema = _schema(seed)
    for max_cases in (1, 2, 3, 5, 24, 100):
        assert generate_cases(schema, max_cases) == jax_generate_cases(schema, max_cases)
    assert generate_cases({}) == jax_generate_cases({})


async def _toolops(s: Session):
    await s.call("post", "/tools", json={"name": "echo", "url": s.url, "input_schema": SCHEMA})
    await s.call("post", "/tools", json={"name": "dark", "url": s.url, "enabled": False})
    await s.call("get", "/toolops/echo/cases")
    ctx = s.client.app["ctx"]
    registry = ctx.llm_registry
    ctx.llm_registry = ScriptedChat([
        ('{"text": "hello", "count": 1}\nnot json\n[1, 2]\n{"text": 5}', "stop"),
        ("{}", "stop")])
    try:
        await s.call("get", "/toolops/echo/cases?use_llm=true")
        ctx.llm_registry.chat = None   # a registry that fails: the cases stand alone
        await s.call("get", "/toolops/echo/cases?use_llm=true")
    finally:
        ctx.llm_registry = registry
    await s.call("get", "/toolops/dark/cases")
    await s.call("get", "/toolops/missing/cases")
    await s.call("post", "/toolops/echo/run", json={"cases": [
        {"name": "good", "arguments": {"text": "a", "count": 3}},
        {"arguments": {"text": "a"}, "expect": "error"},
        {"arguments": {"text": "a"}}]})
    await s.call("post", "/toolops/echo/run")
    await s.call("post", "/toolops/echo/run", json={"cases": [{"name": "x"}]})
    await s.call("post", "/toolops/echo/run", json={"cases": "all"})
    await s.call("post", "/toolops/echo/run", json=[1])
    await s.call("post", "/toolops/missing/run", json={})
    await s.call("get", "/toolops/echo/cases", headers={})


def test_toolops_agrees(loop, pair):
    log = _both(loop, pair, _toolops)
    cases = log[2][3]["cases"]
    assert cases == _mask(generate_cases(SCHEMA))
    llm = [c for c in log[3][3]["cases"] if c["name"].startswith("llm-")]
    # 23 schema cases: the first object line fills max_cases (24)
    assert llm == [{"name": "llm-0", "arguments": {"text": "hello", "count": 1}, "expect": "ok"}]
    assert log[7][3]["passed"] == 2 and log[7][3]["total"] == 3
    assert [entry[2] for entry in log[8:]] == [200, 422, 422, 422, 404, 401]


# -- elicitation ---------------------------------------------------------------------------


async def _elicitation(s: Session):
    app = s.client.app
    session = await s.initialize()
    other = await s.initialize()
    stream = await s.client.get("/mcp", headers=session)

    async def next_request() -> dict:
        while True:
            line = await asyncio.wait_for(stream.content.readline(), 10)
            if line.startswith(b"data: "):
                return json.loads(line[6:])

    async def ask(body: dict, answer) -> None:
        call = asyncio.ensure_future(s.call("post", f"/sessions/{session['mcp-session-id']}/elicit",
                                            json=body))
        request = await next_request()
        s.log.append(("pushed", _mask(request)))
        if answer is not None:
            headers = other if answer == "forged" else session
            reply = {"jsonrpc": "2.0", "id": request["id"],
                     **({"error": {"code": -1, "message": "declined"}} if answer == "error"
                        else {"result": {"action": "accept", "content": {"name": "Ada"}}})}
            await s.call("post", "/mcp", headers=headers, json=reply)
        await call

    await ask({"message": "Your name?", "requestedSchema": {
        "type": "object", "properties": {"name": {"type": "string"}}}}, "accept")
    await ask({"message": "Again?", "timeout": 5}, "error")
    await ask({"message": "Forged?", "timeout": 1}, "forged")
    stream.close()
    # initialized, but no stream open: queued, then the timeout answers
    await s.call("post", f"/sessions/{other['mcp-session-id']}/elicit",
                 json={"message": "Anyone?", "timeout": 0.2})
    for timeout in ("soon", "nan", "inf", None):
        await s.call("post", f"/sessions/{session['mcp-session-id']}/elicit",
                     json={"message": "x", "timeout": timeout})
    await s.call("post", "/sessions/unknown/elicit", json={"message": "x"})
    ctx = app["ctx"]
    await ctx.leases.acquire("session-owner:elsewhere", "another-worker", 60)
    await s.call("post", "/sessions/elsewhere/elicit", json={"message": "x"})
    await ctx.leases.release("session-owner:elsewhere", "another-worker")
    await s.call("post", "/sessions/unknown/elicit", headers={}, json={"message": "x"})
    s.log.append(("pending", app["elicitation_service"].pending_count))


def test_elicitation_agrees(loop, pair):
    log = _both(loop, pair, _elicitation)
    answers = [entry[3] for entry in log if entry[0] == "post" and "/elicit" in entry[1]]
    assert answers[:4] == [{"action": "accept", "content": {"name": "Ada"}},
                           {"action": "cancel", "error": {"code": -1, "message": "declined"}},
                           {"action": "cancel", "reason": "timeout"},
                           {"action": "cancel", "reason": "timeout"}]
    statuses = [entry[2] for entry in log if entry[0] == "post" and "/elicit" in entry[1]]
    assert statuses[4:] == [422, 422, 422, 422, 404, 409, 401]
    assert log[-1] == ("pending", 0)
