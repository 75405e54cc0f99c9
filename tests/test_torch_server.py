"""The port's /v1 app (``tpu_local/server.py`` ``build_llm_app``) against
the JAX gateway's /v1 surface, on the CPU. Both are built from the same
``load_settings(env=...)``; the port's engine serves the JAX engine's
weights (``params_from_jax``) and its provider the JAX provider's encoder
weights. They must agree on the model list, greedy completions and usage,
SSE streams, the error statuses (400, 422, 404, 503 with Retry-After
before and after the first-chunk window, the error event of a stream that
fails midway), embeddings and moderations, each sent with the same Basic
credentials to both, and a 401 from each without credentials. Also: ``EngineConfig
.from_settings`` field by field, and the port's modules that run on the
card import none of aiohttp, safetensors or tokenizers."""

import asyncio
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import aiohttp
import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mcp_context_forge_tpu.config import load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.tpu_local import provider as jax_provider
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu_torch.tpu_local import provider as port_provider
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import (encoder_params_from_jax,
                                                                  params_from_jax)
from mcp_context_forge_tpu_torch.tpu_local.roofline import (H100_HBM_GBPS,
                                                            H100_PEAK_BF16_TFLOPS)
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

ROOT = Path(__file__).resolve().parents[1]
BASIC = aiohttp.BasicAuth("admin", "changeme")
TOL = 1e-5
ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_ENABLED": "true",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "4",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "128",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "64",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
    # short, so that a stub can outlast it cheaply
    "MCPFORGE_GW_STREAM_FIRST_CHUNK_WAIT_S": "0.2",
}


@pytest.fixture(scope="module")
def loop():
    """One event loop for the module: a provider's batcher queue binds to
    the loop that first waits on it."""
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def _run(loop, coro):
    return loop.run_until_complete(asyncio.wait_for(coro, 120))


def stub(errors, mode: str):
    """A provider of ``errors``' module (its LLMError/LLMUnavailable) that
    fails: ``unknown`` raises LLMError, ``refuse`` LLMUnavailable at once,
    ``late`` LLMUnavailable after the first-chunk window, ``midway`` a
    RuntimeError after one chunk."""
    class Stub(errors.LLMProvider):
        name = f"stub-{mode}"

        async def chat(self, request):
            if mode == "unknown":
                raise errors.LLMError("no such deployment")
            raise errors.LLMUnavailable("capacity gone", retry_after_s=3)

        async def chat_stream(self, request):
            if mode == "late":
                await asyncio.sleep(0.5)
            if mode == "midway":
                yield {"id": "chatcmpl-stub", "object": "chat.completion.chunk",
                       "created": 0, "model": request["model"],
                       "choices": [{"index": 0, "delta": {"content": "half"},
                                    "finish_reason": None}]}
                raise RuntimeError("engine lost")
            await self.chat(request)
            yield {}

    return Stub()


@pytest.fixture(scope="module")
def clients(loop):
    """(JAX gateway client, port app client), each registry also holding
    the failing stubs under ``stub-<mode>``."""
    settings = load_settings(env=ENV, env_file=None)

    async def build():
        ref_app = await build_app(settings)
        ref_engine, ref_prov = ref_app["tpu_engine"], ref_app["tpu_provider"]
        config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu")
        engine = TorchEngine(config, params=params_from_jax(
            jax.device_get(ref_engine.params), MODEL_CONFIGS[config.model],
            device="cpu", dtype=torch.float32))
        app = build_llm_app(settings, engine=engine)
        app["tpu_provider"].encoder_params = encoder_params_from_jax(
            jax.device_get(ref_prov.encoder_params), app["tpu_provider"].encoder_config,
            device="cpu")
        for registry, errors in ((ref_app["llm_registry"], jax_provider),
                                 (app["llm_registry"], port_provider)):
            for mode in ("unknown", "refuse", "late", "midway"):
                registry.register(stub(errors, mode), [f"stub-{mode}"])
        out = []
        for one in (ref_app, app):
            client = TestClient(TestServer(one))
            await client.start_server()
            out.append(client)
        return out

    pair = _run(loop, build())
    yield pair
    for client in pair:
        _run(loop, client.close())


def both(loop, clients, method: str, path: str, auth=BASIC, **kwargs):
    """(status, headers, body text) of the same request, with the same
    credentials, to each app."""
    async def one(client):
        resp = await client.request(method, path, auth=auth, **kwargs)
        return resp.status, resp.headers, await resp.text()

    ref, port = clients
    return _run(loop, one(ref)), _run(loop, one(port))


@pytest.mark.parametrize("method,path", [
    ("GET", "/v1/models"), ("POST", "/v1/chat/completions"),
    ("POST", "/v1/embeddings"), ("POST", "/v1/moderations"),
])
def test_no_credentials_is_401(loop, clients, method, path):
    """``auth_required`` is on by default: a request without credentials is
    refused by both apps before any handler runs."""
    ref, port = both(loop, clients, method, path, auth=None,
                     json={"messages": [{"role": "user", "content": "x"}]})
    assert ref[0] == port[0] == 401
    for _, headers, _ in (ref, port):
        assert headers["www-authenticate"] == "Bearer"
    assert json.loads(port[2]) == json.loads(ref[2]) == {"detail": "Authentication required"}


def test_models(loop, clients):
    ref, port = both(loop, clients, "GET", "/v1/models")
    assert ref[0] == port[0] == 200
    ids = [[m["id"] for m in json.loads(body)["data"]] for _, _, body in (ref, port)]
    assert "llama3-test" in ids[1] and "tpu_local" in ids[1]
    assert ids[1] == ids[0]


@pytest.mark.parametrize("content", ["hello", "tell me about the gateway"])
def test_chat_completion(loop, clients, content):
    request = {"model": "llama3-test", "max_tokens": 8,
               "messages": [{"role": "user", "content": content}]}
    ref, port = both(loop, clients, "POST", "/v1/chat/completions", json=request)
    assert ref[0] == port[0] == 200, (ref[2], port[2])
    want, got = json.loads(ref[2]), json.loads(port[2])
    assert got["object"] == "chat.completion"
    assert got["choices"] == want["choices"]
    assert got["usage"] == want["usage"] and got["usage"]["completion_tokens"] >= 1


def sse_frames(body: str) -> list[str]:
    return [line[6:] for line in body.splitlines() if line.startswith("data: ")]


def test_chat_stream(loop, clients):
    request = {"model": "llama3-test", "max_tokens": 8, "stream": True,
               "messages": [{"role": "user", "content": "stream me"}]}
    ref, port = both(loop, clients, "POST", "/v1/chat/completions", json=request)
    assert ref[0] == port[0] == 200
    for status, headers, body in (ref, port):
        assert headers["content-type"].startswith("text/event-stream")
        assert "X-Queue-Depth" in headers
        assert body.endswith("data: [DONE]\n\n")

    def deltas(body):
        chunks = [json.loads(f) for f in sse_frames(body)[:-1]]
        text = "".join(c["choices"][0]["delta"].get("content") or "" for c in chunks)
        return text, chunks[-1]["choices"][0]["finish_reason"]

    assert deltas(port[2]) == deltas(ref[2])


@pytest.mark.parametrize("path,kwargs,status", [
    ("/v1/chat/completions", {"data": b"{not json"}, 400),
    ("/v1/chat/completions", {"json": {"messages": []}}, 422),
    ("/v1/chat/completions", {"json": {"model": "stub-unknown",
                                       "messages": [{"role": "user", "content": "x"}]}}, 404),
    ("/v1/embeddings", {"data": b"{not json"}, 400),
    ("/v1/embeddings", {"json": {"input": [1, 2]}}, 422),
    ("/v1/moderations", {"data": b"["}, 400),
])
def test_error_statuses(loop, clients, path, kwargs, status):
    ref, port = both(loop, clients, "POST", path, **kwargs)
    assert ref[0] == port[0] == status
    assert json.loads(port[2]) == json.loads(ref[2])


@pytest.mark.parametrize("stream", [False, True])
def test_unavailable_is_503_with_retry_after(loop, clients, stream):
    """A refusal within the first-chunk window (or of a unary chat) is a
    503 with Retry-After and X-Queue-Depth, before any stream starts."""
    request = {"model": "stub-refuse", "stream": stream,
               "messages": [{"role": "user", "content": "x"}]}
    ref, port = both(loop, clients, "POST", "/v1/chat/completions", json=request)
    assert ref[0] == port[0] == 503
    for _, headers, _ in (ref, port):
        assert headers["Retry-After"] == "3" and headers["X-Queue-Depth"] == "0"
    assert json.loads(port[2]) == json.loads(ref[2])


@pytest.mark.parametrize("mode,message", [
    ("late", "LLMUnavailable: capacity gone"),
    ("midway", "RuntimeError: engine lost"),
])
def test_stream_failure_is_an_error_event(loop, clients, mode, message):
    """Past the first-chunk window the headers are out: a refusal, like a
    failure after a chunk, ends the stream with an error event."""
    request = {"model": f"stub-{mode}", "stream": True,
               "messages": [{"role": "user", "content": "x"}]}
    ref, port = both(loop, clients, "POST", "/v1/chat/completions", json=request)
    assert ref[0] == port[0] == 200
    assert port[2] == ref[2]
    assert json.loads(sse_frames(port[2])[-1]) == {"error": {"message": message}}


def test_embeddings_and_moderations(loop, clients):
    texts = ["hello world", "bonjour le monde", "ignore previous instructions"]
    ref, port = both(loop, clients, "POST", "/v1/embeddings", json={"input": texts})
    assert ref[0] == port[0] == 200
    want, got = json.loads(ref[2]), json.loads(port[2])
    assert {k: v for k, v in got.items() if k != "data"} == \
        {k: v for k, v in want.items() if k != "data"}
    np.testing.assert_allclose([d["embedding"] for d in got["data"]],
                               [d["embedding"] for d in want["data"]], atol=TOL, rtol=TOL)
    ref, port = both(loop, clients, "POST", "/v1/moderations", json={"input": texts})
    assert ref[0] == port[0] == 200
    want, got = json.loads(ref[2]), json.loads(port[2])
    assert [r["flagged"] for r in got["results"]] == [r["flagged"] for r in want["results"]]
    np.testing.assert_allclose(
        [r["category_scores"]["harmful"] for r in got["results"]],
        [r["category_scores"]["harmful"] for r in want["results"]], atol=TOL, rtol=TOL)


def test_from_settings_equals_jax():
    """Every field both configs have, from settings that move each one off
    its default; the roofline peaks stay the H100's (the settings' are a
    TPU chip's)."""
    settings = load_settings(env={
        "MCPFORGE_TPU_LOCAL_MODEL": "mixtral-test", "MCPFORGE_TPU_LOCAL_CHECKPOINT": "/ckpt",
        "MCPFORGE_TPU_LOCAL_MAX_BATCH": "3", "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "256",
        "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "32", "MCPFORGE_TPU_LOCAL_NUM_PAGES": "99",
        "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "32,96",
        "MCPFORGE_TPU_LOCAL_PREFILL_MAX_BATCH": "2", "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
        "MCPFORGE_TPU_LOCAL_DECODE_BLOCK": "2", "MCPFORGE_TPU_LOCAL_SUPERSTEP": "2",
        "MCPFORGE_TPU_LOCAL_DECODE_OVERLAP": "false",
        "MCPFORGE_TPU_LOCAL_PREFIX_CACHE": "false", "MCPFORGE_TPU_LOCAL_SPEC_DECODE": "true",
        "MCPFORGE_TPU_LOCAL_SPEC_K": "5", "MCPFORGE_TPU_LOCAL_SPEC_NGRAM": "3",
        "MCPFORGE_TPU_LOCAL_QUANT": "int8", "MCPFORGE_TPU_LOCAL_KV_QUANT": "int8",
        "MCPFORGE_TPU_LOCAL_MOE_IMPL": "grouped", "MCPFORGE_TPU_LOCAL_BATCH_BUCKETS": "true",
        "MCPFORGE_TPU_LOCAL_MAX_QUEUE": "17", "MCPFORGE_TPU_LOCAL_AUTO_RESTART": "true",
        "MCPFORGE_TPU_LOCAL_AUTO_RESTART_MAX": "5", "MCPFORGE_TPU_LOCAL_STEP_LOG_SIZE": "9",
        "MCPFORGE_TPU_LOCAL_STEP_SAMPLE_EVERY": "4",
        "MCPFORGE_TPU_LOCAL_COST_ANALYSIS": "false",
        "MCPFORGE_CONTROLLER_ENABLED": "true", "MCPFORGE_CONTROLLER_K_LADDER": "1,4",
    }, env_file=None)
    port, ref = EngineConfig.from_settings(settings), JaxConfig.from_settings(settings)
    port_fields = {f.name for f in dataclasses.fields(EngineConfig)}
    common = port_fields & {f.name for f in dataclasses.fields(JaxConfig)}
    peaks = {"peak_tflops_per_chip", "hbm_gbps_per_chip"}
    assert port_fields - common == {"device", "seed"}
    for name in sorted(common - peaks):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.k_ladder == (1, 4) and port.spec_k == 5 and port.checkpoint == "/ckpt"
    assert (port.peak_tflops_per_chip, port.hbm_gbps_per_chip) == \
        (H100_PEAK_BF16_TFLOPS, H100_HBM_GBPS)
    assert (port.device, port.seed) == ("cuda", 0)


def test_card_modules_import_no_server_packages():
    """What the card runs (admission, the controller, the signal bus and
    the fault plane included) imports none of aiohttp, safetensors or
    tokenizers (the card has none of them): they load only with the
    server and its middlewares, or with a checkpoint that holds a
    tokenizer.json."""
    code = (
        "import sys\n"
        "import mcp_context_forge_tpu_torch.tpu_local.checkpoint\n"
        "import mcp_context_forge_tpu_torch.tpu_local.provider\n"
        "import mcp_context_forge_tpu_torch.tpu_local.tokenizer\n"
        "import mcp_context_forge_tpu_torch.tpu_local.engine\n"
        "import mcp_context_forge_tpu_torch.tpu_local.tpu_provider\n"
        "import mcp_context_forge_tpu_torch.gateway.serialize\n"
        "import mcp_context_forge_tpu_torch.gateway.flight_recorder\n"
        "import mcp_context_forge_tpu_torch.gateway.auth\n"
        "import mcp_context_forge_tpu_torch.utils.jwt\n"
        "import mcp_context_forge_tpu_torch.observability.phases\n"
        "import mcp_context_forge_tpu_torch.observability.tracing\n"
        "import mcp_context_forge_tpu_torch.observability.degradation\n"
        "import mcp_context_forge_tpu_torch.observability.signals\n"
        "import mcp_context_forge_tpu_torch.observability.faults\n"
        "import mcp_context_forge_tpu_torch.tpu_local.controller\n"
        "import mcp_context_forge_tpu_torch.coordination.hub\n"
        "import mcp_context_forge_tpu_torch.coordination.rpc\n"
        "import mcp_context_forge_tpu_torch.coordination.kv\n"
        "import mcp_context_forge_tpu_torch.coordination.heartbeat\n"
        "import mcp_context_forge_tpu_torch.tpu_local.pool_rpc\n"
        "import mcp_context_forge_tpu_torch.tpu_local.kv.fabric.publisher\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('aiohttp', 'safetensors', 'tokenizers')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


# ------------------------------------------------ the fabric routes, the plane

def test_fabric_adverts_routes_answer_like_the_gateway(loop, clients):
    """``GET /admin/fabric/adverts`` gives the publisher's counters and the
    store (none: no tiers) as the JAX gateway does, the host (a worker id)
    aside; ``POST`` without an object tier is the same 404."""
    ref, port = both(loop, clients, "GET", "/admin/fabric/adverts")
    assert ref[0] == port[0] == 200
    want, got = json.loads(ref[2]), json.loads(port[2])
    assert got.pop("host") and want.pop("host")
    assert got == want
    assert got["store"] is None and got["bus"] is True and got["sent"] == 0
    for body in ({"adverts": []}, {"nope": 1}):
        ref, port = both(loop, clients, "POST", "/admin/fabric/adverts", json=body)
        assert ref[0] == port[0] == 404
        assert json.loads(port[2]) == json.loads(ref[2])
    ref, port = both(loop, clients, "GET", "/admin/fabric/adverts", auth=None)
    assert ref[0] == port[0] == 401


@pytest.fixture(scope="module")
def plane_apps(loop, clients):
    """Two port apps with ``tpu_local_pool_shared`` over one bus and one
    lease table: the owner, given an engine on the JAX weights, elected
    first; the other, given none, whose own build (a CUDA engine from the
    settings) fails on this box, so that it only forwards."""
    from mcp_context_forge_tpu_torch.coordination.bus import MemoryEventBus
    from mcp_context_forge_tpu_torch.coordination.leases import MemoryLeaseManager

    settings = load_settings(env={**ENV, "MCPFORGE_TPU_LOCAL_POOL_SHARED": "true",
                                  "MCPFORGE_LEADER_LEASE_TTL": "3"}, env_file=None)
    bus, leases = MemoryEventBus(), MemoryLeaseManager()
    params = clients[1].app["tpu_engine"].params
    config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu")
    owner = build_llm_app(settings, engine=TorchEngine(config, params=params), bus=bus,
                          leases=leases, worker_id="owner")
    other = build_llm_app(settings, bus=bus, leases=leases, worker_id="other")

    async def start():
        out = []
        for app in (owner, other):
            client = TestClient(TestServer(app))
            await client.start_server()
            out.append(client)
            while app is owner and not app["engine_plane"].ready_local:
                await asyncio.sleep(0.01)
        return out

    pair = _run(loop, start())
    yield pair
    for client in pair:
        if not client._closed:
            _run(loop, client.close())


@pytest.mark.parametrize("stream", [False, True])
def test_non_owner_answers_the_owners_content(loop, clients, plane_apps, stream):
    """The non-owner's /v1/chat/completions forwards to the owner: the
    content (unary, or streamed as SSE) is the JAX gateway's and the
    owner's own."""
    request = {"model": "llama3-test", "max_tokens": 8, "stream": stream,
               "messages": [{"role": "user", "content": "hello"}]}
    owner, other = plane_apps
    assert other.app["tpu_engine"] is None and other.app["engine_plane"].ready_local is False

    async def ask(client):
        resp = await client.post("/v1/chat/completions", json=request, auth=BASIC)
        return resp.status, await resp.text()

    want = _run(loop, ask(clients[0]))
    answers = [_run(loop, ask(c)) for c in (other, owner)]
    assert want[0] == answers[0][0] == answers[1][0] == 200

    def content(body):
        if not stream:
            return json.loads(body)["choices"][0]["message"]["content"]
        return "".join(json.loads(f)["choices"][0]["delta"].get("content") or ""
                       for f in sse_frames(body)[:-1])

    assert content(answers[0][1]) == content(answers[1][1]) == content(want[1])


def test_no_owner_is_503_with_retry_after(loop, plane_apps):
    """Once the owner's app has stopped (its lease released), the other
    worker, which cannot build, answers 503 with Retry-After."""
    owner, other = plane_apps
    _run(loop, owner.close())
    request = {"model": "llama3-test", "max_tokens": 4,
               "messages": [{"role": "user", "content": "hello"}]}

    async def ask():
        resp = await other.post("/v1/chat/completions", json=request, auth=BASIC)
        return resp.status, resp.headers, await resp.json()

    status, headers, body = _run(loop, ask())
    assert status == 503 and headers["Retry-After"] == "1"
    assert body["error"]["type"] == "overloaded_error" and body["error"]["retry_after_s"] == 1
    assert "owner" in body["error"]["message"] or "not built" in body["error"]["message"]
    # the other worker tried to build (a CUDA engine from the settings) and
    # failed each time: it never served
    assert other.app["engine_plane"].build_failures >= 1
    assert not other.app["engine_plane"].ready_local


def test_apps_share_a_tcp_hub_from_settings(loop, clients):
    """``bus_backend=tcp``: one app hosts the hub (``bus_tcp_serve``), the
    other connects to it, both with the settings' secret; the second
    app's chat is served by the first's engine over the hub."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**ENV, "MCPFORGE_TPU_LOCAL_POOL_SHARED": "true", "MCPFORGE_LEADER_LEASE_TTL": "3",
           "MCPFORGE_BUS_BACKEND": "tcp", "MCPFORGE_BUS_TCP_PORT": str(port),
           "MCPFORGE_BUS_TCP_SECRET": "hub-secret"}
    hosting = load_settings(env={**env, "MCPFORGE_BUS_TCP_SERVE": "true"}, env_file=None)
    joining = load_settings(env=env, env_file=None)
    params = clients[1].app["tpu_engine"].params
    config = dataclasses.replace(EngineConfig.from_settings(hosting), device="cpu")
    owner = build_llm_app(hosting, engine=TorchEngine(config, params=params))
    other = build_llm_app(joining)
    request = {"model": "llama3-test", "max_tokens": 6,
               "messages": [{"role": "user", "content": "over the hub"}]}

    async def main():
        started = []
        try:
            for app in (owner, other):
                client = TestClient(TestServer(app))
                await client.start_server()
                started.append(client)
                while app is owner and not app["engine_plane"].ready_local:
                    await asyncio.sleep(0.01)
            answers = []
            for client in reversed(started):
                resp = await client.post("/v1/chat/completions", json=request, auth=BASIC)
                answers.append((resp.status, (await resp.json())["choices"]))
            return answers, owner["coordination_hub"].bound_port
        finally:
            for client in reversed(started):
                await client.close()

    (forwarded, local), bound = _run(loop, main())
    assert bound == port and other["coordination_hub"] is None
    assert forwarded == local and forwarded[0] == 200
