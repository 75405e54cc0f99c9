"""The port's /v1 app (``tpu_local/server.py`` ``build_llm_app``) against
the JAX gateway's /v1 surface, on the CPU. Both are built from the same
``load_settings(env=...)``; the port's engine serves the JAX engine's
weights (``params_from_jax``) and its provider the JAX provider's encoder
weights. They must agree on the model list, greedy completions and usage,
SSE streams, the error statuses (400, 422, 404, 503 with Retry-After
before and after the first-chunk window, the error event of a stream that
fails midway), embeddings and moderations. Also: ``EngineConfig
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


def both(loop, clients, method: str, path: str, **kwargs):
    """(status, headers, body text) of the same request to each app."""
    async def one(client, auth):
        resp = await client.request(method, path, auth=auth, **kwargs)
        return resp.status, resp.headers, await resp.text()

    ref, port = clients
    return _run(loop, one(ref, BASIC)), _run(loop, one(port, None))


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
    """What the card runs imports none of aiohttp, safetensors or
    tokenizers (the card has none of them): they load only with the
    server, or with a checkpoint that holds a tokenizer.json."""
    code = (
        "import sys\n"
        "import mcp_context_forge_tpu_torch.tpu_local.checkpoint\n"
        "import mcp_context_forge_tpu_torch.tpu_local.provider\n"
        "import mcp_context_forge_tpu_torch.tpu_local.tokenizer\n"
        "import mcp_context_forge_tpu_torch.tpu_local.engine\n"
        "import mcp_context_forge_tpu_torch.tpu_local.tpu_provider\n"
        "import mcp_context_forge_tpu_torch.gateway.serialize\n"
        "import mcp_context_forge_tpu_torch.gateway.flight_recorder\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('aiohttp', 'safetensors', 'tokenizers')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
