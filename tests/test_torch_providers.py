"""The port's outbound providers (``OpenAICompatProvider`` and every
``DialectProvider`` family) against the JAX package's, on the CPU: a stub
upstream on localhost records the method, path, query, headers and body
each package sends for the same OpenAI request, and answers both with the
same canned reply, unary or streamed (SSE, ndjson, AWS event-stream frames),
errors and early closes included. The records are equal, and so are the
OpenAI dicts each package translates the replies into (their random ids and
clocks aside), or the errors they raise; the AWS event-stream codec
(``utils/eventstream.py``) encodes and decodes as the JAX one does, across
any chunking, and refuses the same corrupt input. Exact equality."""

import asyncio
import json

import httpx
import pytest
from aiohttp import web
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu.tpu_local import provider as jax_provider
from mcp_context_forge_tpu_torch.tpu_local import provider as port_provider
from mcp_context_forge_tpu_torch.utils.eventstream import encode_frame

REQUEST = {"model": "m1", "max_tokens": 16, "temperature": 0.3,
           "messages": [{"role": "system", "content": "Be brief."},
                        {"role": "user", "content": "Hi"},
                        {"role": "assistant", "content": "Hello."},
                        {"role": "user", "content": "List two tools."}]}
CONFIGS = {"azure_openai": {"deployment": "dep", "api_version": "2024-06-01"},
           "anthropic": {"anthropic_version": "2023-06-01"}, "ollama": {}, "bedrock": {},
           "google_vertex": {"project": "proj", "location": "europe-west4"},
           "watsonx": {"project_id": "pid", "api_version": "2024-05-31"}}
HEADERS = ("content-type", "authorization", "api-key", "x-api-key", "anthropic-version")


def _sse(events: list) -> bytes:
    return b"".join(f"data: {json.dumps(e) if not isinstance(e, str) else e}\n\n".encode()
                    for e in events)


def _openai_chunk(text=None, finish=None) -> dict:
    delta = {"role": "assistant", "content": text} if text else {}
    return {"id": "up-1", "object": "chat.completion.chunk", "created": 1,
            "choices": [{"index": 0, "delta": delta, "finish_reason": finish}]}


OPENAI_REPLY = {"id": "up-1", "object": "chat.completion", "created": 1,
                "choices": [{"index": 0, "message": {"role": "assistant", "content": "ok"},
                             "finish_reason": "stop"}],
                "usage": {"prompt_tokens": 3, "completion_tokens": 1, "total_tokens": 4}}
UNARY = {
    "openai": OPENAI_REPLY, "azure_openai": OPENAI_REPLY, "watsonx": OPENAI_REPLY,
    "anthropic": {"content": [{"type": "text", "text": "Hel"}, {"type": "tool_use"},
                              {"type": "text", "text": "lo"}],
                  "usage": {"input_tokens": 5, "output_tokens": 2}, "stop_reason": "max_tokens"},
    "ollama": {"message": {"content": "hi"}, "prompt_eval_count": 3, "eval_count": 4,
               "done": True},
    "bedrock": {"output": {"message": {"content": [{"text": "a"}, {"text": "b"}]}},
                "usage": {"inputTokens": 2, "outputTokens": 3}, "stopReason": "end_turn"},
    "google_vertex": {"candidates": [{"content": {"parts": [{"text": "x"}, {"text": "y"}]},
                                      "finishReason": "MAX_TOKENS"}],
                      "usageMetadata": {"promptTokenCount": 1, "candidatesTokenCount": 2}},
}


def _bedrock_frames(events: list) -> bytes:
    out = b""
    for event_type, payload, message_type in events:
        headers = {":message-type": message_type}
        if message_type == "exception":
            headers[":exception-type"] = event_type
        else:
            headers[":event-type"] = event_type
        out += encode_frame(headers, json.dumps(payload).encode())
    return out


# (content type, body) per family and stream case
STREAMS = {
    ("azure_openai", "ok"): ("text/event-stream", _sse(
        [_openai_chunk("He"), ": comment", _openai_chunk("y"), _openai_chunk(None, "stop"),
         "[DONE]"])),
    ("watsonx", "ok"): ("text/event-stream", _sse(
        [_openai_chunk("a"), _openai_chunk(None, "length"), "[DONE]"])),
    ("watsonx", "early_close"): ("text/event-stream", _sse([_openai_chunk("a")])),
    ("anthropic", "ok"): ("text/event-stream", b"event: message_start\n" + _sse(
        [{"type": "message_start"}, {"type": "content_block_delta", "delta": {"text": "Hi"}},
         {"type": "content_block_delta", "delta": {"text": " there"}},
         {"type": "message_delta", "delta": {"stop_reason": "max_tokens"}},
         {"type": "message_stop"}])),
    ("anthropic", "early_close"): ("text/event-stream", _sse(
        [{"type": "content_block_delta", "delta": {"text": "cut"}}])),
    ("anthropic", "error"): ("text/event-stream", _sse(
        [{"type": "content_block_delta", "delta": {"text": "x"}},
         {"type": "error", "error": {"type": "overloaded_error"}}])),
    ("ollama", "ok"): ("application/x-ndjson", b"".join(
        json.dumps(e).encode() + b"\n" for e in
        [{"message": {"content": "o"}}, {"message": {"content": ""}},
         {"message": {"content": "k"}}, {"done": True, "done_reason": "length"}])),
    ("ollama", "error"): ("application/x-ndjson", b'{"message": {"content": "a"}}\n'
                          b'{"error": "model not found"}\n'),
    ("bedrock", "ok"): ("application/vnd.amazon.eventstream", _bedrock_frames(
        [("messageStart", {"role": "assistant"}, "event"),
         ("contentBlockDelta", {"delta": {"text": "be"}}, "event"),
         ("contentBlockDelta", {"delta": {"text": "d"}}, "event"),
         ("messageStop", {"stopReason": "max_tokens"}, "event")])),
    ("bedrock", "error"): ("application/vnd.amazon.eventstream", _bedrock_frames(
        [("contentBlockDelta", {"delta": {"text": "be"}}, "event"),
         ("throttlingException", {"message": "slow down"}, "exception")])),
    ("google_vertex", "ok"): ("text/event-stream", _sse(
        [{"candidates": [{"content": {"parts": [{"text": "v1"}]}}]},
         {"candidates": [{"content": {"parts": [{"text": "v2"}]},
                          "finishReason": "MAX_TOKENS"}]}])),
    ("google_vertex", "early_close"): ("text/event-stream", _sse(
        [{"candidates": [{"content": {"parts": [{"text": "v1"}]}}]}, "[DONE]"])),
}


def _make(module, family: str, base: str):
    if family == "openai":
        return module.OpenAICompatProvider("up", base, api_key="k")
    return module.DialectProvider("up", family, api_base=base, api_key="k",
                                  config=CONFIGS[family])


async def _exchange(module, family: str, mode: str, reply) -> tuple[list, object]:
    """(what the stub received, the translated result or the error) for one
    call of ``module``'s provider of ``family``."""
    received = []

    async def handler(request: web.Request) -> web.StreamResponse:
        body = await request.read()
        received.append({"method": request.method, "path": request.path,
                         "query": dict(request.query),
                         "headers": {h: request.headers.get(h) for h in HEADERS},
                         "body": json.loads(body) if body else None})
        status, content_type, payload = reply
        if status != 200 or content_type == "application/json":
            return web.json_response(payload, status=status)
        resp = web.StreamResponse(headers={"content-type": content_type})
        await resp.prepare(request)
        for i in range(0, len(payload), 7):   # split across chunk boundaries
            await resp.write(payload[i:i + 7])
        await resp.write_eof()
        return resp

    app = web.Application()
    app.router.add_route("*", "/{tail:.*}", handler)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = f"http://127.0.0.1:{site._server.sockets[0].getsockname()[1]}"
    provider = _make(module, family, base)
    try:
        if mode == "embed":
            result = await provider.embed(["a", "b"], model="e1")
        elif mode.startswith("stream"):
            result = [c async for c in provider.chat_stream(dict(REQUEST, stream=True))]
        else:
            result = await provider.chat(dict(REQUEST))
    except Exception as exc:
        result = (type(exc).__name__, str(exc).split(" for url")[0].split("\nFor more")[0])
    finally:
        await runner.cleanup()
    return received, result


def _mask(result):
    """Random ids and clocks out; every chunk of a stream shares one id."""
    if isinstance(result, list) and result and isinstance(result[0], dict):
        ids = {c["id"] for c in result}
        assert len(ids) == 1, ids
        return [{k: v for k, v in c.items() if k not in ("id", "created")} for c in result]
    if isinstance(result, dict):
        return {k: v for k, v in result.items() if k not in ("id", "created")}
    return result


CASES = ([("openai", "unary", (200, "application/json", UNARY["openai"])),
          ("openai", "embed", (200, "application/json",
                               {"data": [{"embedding": [0.5, 1.0]}, {"embedding": [2.0]}]})),
          ("openai", "stream", (200, "application/json", UNARY["openai"])),
          ("openai", "unary_error", (503, "application/json", {"error": "busy"}))]
         + [(family, "unary", (200, "application/json", UNARY[family])) for family in CONFIGS]
         + [(family, "unary_error", (500, "application/json", {"error": "x"}))
            for family in CONFIGS]
         + [(family, f"stream_{case}", (200, *STREAMS[family, case]))
            for family, case in STREAMS]
         + [(family, "stream_http_error", (429, "application/json", {"error": "slow"}))
            for family in ("anthropic", "bedrock", "google_vertex")])


@pytest.mark.parametrize("family,mode,reply", CASES, ids=[f"{f}-{m}" for f, m, _ in CASES])
def test_provider_agrees_with_jax(family, mode, reply):
    loop = asyncio.new_event_loop()
    try:
        theirs = loop.run_until_complete(_exchange(jax_provider, family, mode, reply))
        ours = loop.run_until_complete(_exchange(port_provider, family, mode, reply))
    finally:
        loop.close()
    assert ours[0] == theirs[0] and len(ours[0]) == 1
    assert _mask(ours[1]) == _mask(theirs[1])
    if mode.startswith("stream") and isinstance(ours[1], list):
        assert ours[1][-1]["choices"][0]["finish_reason"] in ("stop", "length")
    if "error" in mode:
        assert isinstance(ours[1], tuple), ours[1]


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_request_builders_agree(family):
    """The builders alone, on requests with and without a system prompt,
    temperature and max_tokens."""
    bare = {"model": "m2", "messages": [{"role": "user", "content": None}]}
    for request in (REQUEST, bare, dict(REQUEST, temperature=None, max_tokens=0)):
        ours = _make(port_provider, family, "https://up.example").build_request(dict(request))
        theirs = _make(jax_provider, family, "https://up.example").build_request(dict(request))
        assert ours == theirs


def test_unknown_dialect_and_no_httpx_at_import():
    with pytest.raises(port_provider.LLMError, match="unknown provider dialect"):
        port_provider.DialectProvider("x", "cohere")
    assert port_provider.DialectProvider("x", "anthropic").provider_type == "anthropic"
    assert httpx   # the tests post with it; provider.py imports it only when posting


@pytest.mark.parametrize("chunk", [1, 5, 64, 4096])
def test_eventstream_frames_agree(chunk):
    """The port's AWS event-stream codec against the JAX one: the same
    frames, decoded the same across any chunking; the same refusals."""
    from mcp_context_forge_tpu.utils import eventstream as jax_eventstream
    from mcp_context_forge_tpu_torch.utils import eventstream as port_eventstream

    frames = [({":event-type": "contentBlockDelta", ":message-type": "event"},
               json.dumps({"delta": {"text": "x" * i}}).encode()) for i in range(5)]
    data = b"".join(port_eventstream.encode_frame(h, p) for h, p in frames)
    assert data == b"".join(jax_eventstream.encode_frame(h, p) for h, p in frames)

    async def decode(module, payload):
        async def chunks():
            for i in range(0, len(payload), chunk):
                yield payload[i:i + chunk]
        try:
            return [f async for f in module.iter_frames(chunks())]
        except module.EventStreamError as exc:
            return ("refused", str(exc))

    corrupt = bytearray(data)
    corrupt[20] ^= 0xFF
    for payload in (data, bytes(corrupt), data[:-3]):
        ours = asyncio.run(decode(port_eventstream, payload))
        theirs = asyncio.run(decode(jax_eventstream, payload))
        assert ours == theirs
    assert asyncio.run(decode(port_eventstream, data)) == frames


LAG_PROBE = """
import asyncio, json, ssl, sys, threading
from aiohttp import web
from mcp_context_forge_tpu_torch.gateway.flight_recorder import LoopLagSampler
from mcp_context_forge_tpu_torch.tpu_local.provider import OpenAICompatProvider

REPLY = json.loads(sys.argv[1])
HEAVY = ("httpx", "httpcore", "h11", "anyio", "certifi")
ca_loads = []
load_verify_locations = ssl.SSLContext.load_verify_locations


def counted(self, *args, **kwargs):
    ca_loads.append(threading.current_thread().name)
    return load_verify_locations(self, *args, **kwargs)


ssl.SSLContext.load_verify_locations = counted


async def main():
    async def completions(request):
        return web.json_response(REPLY)

    app = web.Application()
    app.router.add_post("/v1/chat/completions", completions)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    loaded = "httpx" in sys.modules
    # built as the provider table's rewire builds it: in a worker thread
    provider = await asyncio.to_thread(OpenAICompatProvider, "up", f"http://127.0.0.1:{port}/v1")
    sampler = LoopLagSampler(interval_s=0.01, warn_s=0.0)
    await sampler.start()
    await asyncio.sleep(0.1)
    sampler.max_lag_s = 0.0
    modules, loads = set(sys.modules), len(ca_loads)
    reply = await provider.chat({"model": "m", "messages": [{"role": "user", "content": "hi"}]})
    imported = sorted(m for m in set(sys.modules) - modules if m.split(".")[0] in HEAVY)
    await asyncio.sleep(0.05)
    await sampler.stop()
    await runner.cleanup()
    print(json.dumps({"httpx_before": loaded, "imported_at_post": imported,
                      "ca_loads_at_post": ca_loads[loads:], "max_lag_ms": sampler.max_lag_s * 1e3,
                      "samples": sampler.samples, "text": reply["choices"][0]["message"]["content"]}))


asyncio.run(main())
"""


def test_first_post_does_not_stall_the_loop():
    """A provider's first post in a fresh process (httpx not yet imported)
    imports nothing of httpx's stack and loads no CA bundle on the event
    loop: the provider did both when it was built, off the loop. Those two
    are what stalled the loop for ~0.9 s at the first post; the loop-lag
    sampler's max lag across the post is read and reported, not bounded,
    since a wall-clock bound fails whenever the host is loaded."""
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", LAG_PROBE, json.dumps(OPENAI_REPLY)],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    reading = json.loads(out.strip().splitlines()[-1])
    print(reading)
    assert reading["httpx_before"] is False and reading["text"] == "ok"
    assert reading["samples"] >= 5
    assert reading["imported_at_post"] == [], reading
    assert reading["ca_loads_at_post"] == [], reading
