"""The port's HTTP middleware chain against the JAX package's, on the CPU.
Each package's layers (its flight recorder and the twelve that need no
database auth, in ``MIDDLEWARES``' order) wrap a small app with the same
stub routes and the same settings, and the same requests get the same
statuses, headers and bodies:

- ``header_size`` (431 by total bytes, field count and field size),
  ``host_validation`` (421), ``cors`` (a preflight's 204 and the granted
  headers; a foreign origin granted nothing), ``protocol_version`` (400 on
  the MCP paths only), ``compression`` (a large unary body gzip-encoded
  for a gzip client, a small one, an event stream and a streamed answer
  left alone), ``security_headers``, ``deprecation`` (Deprecation, Sunset),
  ``rate_limit`` with ``forwarded`` (429 with ``retry-after: 1`` per
  client address, the rightmost X-Forwarded-For entry only from a trusted
  edge), ``request_logging`` (the masked DEBUG lines) and
  ``db_query_logging`` (X-DB-Query-Count and the N+1 warning);
- ``RateLimiter``: recency-ordered eviction past ``max_buckets`` and the
  sweep of full buckets, step for step as JAX's;
- ``MIDDLEWARES``: JAX's names in JAX's order, ``token_usage``, ``csrf``
  and ``password_change`` included;
- ``client_disconnect``: a handler that raises ``CancelledError`` counts a
  disconnect and leaves a 499 row flagged ``client_disconnected``; a client
  that closes a stream after its first event cancels no handler under
  ``web.AppRunner``'s defaults, so neither package counts it (the
  handler's next write fails and its row records that error as a 500);
  under aiohttp's ``TestServer``, which cancels handlers, both count it;
- ``utils/masking.py``: ``mask_text`` (the native library and the Python
  path) and ``mask_obj`` equal JAX's over seeded payloads.
"""

import asyncio
import gzip
import json
import logging
import types

import aiohttp
import numpy as np
import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.db import core as jax_core
from mcp_context_forge_tpu.gateway import flight_recorder as jax_flight
from mcp_context_forge_tpu.gateway import middleware as jax_mw
from mcp_context_forge_tpu.observability import PrometheusRegistry as JaxRegistry
from mcp_context_forge_tpu.utils import masking as jax_masking
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.db import core
from mcp_context_forge_tpu_torch.gateway import flight_recorder
from mcp_context_forge_tpu_torch.gateway import middleware as mw
from mcp_context_forge_tpu_torch.observability.metrics import PrometheusRegistry
from mcp_context_forge_tpu_torch.utils import masking

AUTH_BOUND = {"token_usage_middleware", "csrf_middleware", "password_change_middleware"}
TWELVE = ["client_disconnect_middleware", "forwarded_middleware", "host_validation_middleware",
          "cors_middleware", "compression_middleware", "security_headers_middleware",
          "deprecation_middleware", "header_size_middleware", "protocol_version_middleware",
          "rate_limit_middleware", "request_logging_middleware", "db_query_logging_middleware"]
PACKAGES = {
    "jax": dict(mw=jax_mw, flight=jax_flight, core=jax_core, registry=JaxRegistry,
                load=lambda env: jax_load_settings(
                    env={f"MCPFORGE_{k}": v for k, v in env.items()}, env_file=None)),
    "port": dict(mw=mw, flight=flight_recorder, core=core, registry=PrometheusRegistry,
                 load=lambda env: load_settings(env, env_file=None)),
}
ENV = {"DATABASE_URL": "sqlite:///:memory:", "MAX_HEADER_BYTES": "3000",
       "MAX_HEADER_COUNT": "24", "MAX_HEADER_FIELD_BYTES": "700",
       "ALLOWED_HOSTS": "127.0.0.1,good.example", "CORS_ALLOWED_ORIGINS": "https://app.example",
       "CORS_ALLOW_CREDENTIALS": "true", "DEPRECATED_PATH_PREFIXES_CSV": "/legacy",
       "LEGACY_API_SUNSET_DATE": "Sat, 31 Dec 2026 23:59:59 GMT", "DB_QUERY_LOGGING": "true",
       "DB_QUERY_N1_THRESHOLD": "3", "TRUST_PROXY_HEADERS": "true"}
# compared on every answer; Date, Server and the query time vary by run
HEADERS = ("content-type", "content-encoding", "vary", "access-control-allow-origin",
           "access-control-allow-methods", "access-control-allow-headers",
           "access-control-max-age", "access-control-allow-credentials",
           "access-control-expose-headers", "x-content-type-options", "x-frame-options",
           "referrer-policy", "cache-control", "deprecation", "x-deprecated-endpoint", "sunset",
           "retry-after", "x-db-query-count")
BIG = {"rows": [{"i": i, "text": "lorem ipsum " * 4} for i in range(80)]}


def _chain(module) -> list:
    names = ["flight_recorder_middleware"] + TWELVE
    order = [m.__name__ for m in jax_mw.MIDDLEWARES]
    return [getattr(module, n) for n in sorted(names, key=order.index)]


def _app(package: str, env: dict | None = None, rps: int = 0, burst: int = 200):
    p = PACKAGES[package]
    settings = p["load"]({**ENV, **(env or {})})
    registry = p["registry"]()
    db = p["core"].Database(":memory:")
    app = web.Application(middlewares=_chain(p["mw"]))
    app["settings"] = settings
    app["metrics"] = registry
    app["ctx"] = types.SimpleNamespace(settings=settings, metrics=registry, db=db, extras={})
    app["rate_limiter"] = p["mw"].RateLimiter(rps, burst)
    app["flight_recorder"] = p["flight"].FlightRecorder(slow_request_s=0.0)
    app["stream_log"] = []

    async def small(request):
        return web.json_response({"ok": True})

    async def big(request):
        return web.json_response(BIG)

    async def sse_unary(request):
        return web.Response(body=b"data: x\n\n" * 400, content_type="text/event-stream")

    async def streamed(request):
        response = web.StreamResponse(headers={"content-type": "text/event-stream"})
        await response.prepare(request)
        for i in range(int(request.query.get("n", "3"))):
            try:
                await response.write(f"data: {i}\n\n".encode())
            except Exception as exc:
                request.app["stream_log"].append(("write_failed", i, type(exc).__name__))
                raise
            await asyncio.sleep(float(request.query.get("gap", "0")))
        request.app["stream_log"].append(("ended",))
        return response

    async def echo(request):
        return web.json_response(await request.json())

    async def queries(request):
        for _ in range(int(request.query.get("n", "3"))):
            await db.fetchall("SELECT 1 AS one")
        return web.json_response({"ran": request.query.get("n", "3")})

    async def cancelled(request):
        raise asyncio.CancelledError()

    for path, handler in (("/small", small), ("/big", big), ("/sse-unary", sse_unary),
                          ("/stream", streamed), ("/legacy/thing", small), ("/db", queries),
                          ("/gone", cancelled)):
        app.router.add_get(path, handler)
    for path in ("/mcp", "/rpc", "/other"):
        app.router.add_post(path, echo)

    async def start(app):
        await db.connect()

    async def stop(app):
        await db.close()

    app.on_startup.append(start)
    app.on_cleanup.append(stop)
    return app


def _counter(metric) -> float:
    return sum(s.value for family in metric.collect() for s in family.samples
               if s.name.endswith("_total"))


async def _answer(client, method: str, path: str, **kwargs) -> tuple:
    async with getattr(client, method)(path, **kwargs) as resp:
        raw = await resp.read()
        return (resp.status, {h: resp.headers.get(h) for h in HEADERS if h in resp.headers},
                raw.decode(errors="replace"))


def _run_both(script, env: dict | None = None, **app_kwargs) -> list:
    async def run(package):
        app = _app(package, env, **app_kwargs)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await script(client, app)
        finally:
            await client.close()

    return [asyncio.run(run(package)) for package in ("jax", "port")]


REQUESTS = [
    ("get", "/small", {}),
    ("get", "/big", {"headers": {"accept-encoding": "gzip"}}),
    ("get", "/big", {"headers": {"accept-encoding": "identity"}}),
    ("get", "/sse-unary", {"headers": {"accept-encoding": "gzip"}}),
    ("get", "/stream", {"headers": {"accept-encoding": "gzip"}}),
    ("get", "/legacy/thing", {}),
    ("get", "/small", {"headers": {"x-big": "v" * 800}}),
    ("get", "/small", {"headers": {f"x-h{i}": "v" for i in range(30)}}),
    ("get", "/small", {"headers": {f"x-h{i}": "v" * 600 for i in range(5)}}),
    ("get", "/small", {"headers": {"host": "evil.example"}}),
    ("get", "/small", {"headers": {"host": "good.example:4444"}}),
    ("options", "/mcp", {"headers": {"origin": "https://app.example",
                                     "access-control-request-method": "POST"}}),
    ("options", "/mcp", {"headers": {"origin": "https://evil.example"}}),
    ("get", "/small", {"headers": {"origin": "https://app.example"}}),
    ("post", "/mcp", {"json": {"a": 1}, "headers": {"mcp-protocol-version": "1999-01-01"}}),
    ("post", "/rpc", {"json": {"a": 1}, "headers": {"mcp-protocol-version": "2025-03-26"}}),
    ("post", "/other", {"json": {"a": 1}, "headers": {"mcp-protocol-version": "1999-01-01"}}),
    ("get", "/db?n=2", {}),
    ("get", "/db?n=4", {}),
    ("get", "/db?n=0", {}),
]


@pytest.mark.parametrize("index", range(len(REQUESTS)))
def test_layer_answers_agree(index):
    method, path, kwargs = REQUESTS[index]

    async def script(client, app):
        return await _raw(client, method, path, kwargs)

    theirs, ours = _run_both(script)
    assert ours == theirs


async def _raw(client, method: str, path: str, kwargs: dict) -> tuple:
    """The answer as sent: a gzip body is decoded here and marked so."""
    session = aiohttp.ClientSession(auto_decompress=False)
    try:
        async with getattr(session, method)(client.make_url(path), **kwargs) as resp:
            raw = await resp.read()
            headers = {h: resp.headers.get(h) for h in HEADERS if h in resp.headers}
            if resp.headers.get("content-encoding") == "gzip":
                raw = b"gzip:" + gzip.decompress(raw)
            return resp.status, headers, raw.decode(errors="replace")
    finally:
        await session.close()


def test_compression_and_security_headers_as_expected():
    """The readings the layer tests compare: gzip for the large unary body
    only, the security set on every unary answer."""
    async def script(client, app):
        return [await _raw(client, m, p, k) for m, p, k in REQUESTS[:5]]

    theirs, ours = _run_both(script)
    assert ours == theirs
    small, gz, identity, sse, stream = ours
    assert gz[1]["content-encoding"] == "gzip" and gz[2] == "gzip:" + identity[2]
    assert "content-encoding" not in identity[1] and "content-encoding" not in sse[1]
    assert "content-encoding" not in stream[1] and stream[2] == "data: 0\n\ndata: 1\n\ndata: 2\n\n"
    for answer in (small, gz, identity, sse):
        assert answer[1]["x-frame-options"] == "DENY"
    # a streamed answer's headers went out before the layer ran, in both
    assert "x-frame-options" not in stream[1]


@pytest.mark.parametrize("trusted", ["true", "false"])
def test_rate_limit_and_forwarded_agree(trusted):
    """rps 1, burst 2 per client address: 200, 200, 429 (``retry-after``);
    a second address through a trusted edge has its own bucket, and a
    client-supplied leftmost entry changes nothing."""
    async def script(client, app):
        out = []
        for forwarded in (None, None, None, "1.1.1.1, 10.0.0.7", "9.9.9.9, 10.0.0.7",
                          "10.0.0.7", "10.0.0.8"):
            headers = {"x-forwarded-for": forwarded} if forwarded else {}
            out.append(await _answer(client, "post", "/other", json={"n": 1}, headers=headers))
        return out

    theirs, ours = _run_both(script, {"TRUST_PROXY_HEADERS": trusted}, rps=1, burst=2)
    assert ours == theirs
    statuses = [a[0] for a in ours]
    assert statuses[:3] == [200, 200, 429] and ours[2][1]["retry-after"] == "1"
    assert statuses[3:] == ([200, 200, 429, 200] if trusted == "true" else [429] * 4)


def test_request_and_db_logging_agree(caplog):
    """At DEBUG the request line carries the masked body; a route that
    repeats a statement gets the N+1 warning; both packages log alike."""
    body = {"user": "a", "password": "hunter2", "nested": {"api_key": "k", "x": [1, 2]}}

    async def script(client, app):
        caplog.clear()
        with caplog.at_level(logging.DEBUG, logger="aiohttp.web"):
            await _answer(client, "post", "/rpc", json=body)
            await _answer(client, "get", "/db?n=3")
        return [(r.levelname, r.getMessage()) for r in caplog.records
                if r.name == "aiohttp.web"]

    theirs, ours = _run_both(script)
    assert ours == theirs
    assert any("hunter2" not in m and '"password": "***"' in m for _, m in ours)
    assert any(level == "WARNING" and "possible N+1" in m for level, m in ours)


def test_middlewares_are_jax_less_the_auth_bound_three():
    """Since the database-backed auth landed, the three auth-bound layers
    are in the port too: the chain is JAX's, name for name and in order."""
    want = [m.__name__ for m in jax_mw.MIDDLEWARES]
    assert [m.__name__ for m in mw.MIDDLEWARES] == want
    assert set(TWELVE) | AUTH_BOUND <= set(want)


@pytest.mark.parametrize("seed", range(3))
def test_rate_limiter_steps_as_jax(seed, monkeypatch):
    """Seeded arrivals over 12 addresses against ``max_buckets`` 8: each
    decision and the buckets' order after it are JAX's, through the sweep."""
    rng = np.random.default_rng(seed)
    # bursts over 12 addresses, and now and then a pause past the sweep
    arrivals = [(f"10.0.0.{int(rng.integers(12))}",
                 float(rng.exponential(0.05)) + (25.0 if rng.random() < 0.02 else 0.0))
                for _ in range(300)]
    traces = []
    for module in (jax_mw, mw):
        clock = types.SimpleNamespace(now=500.0)
        monkeypatch.setattr(module.time, "monotonic", lambda clock=clock: clock.now)
        limiter = module.RateLimiter(rps=2, burst=3, max_buckets=8)
        trace = []
        for key, gap in arrivals:
            clock.now += gap
            trace.append((limiter.allow(key), list(limiter._buckets)))
        traces.append(trace)
        monkeypatch.undo()
    assert traces[1] == traces[0]
    assert all(len(order) <= 8 for _, order in traces[1])
    assert not all(allowed for allowed, _ in traces[1])


def test_cancelled_handler_counts_a_disconnect():
    async def script(client, app):
        before = _counter(app["metrics"].client_disconnects)
        try:
            await client.get("/gone")
        except aiohttp.ClientError:
            pass   # the server drops the connection of a cancelled handler
        await asyncio.sleep(0.05)
        row = next(r for r in app["flight_recorder"].recent if r["path"] == "/gone")
        return (_counter(app["metrics"].client_disconnects) - before,
                {k: row[k] for k in ("status", "error", "client_disconnected")})

    theirs, ours = _run_both(script)
    assert ours == theirs == (1.0, {"status": 499, "error": "CancelledError",
                                    "client_disconnected": True})


async def _close_after_first_event(base: str, app) -> tuple:
    before = _counter(app["metrics"].client_disconnects)
    async with aiohttp.ClientSession() as http:
        resp = await http.get(f"{base}/stream?n=40&gap=0.02")
        first = await resp.content.readline()
        resp.close()
        for _ in range(300):
            if app["flight_recorder"].recent:
                break
            await asyncio.sleep(0.01)
    row = app["flight_recorder"].recent[-1]
    return (first, _counter(app["metrics"].client_disconnects) - before, app["stream_log"],
            {k: row.get(k) for k in ("path", "status", "error", "client_disconnected")})


@pytest.mark.parametrize("server", ["app_runner", "test_server"])
def test_client_close_mid_stream_agrees(server):
    """A client that reads the first event of a 40-event stream and goes
    away. Under ``web.AppRunner``'s defaults (how ``serve`` and the card's
    script run the app) no handler is cancelled: its next write fails, the
    row records that error as a 500 and no disconnect is counted. aiohttp's
    ``TestServer`` cancels handlers (``handler_cancellation=True``): a 499
    row and one disconnect. Each package answers as JAX's in both."""
    async def run(package):
        app = _app(package)
        if server == "test_server":
            client = TestServer(app)
            await client.start_server()
            try:
                return await _close_after_first_event(str(client.make_url("")).rstrip("/"),
                                                      app)
            finally:
                await client.close()
        runner = web.AppRunner(app, access_log=None)
        await runner.setup()
        try:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            port = site._server.sockets[0].getsockname()[1]
            return await _close_after_first_event(f"http://127.0.0.1:{port}", app)
        finally:
            await runner.cleanup()

    theirs, ours = [asyncio.run(run(package)) for package in ("jax", "port")]
    assert ours == theirs
    if server == "app_runner":
        assert ours == (b"data: 0\n", 0.0, [("write_failed", 1, "ClientConnectionResetError")],
                        {"path": "/stream", "status": 500, "error": "ClientConnectionResetError",
                         "client_disconnected": None})
    else:
        assert ours == (b"data: 0\n", 1.0, [], {"path": "/stream", "status": 499,
                                                 "error": "CancelledError",
                                                 "client_disconnected": True})


# -- masking -------------------------------------------------------------------------

KEYS = ["user", "password", "Authorization", "api_key", "note", "session_id", "x-api-key",
        "items", "Token", "client_secret", "name", "cookie", "data"]


def _payload(rng, depth: int = 0):
    if depth > 2 or rng.random() < 0.3:
        return str(rng.choice(["v", "hunter2", "a b", "", "é"])) if rng.random() < 0.7 \
            else int(rng.integers(100))
    if rng.random() < 0.3:
        return [_payload(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]
    return {str(rng.choice(KEYS)): _payload(rng, depth + 1)
            for _ in range(int(rng.integers(1, 5)))}


TEXTS = ["password=hunter2 user=bob", 'token: "abc def", other: 1', "plain text, nothing",
         "Authorization=Bearer x,api_key=y}", "{not json: secret=1"]


@pytest.mark.parametrize("seed", range(4))
def test_masking_agrees(seed):
    """``mask_obj``, the Python path of ``mask_text`` and the native
    library's (built by ``native_available`` in each package) answer alike."""
    rng = np.random.default_rng(seed)
    payloads = [_payload(rng) for _ in range(12)]
    texts = [json.dumps(p) for p in payloads] + [json.dumps(p, indent=1) for p in payloads[:3]]
    texts += TEXTS
    assert masking.native_available() and jax_masking.native_available()
    for payload in payloads:
        assert masking.mask_obj(payload) == jax_masking.mask_obj(payload)
    for text in texts:
        assert masking._mask_python(text) == jax_masking._mask_python(text)
        assert masking.mask_text(text) == jax_masking.mask_text(text)
    assert masking.library_path().parent == masking.BUILD_DIR
