"""The port's structured logging and OTLP export against the JAX package's,
on the CPU: ``JsonFormatter`` lines are equal for the same records, with and
without trace context (an explicit ``trace_extra`` and the contextvar span);
``RingBufferHandler.search`` returns the same rows; ``encode_spans`` builds
equal OTLP-JSON from spans of the same data; and ``OTLPExporter``, run
against a stub collector on localhost through one script of 200, 503 and
400 answers (and a refused connection), counts the same exported, dropped
and retried spans, per drop reason in the registries too, and delivers the
same span ids. Exact equality throughout."""

import asyncio
import json
import logging
import sys
from types import SimpleNamespace

import httpx
import numpy as np
import pytest
from aiohttp import web
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu.observability import logging as jax_logging
from mcp_context_forge_tpu.observability import metrics as jax_metrics
from mcp_context_forge_tpu.observability import otlp as jax_otlp
from mcp_context_forge_tpu.observability import tracing as jax_tracing
from mcp_context_forge_tpu_torch.observability import logging as port_logging
from mcp_context_forge_tpu_torch.observability import metrics as port_metrics
from mcp_context_forge_tpu_torch.observability import otlp as port_otlp
from mcp_context_forge_tpu_torch.observability import tracing as port_tracing

TRACE, SPAN = "4bf92f3577b34da6a3ce929d0e0e4736", "00f067aa0ba902b7"
LEVELS = [logging.DEBUG, logging.INFO, logging.WARNING, logging.ERROR, logging.CRITICAL]


def _records(seed: int, n: int = 40) -> list[logging.LogRecord]:
    """Seeded records: levels, loggers, %-args, explicit trace contexts,
    an exception."""
    rng = np.random.default_rng(seed)
    words = ["engine", "failing", "request", "tier", "SPILL", "slow", "loop", "lagged"]
    out = []
    for i in range(n):
        msg = " ".join(rng.choice(words, size=rng.integers(1, 5))) + " %s after %d token(s)"
        record = logging.LogRecord(
            name=str(rng.choice(["mcpforge.engine", "mcpforge.gateway", "root"])),
            level=int(rng.choice(LEVELS)), pathname=__file__, lineno=i, msg=msg,
            args=(f"req-{i}", int(rng.integers(0, 64))), exc_info=None)
        if rng.random() < 0.4:
            ctx = (f"{i:032x}", f"{i:016x}" if rng.random() < 0.8 else "")
            for key, value in port_logging.trace_extra(ctx).items():
                setattr(record, key, value)
        if i == 3:
            try:
                raise ValueError("boom")
            except ValueError:
                record.exc_info = sys.exc_info()
        out.append(record)
    return out


def _with_span(package_tracing, fn):
    """``fn()`` with a span of the fixed ids current in ``package_tracing``."""
    span = package_tracing.Span(name="http.request", trace_id=TRACE, span_id=SPAN)
    token = package_tracing._current_span.set(span)
    try:
        return fn()
    finally:
        package_tracing._current_span.reset(token)


@pytest.mark.parametrize("span", [False, True], ids=["no_span", "current_span"])
@pytest.mark.parametrize("seed", range(3))
def test_json_lines_equal(seed, span):
    port, ref = port_logging.JsonFormatter(), jax_logging.JsonFormatter()
    for record in _records(seed):
        if span:
            ours = _with_span(port_tracing, lambda: port.format(record))
            theirs = _with_span(jax_tracing, lambda: ref.format(record))
        else:
            ours, theirs = port.format(record), ref.format(record)
        assert json.loads(ours) == json.loads(theirs)
        assert ours == theirs   # same record, same clock value: byte for byte
        if span or getattr(record, "ctx", None):
            assert "trace_id" in json.loads(ours)


def test_trace_extra_is_the_jax_one_and_reexported():
    from mcp_context_forge_tpu_torch.observability import trace_extra

    assert trace_extra is port_logging.trace_extra
    for ctx in (None, (TRACE, SPAN), (TRACE, "")):
        assert trace_extra(ctx) == jax_logging.trace_extra(ctx)


def _rings(seed: int, capacity: int):
    port, ref = port_logging.RingBufferHandler(capacity), jax_logging.RingBufferHandler(capacity)
    for i, record in enumerate(_records(seed, n=60)):
        if i % 5 == 0:
            _with_span(port_tracing, lambda: port.emit(record))
            _with_span(jax_tracing, lambda: ref.emit(record))
        else:
            port.emit(record)
            ref.emit(record)
    return port, ref


@pytest.mark.parametrize("query,level,limit", [
    ("", None, 200), ("request", None, 5), ("SPILL", "warning", 200), ("spill", "ERROR", 3),
    ("absent", None, 10), ("", "info", 1), ("token", "DEBUG", 50), ("", "critical", 200)])
@pytest.mark.parametrize("capacity", [16, 5000])
def test_ring_search_equal(query, level, limit, capacity):
    port, ref = _rings(7, capacity)
    assert port.search(query, level, limit) == ref.search(query, level, limit)
    assert len(port.records) == min(capacity, 60)


def test_init_logging_installs_ring_json_and_rotating_file(tmp_path):
    root = logging.getLogger()
    saved = (root.level, list(root.handlers))
    path = tmp_path / "logs" / "port.log"
    try:
        port_logging.init_logging("WARNING", as_json=True, buffer_capacity=32,
                                  file_path=str(path), rotation=True, max_mb=0.001,
                                  backup_count=2)
        assert port_logging.ring_buffer in root.handlers
        assert port_logging.ring_buffer.records.maxlen == 32
        for i in range(40):
            logging.getLogger("mcpforge.test").warning("line %d", i,
                                                       extra=port_logging.trace_extra(
                                                           (TRACE, SPAN)))
        line = json.loads(path.read_text().splitlines()[-1])
        assert line["trace_id"] == TRACE and line["span_id"] == SPAN
        assert (tmp_path / "logs" / "port.log.1").exists()
        rows = port_logging.ring_buffer.search("line 39")
        assert rows[0]["trace_id"] == TRACE
        port_logging.init_logging("WARNING")   # a later init drops the file sink
        assert port_logging._file_handler is None
    finally:
        for handler in list(root.handlers):
            if handler not in saved[1]:
                root.removeHandler(handler)
        root.setLevel(saved[0])


def _spans(package_tracing, seed: int, n: int = 12) -> list:
    rng = np.random.default_rng(seed)
    spans = []
    for i in range(n):
        span = package_tracing.Span(
            name=str(rng.choice(["http.request", "llm.request", "llm.decode"])),
            trace_id=f"{seed:016x}{i:016x}", span_id=f"{i + 1:016x}",
            parent_span_id=None if i % 3 == 0 else f"{i:016x}",
            start_ts=1.7e9 + i * 0.25, status="ERROR" if i % 4 == 3 else "OK",
            attributes={"http.status_code": int(rng.integers(200, 600)),
                        "llm.stream": bool(i % 2), "gen_ai.request.model": "llama3-test",
                        "ratio": float(rng.random()), "none": None})
        span.end_ts = None if i == 5 else span.start_ts + float(rng.random())
        span.events = [(span.start_ts + 0.01 * k, f"ev{k}", {"k": k, "v": 0.5 * k})
                       for k in range(i % 3)]
        spans.append(span)
    return spans


@pytest.mark.parametrize("seed", range(4))
def test_encode_spans_equal(seed):
    ours = port_otlp.encode_spans(_spans(port_tracing, seed), "mcpforge-test")
    theirs = jax_otlp.encode_spans(_spans(jax_tracing, seed), "mcpforge-test")
    assert ours == theirs


# -- the exporter against a stub collector ---------------------------------

# (spans sunk before the flush, the collector's answer to each POST the flush
# makes, seconds to wait before the flush): batches of 3, max_retries 2
SCRIPT = [
    (5, [200, 200], 0.0),           # two batches delivered
    (3, [503], 0.0),                # deferred, retry 1 scheduled
    (0, [], 0.0),                   # not yet due: no POST
    (0, [200], 0.06),               # the retry delivered
    (2, [400], 0.0),                # refused: dropped at once
    (4, [503], 0.0),                # deferred (attempt 1 of the first batch)
    (0, [503], 0.06),               # attempt 2
    (0, [503], 0.15),               # attempt 3 > max_retries: dropped
    (0, [200], 0.0),                # the span left behind the dropped batch
    (2, ["refuse"], 0.0),           # the collector is down: deferred
]


def _stub_collector():
    state = {"answers": [], "received": []}

    async def traces(request: web.Request) -> web.Response:
        body = await request.json()
        answer = state["answers"].pop(0)
        state["received"].append((answer, [s["spanId"] for rs in body["resourceSpans"]
                                           for ss in rs["scopeSpans"] for s in ss["spans"]]))
        return web.Response(status=answer, text=f"stub {answer}")

    app = web.Application()
    app.router.add_post("/v1/traces", traces)
    return app, state


async def _run_script(make_exporter, tracing_module) -> dict:
    app, state = _stub_collector()
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    exporter, registry, close = make_exporter(f"http://127.0.0.1:{port}/")
    try:
        spans = _spans(tracing_module, 9, n=17)
        for sunk, answers, wait in SCRIPT:
            for _ in range(sunk):
                exporter.sink(spans.pop(0))
            if answers == ["refuse"]:
                await runner.cleanup()   # nothing listens any more
                runner = None
            else:
                state["answers"].extend(answers)
            await asyncio.sleep(wait)
            await exporter.flush()
            assert not state["answers"], "the flush did not make the scripted POSTs"
        exporter.sink(spans.pop(0))
        await exporter.stop()   # the deferred batch's last try, then shutdown drops
    finally:
        if runner is not None:
            await runner.cleanup()
        await close()
    dropped = {}
    for sample in registry.otel_spans_dropped.collect()[0].samples:
        if sample.name.endswith("_total"):
            dropped[sample.labels["reason"]] = sample.value
    exported = [s.value for s in registry.otel_spans_exported.collect()[0].samples
                if s.name.endswith("_total")]
    return {"exported": exporter.exported, "dropped": exporter.dropped,
            "retries": exporter.retries, "received": state["received"],
            "registry_exported": exported, "registry_dropped": dropped}


def test_exporter_counts_equal_against_a_stub_collector():
    def port_exporter(endpoint):
        registry = port_metrics.PrometheusRegistry()
        post, close = port_otlp.aiohttp_post(timeout_s=5.0)
        exporter = port_otlp.OTLPExporter(post, endpoint, "mcpforge", {"x-team": "a"},
                                          metrics=registry, max_batch=3, max_retries=2,
                                          backoff_base_s=0.02)
        return exporter, registry, close

    def jax_exporter(endpoint):
        registry = jax_metrics.PrometheusRegistry()
        client = httpx.AsyncClient(timeout=5.0)
        ctx = SimpleNamespace(http_client=client, metrics=registry)
        exporter = jax_otlp.OTLPExporter(ctx, endpoint, "mcpforge", {"x-team": "a"},
                                         max_batch=3, max_retries=2, backoff_base_s=0.02)
        return exporter, registry, client.aclose

    loop = asyncio.new_event_loop()
    try:
        ours = loop.run_until_complete(_run_script(port_exporter, port_tracing))
        theirs = loop.run_until_complete(_run_script(jax_exporter, jax_tracing))
    finally:
        loop.close()
    assert ours == theirs
    assert ours["exported"] == 9 and ours["retries"] == 5
    assert ours["registry_dropped"] == {"rejected": 2.0, "retry_exhausted": 3.0,
                                        "shutdown": 3.0}


def test_exporter_buffer_full_and_background_flush():
    """A full buffer drops at the sink; the flusher task delivers on its own
    tick; ``stop`` flushes what is left."""
    sent = []

    async def post(url, payload, headers):
        sent.append((url, len(payload["resourceSpans"][0]["scopeSpans"][0]["spans"]),
                     headers["content-type"]))
        return 204, ""

    async def run():
        registry = port_metrics.PrometheusRegistry()
        exporter = port_otlp.OTLPExporter(post, "http://collector:4318", "svc", metrics=registry,
                                          flush_interval=0.02, max_buffer=4)
        spans = _spans(port_tracing, 3, n=6)
        for span in spans:
            exporter.sink(span)
        await exporter.start()
        await asyncio.sleep(0.1)
        exporter.sink(spans[0])
        await exporter.stop()
        return exporter

    exporter = asyncio.run(run())
    assert exporter.exported == 5 and exporter.dropped == 2
    assert sent[0] == ("http://collector:4318/v1/traces", 4, "application/json")
