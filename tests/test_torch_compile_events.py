"""Kernel-build and graph-capture tracking (``compile_events``): events are
attributed to the stage their thread is registered for (construction
"warmup", the dispatch thread "serving"), unregistered threads are
ignored, ``ops._build.build`` records one ``kernel_build`` per nvcc run,
a serving-stage event emits its span and the JAX engine's compile
counters, and the snapshot keeps the JAX tracker's keys."""

import asyncio
import subprocess
import threading

from mcp_context_forge_tpu.observability.metrics import PrometheusRegistry
from mcp_context_forge_tpu.observability.tracing import Tracer
from mcp_context_forge_tpu.tpu_local.compile_events import \
    CompileTracker as JaxCompileTracker
from mcp_context_forge_tpu_torch.tpu_local import compile_events
from mcp_context_forge_tpu_torch.tpu_local.compile_events import (
    CompileTracker, record_event, restore_thread, track_thread)
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig, GenRequest,
                                                          TorchEngine)
from mcp_context_forge_tpu_torch.tpu_local.ops import _build

SHAPE = dict(model="llama3-test", max_batch=2, max_seq_len=64, page_size=8,
             num_pages=32, prefill_buckets=(16,), dtype="float32", device="cpu")


def test_snapshot_keys_equal_jax():
    ref, port = JaxCompileTracker().snapshot(), CompileTracker().snapshot()
    assert set(port) == set(ref)
    for stage in ("warmup", "serving"):
        assert set(ref[stage]) <= set(port[stage])
        assert {k: port[stage][k] for k in ref[stage]} == ref[stage]
        assert port[stage]["kernel_build"] == port[stage]["graph_capture"] == 0


def test_events_follow_the_registered_thread():
    calls = []
    tracker = CompileTracker(lambda *args: calls.append(args))
    record_event("kernel_build", 1.0)        # unregistered: ignored
    token = track_thread(tracker, "warmup")
    try:
        record_event("graph_capture", 0.25)
        inner = track_thread(tracker, "serving")
        record_event("kernel_build", 0.5)
        restore_thread(inner)
        record_event("graph_capture", 0.125)  # back to warmup

        def other_thread():
            record_event("kernel_build", 2.0)   # another thread: ignored
        worker = threading.Thread(target=other_thread)
        worker.start()
        worker.join(10)
        assert not worker.is_alive()
    finally:
        restore_thread(token)
    record_event("graph_capture", 4.0)
    snap = tracker.snapshot()
    assert snap["warmup"] == {"count": 2, "ms_total": 375.0, "kernel_build": 0,
                              "graph_capture": 2}
    assert snap["serving"] == {"count": 1, "ms_total": 500.0, "kernel_build": 1,
                               "graph_capture": 0}
    assert tracker.serving_compiles() == 1
    assert [e["kind"] for e in snap["recent"]] == ["graph_capture", "kernel_build",
                                                   "graph_capture"]
    assert calls == [("warmup", 0.25, "graph_capture"), ("serving", 0.5, "kernel_build"),
                     ("warmup", 0.125, "graph_capture")]


def test_build_records_one_event_per_nvcc(tmp_path, monkeypatch):
    """``build`` with a stand-in compiler (no nvcc here): two sources built
    are two kernel_build events; a source already built is none."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")

    class FakeNvcc:
        def __init__(self, cmd, **kwargs):
            out = cmd[cmd.index("-o") + 1]
            open(out, "wb").close()
            self.returncode = 0

        def communicate(self):
            return "ptxas info: 32 registers", None

    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    tracker = CompileTracker()
    token = track_thread(tracker, "serving")
    try:
        _build.build(("grouped_moe", "kv_quant_store"))
        _build.build(("grouped_moe",))
    finally:
        restore_thread(token)
    assert tracker.snapshot()["serving"]["kernel_build"] == 2
    assert tracker.snapshot()["warmup"]["count"] == 0


def _serve_one(engine, trace_ctx=None):
    async def main():
        await engine.start()
        try:
            request = GenRequest(request_id="r", prompt_ids=engine.tokenizer.encode("hi"),
                                 max_tokens=4, trace_ctx=trace_ctx)
            await engine.submit(request)
            while await asyncio.wait_for(request.stream.get(), 60) is not None:
                pass
            return request
        finally:
            await engine.stop()
    return asyncio.run(main())


def test_engine_attributes_construction_and_serving(monkeypatch):
    """On the CPU the construction captures nothing (no graphs) and serving
    builds nothing: both stages read 0. An event raised on the dispatch
    thread (standing in for a kernel built lazily while serving) counts as
    serving, with its llm.kernel_build span and the compile counters."""
    tracer, metrics = Tracer(exporter="memory"), PrometheusRegistry()
    engine = TorchEngine(EngineConfig(**SHAPE), tracer=tracer, metrics=metrics)
    assert engine.compile_stats()["warmup"]["count"] == 0
    assert engine.stats.graph_captures == 0
    _serve_one(engine)
    assert engine.compile_stats()["serving"]["count"] == 0
    dispatch = engine._decode_dispatch

    def building_dispatch(*args, **kwargs):
        if not engine.compile_stats()["serving"]["count"]:
            record_event("kernel_build", 0.002)
        return dispatch(*args, **kwargs)

    monkeypatch.setattr(engine, "_decode_dispatch", building_dispatch)
    assert _serve_one(engine).finish_reason in ("stop", "length")
    stats = engine.compile_stats()
    assert stats["serving"]["count"] == stats["serving"]["kernel_build"] == 1
    assert stats["warmup"]["count"] == 0
    spans = [s for s in tracer.finished if s.name == "llm.kernel_build"]
    assert len(spans) == 1
    assert spans[0].attributes["llm.compile_stage"] == "serving"
    text = metrics.render()[0].decode()
    assert ('mcpforge_llm_xla_compiles_total{replica="0",stage="serving"} 1.0'
            in text)
    assert 'mcpforge_llm_xla_compile_seconds_count{replica="0"} 1.0' in text
    assert compile_events._by_thread == {}   # every registration unwound
