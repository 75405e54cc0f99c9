"""Sampled phase attribution of the port's decode steps, on the CPU, after
``tests/tpu_local/test_step_attribution.py``: with ``step_sample_every=N``
every Nth decode dispatch runs serially and carries a complete phase row
whose parts sum to the step's wall; sampling leaves greedy streams as they
are (and equal to TPUEngine's); the default (0) emits no row, no phase
histogram sample and takes no timed window; a crash or an EOS mid-pipeline
leaves no partial row."""

import asyncio

import pytest

from mcp_context_forge_tpu.observability.metrics import PrometheusRegistry
from mcp_context_forge_tpu.observability.tracing import Tracer
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig, GenRequest,
                                                          TorchEngine)
from torch_engine_pair import TEXTS, make_pair, serve, serve_both

PHASE_KEYS = {"host_dispatch_ms", "table_sync_ms", "device_compute_ms",
              "readback_ms", "emit_ms", "total_ms"}
SHAPE = dict(model="llama3-test", max_batch=4, max_seq_len=128, page_size=16,
             num_pages=64, prefill_buckets=(16, 64), dtype="float32", device="cpu")


def _phase_rows(engine):
    return [s for s in engine.recent_steps() if s.get("phases")]


def _assert_row_complete(row):
    phases = row["phases"]
    assert set(phases) == PHASE_KEYS, phases
    for key, value in phases.items():
        assert isinstance(value, float) and value >= 0.0, (key, value)


def test_sampled_rows_complete_and_sum_to_wall():
    engine = TorchEngine(EngineConfig(**SHAPE, step_sample_every=2))
    outs = serve(engine, [(engine.tokenizer.encode("attribute my steps"),
                           dict(max_tokens=12))])
    assert outs[0][0]
    rows = _phase_rows(engine)
    assert rows, "sampling on but no phase row"
    assert engine.stats.phase_samples == len(rows)
    for row in rows:
        assert row["kind"] == "decode"
        _assert_row_complete(row)
        phases = row["phases"]
        total = phases["total_ms"]
        parts = sum(v for k, v in phases.items() if k != "total_ms")
        # the parts are timed inside the envelope and cover most of it (the
        # residue is a few Python lines between the windows; CPU clocks
        # jitter at the sub-ms scale of these phases)
        assert parts <= total + 0.5
        assert total - parts <= max(5.0, 0.5 * total)


@pytest.fixture(scope="module")
def pair():
    return make_pair(superstep=1)


def test_sampling_keeps_greedy_streams(pair):
    """Sampling every 3rd dispatch changes no token: the port with it equals
    TPUEngine without it, and the port without it."""
    ref, port = pair
    jobs = [(port.tokenizer.encode(t), dict(max_tokens=12)) for t in TEXTS]
    port.config.step_sample_every = 3
    sampled = serve_both(pair, jobs)
    assert port.stats.phase_samples > 0
    port.config.step_sample_every = 0
    before = port.stats.phase_samples
    assert serve(port, jobs) == sampled
    assert port.stats.phase_samples == before


def test_sampling_off_is_silent():
    metrics = PrometheusRegistry()
    engine = TorchEngine(EngineConfig(**SHAPE), metrics=metrics)
    timed_calls = []
    launch = engine._graphs.launch

    def recording_launch(key, feed=None, timed=False):
        timed_calls.append(timed)
        return launch(key, feed, timed=timed)

    engine._graphs.launch = recording_launch
    serve(engine, [(engine.tokenizer.encode("quiet steady state"), dict(max_tokens=8))])
    assert timed_calls and not any(timed_calls)
    assert not _phase_rows(engine)
    assert engine.stats.phase_samples == 0
    text = metrics.render()[0].decode()
    assert "mcpforge_llm_step_phase_seconds_count" not in text


def test_phase_histograms_and_span_events():
    tracer, metrics = Tracer(exporter="memory"), PrometheusRegistry()
    engine = TorchEngine(EngineConfig(**SHAPE, step_sample_every=2), tracer=tracer,
                         metrics=metrics)
    serve(engine, [(engine.tokenizer.encode("span events please"),
                    dict(max_tokens=10, trace_ctx=("ab" * 16, "cd" * 8)))])
    text = metrics.render()[0].decode()
    for phase in ("host_dispatch", "table_sync", "device_compute", "readback", "emit"):
        line = f'mcpforge_llm_step_phase_seconds_count{{phase="{phase}",replica="0"}}'
        counts = [float(ln.split()[-1]) for ln in text.splitlines() if ln.startswith(line)]
        assert counts and counts[0] >= 1, phase
    events = [ev for span in tracer.finished if span.name == "llm.decode"
              for ev in span.events if ev[1] == "decode.step.phases"]
    assert events
    for _ts, _name, attrs in events:
        assert set(attrs) == PHASE_KEYS


def test_crash_mid_pipeline_leaves_no_partial_row():
    engine = TorchEngine(EngineConfig(**SHAPE, step_sample_every=2))
    launch = engine._graphs.launch
    calls = {"n": 0}

    def exploding(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise RuntimeError("injected device fault")
        return launch(*args, **kwargs)

    engine._graphs.launch = exploding

    async def main():
        await engine.start()
        try:
            request = GenRequest(request_id="crash", max_tokens=64,
                                 prompt_ids=engine.tokenizer.encode("crash mid window"))
            await engine.submit(request)
            while await asyncio.wait_for(request.stream.get(), 60) is not None:
                pass
            return request
        finally:
            await engine.stop()

    request = asyncio.run(main())
    assert calls["n"] >= 3
    assert request.finish_reason == "error"
    for row in _phase_rows(engine):
        _assert_row_complete(row)
    assert engine.stats.phase_samples == len(_phase_rows(engine))


def test_eos_mid_pipeline_rows_complete():
    """Staggered ends at K = 2 (the legacy decode_block alias) with sampling:
    every row that surfaces is complete, every stream ends."""
    engine = TorchEngine(EngineConfig(**SHAPE, step_sample_every=2, decode_block=2))
    assert engine._k == 2
    outs = serve(engine, [(engine.tokenizer.encode(t), dict(max_tokens=7))
                          for t in ("one", "two words here", "three is a longer one")])
    assert all(tokens for tokens, _ in outs)
    rows = _phase_rows(engine)
    assert rows
    for row in rows:
        _assert_row_complete(row)
        assert row["superstep"] == 2
