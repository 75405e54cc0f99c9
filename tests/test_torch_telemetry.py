"""Engine telemetry of the port against the JAX engine's, on the CPU: the
JAX package's own ``Tracer(exporter="memory")``, ``PrometheusRegistry``,
``SignalBus`` and ``TenantLedger`` are handed to a ``TPUEngine`` and a
``TorchEngine`` on the same llama3-test weights, which serve the same
preloaded requests. The spans (names, parents, attribute keys), the metric
families with their label sets, the signal names and the ledger's counts
must be equal; an engine without handles stays silent; the step ring is
bounded and shaped as ``tests/unit/test_engine_telemetry.py`` pins for the
JAX engine, and its kind/batch/width/tokens sequence equals TPUEngine's."""

import asyncio

import jax
import pytest
import torch

import chip_smoke

from mcp_context_forge_tpu.observability.metering import TenantLedger
from mcp_context_forge_tpu.observability.metrics import PrometheusRegistry
from mcp_context_forge_tpu.observability.signals import SignalBus
from mcp_context_forge_tpu.observability.tracing import Tracer
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.observability import (reset_current_tenant,
                                                       set_current_tenant)
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from torch_engine_pair import SHAPE, TEXTS, serve
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

# families only the JAX engine can fill here, or only the port: XLA compile
# counters (the JAX engine compiles on its dispatch thread; the port builds
# nothing on the CPU) and the roofline gauges (an unwarmed JAX engine has no
# XLA cost entries; the port counts every step)
ENGINE_SPECIFIC = ("mcpforge_llm_xla_compile", "mcpforge_llm_mfu",
                   "mcpforge_llm_hbm_roofline_frac")
TRACES = [(f"{i:02x}" * 16, f"{i + 16:02x}" * 8) for i in range(4)]


def _handles():
    metrics = PrometheusRegistry()
    return dict(tracer=Tracer(exporter="memory"), metrics=metrics,
                signals=SignalBus(), ledger=TenantLedger(metrics=None))


@pytest.fixture(scope="module")
def served():
    """Both engines with telemetry, after serving three chats and a long
    prompt that chunks (tenants and trace contexts set)."""
    ref_h, port_h = _handles(), _handles()
    ref = TPUEngine(JaxConfig(**SHAPE, attn_impl="reference"), **ref_h)
    params = params_from_jax(jax.device_get(ref.params), MODEL_CONFIGS["llama3-test"],
                             device="cpu", dtype=torch.float32)
    port = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=params, **port_h)
    tok = port.tokenizer
    prompts = [tok.encode(t) for t in TEXTS[:3]] + [tok.encode("long " * 18)]
    jobs = [(ids, dict(max_tokens=m, trace_ctx=ctx, tenant=tenant))
            for ids, m, ctx, tenant in zip(prompts, (9, 6, 12, 5), TRACES,
                                           ("team:a", "", "team:a", "key:b"))]
    outs = [serve(ref, jobs), serve(port, jobs)]
    assert outs[0] == outs[1]
    return (ref, ref_h), (port, port_h)


def _spans(tracer):
    """{trace: {name: (parent, sorted attribute keys, event names)}}."""
    out = {}
    for span in tracer.finished:
        if span.trace_id in {t for t, _ in TRACES}:
            out.setdefault(span.trace_id, {})[span.name] = (
                span.parent_span_id, sorted(span.attributes),
                sorted({ev[1] for ev in span.events}))
    return out


def test_spans_equal_jax(served):
    (_, ref_h), (_, port_h) = served
    want, got = _spans(ref_h["tracer"]), _spans(port_h["tracer"])
    assert got == want
    assert len(got) == 4
    for trace, parent in TRACES:
        assert set(got[trace]) == {"llm.queue", "llm.prefill", "llm.decode"}
        assert all(span[0] == parent for span in got[trace].values())


def _samples(metrics) -> set[tuple[str, str]]:
    """(sample name, label set) of every mcpforge_llm sample line."""
    out = set()
    for line in metrics.render()[0].decode().splitlines():
        if line.startswith("mcpforge_llm") and not line.startswith(ENGINE_SPECIFIC):
            name, _, rest = line.partition("{")
            labels = rest.rpartition("}")[0] if rest else ""
            out.add((name.split()[0], labels))
    return out


def test_metric_families_and_labels_equal_jax(served):
    (_, ref_h), (port, port_h) = served
    got, want = _samples(port_h["metrics"]), _samples(ref_h["metrics"])
    assert got == want
    names = {name for name, _ in got}
    assert {"mcpforge_llm_ttft_seconds_count", "mcpforge_llm_tpot_seconds_count",
            "mcpforge_llm_queue_wait_seconds_count", "mcpforge_llm_dispatch_gap_seconds_count",
            "mcpforge_llm_kv_bytes_in_use", "mcpforge_llm_step_tokens_per_sec",
            "mcpforge_llm_device_idle_fraction", "mcpforge_llm_tokens_per_dispatch_ewma"} <= names
    assert ("mcpforge_llm_ttft_seconds_count",
            'model="llama3-test",replica="0",tenant="team:a"') in got
    # the port's own roofline gauges, from step_cost
    text = port_h["metrics"].render()[0].decode()
    assert float(text.split('mcpforge_llm_mfu{replica="0"} ')[1].split()[0]) > 0
    assert port.roofline_snapshot()["hbm_roofline_frac"] > 0


def test_signals_and_ledger_equal_jax(served):
    """The same signal series (name@replica; the roofline's two aside, as
    above) and the same per-tenant counts, each counted where the untagged
    counter is."""
    (_, ref_h), (port, port_h) = served
    skip = ("llm.mfu@", "llm.hbm_roofline_frac@")
    names = [{key for key in h["signals"].snapshot() if not key.startswith(skip)}
             for h in (ref_h, port_h)]
    assert names[1] == names[0]
    assert {"llm.ttft_ms@0", "llm.queue_wait_ms@0", "llm.tokens_per_dispatch@0",
            "llm.occupancy@0", "llm.idle_frac@0", "llm.tpot_ms@0"} <= names[1]
    assert "llm.mfu@0" in port_h["signals"].snapshot()
    counted = ("requests", "prompt_tokens", "generated_tokens", "cache_hit_tokens")
    totals = [{tenant: {k: row[k] for k in counted}
               for tenant, row in h["ledger"].totals().items()} for h in (ref_h, port_h)]
    assert totals[1] == totals[0]
    assert len(totals[1]) == 3
    assert sum(row["generated_tokens"] for row in totals[1].values()) \
        == port.stats.completion_tokens
    assert all(row["kv_page_seconds"] > 0 for row in port_h["ledger"].totals().values())


def test_ring_sequence_equals_jax(served):
    """The ring rows in order: kind, rows, tokens and (decode) width equal
    TPUEngine's. A prefill's width is the port's dispatch width (its rows;
    it pads no batch) where the JAX engine pads to a power of two."""
    (ref, _), (port, _) = served
    want, got = ref.recent_steps(), port.recent_steps()
    assert [(s["kind"], s["batch"], s["tokens"]) for s in got] == \
        [(s["kind"], s["batch"], s["tokens"]) for s in want]
    kinds = {s["kind"] for s in got}
    assert {"prefill", "chunk_prefill", "decode"} <= kinds
    for mine, theirs in zip(got, want):
        if mine["kind"] == "decode":
            assert (mine["width"], mine["superstep"], mine["frozen"]) == \
                (theirs["width"], theirs["superstep"], theirs["frozen"])
        else:
            assert mine["width"] == mine["batch"]
            assert theirs["width"] == 1 << (mine["batch"] - 1).bit_length()
            assert mine["bucket"] == theirs["bucket"]
    assert set(got[0]) == set(want[0])


def test_ring_bounded_and_shaped():
    engine = TorchEngine(EngineConfig(**SHAPE, device="cpu", step_log_size=8))
    serve(engine, [(engine.tokenizer.encode("fill the ring"), dict(max_tokens=24))])
    steps = engine.recent_steps()
    assert 0 < len(steps) <= 8 and len(engine.step_log) <= 8
    kinds = {s["kind"] for s in steps}
    assert kinds <= {"prefill", "chunk_prefill", "decode", "spec_decode"}
    assert "decode" in kinds
    for step in steps:
        assert step["duration_ms"] >= 0
        assert step["width"] >= step["batch"] >= 0
        assert step["kv_pages_in_use"] >= 0
        if step["kind"] == "decode":
            assert step["mfu"] > 0 and step["hbm_frac"] > 0
    seqs = [s["seq"] for s in steps]
    assert seqs == sorted(seqs) and seqs[-1] > 8
    assert engine.recent_steps(limit=2) == steps[-2:]
    assert 0.0 <= engine.device_idle_fraction() <= 1.0
    assert engine.last_step_age() >= 0.0 and engine.heartbeat_age() >= 0.0
    assert not engine.dispatch_alive()


def test_engine_without_handles_is_silent():
    """No handles: the same requests (trace contexts and tenants set) serve
    with nothing to report to; a tracer with no trace context emits no
    engine span; cost_analysis off leaves the roofline empty."""
    bare = TorchEngine(EngineConfig(**SHAPE, device="cpu", cost_analysis=False))
    outs = serve(bare, [(bare.tokenizer.encode(t), dict(max_tokens=5, trace_ctx=ctx,
                                                        tenant="team:a"))
                        for t, ctx in zip(TEXTS, TRACES)])
    assert all(tokens for tokens, _ in outs)
    assert bare.roofline_snapshot() == {"window_steps": 0, "cost_entries": {}}
    assert all(s["mfu"] is None for s in bare.recent_steps())
    tracer = Tracer(exporter="memory")
    quiet = TorchEngine(EngineConfig(**SHAPE, device="cpu"), tracer=tracer)
    serve(quiet, [(quiet.tokenizer.encode("no spans please"), dict(max_tokens=4))])
    assert not [s for s in tracer.finished if s.name.startswith("llm.")]


def test_served_spans_and_families_pinned_for_the_card():
    """What ``chip_smoke.py`` holds the card's llama3-8b ops phase to, on
    the CPU with its own telemetry handles (the port's tracer, signal bus,
    metrics registry and tenant ledger): chats through the provider
    with phase sampling and a K move report exactly SERVED_SPANS and
    SERVED_FAMILIES, read from the registry's ``collect()`` (the card adds
    the construction's capture events, CAPTURE_FAMILIES)."""
    from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

    handles = chip_smoke.telemetry_handles()
    engine = TorchEngine(EngineConfig(**SHAPE, device="cpu", k_ladder=(1, 4),
                                      step_sample_every=4), **handles)
    provider = TorchLocalProvider("tpu_local", engine, tracer=handles["tracer"],
                                  metrics=handles["metrics"])

    async def main():
        await engine.start()
        try:
            first = await provider.chat(chip_smoke.chat("llama3-test", "Hello!"))
            assert engine.request_knobs(superstep=4) == {"superstep": True}
            # the provider stamps the request's tenant from the port's own
            # contextvar (a gateway sets it around the call)
            token = set_current_tenant("team:x")
            try:
                tenant_chat = asyncio.ensure_future(
                    provider.chat(chip_smoke.chat("llama3-test", "bill me")))
            finally:
                reset_current_tenant(token)
            return [first, await tenant_chat] + await asyncio.gather(*[
                provider.chat(chip_smoke.chat("llama3-test", text)) for text in TEXTS])
        finally:
            await engine.stop()

    replies = asyncio.run(main())
    assert len(replies) == 6
    ledger = handles["ledger"].totals()
    assert set(ledger) == {"unattributed", "team:x"} and ledger["team:x"]["requests"] == 1
    assert ledger["team:x"]["generated_tokens"] == \
        replies[1]["usage"]["completion_tokens"]
    assert {span.name for span in handles["tracer"].finished} == chip_smoke.SERVED_SPANS
    assert chip_smoke.label_names(handles["metrics"]) == chip_smoke.SERVED_FAMILIES
    assert engine.stats.phase_samples > 0
    assert {k for row in engine.recent_steps() if row["kind"] == "decode"
            for k in [row["superstep"]]} == {1, 4}
