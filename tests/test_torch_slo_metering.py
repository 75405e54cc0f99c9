"""The port's SLO evaluator, tenant ledger, tenant clamp, trace store,
distributed tenant limiter and fleet view against the JAX package's, on
the CPU. Each pair gets the same seeded numpy-made input sequence (label
values, values, trace ids, tenants, token counts) and must give equal
results: SLO reports (global, per tenant, per consumer window; the clock
scripted), ledger totals, quota ratios and drained windows, clamp
admissions, the trace ids the store keeps, the limiter's verdicts over the
memory, file and hub counters, and the merged fleet exposition of two
workers on each package's memory bus."""

import asyncio
import dataclasses
import itertools
import json
import re
import time
from types import SimpleNamespace

import numpy as np
import pytest

from mcp_context_forge_tpu.coordination import bus as jax_bus
from mcp_context_forge_tpu.coordination import hub as jax_hub
from mcp_context_forge_tpu.coordination import ratelimit as jax_rl
from mcp_context_forge_tpu.observability import fleet as jax_fleet
from mcp_context_forge_tpu.observability import metering as jax_metering
from mcp_context_forge_tpu.observability import metrics as jax_metrics
from mcp_context_forge_tpu.observability import slo as jax_slo
from mcp_context_forge_tpu.observability import tenant as jax_tenant
from mcp_context_forge_tpu.observability import trace_store as jax_store
from mcp_context_forge_tpu.observability import tracing as jax_tracing
from mcp_context_forge_tpu_torch.coordination import bus as port_bus
from mcp_context_forge_tpu_torch.coordination import hub as port_hub
from mcp_context_forge_tpu_torch.coordination import ratelimit as port_rl
from mcp_context_forge_tpu_torch.observability import fleet as port_fleet
from mcp_context_forge_tpu_torch.observability import metering as port_metering
from mcp_context_forge_tpu_torch.observability import metrics as port_metrics
from mcp_context_forge_tpu_torch.observability import slo as port_slo
from mcp_context_forge_tpu_torch.observability import tenant as port_tenant
from mcp_context_forge_tpu_torch.observability import trace_store as port_store
from mcp_context_forge_tpu_torch.observability import tracing as port_tracing
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

PACKAGES = {
    "jax": SimpleNamespace(metrics=jax_metrics, tenant=jax_tenant, slo=jax_slo,
                           metering=jax_metering, store=jax_store, tracing=jax_tracing,
                           rl=jax_rl, hub=jax_hub, bus=jax_bus, fleet=jax_fleet),
    "port": SimpleNamespace(metrics=port_metrics, tenant=port_tenant, slo=port_slo,
                            metering=port_metering, store=port_store, tracing=port_tracing,
                            rl=port_rl, hub=port_hub, bus=port_bus, fleet=port_fleet),
}
TENANTS = ["team:a", "key:b", "user:c", "team:d", "team:e", "key:f", "", "team:g"]
SETTINGS = SimpleNamespace(
    slo_ttft_p95_ms=200.0, slo_tpot_p95_ms=40.0, slo_queue_wait_p95_ms=100.0,
    slo_http_p95_ms=300.0,
    slo_classes=json.dumps({"premium": {"ttft_p95_ms": 50.0},
                            "batch": {"ttft_p95_ms": 5000.0, "tpot_p95_ms": 500.0}}),
    slo_tenant_classes=json.dumps({"team:a": "premium", "key:b": "batch"}))


def _observe(reg, rng, n: int) -> None:
    """n seeded observations of the four objective histograms."""
    for _ in range(n):
        tenant = reg.tenant_clamp.label(TENANTS[int(rng.integers(len(TENANTS)))])
        ttft, tpot = float(rng.lognormal(-2.5, 1.2)), float(rng.lognormal(-4.0, 0.8))
        reg.llm_ttft.labels("llama3-test", str(int(rng.integers(2))), tenant).observe(ttft)
        reg.llm_tpot.labels("llama3-test", "0", tenant).observe(tpot)
        reg.llm_queue_wait.labels(tenant).observe(float(rng.lognormal(-4.0, 1.5)))
        reg.http_duration.labels("POST", "/v1/chat/completions", tenant).observe(
            float(rng.lognormal(-2.0, 1.0)))


@pytest.fixture
def scripted_time(monkeypatch):
    """time.time() as a counter: each call one second later."""
    ticks = itertools.count(1_760_000_000)
    monkeypatch.setattr(time, "time", lambda: float(next(ticks)))


def test_slo_settings_parse_equal():
    out = {}
    for name, module in (("jax", jax_slo), ("port", port_slo)):
        bad = SimpleNamespace(**{**vars(SETTINGS), "slo_classes": "[1]",
                                 "slo_tenant_classes": "{"})
        errors = []
        for parse in (module.parse_slo_classes, module.parse_tenant_classes):
            with pytest.raises(ValueError) as exc:
                parse(bad)
            errors.append(str(exc.value))
        out[name] = ([dataclasses.asdict(o) for o in module.default_objectives(SETTINGS)],
                     {k: dataclasses.asdict(v)
                      for k, v in module.parse_slo_classes(SETTINGS).items()},
                     module.parse_tenant_classes(SETTINGS), errors)
    assert out["port"] == out["jax"]
    assert set(out["port"][1]) == {"default", "premium", "batch"}


def _report(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in ("evaluated_at",)}


def test_slo_reports_equal(scripted_time):
    """The same histograms under both evaluators: three observation phases,
    each evaluated by two consumers (and more than MAX_CONSUMERS, which
    evicts), globally and per tenant (classed, default-class, clamped and
    unknown), alternating between the packages on one scripted clock."""
    evaluators, regs = {}, {}
    for name, pkg in PACKAGES.items():
        clamp = pkg.tenant.TenantClamp(4)
        regs[name] = pkg.metrics.PrometheusRegistry(tenant_clamp=clamp)
        evaluators[name] = pkg.slo.SloEvaluator(
            regs[name], pkg.slo.default_objectives(SETTINGS), error_budget=0.05,
            slo_classes=pkg.slo.parse_slo_classes(SETTINGS),
            tenant_classes=pkg.slo.parse_tenant_classes(SETTINGS), tenant_label=clamp.peek)
    reports = {"jax": [], "port": []}
    consumers = ["default", "harness"] + [f"poll{i}" for i in range(16)]
    for phase in range(3):
        for name in PACKAGES:
            _observe(regs[name], np.random.default_rng(phase), 40 + 30 * phase)
        for consumer, tenant in itertools.product(
                consumers[:2 + 8 * phase], [None, "team:a", "key:b", "user:c", "team:zz"]):
            for name in PACKAGES:
                reports[name].append(_report(evaluators[name].evaluate(consumer, tenant)))
    assert reports["port"] == reports["jax"]
    burning = [o for r in reports["port"] for o in r["objectives"] if not o["ok"]]
    assert burning and any(r.get("tenant_clamped") for r in reports["port"])
    assert any(o["window_samples"] > 0 for r in reports["port"] for o in r["objectives"])


def _ledger_run(pkg, seed: int):
    clamp = pkg.tenant.TenantClamp(3)
    reg = pkg.metrics.PrometheusRegistry(tenant_clamp=clamp)
    ledger = pkg.metering.TenantLedger(clamp=clamp, metrics=reg, max_tenants=5,
                                       quota_tokens_per_window=500)
    rng = np.random.default_rng(seed)
    trail = []
    for step in range(400):
        tenant = TENANTS[int(rng.integers(len(TENANTS)))]
        kind = int(rng.integers(5))
        ledger.add(tenant, requests=int(kind == 0), prompt_tokens=int(rng.integers(0, 60)),
                   generated_tokens=int(rng.integers(0, 3)),
                   cache_hit_tokens=int(rng.integers(0, 2)) * 16,
                   kv_page_seconds=float(rng.random()) if kind == 1 else 0.0)
        if step % 25 == 0:
            trail.append([ledger.quota_ratio(t) for t in TENANTS])
        if step % 120 == 119:
            trail.append(ledger.take_window()[1])
    snapshot = ledger.snapshot(limit=4)
    snapshot.pop("window_started")
    text = reg.render()[0].decode()
    text = re.sub(r"^(\S+_created(?:\{[^}]*\})?) \S+$", r"\1 T", text, flags=re.M)
    return ledger.totals(), ledger.column_sums(), trail, snapshot, clamp.snapshot(), text


def test_ledger_equal():
    want, got = (_ledger_run(pkg, 7) for pkg in PACKAGES.values())
    assert got == want
    totals = got[0]
    assert "other" in totals and "unattributed" in totals   # past max_tenants; ""
    assert "mcpforge_gw_tenant_quota_used_ratio" in got[5]


def test_clamp_admits_the_same_tenants():
    rng = np.random.default_rng(3)
    calls = [(str(rng.choice(["label", "peek"])), TENANTS[int(rng.integers(len(TENANTS)))])
             for _ in range(200)]
    out = {}
    for name, pkg in PACKAGES.items():
        clamp = pkg.tenant.TenantClamp(3)
        out[name] = ([getattr(clamp, fn)(tenant) for fn, tenant in calls], clamp.snapshot())
    assert out["port"] == out["jax"]
    assert "other" in out["port"][0]


def _span_stream(seed: int) -> list[dict]:
    """Span fields of many traces: a root (http.request or a parentless
    llm.request) over llm.queue/prefill/decode children, some traces
    rootless, some erroring; routes, tenants and durations seeded."""
    rng = np.random.default_rng(seed)
    spans, t = [], 1_760_000_000.0
    for i in range(150):
        trace = f"{int(rng.integers(1 << 62)):016x}{i:016x}"
        root_id = f"{i:08x}00000000"
        root_name = str(rng.choice(["http.request", "llm.request"]))
        tenant = TENANTS[int(rng.integers(len(TENANTS)))] or "anonymous"
        route = f"/v1/route{int(rng.integers(6))}"
        queue, prefill, decode = (float(x) for x in rng.lognormal(-3.0, 1.0, 3))
        tokens = int(rng.integers(1, 40))
        start = t + i
        children = [("llm.queue", start, start + queue, {}),
                    ("llm.prefill", start + queue, start + queue + prefill, {}),
                    ("llm.decode", start + queue + prefill, start + queue + prefill + decode,
                     {"gen_ai.usage.completion_tokens": tokens, "llm.replica_id": "0"})]
        status = "ERROR" if rng.random() < 0.08 else "OK"
        for k, (name, s, e, attrs) in enumerate(children):
            spans.append(dict(name=name, trace_id=trace, span_id=f"{i:08x}{k + 1:08x}",
                              parent_span_id=root_id, start_ts=s, end_ts=e,
                              status=status if name == "llm.decode" else "OK",
                              attributes={"llm.tenant": tenant, **attrs}))
        if rng.random() < 0.9:
            end = start + queue + prefill + decode + float(rng.random()) * 0.01
            spans.append(dict(name=root_name, trace_id=trace, span_id=root_id,
                              parent_span_id=None, start_ts=start, end_ts=end, status="OK",
                              attributes={"http.route": route, "gw.tenant": tenant}))
            spans[-1]["exemplar"] = (float(rng.lognormal(-2.5, 1.2)),
                                     str(rng.choice(["a", "b"])))
    return spans


def _store_run(pkg, spans: list[dict]):
    ledger = pkg.store.ExemplarLedger(max_entries=16)
    ledger.register("llm_ttft", (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0))
    store = pkg.store.TraceStore(max_traces=32, max_spans_per_trace=8, sample_every=4,
                                 slowest_per_key=2, max_keys=3, idle_finalize_s=0.0,
                                 slo_targets={"http": 0.5, "ttft": 0.2, "tpot": 0.02,
                                              "queue_wait": 0.1},
                                 exemplars=ledger)
    for fields in spans:
        fields = dict(fields)
        exemplar = fields.pop("exemplar", None)
        if exemplar is not None:
            ledger.note("llm_ttft", exemplar[0], fields["trace_id"], (exemplar[1],))
        store.sink(pkg.tracing.Span(**fields))
    snapshot = store.snapshot(limit=1000)
    for summary in snapshot["traces"]:
        summary.pop("ts")
    kept = {}
    for trace in sorted({s["trace_id"] for s in spans}):
        entry = store.get(trace)
        if entry is not None:
            entry.pop("ts")
            kept[trace] = entry
    waterfalls = {trace: pkg.store.stitch_waterfall(entry["spans"])
                  for trace, entry in list(kept.items())[:20]}
    return snapshot, kept, waterfalls, ledger.stats(), sorted(ledger.trace_ids())


def test_trace_store_keeps_the_same_traces():
    spans = _span_stream(11)
    want, got = (_store_run(pkg, spans) for pkg in PACKAGES.values())
    assert got == want
    snapshot = got[0]
    assert snapshot["retained"] == 32 and snapshot["evicted"] > 0
    reasons = {r for t in snapshot["traces"] for r in t["reasons"]}
    assert {"error", "slo_breach", "exemplar"} <= reasons


class _ScriptedTime:
    """The ``time`` a limiter module sees: monotonic advances 50 ms per
    read, so refusal caching and grant expiry do not hang on the box's
    speed; wall time is the real one (the file counter's window)."""

    def __init__(self):
        self._ticks = itertools.count()
        self.time = time.time

    def monotonic(self) -> float:
        return 1000.0 + 0.05 * next(self._ticks)


async def _limiter_run(pkg, counter) -> tuple:
    clamp = pkg.tenant.TenantClamp(8)
    ledger = pkg.metering.TenantLedger(clamp=clamp)
    limiter = pkg.rl.DistributedTenantLimiter(counter, ledger, quota_tokens=4000,
                                              window_s=3600.0, burst_tokens=900,
                                              sync_interval_s=0.02)
    rng = np.random.default_rng(5)
    verdicts = []
    for step in range(90):
        tenant = ["team:a", "key:b", "user:c"][int(rng.integers(3))]
        est = float(rng.integers(1, 500))
        verdict = await limiter.decide(tenant, est)
        if verdict is None:
            actual = max(1, int(est + rng.integers(-50, 120)))
            ledger.add(tenant, requests=1, prompt_tokens=actual // 2,
                       generated_tokens=actual - actual // 2)
            verdicts.append(None)
        else:
            assert verdict["retry_after_s"] >= 1
            verdicts.append({k: v for k, v in verdict.items() if k != "retry_after_s"})
        if step % 6 == 5:
            await limiter.reconcile()
    return verdicts, limiter.stats()


@pytest.mark.parametrize("backend", ["memory", "file", "hub"])
def test_limiter_grants_equal(backend, tmp_path, monkeypatch):
    results = {}

    async def run(name, pkg):
        monkeypatch.setattr(pkg.rl, "time", _ScriptedTime())
        if backend != "hub":
            counter = pkg.rl.make_rate_counter(backend, str(tmp_path / name))
            return await _limiter_run(pkg, counter)
        hub = pkg.hub.CoordinationHub("127.0.0.1", 0, secret="limiter-secret")
        await hub.start()
        client = pkg.hub.HubClient("127.0.0.1", hub.bound_port, secret="limiter-secret")
        await client.start()
        try:
            counter = pkg.rl.make_rate_counter("tcp", str(tmp_path), hub_client=client)
            assert type(counter).__name__ == "HubRateCounter"
            return await _limiter_run(pkg, counter)
        finally:
            await client.stop()
            await hub.stop()

    for name, pkg in PACKAGES.items():
        results[name] = asyncio.run(run(name, pkg))
    assert results["port"] == results["jax"]
    verdicts, stats = results["port"]
    assert None in verdicts and any(v is not None for v in verdicts)
    assert stats["grants_taken"] > 0 and stats["refusals"] > 0


def _fleet_run(pkg) -> tuple:
    async def run():
        bus = pkg.bus.MemoryEventBus()
        workers = []
        for k, worker in enumerate(("w0", "w1")):
            reg = pkg.metrics.PrometheusRegistry(tenant_clamp=pkg.tenant.TenantClamp(4))
            _observe(reg, np.random.default_rng(20 + k), 60)
            reg.llm_queue_depth.labels(replica="0").set(3 + k)
            reg.http_requests.labels("GET", "/x", "200").inc(5 + k)
            workers.append(pkg.fleet.FleetMetrics(bus, worker, reg, interval_s=60.0))
        for fleet in workers:
            await fleet.start()
        try:
            for fleet in workers:
                await fleet.publish_once()
            body, content_type = workers[0].render_fleet()
            view = pkg.fleet.FleetMetricsView(workers[0].metrics, workers[0])
            evaluator = pkg.slo.SloEvaluator(view, pkg.slo.default_objectives(SETTINGS))
            report = evaluator.evaluate("fleet", None)
            report.pop("evaluated_at")
            return body, content_type, workers[0].stats(), report
        finally:
            for fleet in workers:
                await fleet.stop()

    return asyncio.run(run())


def test_fleet_render_equal(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.25)
    want, got = _fleet_run(PACKAGES["jax"]), _fleet_run(PACKAGES["port"])
    assert got == want
    text = got[0].decode()
    assert 'mcpforge_llm_queue_depth{replica="0",worker="w0"} 3.0' in text
    assert 'mcpforge_llm_queue_depth{replica="0",worker="w1"} 4.0' in text
    assert 'mcpforge_http_requests_total{method="GET",path="/x",status="200"} 11.0' in text
    assert got[3]["objectives"][0]["total_samples"] == 120


def _fleet_renders(packages, directory) -> list:
    """Each worker's fleet render, ``_created`` lines dropped, once it holds
    its peer's frame: w0 of ``packages[0]`` and w1 of ``packages[1]``, seeded
    as in ``_fleet_run``, each on its package's file bus over ``directory``."""
    async def run():
        workers = []
        for k, pkg in enumerate(packages):
            reg = pkg.metrics.PrometheusRegistry(tenant_clamp=pkg.tenant.TenantClamp(4))
            _observe(reg, np.random.default_rng(20 + k), 60)
            reg.llm_queue_depth.labels(replica="0").set(3 + k)
            reg.http_requests.labels("GET", "/x", "200").inc(5 + k)
            workers.append(pkg.fleet.FleetMetrics(pkg.bus.FileEventBus(str(directory)),
                                                  f"w{k}", reg, interval_s=60.0))
        for fleet in workers:
            await fleet.bus.start()
            await fleet.start()
        try:
            deadline = time.monotonic() + 60
            while not all(len(fleet.live_peers()) == 1 for fleet in workers):
                assert time.monotonic() < deadline, "a worker never heard its peer"
                await asyncio.sleep(0.02)
            return ["\n".join(line for line in fleet.render_fleet()[0].decode().splitlines()
                              if "_created" not in line) for fleet in workers]
        finally:
            for fleet in workers:
                await fleet.stop()
                await fleet.bus.stop()

    return asyncio.run(run())


def test_mixed_fleet_renders_as_a_jax_fleet(tmp_path):
    """A port worker and a JAX worker on one bus directory, as in a fleet
    part way through moving to the port: each merges the other's frame, and
    both render the fleet view that two JAX workers render."""
    want = _fleet_renders((PACKAGES["jax"], PACKAGES["jax"]), tmp_path / "jax")
    got = _fleet_renders((PACKAGES["port"], PACKAGES["jax"]), tmp_path / "mixed")
    assert got == want
    assert 'mcpforge_llm_queue_depth{replica="0",worker="w1"} 4.0' in got[0]
    assert 'mcpforge_http_requests_total{method="GET",path="/x",status="200"} 11.0' in got[1]
