"""The port's /v1 admission pieces against the JAX package's, on the CPU:
the overload shedder's verdicts over a grid of saturations, SLO classes
and quota ratios (and the degradation state it reports); the
``PhaseClock``'s self-time vectors on a scripted clock; the tracer's span
names, parents, attributes and statuses; and the two /v1 apps built with
``gw_shed_saturation_at`` 0 and the class order ``["batch"]``: a ``batch``
tenant gets the same 429 with Retry-After from both, a ``default`` tenant
is admitted by both, and the port's request leaves the span tree
``http.request`` -> ``llm.request`` -> ``llm.queue``/``llm.prefill``/
``llm.decode`` and a phase vector that sums to its wall."""

import asyncio
import dataclasses
import itertools

import aiohttp
import jax
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mcp_context_forge_tpu.config import load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.observability import degradation as jax_degradation
from mcp_context_forge_tpu.observability import phases as jax_phases
from mcp_context_forge_tpu.observability import tracing as jax_tracing
from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch.observability import degradation as port_degradation
from mcp_context_forge_tpu_torch.observability import phases as port_phases
from mcp_context_forge_tpu_torch.observability import tracing as port_tracing
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

DEGRADATION = {"jax": jax_degradation, "port": port_degradation}


class Ledger:
    def __init__(self, ratios):
        self.ratios = ratios

    def quota_ratio(self, tenant):
        return self.ratios.get(tenant, 0.0)


class Limiter:
    """A shared-window stand-in: refuses one tenant's quota."""
    enabled = True

    async def decide(self, tenant, est_tokens):
        if tenant == "team:over":
            return {"retry_after_s": 4, "reason": "quota", "est_tokens": est_tokens}
        return None


TENANTS = {"team:batch": "batch", "team:std": "standard", "team:gold": "premium",
           "team:over": "batch"}
SATURATIONS = [0.0, 0.5, 0.6, 0.7, 0.79, 0.8, 0.9, 0.95, 1.0]


@pytest.mark.parametrize("shed_at,order", [(0.6, ["batch", "standard"]), (0.0, ["batch"]),
                                           (0.95, []), (1.0, ["standard"])])
def test_shedder_verdicts_equal(shed_at, order):
    ratios = {"team:std": 1.2, "team:gold": 0.99, "team:over": 3.7}
    results = {}
    for name, module in DEGRADATION.items():
        manager = module.configure_degradation()
        shedder = module.OverloadShedder(shed_at=shed_at, class_order=order,
                                         tenant_classes=TENANTS, ledger=Ledger(ratios),
                                         degradation=manager, limiter=Limiter())
        verdicts = []
        for saturation, tenant in itertools.product(
                SATURATIONS, ["", "team:batch", "team:std", "team:gold", "team:over"]):
            verdicts.append(shedder.decide(saturation, tenant))
            verdicts.append(asyncio.run(shedder.decide_admission(saturation, tenant, 12.5)))
            verdicts.append(manager.component_state("llm.overload"))
        results[name] = (verdicts, shedder.shed_total,
                         [{k: v for k, v in row.items() if k != "ts"}
                          for row in manager.transitions()])
        module.configure_degradation()
    assert results["port"] == results["jax"]
    verdicts = results["port"][0]
    assert any(v is not None and isinstance(v, dict) for v in verdicts)


def test_breaker_ladder_equal(monkeypatch):
    """The same failure/success sequence walks both breakers through the
    same states on a scripted clock."""
    now = [1000.0]
    states = {}
    for name, module in DEGRADATION.items():
        monkeypatch.setattr(module.time, "monotonic", lambda: now[0])
        now[0] = 1000.0
        manager = module.configure_degradation(failure_threshold=2, cooldown_s=5.0)
        breaker = manager.breaker("tier.disk")
        trail = []
        for step in ["f", "f", "a", "t6", "a", "a", "f", "t6", "a", "s", "a"]:
            if step == "f":
                breaker.record_failure("io")
            elif step == "s":
                breaker.record_success()
            elif step == "a":
                trail.append(breaker.allow())
            else:
                now[0] += float(step[1:])
            trail.append(breaker.state)
        status = manager.status()
        states[name] = (trail, status["components"], [
            (t["from"], t["to"]) for t in status["transitions"]])
        module.configure_degradation()
    assert states["port"] == states["jax"]
    assert ("open", "half_open") in states["port"][2]


def _scripted_vector(module, monkeypatch):
    ticks = iter(range(0, 10_000, 7))
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks) / 1000.0)
    clock = module.PhaseClock()
    token = module.set_phase_clock(clock)
    try:
        with module.phase("auth"):
            module.add_phase("db", 0.004)
        with module.phase("engine"):
            with module.phase("routing"):
                pass
            with module.phase("serialize"):
                with module.phase("engine"):
                    pass
        clock.add("negative", -1.0)
        assert module.current_phases() is clock
    finally:
        module.reset_phase_clock(token)
    assert module.current_phases() is None
    with module.phase("ignored"):   # no clock: a no-op
        pass
    return clock.vector_ms(), round(clock.total(), 9)


def test_phase_clock_self_time_equal(monkeypatch):
    got = {name: _scripted_vector(module, monkeypatch)
           for name, module in (("jax", jax_phases), ("port", port_phases))}
    assert got["port"] == got["jax"]
    vector, total = got["port"]
    assert set(vector) == {"auth", "db", "engine", "routing", "serialize"}
    assert abs(sum(vector.values()) / 1e3 - total) < 1e-6


def _span_tree(module):
    tracer = module.Tracer(exporter="memory")
    with tracer.span("http.request", {"http.method": "POST"},
                     traceparent="00-" + "ab" * 16 + "-" + "cd" * 8 + "-01") as root:
        root.set_attribute("http.status_code", 200)
        with tracer.span("llm.request", {"gen_ai.system": "tpu_local"}) as req:
            tracer.emit_span("llm.queue", 1.0, 2.0, trace_ctx=req.context(),
                             attributes={"llm.queue_ms": 1.0},
                             events=[(1.5, "admit", {"slot": 0})])
            req.add_event("gen_ai.first_token")
        try:
            with tracer.span("plugin.hook"):
                raise ValueError("refused")
        except ValueError:
            pass
    with tracer.span("orphan", traceparent="00-XYZ-bad-01"):
        pass
    assert module.current_span() is None
    ids = {s.span_id: s.name for s in tracer.finished}
    return [(s.name, ids.get(s.parent_span_id, s.parent_span_id), s.trace_id == root.trace_id,
             s.attributes, s.status, [e[1:] for e in s.events], s.end_ts is not None)
            for s in tracer.finished]


def test_tracer_spans_equal():
    got = {name: _span_tree(module) for name, module in (("jax", jax_tracing),
                                                         ("port", port_tracing))}
    assert got["port"] == got["jax"]
    assert [row[:3] for row in got["port"]] == [
        ("llm.queue", "llm.request", True), ("llm.request", "http.request", True),
        ("plugin.hook", "http.request", True), ("http.request", "cd" * 8, True),
        ("orphan", None, False)]
    assert port_tracing.parse_traceparent("00-" + "AB" * 16 + "-" + "cd" * 8 + "-01") is None


ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_ENABLED": "true",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "2",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "128",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "32",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
    "MCPFORGE_GW_SHED_SATURATION_AT": "0",
    "MCPFORGE_GW_SHED_CLASS_ORDER": '["batch"]',
    "MCPFORGE_SLO_TENANT_CLASSES": '{"user:batch@example.com": "batch"}',
}


@pytest.fixture(scope="module")
def apps():
    settings = load_settings(env=ENV, env_file=None)
    loop = asyncio.new_event_loop()

    async def build():
        ref_app = await build_app(settings)
        config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu")
        engine = TorchEngine(config, params=params_from_jax(
            jax.device_get(ref_app["tpu_engine"].params), MODEL_CONFIGS[config.model],
            device="cpu", dtype=torch.float32))
        port_app = build_llm_app(settings, engine=engine)
        clients = []
        for app in (ref_app, port_app):
            client = TestClient(TestServer(app))
            await client.start_server()
            clients.append(client)
        return clients, port_app

    clients, port_app = loop.run_until_complete(build())
    yield loop, settings, clients, port_app
    for client in clients:
        loop.run_until_complete(client.close())
    loop.close()


CHAT = {"model": "llama3-test", "max_tokens": 4,
        "messages": [{"role": "user", "content": "shed me?"}]}


def _post(apps, headers):
    loop, _, clients, _ = apps

    async def one(client):
        resp = await client.post("/v1/chat/completions", json=CHAT, headers=headers)
        return resp.status, dict(resp.headers), await resp.json()

    return [loop.run_until_complete(asyncio.wait_for(one(c), 120)) for c in clients]


def test_batch_tenant_shed_with_429_by_both(apps):
    settings = apps[1]
    token = jax_jwt.create_token({"sub": "batch@example.com"}, settings.jwt_secret_key,
                                 audience=settings.jwt_audience, issuer=settings.jwt_issuer)
    ref, port = _post(apps, {"Authorization": f"Bearer {token}"})
    assert ref[0] == port[0] == 429
    assert port[2] == ref[2]
    assert port[2]["error"]["slo_class"] == "batch"
    assert port[2]["error"]["reason"] == "overload"
    for key in ("Retry-After", "X-Queue-Depth"):
        assert port[1][key] == ref[1][key]


def test_default_tenant_admitted_by_both_with_spans_and_phases(apps):
    settings, port_app = apps[1], apps[3]
    basic = aiohttp.BasicAuth(settings.basic_auth_user, settings.basic_auth_password)
    tracer = port_app["tracer"]
    tracer.finished.clear()
    ref, port = _post(apps, {"Authorization": basic.encode()})
    assert ref[0] == port[0] == 200
    assert port[2]["choices"] == ref[2]["choices"]
    spans = {s.span_id: s for s in tracer.finished}
    roots = [s for s in spans.values() if s.name == "http.request"]
    assert len(roots) == 1 and roots[0].attributes["http.status_code"] == 200
    assert roots[0].attributes["gw.tenant"] == f"user:{settings.platform_admin_email}"
    parents = {s.name: spans[s.parent_span_id].name for s in spans.values()
               if s.parent_span_id in spans}
    assert parents == {"llm.request": "http.request", "llm.queue": "llm.request",
                       "llm.prefill": "llm.request", "llm.decode": "llm.request"}
    assert roots[0].attributes["gen_ai.operation.name"] == "chat"
    (event,) = [e for e in roots[0].events if e[1] == "gw.phases"]
    phases = dict(event[2])
    wall = phases.pop("duration_ms")
    assert {"auth", "engine", "serialize", "handler"} <= set(phases)
    assert abs(sum(phases.values()) - wall) <= 0.01 + 1e-3 * wall
