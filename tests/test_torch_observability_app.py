"""The observability plane through the port's ``build_llm_app`` against the
JAX gateway's, on the CPU (aiohttp): the four routes
(``/metrics/prometheus``, ``/admin/slo``, ``/admin/tenants/usage``,
``/admin/trace/{trace_id}``) answer with the JAX routes' status codes and
keys, enabled (a tiny engine on the JAX weights, fleet metrics and a tenant
quota on) and disabled (metering, the trace store and the fleet view off);
a ``ServingController`` over the port's evaluator publishes the same
``slo.burn_rate``, and moves ``shed_at`` the same way, as the JAX
controller over the JAX evaluator fed the same histograms; and the served
run of ``tests/test_torch_telemetry.py``, handed the port's own registry,
yields the same families and label sets as with the JAX registry."""

import asyncio
import dataclasses
import itertools
import re

import aiohttp
import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mcp_context_forge_tpu.config import load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.observability import degradation as jax_degradation
from mcp_context_forge_tpu.observability import metrics as jax_metrics
from mcp_context_forge_tpu.observability import signals as jax_signals
from mcp_context_forge_tpu.observability import slo as jax_slo
from mcp_context_forge_tpu.observability.metering import TenantLedger as JaxLedger
from mcp_context_forge_tpu.observability.tracing import Tracer as JaxTracer
from mcp_context_forge_tpu.tpu_local import controller as jax_controller
from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch.observability import degradation as port_degradation
from mcp_context_forge_tpu_torch.observability import metrics as port_metrics
from mcp_context_forge_tpu_torch.observability import signals as port_signals
from mcp_context_forge_tpu_torch.observability import slo as port_slo
from mcp_context_forge_tpu_torch.observability.metering import TenantLedger
from mcp_context_forge_tpu_torch.observability.tracing import Tracer
from mcp_context_forge_tpu_torch.tpu_local import controller as port_controller
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app
from torch_engine_pair import SHAPE, TEXTS, serve
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

ENGINE_ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "2",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "128",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "32",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
}
ENABLED = {**ENGINE_ENV, "MCPFORGE_TPU_LOCAL_ENABLED": "true",
           "MCPFORGE_GW_FLEET_METRICS": "true",
           "MCPFORGE_TENANT_QUOTA_TOKENS_PER_WINDOW": "100000",
           "MCPFORGE_SLO_TENANT_CLASSES": '{"user:admin@example.com": "default"}'}
DISABLED = {**ENGINE_ENV, "MCPFORGE_TPU_LOCAL_ENABLED": "false",
            "MCPFORGE_TENANT_METERING_ENABLED": "false",
            "MCPFORGE_TRACE_STORE_ENABLED": "false"}
# a quota the first chat spends whole; the shared limiter's window is an
# hour, so only the ledger's window (the rollup interval) decides admission
QUOTA = {**ENGINE_ENV, "MCPFORGE_TENANT_QUOTA_TOKENS_PER_WINDOW": "8",
         "MCPFORGE_TENANT_USAGE_ROLLUP_INTERVAL_S": "2.0",
         "MCPFORGE_TENANT_QUOTA_WINDOW_S": "3600"}
TRACE = "4bf92f3577b34da6a3ce929d0e0e4736"


def _app_pair(env: dict, jax_engine: bool):
    """(loop, settings, [JAX client, port client], port app): the JAX
    gateway and the port's app on the same settings; the port's engine on
    the JAX engine's weights when the JAX app has one, else a tiny CPU
    engine of its own."""
    settings = load_settings(env=env, env_file=None)
    loop = asyncio.new_event_loop()

    async def build():
        ref_app = await build_app(settings)
        config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu")
        params = (params_from_jax(jax.device_get(ref_app["tpu_engine"].params),
                                  MODEL_CONFIGS[config.model], device="cpu",
                                  dtype=torch.float32) if jax_engine else None)
        port_app = build_llm_app(settings, engine=TorchEngine(config, params=params))
        clients = []
        for app in (ref_app, port_app):
            client = TestClient(TestServer(app))
            await client.start_server()
            clients.append(client)
        return clients, port_app

    clients, port_app = loop.run_until_complete(build())
    return loop, settings, clients, port_app


def _close(pair) -> None:
    loop, _, clients, _ = pair
    for client in clients:
        loop.run_until_complete(client.close())
    loop.close()


@pytest.fixture(scope="module")
def apps():
    pair = _app_pair(ENABLED, jax_engine=True)
    yield pair
    _close(pair)


@pytest.fixture(scope="module")
def bare_apps():
    pair = _app_pair(DISABLED, jax_engine=False)
    yield pair
    _close(pair)


def _basic(settings) -> dict:
    auth = aiohttp.BasicAuth(settings.basic_auth_user, settings.basic_auth_password)
    return {"Authorization": auth.encode()}


def _get(pair, path: str, headers: dict | None = None, method: str = "get", **kwargs):
    """(status, content type, body) from the JAX app and the port's."""
    loop, settings, clients, _ = pair
    headers = _basic(settings) if headers is None else headers

    async def one(client):
        resp = await getattr(client, method)(path, headers=headers, **kwargs)
        body = await resp.read()
        if resp.content_type == "application/json":
            import json
            body = json.loads(body)
        return resp.status, resp.headers.get("Content-Type"), body

    return [loop.run_until_complete(asyncio.wait_for(one(c), 120)) for c in clients]


@pytest.fixture(scope="module")
def chatted(apps):
    """One chat through each app under the same W3C trace."""
    headers = {**_basic(apps[1]), "traceparent": f"00-{TRACE}-00f067aa0ba902b7-01"}
    chat = {"model": "llama3-test", "max_tokens": 4,
            "messages": [{"role": "user", "content": "count my tokens"}]}
    ref, port = _get(apps, "/v1/chat/completions", headers, method="post", json=chat)
    assert ref[0] == port[0] == 200
    assert port[2]["choices"] == ref[2]["choices"]
    return apps


def _series(text: str, prefix: str) -> set:
    """(sample name, label text) of the exposition's ``prefix`` samples."""
    out = set()
    for line in text.splitlines():
        if line.startswith(prefix) and "_created" not in line:
            name, _, rest = line.partition("{")
            out.add((name.split()[0], rest.rpartition("}")[0] if rest else ""))
    return out


def test_prometheus_route_equal(chatted):
    ref, port = _get(chatted, "/metrics/prometheus")
    assert ref[0] == port[0] == 200 and port[1] == ref[1]
    want, got = ref[2].decode(), port[2].decode()
    # every family (a _created group follows a family only once it has a child)
    families = [sorted(line for line in re.findall(r"^# (?:HELP|TYPE) .*$", t, re.M)
                       if "_created " not in line) for t in (want, got)]
    assert families[1] == families[0] and len(families[1]) == 2 * 59
    assert _series(got, "mcpforge_http_") == _series(want, "mcpforge_http_")
    assert ('mcpforge_http_requests_total', 'method="POST",path="/v1/chat/completions",'
            'status="200"') in _series(got, "mcpforge_http_")
    for tenant in ("user:admin@example.com",):
        assert f'tenant="{tenant}"' in got


def test_prometheus_openmetrics_and_fleet_equal(chatted):
    accept = {**_basic(chatted[1]), "Accept": "application/openmetrics-text"}
    ref, port = _get(chatted, "/metrics/prometheus", accept)
    assert ref[0] == port[0] == 200 and port[1] == ref[1]
    assert port[2].endswith(b"# EOF\n") and ref[2].endswith(b"# EOF\n")
    assert f'# {{trace_id="{TRACE}"}}'.encode() in port[2]
    ref, port = _get(chatted, "/metrics/prometheus?scope=fleet")
    assert ref[0] == port[0] == 200 and port[1] == ref[1]
    assert b'worker="' in port[2] and b'worker="' in ref[2]
    assert [s[0] for s in _get(chatted, "/metrics/prometheus", {})] == [401, 401]


def test_slo_route_equal(chatted):
    for query in ("", "?window=ui&tenant=user:admin@example.com", "?tenant=team:nobody",
                  "?scope=fleet"):
        ref, port = _get(chatted, "/admin/slo" + query)
        assert ref[0] == port[0] == 200, query
        assert set(port[2]) == set(ref[2]), query
        assert [o["name"] for o in port[2]["objectives"]] == \
            [o["name"] for o in ref[2]["objectives"]]
        assert [set(o) for o in port[2]["objectives"]] == [set(o) for o in ref[2]["objectives"]]
    ttft = next(o for o in port[2]["objectives"] if o["name"] == "ttft_p95")
    assert ttft["total_samples"] == 1 and port[2]["scope"] == "fleet"


def test_slo_route_needs_observability_read(chatted):
    settings = chatted[1]
    token = jax_jwt.create_token({"sub": "ci@example.com", "scopes": ["tools.read"]},
                                 settings.jwt_secret_key, audience=settings.jwt_audience,
                                 issuer=settings.jwt_issuer)
    statuses = [s[0] for s in _get(chatted, "/admin/slo", {"Authorization": f"Bearer {token}"})]
    assert statuses == [403, 403]


def test_tenant_usage_route_equal(chatted):
    ref, port = _get(chatted, "/admin/tenants/usage")
    assert ref[0] == port[0] == 200
    assert set(port[2]) == set(ref[2])
    assert [set(t) for t in port[2]["tenants"]] == [set(t) for t in ref[2]["tenants"]]
    row = next(t for t in port[2]["tenants"] if t["tenant"] == "user:admin@example.com")
    assert row["requests"] == 1 and row["generated_tokens"] == 4 and "quota_used_ratio" in row
    ref, port = _get(chatted, "/admin/tenants/usage?limit=many")
    assert ref[0] == port[0] == 422 and set(port[2]) == set(ref[2]) == {"detail"}


def test_trace_route_equal(chatted):
    ref, port = _get(chatted, f"/admin/trace/{TRACE}")
    assert ref[0] == port[0] == 200
    assert set(port[2]) == set(ref[2])
    assert set(port[2]["retention"]) == set(ref[2]["retention"])
    assert port[2]["root"]["name"] == ref[2]["root"]["name"] == "http.request"
    assert port[2]["invariants"]["children_within_parent"]
    names = {"http.request", "llm.request", "llm.queue", "llm.prefill", "llm.decode"}
    assert {"http.request", "llm.request", "llm.queue", "llm.prefill", "llm.decode"} <= \
        set(ref[2]["layers"]) | names
    assert port[2]["layers"] == {"gateway": 1, "provider": 1, "engine": 3}
    ref, port = _get(chatted, "/admin/trace/" + "0" * 32)
    assert ref[0] == port[0] == 404 and set(port[2]) == set(ref[2]) == {"detail"}


@pytest.mark.parametrize("path", ["/admin/tenants/usage", f"/admin/trace/{TRACE}",
                                  "/metrics/prometheus?scope=fleet", "/admin/slo?scope=fleet"])
def test_disabled_routes_404_like_jax(bare_apps, path):
    ref, port = _get(bare_apps, path)
    assert ref[0] == port[0] == 404
    assert set(port[2]) == set(ref[2]) == {"detail"}


def test_disabled_app_still_evaluates_slo(bare_apps):
    ref, port = _get(bare_apps, "/admin/slo")
    assert ref[0] == port[0] == 200 and set(port[2]) == set(ref[2])
    port_app = bare_apps[3]
    assert port_app["tenant_ledger"] is None and port_app["trace_store"] is None
    assert port_app["tpu_engine"].ledger is None


def test_unmatched_paths_add_no_series(bare_apps):
    """A scan of paths that match no route adds no HTTP series in either
    app (aiohttp raises their 404 through the middleware), and the client's
    raw path shows in no label."""
    before = _series(bare_apps[3]["metrics"].render()[0].decode(), "mcpforge_http_")
    for k in range(3):
        ref, port = _get(bare_apps, f"/no/such/page-{k}")
        assert ref[0] == port[0] == 404
    text = bare_apps[3]["metrics"].render()[0].decode()
    assert _series(text, "mcpforge_http_") == before and "/no/such/page" not in text


def test_quota_refusal_lifts_when_the_window_closes():
    """A tenant past one window's quota is refused with reason "quota" and
    admitted again once the ledger's window closes; the window's tokens read
    0 in ``/admin/tenants/usage`` in between, the totals keep them."""
    settings = load_settings(env=QUOTA, env_file=None)
    config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu")
    app = build_llm_app(settings, engine=TorchEngine(config))
    headers = _basic(settings)
    chat = {"model": "llama3-test", "max_tokens": 4,
            "messages": [{"role": "user", "content": "count my tokens"}]}

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        ledger = app["tenant_ledger"]

        async def post():
            resp = await client.post("/v1/chat/completions", json=chat, headers=headers)
            return resp.status, await resp.json()

        async def next_window():
            seen = ledger.snapshot()["window_started"]
            for _ in range(2000):
                if ledger.snapshot()["window_started"] != seen:
                    return
                await asyncio.sleep(0.01)
            raise AssertionError("the ledger's window never closed")

        try:
            assert (await post())[0] == 200   # warm-up
            await next_window()
            first, refused = await post(), await post()
            await next_window()
            usage = await (await client.get("/admin/tenants/usage", headers=headers)).json()
            return first, refused, usage, await post()
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        first, refused, usage, again = loop.run_until_complete(asyncio.wait_for(run(), 120))
    finally:
        loop.close()
    assert first[0] == 200
    assert refused[0] == 429 and refused[1]["error"]["reason"] == "quota"
    assert usage["rollup_interval_s"] == 2.0
    row = next(t for t in usage["tenants"] if t["tenant"] == "user:admin@example.com")
    assert row["window_tokens"] == 0 and row["quota_used_ratio"] == 0
    assert row["requests"] == 2 and row["prompt_tokens"] > 8
    assert again[0] == 200


def test_app_wires_the_handles(chatted):
    app = chatted[3]
    engine, metrics = app["tpu_engine"], app["metrics"]
    assert isinstance(metrics, port_metrics.PrometheusRegistry)
    assert engine.metrics is metrics and engine.ledger is app["tenant_ledger"]
    assert app["tpu_provider"].metrics is metrics
    assert app["overload_shedder"].metrics is metrics
    assert app["overload_shedder"].ledger is app["tenant_ledger"]
    assert app["overload_shedder"].limiter is app["tenant_limiter"]
    assert app["tenant_limiter"].enabled and app["tenant_ledger"].clamp is metrics.tenant_clamp
    assert app["tenant_usage_rollup"].ledger is app["tenant_ledger"]
    assert app["tenant_usage_rollup"].db is app["ctx"].db
    assert app["slo_evaluator"].metrics is metrics


def _controller_run(signals, slo, controller, metrics, degradation) -> list:
    """Three observation phases into a registry (fast, slow, fast); after
    each, three ticks of a controller over an evaluator of it, a shedder at
    0.95 and a scripted clock. Returns per tick: the published burn,
    shed_at, the decisions."""
    now = itertools.count(0.0, 1.0)
    clock = lambda: next(now)   # noqa: E731
    bus = signals.SignalBus(clock=clock)
    registry = metrics.PrometheusRegistry()
    shedder = degradation.OverloadShedder(shed_at=0.95)
    evaluator = slo.SloEvaluator(registry, [slo.SloObjective("ttft_p95", "llm_ttft", 0.95, 120.0)])
    ctl = controller.ServingController(bus, lambda: [], shedder=shedder, slo_evaluator=evaluator,
                                       tick_s=0.05, cooldown_s=0.0, clock=clock)
    rng = np.random.default_rng(4)
    trail = []
    for scale in (-3.0, -1.0, -4.0):   # fast, slow, fast
        for _ in range(50):
            registry.llm_ttft.labels("m", "0", "t").observe(float(rng.lognormal(scale, 0.5)))
        for _ in range(3):
            rows = ctl.tick()
            view = bus.get("slo.burn_rate", signals.GATEWAY_REPLICA)
            trail.append((view["last"] if view else None, round(shedder.shed_at, 6),
                          [{k: v for k, v in r.items() if k not in ("ts", "seq")} for r in rows]))
    return trail


def test_controller_burn_equal_and_moves_shed_at():
    want = _controller_run(jax_signals, jax_slo, jax_controller, jax_metrics, jax_degradation)
    got = _controller_run(port_signals, port_slo, port_controller, port_metrics,
                          port_degradation)
    assert got == want
    assert min(shed for _, shed, _ in got) < 0.95
    assert any(burn > 1.0 for burn, _, _ in got)
    assert any(row["knob"] == "shed_bar" for _, _, rows in got for row in rows)


def _served_series(handles) -> set:
    """tests/test_torch_telemetry.py's served run (chats with tenants and
    trace contexts, a prompt that chunks) on a port engine with
    ``handles``: every sample's (name, label set)."""
    engine = TorchEngine(EngineConfig(**SHAPE, device="cpu"), **handles)
    tok = engine.tokenizer
    prompts = [tok.encode(t) for t in TEXTS[:3]] + [tok.encode("long " * 18)]
    traces = [(f"{i:02x}" * 16, f"{i + 16:02x}" * 8) for i in range(4)]
    serve(engine, [(ids, dict(max_tokens=m, trace_ctx=ctx, tenant=tenant))
                   for ids, m, ctx, tenant in zip(prompts, (9, 6, 12, 5), traces,
                                                  ("team:a", "", "team:a", "key:b"))])
    return _series(handles["metrics"].render()[0].decode(), "mcpforge_")


def test_served_families_equal_with_either_registry():
    jax_reg, port_reg = jax_metrics.PrometheusRegistry(), port_metrics.PrometheusRegistry()
    want = _served_series(dict(tracer=JaxTracer(exporter="memory"), metrics=jax_reg,
                               ledger=JaxLedger(clamp=jax_reg.tenant_clamp, metrics=jax_reg)))
    got = _served_series(dict(tracer=Tracer(exporter="memory"), metrics=port_reg,
                              ledger=TenantLedger(clamp=port_reg.tenant_clamp, metrics=port_reg)))
    assert got == want
    assert ("mcpforge_llm_tenant_tokens_total", 'kind="generated",tenant="team:a"') in got
    assert ("mcpforge_llm_ttft_seconds_count",
            'model="llama3-test",replica="0",tenant="key:b"') in got
