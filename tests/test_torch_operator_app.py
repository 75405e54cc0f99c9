"""The operator plane of the port against the JAX gateway's, on the CPU:
``FlightRecorder`` and ``LoopLagSampler`` give the same snapshots, registry
samples and signals as the JAX ones on the same seeded request and lag
scripts; the operator routes of ``build_llm_app`` (``/health``, ``/ready``,
``/version``, ``/admin/logs``, ``/admin/engine/stats``,
``/admin/engine/steps``, ``/admin/gateway/requests``,
``/admin/engine/profile*``) answer with the JAX gateway's status codes and
keys, enabled and disabled, and refuse the same requests (401 without
credentials, 403 without the permission, 422 on a malformed limit); a CPU
``torch.profiler`` capture writes its trace into ``torch_profile_dir`` and a
second start answers 409; a request through the app adds a recorder row and
its ``gw_request_phase`` counts. Exact equality of keys, codes and samples."""

import asyncio
import json
import time
from pathlib import Path

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

from mcp_context_forge_tpu.config import load_settings as jax_load_settings
from mcp_context_forge_tpu.gateway import flight_recorder as jax_recorder
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.observability import metrics as jax_metrics
from mcp_context_forge_tpu.observability import signals as jax_signals
from mcp_context_forge_tpu.utils import jwt as jax_jwt
from mcp_context_forge_tpu_torch.config import load_settings
from mcp_context_forge_tpu_torch.gateway import flight_recorder as port_recorder
from mcp_context_forge_tpu_torch.observability import metrics as port_metrics
from mcp_context_forge_tpu_torch.observability import signals as port_signals
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app

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
PROFILED = {"MCPFORGE_JAX_PROFILE_ENABLED": "true", "MCPFORGE_TORCH_PROFILE_ENABLED": "true"}
DISABLED = {"MCPFORGE_TPU_LOCAL_ENABLED": "false", "MCPFORGE_GW_FLIGHT_RECORDER_ENABLED": "false"}
READ_ROUTES = ["/admin/logs?q=request&limit=5", "/admin/engine/stats",
               "/admin/engine/steps?limit=3", "/admin/gateway/requests?limit=2",
               "/admin/engine/profile/status"]
ADMIN_ROUTES = ["/admin/engine/profile/start", "/admin/engine/profile/stop",
                "/admin/engine/profile"]


# -- the recorder and the sampler, unit against unit ------------------------


def _phase_vector(rng) -> dict[str, float]:
    names = rng.choice(["auth", "routing", "engine", "serialize", "handler", "db", "error"],
                       size=rng.integers(1, 5), replace=False)
    return {str(n): float(np.round(rng.random() * 80, 3)) for n in names}


def _script(seed: int, n: int = 40) -> list[dict]:
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        route = str(rng.choice(["/v1/chat/completions", "/admin/logs", "unmatched"]))
        trace = f"{seed:016x}{i:016x}" if rng.random() < 0.8 else None
        rows.append(dict(
            method=str(rng.choice(["GET", "POST"])), path=f"{route}?i={i}", route=route,
            status=int(rng.choice([200, 200, 404, 429, 500, 499])),
            duration_s=float(np.round(rng.random() * 0.2, 6)), phases_ms=_phase_vector(rng),
            trace_id=trace, span_id=(f"{i:016x}" if trace and rng.random() < 0.9 else None),
            correlation_id=f"c{i}" if rng.random() < 0.5 else None,
            tenant=str(rng.choice(["team:a", "team:b", "user:x@example.com", "", "t" * 9]))
            if rng.random() < 0.9 else None,
            error=str(rng.choice(["ValueError", "http_500"])) if rng.random() < 0.2 else None,
            client_disconnected=bool(rng.random() < 0.1)))
    return rows


def _samples(registry, family: str) -> list:
    """The family's samples but ``_created``, sorted."""
    out = []
    for metric in getattr(registry, family).collect():
        for s in metric.samples:
            if not s.name.endswith("_created"):
                out.append((s.name, tuple(sorted(s.labels.items())), s.value))
    return sorted(out)


def _masked(snapshot: dict) -> dict:
    return {k: ([{kk: vv for kk, vv in row.items() if kk != "ts"} for row in v]
                if k in ("slowest", "recent") else v) for k, v in snapshot.items()}


@pytest.mark.parametrize("seed", range(4))
def test_recorder_agrees(seed):
    registries = (port_metrics.PrometheusRegistry(), jax_metrics.PrometheusRegistry())
    recorders = [port_recorder.FlightRecorder(registries[0], ring_size=16, slowest_size=5,
                                              slow_request_s=0.15, worker="w1"),
                 jax_recorder.FlightRecorder(registries[1], ring_size=16, slowest_size=5,
                                             slow_request_s=0.15, worker="w1")]
    script = _script(seed)
    for rec in recorders:
        ids = [rec.start_request(r["path"], (r["trace_id"], r["span_id"] or "")
                                 if r["trace_id"] else None) for r in script[:3]]
        for row in script:
            rec.record(**row)
        rec.finish_request(ids[1])
    assert [r.longest_inflight()["path"] for r in recorders] == [script[0]["path"]] * 2
    for limit, tenant in ((64, None), (3, None), (64, "team:a"), (2, "t" * 9)):
        ours, theirs = (_masked(r.snapshot(limit=limit, tenant=tenant)) for r in recorders)
        assert ours == theirs
    for row in script:
        if row["trace_id"]:
            found = [r.find_trace(row["trace_id"]) for r in recorders]
            assert [f and {k: v for k, v in f.items() if k != "ts"} for f in found][0] == \
                [f and {k: v for k, v in f.items() if k != "ts"} for f in found][1]
    for family in ("gw_request_phase", "gw_slow_requests"):
        assert _samples(registries[0], family) == _samples(registries[1], family)
    assert recorders[0].slow_requests == recorders[1].slow_requests > 0


@pytest.mark.parametrize("seed", range(3))
def test_loop_lag_sampler_agrees(seed):
    rng = np.random.default_rng(seed)
    lags = [float(v) for v in np.round(rng.exponential(0.02, size=50), 6)]
    registries = (port_metrics.PrometheusRegistry(), jax_metrics.PrometheusRegistry())
    buses = (port_signals.SignalBus(), jax_signals.SignalBus())
    samplers = []
    for registry, bus, module in zip(registries, buses, (port_recorder, jax_recorder)):
        recorder = module.FlightRecorder(registry)
        recorder.start_request("/v1/chat/completions", ("ab" * 16, "cd" * 8))
        sampler = module.LoopLagSampler(registry, interval_s=0.01, warn_s=0.05,
                                        recorder=recorder)
        sampler.signals = bus
        for lag in lags:
            sampler._observe(lag)
        samplers.append(sampler)
    assert samplers[0].snapshot() == samplers[1].snapshot()
    assert samplers[0].long_callbacks == sum(lag >= 0.05 for lag in lags)
    assert _samples(registries[0], "gw_loop_lag") == _samples(registries[1], "gw_loop_lag")
    views = [bus.get("gw.loop_lag_ms") for bus in buses]
    for key in ("count", "last", "ewma", "max"):
        if key in views[1]:
            assert views[0][key] == views[1][key], key


def test_loop_lag_sampler_measures_a_blocked_loop():
    """Both samplers on one loop see the same blocking callback as lag."""
    async def run():
        samplers = [module.LoopLagSampler(interval_s=0.01, warn_s=0.04)
                    for module in (port_recorder, jax_recorder)]
        for sampler in samplers:
            await sampler.start()
        await asyncio.sleep(0.05)
        time.sleep(0.08)   # a callback that blocks the loop
        await asyncio.sleep(0.05)
        for sampler in samplers:
            await sampler.stop()
        return samplers

    ours, theirs = asyncio.run(run())
    for sampler in (ours, theirs):
        assert sampler.samples >= 3 and sampler.long_callbacks >= 1
        assert sampler.max_lag_s >= 0.04
    assert ours._task is None


# -- the routes, app against app ---------------------------------------------


def _app_pair(env: dict, tmp: Path):
    """(loop, port settings, [JAX client, port client], port app) on one env:
    the JAX gateway on the JAX settings, the port's app on its own settings
    and a CPU engine (``device="cpu"``)."""
    env = {**env, "MCPFORGE_TORCH_PROFILE_DIR": str(tmp / "torch"),
           "MCPFORGE_JAX_PROFILE_DIR": str(tmp / "jax")}
    settings = load_settings(env=env, env_file=None)
    loop = asyncio.new_event_loop()

    async def build():
        apps = [await build_app(jax_load_settings(env=env, env_file=None)),
                build_llm_app(settings, device="cpu")]
        clients = []
        for app in apps:
            client = TestClient(TestServer(app))
            await client.start_server()
            clients.append(client)
        return clients, apps[1]

    clients, port_app = loop.run_until_complete(build())
    return loop, settings, clients, port_app


def _close(pair) -> None:
    loop, _, clients, _ = pair
    for client in clients:
        loop.run_until_complete(client.close())
    loop.close()


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    pair = _app_pair({**ENGINE_ENV, **PROFILED}, tmp_path_factory.mktemp("profiled"))
    yield pair
    _close(pair)


@pytest.fixture(scope="module")
def bare_apps(tmp_path_factory):
    pair = _app_pair({**ENGINE_ENV, **DISABLED}, tmp_path_factory.mktemp("bare"))
    yield pair
    _close(pair)


def _basic(settings) -> dict:
    return {"Authorization": aiohttp.BasicAuth(settings.basic_auth_user,
                                               settings.basic_auth_password).encode()}


def _bearer(settings, scopes: list[str]) -> dict:
    return {"Authorization": "Bearer " + jax_jwt.create_token(
        {"sub": "ci@example.com", "scopes": scopes}, settings.jwt_secret_key,
        audience=settings.jwt_audience, issuer=settings.jwt_issuer)}


def _call(pair, path: str, headers: dict | None = None, method: str = "get", which=(0, 1),
          **kwargs) -> list:
    """(status, JSON body or None) from the JAX app and the port's."""
    loop, settings, clients, _ = pair
    headers = _basic(settings) if headers is None else headers

    async def one(client):
        resp = await getattr(client, method)(path, headers=headers, **kwargs)
        body = await resp.read()
        return resp.status, (json.loads(body) if resp.content_type == "application/json"
                             else None)

    return [loop.run_until_complete(asyncio.wait_for(one(clients[i]), 120)) for i in which]


def _keys(body) -> object:
    """The body's key structure: dicts by their keys (nested), lists by
    their first element's."""
    if isinstance(body, dict):
        return {k: _keys(v) for k, v in body.items()}
    if isinstance(body, list):
        return [_keys(body[0])] if body else []
    return None


@pytest.mark.parametrize("path", ["/health", "/ready", "/version"])
def test_public_routes_agree(apps, path):
    (js, jbody), (ps, pbody) = _call(apps, path, headers={})
    assert js == ps == 200
    assert set(jbody) == set(pbody)
    if path != "/ready":
        assert jbody == pbody
    else:
        assert pbody["status"] == "ready" and pbody["leader"] is True


@pytest.mark.parametrize("path", READ_ROUTES)
def test_read_routes_agree(apps, path):
    (js, jbody), (ps, pbody) = _call(apps, path)
    assert js == ps == 200, (jbody, pbody)
    if path.startswith("/admin/logs"):
        assert isinstance(jbody, list) and isinstance(pbody, list)
        return
    ours, theirs = _keys(pbody), _keys(jbody)
    for key in ("steps", "recent", "slowest", "roofline", "xla_compiles", "degradation",
                "backpressure", "tiers"):
        # rows of rings and the engines' own reports: compared by presence
        for body in (ours, theirs):
            body.pop(key, None)
            body.get("prefix_cache", {}).pop(key, None)
    assert ours == theirs


def test_engine_stats_values_agree(apps):
    (_, jbody), (_, pbody) = _call(apps, "/admin/engine/stats")
    # "mesh" differs by design: the JAX engine's default mesh spans every
    # device (the tests' eight virtual CPUs), the port's is one device
    for key in ("model", "superstep", "kv_quant", "tier_hits_host", "spec_decode"):
        assert pbody[key] == jbody[key], key


@pytest.mark.parametrize("path", ["/admin/engine/steps?limit=x", "/admin/gateway/requests?limit=1.5",
                                  "/admin/logs?limit=many"])
def test_malformed_limit_is_422(apps, path):
    assert [status for status, _ in _call(apps, path)] == [422, 422]


@pytest.mark.parametrize("path,method", [(p, "get") for p in READ_ROUTES]
                         + [(p, "post") for p in ADMIN_ROUTES])
def test_no_credentials_is_401(apps, path, method):
    assert [s for s, _ in _call(apps, path, headers={}, method=method)] == [401, 401]


@pytest.mark.parametrize("path,method,scopes", [(p, "get", ["tools.read"]) for p in READ_ROUTES]
                         + [(p, "post", ["observability.read"]) for p in ADMIN_ROUTES])
def test_missing_permission_is_403(apps, path, method, scopes):
    loop, settings, _, _ = apps
    statuses = [s for s, _ in _call(apps, path, headers=_bearer(settings, scopes), method=method)]
    assert statuses == [403, 403]


@pytest.mark.parametrize("path,method", [
    ("/admin/gateway/requests", "get"), ("/admin/engine/profile/status", "get"),
    ("/admin/engine/profile/start", "post"), ("/admin/engine/profile/stop", "post"),
    ("/admin/engine/profile", "post")])
def test_disabled_is_404(bare_apps, path, method):
    results = _call(bare_apps, path, method=method)
    assert [s for s, _ in results] == [404, 404]
    assert all(set(body) == {"detail"} for _, body in results)


def test_ready_without_a_running_engine_is_503(bare_apps):
    """The JAX gateway's readiness is its database; the port's is its
    engine: a stopped engine answers 503 with the JAX body's keys."""
    loop, _, _, port_app = bare_apps
    engine = port_app["tpu_engine"]
    loop.run_until_complete(engine.stop())
    try:
        [(status, body)] = _call(bare_apps, "/ready", headers={}, which=(1,))
        assert status == 503 and set(body) == {"status", "detail"}
    finally:
        loop.run_until_complete(engine.start())


def test_ready_with_the_database_closed_is_503(bare_apps):
    """Readiness runs ``SELECT 1`` on the app's database first, as the JAX
    gateway's does: with a closed database in its place both answer 503
    with the JAX keys and the database's error."""
    from mcp_context_forge_tpu.db.core import Database as JaxDatabase
    from mcp_context_forge_tpu_torch.db.core import Database

    loop, _, clients, _ = bare_apps
    saved = []
    for client, cls in zip(clients, (JaxDatabase, Database)):
        closed = cls(":memory:")
        loop.run_until_complete(closed.connect())
        loop.run_until_complete(closed.close())
        ctx = client.app["ctx"]
        saved.append((ctx, ctx.db))
        ctx.db = closed
    try:
        (js, jbody), (ps, pbody) = _call(bare_apps, "/ready", headers={})
    finally:
        for ctx, db in saved:
            ctx.db = db
    assert js == ps == 503
    assert set(jbody) == set(pbody) == {"status", "detail"}
    assert pbody["status"] == jbody["status"] == "not ready"
    assert pbody["detail"] == jbody["detail"] != ""
    assert [s for s, _ in _call(bare_apps, "/ready", headers={})] == [200, 200]


def test_cpu_profiler_capture(apps):
    loop, settings, _, port_app = apps
    (status, body), = _call(apps, "/admin/engine/profile/start", method="post", which=(1,))
    assert status == 200 and body["active"] is True
    (status, body), = _call(apps, "/admin/engine/profile/start", method="post", which=(1,))
    assert status == 409 and "already running" in body["detail"]
    chat = {"model": "llama3-test", "max_tokens": 4, "temperature": 0,
            "messages": [{"role": "user", "content": "profile me"}]}
    (status, _), = _call(apps, "/v1/chat/completions", method="post", json=chat, which=(1,))
    assert status == 200
    (status, body), = _call(apps, "/admin/engine/profile/stop", method="post", which=(1,))
    assert status == 200 and body["active"] is False
    trace = Path(body["trace_file"])
    assert trace.parent == Path(settings.torch_profile_dir) and trace.exists()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    (status, _), = _call(apps, "/admin/engine/profile/stop", method="post", which=(1,))
    assert status == 409
    (status, body), = _call(apps, "/admin/engine/profile", method="post",
                            json={"duration_ms": 30}, which=(1,))
    assert status == 200 and body["active"] is False and Path(body["trace_file"]).exists()
    assert {"duration_ms", "decode_steps", "prefill_batches"} <= set(body)
    assert port_app["torch_profiler"].device == "cpu"


def test_request_adds_a_recorder_row_and_phase_counts(apps):
    loop, settings, _, port_app = apps
    chat = {"model": "llama3-test", "max_tokens": 3, "temperature": 0,
            "messages": [{"role": "user", "content": "recorded"}]}
    before = port_app["flight_recorder"].recorded

    def engine_count(registry) -> float:
        return sum(v for name, labels, v in _samples(registry, "gw_request_phase")
                   if name.endswith("_count") and ("phase", "engine") in labels
                   and ("route", "/v1/chat/completions") in labels)

    counts0 = engine_count(port_app["metrics"])
    results = _call(apps, "/v1/chat/completions", method="post", json=chat)
    assert [s for s, _ in results] == [200, 200]
    assert port_app["flight_recorder"].recorded == before + 1
    assert engine_count(port_app["metrics"]) == counts0 + 1
    for status, body in _call(apps, "/admin/gateway/requests?limit=64"):
        assert status == 200
        rows = [r for r in body["recent"] if r["route"] == "/v1/chat/completions"]
        assert rows and rows[0]["status"] == 200 and "engine" in rows[0]["phases_ms"]
        assert rows[0]["tenant"] == "user:admin@example.com"
        assert body["loop"]["samples"] >= 0 and body["backpressure"] is not None


def test_ready_on_the_shared_plane(tmp_path):
    """Two workers of the shared engine plane over one memory bus: the owner
    (a CPU engine) and a worker that only forwards (its own build, a CUDA
    engine, fails without a card) are both ready once an owner is elected, and
    only the owner leads."""
    from mcp_context_forge_tpu_torch.coordination.bus import MemoryEventBus
    from mcp_context_forge_tpu_torch.coordination.leases import MemoryLeaseManager

    settings = load_settings(env={**ENGINE_ENV, "MCPFORGE_TPU_LOCAL_POOL_SHARED": "true",
                                  "MCPFORGE_LEADER_LEASE_TTL": "3"}, env_file=None)
    bus, leases = MemoryEventBus(), MemoryLeaseManager()

    async def run():
        owner = build_llm_app(settings, bus=bus, leases=leases, worker_id="owner", device="cpu")
        clients = [TestClient(TestServer(owner))]
        await clients[0].start_server()
        try:
            while not owner["engine_plane"].ready_local:
                await asyncio.sleep(0.01)
            other = build_llm_app(settings, bus=bus, leases=leases, worker_id="other")
            clients.append(TestClient(TestServer(other)))
            await clients[1].start_server()
            out = []
            for client in clients:
                resp = await client.get("/ready")
                out.append((resp.status, await resp.json()))
            return out
        finally:
            for client in clients:
                await client.close()

    (s1, owner), (s2, other) = asyncio.run(run())
    assert s1 == s2 == 200
    assert (owner["worker_id"], owner["leader"]) == ("owner", True)
    assert (other["worker_id"], other["leader"]) == ("other", False)
