"""The port's ``EnginePool`` (``tpu_local/pool/``) against the JAX package's
``EnginePool`` and ``TPUEngine``, on CPU replicas of llama3-test in f32
serving the JAX engine's weights (``params_from_jax``): the cases of
``tests/tpu_local/test_engine_pool.py``.

- ``partition_devices``; each replica takes its device in ``cfg.device``
  and reports one mesh device (the port has no mesh); ``probe_devices``;
- greedy streams equal one engine's and the JAX pool's, with the JAX
  pool's routes, when every request is submitted before the pool starts
  (so that admission, and with it every dispatch, is the same in both);
- prefix affinity; priority and ``trace_ctx`` on shadows, field by field
  against the JAX pool's shadows;
- a replica killed mid-decode (its third decode dispatch raises) loses no
  token and repeats none: the streams and routes equal the JAX pool's
  under the same fault, and each of its requests is requeued once;
- a wedged replica is failed over by the health monitor; the verdict
  matrix agrees with the JAX monitor's; a killed engine refuses work;
  cancels reach the serving replica;
- a spent requeue budget ends "unavailable", which the provider turns
  into ``LLMUnavailable``, or, after delivered tokens, into the same
  structured terminal chunk as the JAX provider's;
- drain/undrain/reload, the reload of a dead replica, stragglers of a
  drain that times out requeued onto the survivor;
- ``GET /admin/engine/pool`` and the replica actions of both apps, and
  their 404 without a pool.

The JAX side runs once per module (``ref``): one engine's streams, and its
pool's parity and kill runs.
"""

import asyncio
import dataclasses
import threading
import time
from types import SimpleNamespace

import aiohttp
import jax
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from mcp_context_forge_tpu.config import load_settings
from mcp_context_forge_tpu.gateway.app import build_app
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import GenRequest as JaxRequest
from mcp_context_forge_tpu.tpu_local.pool import EnginePool as JaxPool
from mcp_context_forge_tpu.tpu_local.pool import partition_devices as jax_partition
from mcp_context_forge_tpu.tpu_local.pool.health import HealthMonitor as JaxMonitor
from mcp_context_forge_tpu.tpu_local.tpu_provider import TPULocalProvider
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig, EngineInitTimeout,
                                                          GenRequest, TorchEngine,
                                                          probe_devices)
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.pool import EnginePool, partition_devices
from mcp_context_forge_tpu_torch.tpu_local.pool.health import HealthMonitor
from mcp_context_forge_tpu_torch.tpu_local.provider import LLMUnavailable
from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app, build_pool
from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

SHAPE = dict(model="llama3-test", max_batch=4, max_seq_len=128, page_size=16,
             num_pages=64, prefill_buckets=(16, 64), dtype="float32")
PARITY = [f"parity prompt {i} with a few extra words" for i in range(6)]
CHAOS = [f"chaos prompt number {i} with some extra words" for i in range(6)]
WEDGE = "wedge survivor prompt"
STRAGGLER = "reload straggler prompt"
DRAIN = "drain reload prompt"
HEAL = "kill then heal"
AFFINITY = "the quick brown fox jumps over the lazy dog"   # two full pages
# one engine's streams besides the pool runs': (prompt, max_tokens)
SINGLE = [(WEDGE, 16), (STRAGGLER, 64), (DRAIN, 6), (AFFINITY, 4)]
BASIC = aiohttp.BasicAuth("admin", "changeme")
GATEWAY_ENV = {
    "MCPFORGE_DATABASE_URL": "sqlite:///:memory:",
    "MCPFORGE_PLUGINS_ENABLED": "false",
    "MCPFORGE_TPU_LOCAL_ENABLED": "true",
    "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test",
    "MCPFORGE_TPU_LOCAL_MAX_BATCH": "4",
    "MCPFORGE_TPU_LOCAL_MAX_SEQ_LEN": "128",
    "MCPFORGE_TPU_LOCAL_PAGE_SIZE": "16",
    "MCPFORGE_TPU_LOCAL_NUM_PAGES": "64",
    "MCPFORGE_TPU_LOCAL_PREFILL_BUCKETS": "64",
    "MCPFORGE_TPU_LOCAL_DTYPE": "float32",
    "MCPFORGE_GATEWAY_HEALTH_INTERVAL": "3600",
}


def jax_poison(engine, explode_after):
    """The JAX pool tests' fault: the Nth decode dispatch raises."""
    calls = {"n": 0}
    for name in ("_decode_fn", "_decode_fb_fn"):
        real = getattr(engine, name)

        def make(real):
            def exploding(ctx_pages, batch=None):
                fn = real(ctx_pages, batch)

                def wrapper(*args, **kwargs):
                    calls["n"] += 1
                    if calls["n"] >= explode_after:
                        raise RuntimeError("injected device fault")
                    return fn(*args, **kwargs)
                return wrapper
            return exploding
        setattr(engine, name, make(real))
    return calls


def port_poison(engine, explode_after):
    """The same fault in the port: the Nth decode dispatch (one launch of
    ``DecodeGraphs``) raises."""
    calls = {"n": 0}
    launch = engine._graphs.launch

    def exploding(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] >= explode_after:
            raise RuntimeError("injected device fault")
        return launch(*args, **kwargs)

    engine._graphs.launch = exploding
    return calls


async def drain_stream(request, timeout=60):
    tokens = []
    while (token := await asyncio.wait_for(request.stream.get(), timeout)) is not None:
        tokens.append(token)
    return tokens


async def serve_preloaded(pool, cls, prompts, max_tokens):
    """Every request submitted before the pool starts (so both pools admit
    alike); returns (streams, the replica each landed on)."""
    requests = [cls(request_id=f"r{i}", prompt_ids=pool.tokenizer.encode(p),
                    max_tokens=max_tokens) for i, p in enumerate(prompts)]
    for request in requests:
        await pool.submit(request)
    routes = [next(r.id for r in pool.replicas if q.request_id in r.outstanding)
              for q in requests]
    await pool.start()
    try:
        return [await drain_stream(q) for q in requests], routes
    finally:
        await pool.stop()


def factory(params):
    def build(cfg, tracer, metrics, ledger=None, tier_store=None, prefix_index=None):
        return TorchEngine(cfg, params=params, tracer=tracer, metrics=metrics,
                           ledger=ledger, tier_store=tier_store, prefix_index=prefix_index)
    return build


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once, on one JAX pool: the parity run, then, with
    replica 1 poisoned, the kill run (the JAX pool tests pin both to one
    uninterrupted engine's streams), then replica 0 alone serves the other
    prompts, whose prefixes neither run cached."""
    pool = JaxPool(JaxConfig(**SHAPE, attn_impl="reference"), replicas=2,
                   health_interval_s=0.05)
    engine = pool.replicas[0].engine
    params = params_from_jax(jax.device_get(engine.params), MODEL_CONFIGS["llama3-test"],
                             device="cpu", dtype=torch.float32)

    async def main():
        parity, routes = await serve_preloaded(pool, JaxRequest, PARITY, 12)
        routed = [r.routed for r in pool.replicas]
        jax_poison(pool.replicas[1].engine, explode_after=3)
        chaos, chaos_routes = await serve_preloaded(pool, JaxRequest, CHAOS, 24)
        streams = {**dict(zip(PARITY, parity)), **dict(zip(CHAOS, chaos))}
        await engine.start()
        try:
            for prompt, n in SINGLE:
                streams[prompt] = [t async for t in engine.generate(
                    engine.tokenizer.encode(prompt), max_tokens=n)]
        finally:
            await engine.stop()
        return streams, parity, routes, routed, chaos, chaos_routes

    streams, parity, routes, routed, chaos, chaos_routes = asyncio.run(main())
    return SimpleNamespace(params=params, engine=engine, streams=streams, pool=pool,
                           parity=parity, parity_routes=routes, parity_routed=routed,
                           chaos=chaos, chaos_routes=chaos_routes)


def make_pool(ref, replicas=2, requeue_max=2, health_interval_s=0.05,
              heartbeat_timeout_s=10.0, **overrides):
    return EnginePool(EngineConfig(**{**SHAPE, **overrides}, device="cpu"),
                      replicas=replicas, health_interval_s=health_interval_s,
                      heartbeat_timeout_s=heartbeat_timeout_s, requeue_max=requeue_max,
                      engine_factory=factory(ref.params))


# ----------------------------------------------------------------- routing

def test_partition_devices_shapes():
    devs = list(range(8))
    for n, want in [(1, [devs]), (2, [[0, 1, 2, 3], [4, 5, 6, 7]]),
                    (4, [[0, 1], [2, 3], [4, 5], [6, 7]]),
                    (3, [[0, 1], [2, 3], [4, 5]])]:
        assert partition_devices(devs, n) == jax_partition(devs, n) == want
    # fewer devices than replicas (the CPU, one card): every replica shares
    assert partition_devices([0], 3) == jax_partition([0], 3) == [[0], [0], [0]]


def test_replicas_take_their_device_and_report_one_mesh_device(ref, monkeypatch):
    """No mesh in the port: the pool probes the devices of the config's
    type, places each replica's in ``cfg.device`` with its replica id, and
    each status card reports one mesh device. A CUDA probe without CUDA
    raises, and a probe that hangs raises ``EngineInitTimeout``."""
    pool = make_pool(ref)
    assert [r.engine.config.device for r in pool.replicas] == ["cpu", "cpu"]
    assert [r.engine.config.replica_id for r in pool.replicas] == ["0", "1"]
    assert all(r.status()["mesh_devices"] == 1 for r in pool.replicas)
    assert probe_devices(1.0, "cpu") == [torch.device("cpu")]
    assert pool.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            probe_devices(1.0, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: time.sleep(5) or False)
    with pytest.raises(EngineInitTimeout):
        probe_devices(0.2, "cuda")


def test_pool_greedy_parity_with_single_engine(ref):
    """Routing is invisible in the streams (the JAX pool's, which its tests
    pin to one engine's), and the routes are the JAX pool's."""
    pool = make_pool(ref)
    outs, routes = asyncio.run(serve_preloaded(pool, GenRequest, PARITY, 12))
    assert outs == ref.parity
    assert routes == ref.parity_routes
    assert [r.routed for r in pool.replicas] == ref.parity_routed
    assert all(r.routed > 0 for r in pool.replicas)
    assert pool.requeues == 0


def test_prefix_affinity_routes_to_cached_replica(ref):
    """A prompt whose full-page prefix is resident on replica R routes back
    to R; the router counts the hit."""
    async def main():
        pool = make_pool(ref)
        await pool.start()
        try:
            ids = pool.tokenizer.encode(AFFINITY)
            out1 = [t async for t in pool.generate(ids, max_tokens=4)]
            assert out1 == ref.streams[AFFINITY]
            first = next(r for r in pool.replicas if r.routed)
            assert first.engine.allocator.probe_prefix(ids) >= pool.config.page_size
            out2 = [t async for t in pool.generate(ids, max_tokens=4)]
            assert out2 == out1
            assert pool.router.affinity_hits >= 1
            assert first.routed == 2
        finally:
            await pool.stop()

    asyncio.run(main())


SHADOW_FIELDS = ("request_id", "prompt_ids", "max_tokens", "priority", "queue_observed",
                 "ttft_observed", "trace_ctx", "tenant", "temperature", "stop_ids")


def shadow_fields(shadow) -> dict:
    return {name: getattr(shadow, name) for name in SHADOW_FIELDS}


def test_priority_rides_through_to_the_shadow(ref):
    """The shadow keeps the request's priority; a requeued one is the
    continuation with the once-only guards, as the JAX pool's shadows."""
    pool = make_pool(ref)
    shadows = []
    for cls, p in ((GenRequest, pool), (JaxRequest, ref.pool)):
        request = cls(request_id="prio", prompt_ids=[1, 2, 3], max_tokens=8, priority=1)
        first = p._make_shadow(request, attempts=1)
        request.generated.extend([5, 6])
        requeued = p._make_shadow(request, attempts=2)
        fresh = cls(request_id="fresh", prompt_ids=[1, 2], max_tokens=4)
        shadows.append([shadow_fields(s) for s in
                        (first, requeued, p._make_shadow(fresh, attempts=2),
                         p._make_shadow(request, attempts=1, cap=1))])
    assert shadows[0] == shadows[1]
    first, requeued, fresh, capped = shadows[0]
    assert first["priority"] == requeued["priority"] == 1
    assert (first["queue_observed"], requeued["queue_observed"]) == (False, True)
    assert requeued["prompt_ids"] == [1, 2, 3, 5, 6] and requeued["max_tokens"] == 6
    assert requeued["ttft_observed"] is True and fresh["ttft_observed"] is False
    assert capped["max_tokens"] == 1


def test_shadow_carries_trace_context_across_requeues(ref):
    pool = make_pool(ref)
    trace_ctx = ("ab" * 16, "cd" * 8)
    request = GenRequest(request_id="traced", prompt_ids=[1, 2, 3], max_tokens=8,
                         trace_ctx=trace_ctx, tenant="team:t")
    assert pool._make_shadow(request, attempts=1).trace_ctx == trace_ctx
    request.generated.extend([4, 5])
    requeued = pool._make_shadow(request, attempts=2)
    assert requeued.trace_ctx == trace_ctx and requeued.tenant == "team:t"
    assert requeued.request_id == "traced~r1"


# ---------------------------------------------------------------- failover

def test_kill_one_replica_mid_decode_loses_nothing(ref):
    """Replica 1's third decode dispatch raises: every request completes on
    the survivor with the JAX pool's stream under the same fault (which its
    tests pin to one uninterrupted engine's), on the JAX pool's routes, and
    each request of the dead replica is requeued exactly once. The JAX
    pool may count more: its pump can read an "error" terminal while the
    crashed dispatch thread still runs, route the continuation back to
    that replica and requeue it again after the sweep; the port's engine
    is marked dead before its streams end."""
    pool = make_pool(ref)
    port_poison(pool.replicas[1].engine, explode_after=3)
    outs, routes = asyncio.run(serve_preloaded(pool, GenRequest, CHAOS, 24))
    assert outs == ref.chaos
    assert routes == ref.chaos_routes
    on_victim = routes.count("1")
    assert on_victim >= 1
    assert pool.requeues == pool.replicas[1].requeued_off == on_victim
    assert ref.pool.requeues >= on_victim
    assert [r.state for r in pool.replicas] == ["ready", "dead"]
    assert sum(r.requeued_off for r in pool.replicas) == pool.requeues
    status = pool.status()
    assert status["replicas"][1]["last_failure"]
    for card in status["replicas"]:
        assert {"warmup", "serving"} <= set(card["xla_compiles"])
        assert "cost_entries" in card["roofline"]


def test_wedged_replica_detected_and_failed_over(ref):
    """A replica whose dispatch thread blocks inside a decode dispatch is
    failed over by heartbeat and step staleness (warmed from construction),
    and its requests finish on the survivor."""
    async def main():
        pool = make_pool(ref, heartbeat_timeout_s=0.5)
        assert all(r.engine.warmed for r in pool.replicas)
        await pool.start()
        release = threading.Event()
        try:
            for replica in pool.replicas:   # both retire steps first
                warm = GenRequest(request_id=f"warm-{replica.id}",
                                  prompt_ids=pool.tokenizer.encode("warm up"), max_tokens=2)
                await replica.engine.submit(warm)
                await drain_stream(warm)
            victim = pool.replicas[1].engine
            launch = victim._graphs.launch

            def blocking(*args, **kwargs):
                release.wait(30)   # a device call that never returns
                return launch(*args, **kwargs)

            victim._graphs.launch = blocking

            async def gen():
                ids = pool.tokenizer.encode(WEDGE)
                return [t async for t in pool.generate(ids, max_tokens=16)]

            outs = await asyncio.gather(*[gen() for _ in range(4)])
            assert all(o == ref.streams[WEDGE] for o in outs)
            assert pool.replicas[1].state == "dead"
            assert pool.requeues >= 1 and pool.health.failures >= 1
        finally:
            release.set()
            await pool.stop()

    asyncio.run(main())


def test_wedge_verdict_matrix():
    """Wedge detection is armed only on warmed engines (stale heartbeat and
    in-flight work, before or after the first step); crash detection
    always. The port's monitor and the JAX one agree on every case."""
    def replica(warmed, hb_age, step_age, outstanding=1, alive=True):
        engine = SimpleNamespace(dispatch_alive=lambda: alive, heartbeat_age=lambda: hb_age,
                                 last_step_age=lambda: step_age, warmed=warmed)
        return SimpleNamespace(engine=engine,
                               outstanding={"r": None} if outstanding else {})

    cases = [((False, 99.0, None), False), ((False, 99.0, 99.0), False),
             ((True, 99.0, None), True), ((True, 0.1, None), False),
             ((True, 99.0, 99.0), True), ((True, 99.0, 0.1), False)]
    monitors = (HealthMonitor(pool=None, heartbeat_timeout_s=1.0),
                JaxMonitor(pool=None, heartbeat_timeout_s=1.0))
    for args, wedged in cases:
        for monitor in monitors:
            assert (monitor.verdict(replica(*args)) is not None) == wedged, args
    for monitor in monitors:
        assert monitor.verdict(replica(True, 99.0, None, outstanding=0)) is None
        for warmed in (False, True):
            assert (monitor.verdict(replica(warmed, 0.0, None, alive=False))
                    == "dispatch thread dead")


def test_killed_engine_refuses_submissions(ref):
    async def main():
        engine = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=ref.params)
        await engine.start()
        try:
            engine.kill()
            with pytest.raises(RuntimeError):
                await engine.submit(GenRequest(request_id="late", prompt_ids=[1, 2, 3],
                                               max_tokens=4))
            with pytest.raises(RuntimeError):
                engine.request_chain_export([1, 2, 3])
        finally:
            await engine.stop()

    asyncio.run(main())


def test_engine_request_cancel_mid_decode(ref):
    async def main():
        engine = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=ref.params)
        await engine.start()
        try:
            request = GenRequest(request_id="to-cancel",
                                 prompt_ids=engine.tokenizer.encode("cancel me mid decode"),
                                 max_tokens=96)
            await engine.submit(request)
            tokens, cancelled = [], False
            while (token := await asyncio.wait_for(request.stream.get(), 60)) is not None:
                tokens.append(token)
                if len(tokens) == 2 and not cancelled:
                    cancelled = engine.request_cancel("to-cancel")
            assert cancelled and request.finish_reason == "cancelled"
            assert len(tokens) < 96
            assert engine.request_cancel("never-existed") is False
        finally:
            await engine.stop()

    asyncio.run(main())


def test_pool_cancel_routes_to_serving_replica(ref):
    """``pool.cancel`` finds the record by the client's id and cancels the
    engine's shadow; the cancelled terminal reaches the client."""
    async def main():
        pool = make_pool(ref)
        await pool.start()
        try:
            ids = pool.tokenizer.encode("pool cancel target")
            request = GenRequest(request_id="logical-1", prompt_ids=ids, max_tokens=96)
            await pool.submit(request)
            tokens, cancelled = [], False
            while (token := await asyncio.wait_for(request.stream.get(), 60)) is not None:
                tokens.append(token)
                if len(tokens) == 2 and not cancelled:
                    cancelled = pool.cancel("logical-1")
            assert cancelled and request.finish_reason == "cancelled"
            assert len(tokens) < 96
            assert pool.cancel("logical-1") is False
        finally:
            await pool.stop()

    asyncio.run(main())


def test_requeue_budget_exhaustion_terminates_as_unavailable(ref):
    """Both replicas die at their first decode dispatch: the stream ends
    "unavailable" (never a bare "error"); with ``requeue_max`` 0 one death
    is enough."""
    async def main(requeue_max, poisoned):
        pool = make_pool(ref, requeue_max=requeue_max)
        for i in poisoned:
            port_poison(pool.replicas[i].engine, explode_after=1)
        await pool.start()
        try:
            request = GenRequest(request_id="doomed",
                                 prompt_ids=pool.tokenizer.encode("doomed request"),
                                 max_tokens=16)
            await pool.submit(request)
            await drain_stream(request)
            served = next(r for r in pool.replicas if r.routed)
            return request.finish_reason, [r.state for r in pool.replicas], served
        finally:
            await pool.stop()

    reason, states, _ = asyncio.run(main(2, (0, 1)))
    assert reason == "unavailable" and states == ["dead", "dead"]
    reason, _, served = asyncio.run(main(0, (0, 1)))
    assert reason == "unavailable" and served.state == "dead"


class _Refusing:
    """A duck-typed engine whose every request ends as a requeue-exhausted
    pool ends it: ``delivered`` tokens first, then "unavailable"."""

    def __init__(self, engine, delivered: list[int]):
        self.tokenizer, self.config = engine.tokenizer, engine.config
        self.device = getattr(engine, "device", None)
        self.delivered = delivered

    async def submit(self, gen):
        for token in self.delivered:
            gen.generated.append(token)
            gen.stream.put_nowait(token)
        gen.finish_reason = "unavailable"
        gen.stream.put_nowait(None)
        return gen


CHAT = {"model": "llama3-test", "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 8}


def test_unavailable_terminal_maps_to_llm_unavailable(ref):
    engine = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=ref.params)
    provider = TorchLocalProvider("tpu_local", _Refusing(engine, []))

    async def main():
        with pytest.raises(LLMUnavailable) as err:
            await provider.chat(dict(CHAT))
        assert err.value.retry_after_s >= 1
        with pytest.raises(LLMUnavailable):
            async for _chunk in provider.chat_stream(dict(CHAT)):
                pass

    asyncio.run(main())


def test_unavailable_mid_stream_yields_structured_terminal(ref):
    """Tokens already delivered: the stream ends with the JAX provider's
    structured chunk (finish_reason "unavailable", a 503 error object with
    the retry advice), after the same content."""
    engine = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=ref.params)
    partial = engine.tokenizer.encode("partial answer")[:3]
    providers = (TorchLocalProvider("tpu_local", _Refusing(engine, partial)),
                 TPULocalProvider("tpu_local", _Refusing(ref.engine, partial)))

    async def main(provider):
        return [c async for c in provider.chat_stream(dict(CHAT))]

    port, want = (asyncio.run(main(p)) for p in providers)
    strip = ({k: v for k, v in c.items() if k not in ("id", "created")} for c in port)
    assert list(strip) == [{k: v for k, v in c.items() if k not in ("id", "created")}
                           for c in want]
    terminal = port[-1]
    assert terminal["choices"][0]["finish_reason"] == "unavailable"
    assert terminal["error"]["code"] == 503 and terminal["error"]["retry_after_s"] >= 1


# ------------------------------------------------------------ drain/reload

def test_drain_reload_roundtrip(ref):
    """drain stops routing; undrain readmits; reload builds a new engine
    serving the same weights."""
    async def main():
        pool = make_pool(ref)
        await pool.start()
        try:
            ids = pool.tokenizer.encode(DRAIN)
            out1 = [t async for t in pool.generate(ids, max_tokens=6)]
            assert out1 == ref.streams[DRAIN]
            status = await pool.drain("0")
            assert status["drained"] and pool.replicas[0].state == "draining"
            before = pool.replicas[1].routed
            for _ in range(3):
                assert [t async for t in pool.generate(ids, max_tokens=4)]
            assert pool.replicas[1].routed == before + 3
            await pool.undrain("0")
            assert pool.replicas[0].state == "ready"
            with pytest.raises(ValueError):
                await pool.undrain("0")
            old = pool.replicas[0].engine
            status = await pool.reload("0")
            assert status["state"] == "ready" and pool.replicas[0].reloads == 1
            assert pool.replicas[0].engine is not old
            out2 = [t async for t in pool.generate(ids, max_tokens=6)]
            assert out2 == out1
        finally:
            await pool.stop()

    asyncio.run(main())


def test_reload_recovers_a_dead_replica(ref):
    async def main():
        pool = make_pool(ref)
        port_poison(pool.replicas[1].engine, explode_after=1)
        await pool.start()
        try:
            ids = pool.tokenizer.encode(HEAL)
            for _ in range(4):
                assert [t async for t in pool.generate(ids, max_tokens=6)]
                if pool.replicas[1].state == "dead":
                    break
            assert pool.replicas[1].state == "dead"
            await pool.reload("1")
            assert pool.replicas[1].state == "ready"
            await pool.drain("0")
            assert [t async for t in pool.generate(ids, max_tokens=6)]
            assert pool.replicas[1].routed >= 1
        finally:
            await pool.stop()

    asyncio.run(main())


def test_reload_requeues_stragglers_onto_survivor(ref):
    """A reload whose drain window closes with a generation running hands
    it to the survivor as a continuation, never a "cancelled" stream."""
    async def main():
        pool = make_pool(ref)
        await pool.start()
        try:
            await pool.drain("1")
            request = GenRequest(request_id="straggler",
                                 prompt_ids=pool.tokenizer.encode(STRAGGLER), max_tokens=64)
            await pool.submit(request)
            assert "straggler" in pool.replicas[0].outstanding
            first = await asyncio.wait_for(request.stream.get(), 60)
            await pool.undrain("1")
            await pool.reload("0", timeout_s=0)
            tokens = [first] + await drain_stream(request)
            assert request.finish_reason != "cancelled"
            assert tokens == ref.streams[STRAGGLER]
            assert pool.requeues >= 1 and pool.replicas[1].routed >= 1
            assert pool.replicas[0].state == "ready"
        finally:
            await pool.stop()

    asyncio.run(main())


# ------------------------------------------------------------ gateway HTTP

async def _clients(settings, port_app):
    jax_app = await build_app(settings)
    clients = [TestClient(TestServer(app)) for app in (jax_app, port_app)]
    for client in clients:
        await client.start_server()
    return jax_app, clients


def test_admin_pool_endpoints_of_both_apps(ref):
    """Both apps, two replicas: a chat through the port's pool, the status
    card, drain/undrain, a role set and refused, the 404 of an unknown replica and the 4xx of a bad
    action or a non-object body."""
    settings = load_settings(env={**GATEWAY_ENV, "MCPFORGE_TPU_LOCAL_REPLICAS": "2"},
                             env_file=None)

    async def main():
        pool = build_pool(settings, dataclasses.replace(EngineConfig.from_settings(settings),
                                                        device="cpu"),
                          engine_factory=factory(ref.params))
        port_app = build_llm_app(settings, pool=pool)
        assert port_app["tpu_engine_pool"] is pool
        assert port_app["tpu_engine"] is pool.replicas[0].engine
        assert port_app["tpu_provider"].engine is pool
        _, clients = await _clients(settings, port_app)
        try:
            cards = []
            # chat through the port's pool (the JAX pool's engines would
            # compile for it; its card is compared for shape)
            resp = await clients[1].post("/v1/chat/completions", json={
                "model": "llama3-test", "max_tokens": 4,
                "messages": [{"role": "user", "content": "pool me"}]}, auth=BASIC)
            assert resp.status == 200, await resp.text()
            for client in clients:
                resp = await client.get("/admin/engine/pool", auth=BASIC)
                assert resp.status == 200
                cards.append(await resp.json())
                for action, state in (("drain", "draining"), ("undrain", "ready")):
                    resp = await client.post(f"/admin/engine/pool/0/{action}", auth=BASIC)
                    assert resp.status == 200 and (await resp.json())["state"] == state
                for role in ("prefill", "any"):
                    resp = await client.post("/admin/engine/pool/1/role",
                                             json={"role": role}, auth=BASIC)
                    assert resp.status == 200 and (await resp.json())["role"] == role
                for body in ({"role": "bogus"}, {}):
                    resp = await client.post("/admin/engine/pool/1/role", json=body,
                                             auth=BASIC)
                    assert resp.status == 422
                resp = await client.post("/admin/engine/pool/9/drain", auth=BASIC)
                assert resp.status == 404
                resp = await client.post("/admin/engine/pool/0/explode", auth=BASIC)
                assert resp.status in (400, 422)
                resp = await client.post("/admin/engine/pool/0/drain", json=[30], auth=BASIC)
                assert resp.status in (400, 422)
                resp = await client.get("/admin/engine/pool")
                assert resp.status == 401
            want, got = cards
            assert [r["id"] for r in got["replicas"]] == [r["id"] for r in want["replicas"]]
            assert [r["state"] for r in got["replicas"]] == ["ready", "ready"]
            assert set(want) == set(got)
            assert set(want["replicas"][0]) <= set(got["replicas"][0])
            assert set(got["router"]) == set(want["router"])
            assert got["router"]["routed"] == 1
            assert set(got["health"]) == set(want["health"])
        finally:
            for client in clients:
                await client.close()

    asyncio.run(main())


def test_pool_404_when_single_replica(ref):
    """With one replica there is no pool layer, and both apps say so."""
    settings = load_settings(env=GATEWAY_ENV, env_file=None)

    async def main():
        engine = TorchEngine(dataclasses.replace(EngineConfig.from_settings(settings),
                                                 device="cpu"), params=ref.params)
        port_app = build_llm_app(settings, engine=engine)
        assert port_app["tpu_engine_pool"] is None
        _, clients = await _clients(settings, port_app)
        try:
            for client in clients:
                resp = await client.get("/admin/engine/pool", auth=BASIC)
                assert resp.status == 404
                resp = await client.post("/admin/engine/pool/0/drain", auth=BASIC)
                assert resp.status == 404
        finally:
            for client in clients:
                await client.close()

    asyncio.run(main())
