"""The port's pool with the shared spill tiers and the prefill -> decode
split, against the JAX package on CPU replicas of llama3-test in f32
serving the JAX engine's weights: the cases of
``tests/tpu_local/test_tier_pool.py`` and ``test_pool_disagg.py``.

- one spill store and one prefix index serve every replica: a prefix
  evicted on replica 0 restores into replica 1 (fetch-on-miss) with one
  engine's cold stream; the router scores the pool index as affinity;
- a replica killed mid-generation hands its continuation to the survivor,
  which restores the shared prefix: with the lossless spill the stream is
  the uninterrupted engine's. With the default int8 spill a restored
  continuation drifts from it, which is why the JAX package's own kill
  case, run with the int8 spill, fails;
- spill on drain keeps the prefix corpus across a reload; a reload drops
  the replica's stale index entries;
- roles and the role router; a migration of a long prompt gives the
  unmigrated engine's stream and the JAX pool's counters (migrations,
  pages, bytes); an int8-page migration restores the exported pages bit
  for bit; the ``pool.migrate`` error and corrupt faults and a target that
  dies at the hand-off degrade in place with the same stream; spilled =
  restored + degraded throughout; tenant counts are conserved;
- ``TieredPageStore.verify_chain`` agrees with the JAX store's and
  rejects a corrupt chain; ``request_chain_export`` fails its future when
  the engine dies before the export runs.

The JAX side runs once per module (``ref``).
"""

import asyncio
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.observability.metering import TenantLedger
from mcp_context_forge_tpu.observability.metrics import PrometheusRegistry
from mcp_context_forge_tpu.observability.tenant import TenantClamp
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import GenRequest as JaxRequest
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu.tpu_local.kv.prefix_index import chain_pages as jax_chain_pages
from mcp_context_forge_tpu.tpu_local.kv.tiers import SpilledPage as JaxSpilledPage
from mcp_context_forge_tpu.tpu_local.kv.tiers import TieredPageStore as JaxStore
from mcp_context_forge_tpu.tpu_local.pool import EnginePool as JaxPool
from mcp_context_forge_tpu_torch.observability.faults import (FaultRule,
                                                              configure_fault_plane,
                                                              get_fault_plane)
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, GenRequest, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.kv import SpilledPage, TieredPageStore
from mcp_context_forge_tpu_torch.tpu_local.kv.prefix_index import chain_hashes, chain_pages
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.pool import EnginePool

PS = 16
BASE = dict(model="llama3-test", max_batch=4, max_seq_len=128, page_size=PS, num_pages=64,
            prefill_buckets=(16, 64), dtype="float32", prefix_cache=True)
# test_tier_pool.py's store, and test_pool_disagg.py's
TIERS = dict(prefix_tiers=True, tier_host_bytes=1 << 20, tier_disk_bytes=1 << 20)
DISAGG = dict(prefix_tiers=True, tier_host_bytes=64 << 20, tier_disk_bytes=0)
TMPL_A, TMPL_B, TMPL_C = (list(range(3, 36)), list(range(200, 233)),
                          list(range(400, 433)))    # two full pages and a tail each
WARM = [t + [40] for t in (TMPL_A, TMPL_B, TMPL_C)]
VICTIM = TMPL_A + [41]
# ~88 byte tokens: 5 full pages, past the prefill threshold (PS)
LONG_PROMPT = "the quick brown fox jumps over the lazy dog " * 2
CHAT_PROMPT = "hi there"   # 8 tokens < PS: stays on the decode tier
# the kill-through-tier continuation: tokens delivered before the kill
DELIVERED = 2


@pytest.fixture(autouse=True)
def hermetic_fault_plane():
    yield
    configure_fault_plane(False)


async def gen(engine, ids, n=6):
    return [t async for t in engine.generate(ids, max_tokens=n)]


async def run(pool, prompt, rid, max_tokens=12, tenant="", cls=GenRequest):
    request = cls(request_id=rid, prompt_ids=pool.tokenizer.encode(prompt),
                  max_tokens=max_tokens, tenant=tenant)
    await pool.submit(request)
    out = []
    while (token := await asyncio.wait_for(request.stream.get(), 120)) is not None:
        out.append(token)
    return request, out


def migration_counts(pool) -> dict:
    return {"migrations": dict(pool.migrations), "pages": dict(pool.migration_pages),
            "bytes": pool.migration_bytes, "requeues": pool.requeues,
            "out": [r.migrations_out for r in pool.replicas],
            "in": [r.migrations_in for r in pool.replicas]}


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: one tier-less engine serves the victim cold,
    then template A twice (the second a prefix hit), the long prompt and
    the chat; the disaggregated JAX pool migrates the long prompt, then
    serves the chat."""
    def config(**overrides):
        return JaxConfig(**{**BASE, **overrides}, attn_impl="reference")

    engine = TPUEngine(config())
    pool = JaxPool(config(**DISAGG), replicas=2, roles="prefill,decode",
                   disagg_prompt_tokens=PS, health_interval_s=0.05)
    tok = engine.tokenizer
    jobs = [(VICTIM, 16), (TMPL_A + [40], 6), (TMPL_A + [41], 12),
            (tok.encode(LONG_PROMPT), 12), (tok.encode(CHAT_PROMPT), 12)]

    async def main():
        await engine.start()
        try:
            out = [await gen(engine, ids, n) for ids, n in jobs]
        finally:
            await engine.stop()
        await pool.start()
        try:
            _, long_out = await run(pool, LONG_PROMPT, "mig-1", cls=JaxRequest)
            _, chat_out = await run(pool, CHAT_PROMPT, "chat-1", cls=JaxRequest)
        finally:
            await pool.stop()
        return out, long_out, chat_out

    out, long_out, chat_out = asyncio.run(main())
    params = params_from_jax(jax.device_get(engine.params), MODEL_CONFIGS["llama3-test"],
                             device="cpu", dtype=torch.float32)
    return SimpleNamespace(params=params, victim=out[0], template=out[2], long=out[3],
                           chat=out[4], pool=pool, pool_long=long_out, pool_chat=chat_out,
                           pool_counts=migration_counts(pool))


def make_pool(ref, replicas=2, base=TIERS, roles=None, metrics=None, ledger=None,
              **overrides):
    def factory(cfg, tracer, metrics, ledger=None, tier_store=None, prefix_index=None):
        return TorchEngine(cfg, params=ref.params, tracer=tracer, metrics=metrics,
                           ledger=ledger, tier_store=tier_store, prefix_index=prefix_index)

    return EnginePool(EngineConfig(**{**BASE, **base, **overrides}, device="cpu"),
                      replicas=replicas, roles=roles, disagg_prompt_tokens=PS,
                      health_interval_s=0.05, engine_factory=factory, metrics=metrics,
                      ledger=ledger)


def disagg_pool(ref, roles="prefill,decode", **overrides):
    return make_pool(ref, base=DISAGG, roles=roles, **overrides)


def assert_conserved(pool):
    pages = pool.migration_pages
    assert pages["spilled"] == pages["restored"] + pages["degraded"], pages


# ------------------------------------------------------------ shared tiers

def test_pool_shares_one_store_and_index(ref):
    pool = make_pool(ref)
    clients = [r.engine._tier_client for r in pool.replicas]
    assert all(c is not None for c in clients)
    assert clients[0].store is clients[1].store is pool.tier_store
    assert clients[0].index is clients[1].index is pool.prefix_index
    status, want = pool.status(), ref.pool.status()
    assert status["prefix_tiers"]["enabled"] is True
    assert set(status["prefix_tiers"]["store"]) == set(want["prefix_tiers"]["store"])
    assert set(status["prefix_tiers"]["index"]) == set(want["prefix_tiers"]["index"])
    pool.tier_store.close()


def test_fetch_on_miss_restores_from_any_replica(ref):
    """Replica 0 prefills and spills template A under pressure; replica 1,
    cold, serves A by restoring it from the shared store into its own
    pool, with one engine's stream."""
    async def main():
        pool = make_pool(ref, num_pages=5)
        await pool.start()
        try:
            r0, r1 = pool.replicas[0].engine, pool.replicas[1].engine
            for ids in WARM:
                await gen(r0, ids)
            assert pool.tier_store.stats()["spilled"] >= 1
            assert await gen(r1, VICTIM) == ref.victim[:6]
            assert r1.tier_stats()["restores"] >= 1
            hits = r1.allocator.tier_hit_tokens
            assert hits["host"] + hits["disk"] >= 2 * PS
        finally:
            await pool.stop()

    asyncio.run(main())


def test_router_scores_pool_index_hit_as_affinity(ref):
    """A prefix resident only on replica 1 steers routing there, both when
    its own probe sees it and when only the pool index knows it."""
    async def main():
        pool = make_pool(ref)
        await pool.start()
        try:
            await gen(pool.replicas[1].engine, TMPL_A + [40])
            assert pool.prefix_index.stats()["keys_hbm"] >= 2
            routed = pool.router.routed
            choice, hit = pool.router.route(list(pool.replicas), TMPL_A + [41])
            assert hit is True and choice is pool.replicas[1]
            assert pool.router.routed == routed + 1 and pool.router.affinity_hits >= 1
            ghost = [9000 + i for i in range(33)] + [41]
            for key_hash in chain_hashes(ghost, PS):
                pool.prefix_index.publish_hbm(key_hash, "1")
            choice, hit = pool.router.route(list(pool.replicas), ghost)
            assert hit is True and choice is pool.replicas[1]
            assert pool.router.index_hits >= 1
        finally:
            await pool.stop()

    asyncio.run(main())


def test_shared_tier_hit_is_affinity_neutral_but_counts(ref):
    async def main():
        pool = make_pool(ref, num_pages=5)
        await pool.start()
        try:
            for ids in WARM:
                await gen(pool.replicas[0].engine, ids)
            assert pool.tier_store.stats()["spilled"] >= 1
            choice, hit = pool.router.route(list(pool.replicas), TMPL_A + [60])
            assert hit is True and choice is not None
        finally:
            await pool.stop()

    asyncio.run(main())


def test_kill_mid_generation_requeues_through_tier_restore(ref):
    """The serving replica of a tier-restored prefix is killed mid-decode;
    the survivor restores the prefix itself and, with the lossless spill,
    the merged stream is the uninterrupted engine's."""
    async def main():
        pool = make_pool(ref, num_pages=5, tier_spill_quant="")
        await pool.start()
        try:
            for ids in WARM:
                await gen(pool.replicas[0].engine, ids)
            assert pool.tier_store.stats()["spilled"] >= 1
            request = GenRequest(request_id="victim", prompt_ids=list(VICTIM), max_tokens=16)
            await pool.submit(request)
            out = [await asyncio.wait_for(request.stream.get(), 120) for _ in range(2)]
            serving = next(r for r in pool.replicas if "victim" in r.outstanding)
            pool.fail_replica(serving, reason="chaos: kill mid tier serve")
            while (token := await asyncio.wait_for(request.stream.get(), 120)) is not None:
                out.append(token)
            assert out == ref.victim
            assert pool.requeues >= 1 and serving.state == "dead"
            assert [r for r in pool.replicas if r is not serving][0].state == "ready"
        finally:
            await pool.stop()

    asyncio.run(main())


@pytest.mark.parametrize("spill_quant", ["", "int8"])
def test_restored_continuation_exact_only_with_lossless_spill(ref, spill_quant):
    """What a survivor serves after a kill, made deterministic: template A
    spilled from replica 0, then the continuation prompt (the victim and
    its first DELIVERED tokens) restored and served on replica 1. The
    lossless spill gives the rest of the uninterrupted stream; the default
    int8 spill restores quantized pages, and its stream drifts from it:
    the cause of the JAX package's failing kill case, which runs with the
    int8 spill against an exact stream."""
    async def main():
        pool = make_pool(ref, num_pages=5, tier_spill_quant=spill_quant)
        await pool.start()
        try:
            for ids in WARM:
                await gen(pool.replicas[0].engine, ids)
            r1 = pool.replicas[1].engine
            out = await gen(r1, VICTIM + ref.victim[:DELIVERED], 16 - DELIVERED)
            hits = r1.allocator.tier_hit_tokens
            return out, hits["host"] + hits["disk"]
        finally:
            await pool.stop()

    out, restored = asyncio.run(main())
    assert restored >= 2 * PS
    rest = ref.victim[DELIVERED:]
    if spill_quant == "":
        assert out == rest
    else:
        assert out != rest
        assert out[0] == rest[0]   # the drift shows later in the stream


def test_spill_on_drain_preserves_prefix_corpus_across_reload(ref):
    """drain -> reload spills the replica's resident prefix pages first, so
    the rebuilt replica serves the template from the tiers, with one
    engine's stream (lossless spill)."""
    async def main():
        pool = make_pool(ref, replicas=1, tier_spill_quant="")
        await pool.start()
        try:
            r0 = pool.replicas[0].engine
            await gen(r0, TMPL_A + [40])
            spilled0 = pool.tier_store.stats()["spilled"]
            assert r0.allocator.cached_pages >= 2
            await pool.reload("0")
            assert pool.tier_store.stats()["spilled"] > spilled0
            engine = pool.replicas[0].engine
            assert engine is not r0
            assert await gen(engine, TMPL_A + [41], n=12) == ref.template
            hits = engine.allocator.tier_hit_tokens
            assert hits["host"] + hits["disk"] >= 2 * PS
        finally:
            await pool.stop()

    asyncio.run(main())


def test_reload_drops_stale_hbm_index_entries(ref):
    async def main():
        pool = make_pool(ref)
        await pool.start()
        try:
            await gen(pool.replicas[1].engine, TMPL_A + [40])
            assert pool.prefix_index.stats()["keys_hbm"] >= 2
            await pool.reload("1")
            client = pool.replicas[1].engine._tier_client
            assert client is not None and client.store is pool.tier_store
            chain = pool.prefix_index.chain_locations(TMPL_A + [41], PS)
            assert (pool.prefix_index.reachable_tokens(chain, "1", PS) == 0
                    or all("1" not in hbm for hbm, _ in chain))
        finally:
            await pool.stop()

    asyncio.run(main())


# ------------------------------------------------------------------ roles

def test_role_assignment_validation_and_status_surface(ref):
    pool = disagg_pool(ref)
    assert [r.role for r in pool.replicas] == ["prefill", "decode"]
    status = pool.status()
    assert set(status) == set(ref.pool.status())
    assert status["roles"] == {"active": True, "assignment": {"0": "prefill", "1": "decode"},
                               "disagg_prompt_tokens": PS}
    assert status["migrations"] == {"ok": 0, "degraded": 0, "bytes": 0,
                                    "pages": {"spilled": 0, "restored": 0, "degraded": 0}}
    card = pool.replicas[1].status()
    assert card["role"] == "decode" and card["migrations_out"] == card["migrations_in"] == 0
    assert pool.set_role("1", "any")["role"] == "any"
    pool.set_role("1", "decode")
    with pytest.raises(ValueError):
        pool.set_role("1", "bogus")
    with pytest.raises(KeyError):
        pool.set_role("9", "decode")
    with pytest.raises(ValueError):
        disagg_pool(ref, roles="prefill,bogus")
    assert [r.role for r in disagg_pool(ref, roles="prefill").replicas] == ["prefill", "any"]
    uniform = disagg_pool(ref, roles="")
    assert uniform.roles_active is False
    for p in (pool, uniform):
        p.tier_store.close()


def test_role_router_oversubscribed_prefill_spills_to_any(ref):
    pool = disagg_pool(ref, roles="prefill,any")
    r_prefill, r_any = pool.replicas
    ids = pool.tokenizer.encode(LONG_PROMPT)
    assert pool.router.route(list(pool.replicas), ids, route_class="prefill")[0] is r_prefill
    assert (pool.router.role_routed, pool.router.role_spills) == (1, 0)
    r_prefill.outstanding_tokens = lambda: 10_000
    assert pool.router.route(list(pool.replicas), ids, route_class="prefill")[0] is r_any
    assert pool.router.role_spills == 1
    assert pool.router.route(list(pool.replicas), ids, route_class="decode")[0] is r_any
    assert pool.router.counters()["role_spills"] == 2
    pool.tier_store.close()


# ------------------------------------------------------------- migration

def test_migration_greedy_parity_vs_unmigrated_engine(ref):
    """A long admission prefills on the prefill replica, its chain migrates
    through the shared tiers and it decodes on the decode replica: the
    stream is the unmigrated engine's, and every counter (migrations,
    pages, bytes, per replica) the JAX pool's. A short chat never
    migrates."""
    async def main():
        pool = disagg_pool(ref)
        await pool.start()
        try:
            request, out = await run(pool, LONG_PROMPT, "mig-1")
            _, chat = await run(pool, CHAT_PROMPT, "chat-1")
        finally:
            await pool.stop()
        return pool, request, out, chat

    pool, request, out, chat = asyncio.run(main())
    assert out == ref.long == ref.pool_long
    assert chat == ref.chat == ref.pool_chat
    assert request.finish_reason in ("stop", "length")
    assert migration_counts(pool) == ref.pool_counts
    expected = len(pool.tokenizer.encode(LONG_PROMPT)) // PS
    assert pool.migrations == {"ok": 1, "degraded": 0}
    assert pool.migration_pages == {"spilled": expected, "restored": expected,
                                    "degraded": 0}
    assert pool.migration_bytes > 0
    assert_conserved(pool)
    assert pool.router.role_routed >= 1


def test_int8_pool_migration_is_bit_exact(ref):
    """An int8 pool spills its pages as they are: the decode replica's
    restored chain pages (bytes and scales) equal the prefill replica's bit
    for bit, and the stream is an unmigrated int8 engine's (the port's,
    which ``tests/test_torch_kv_quant.py`` holds to ``TPUEngine``'s)."""
    async def main():
        engine = TorchEngine(EngineConfig(**BASE, kv_quant="int8", device="cpu"),
                             params=ref.params)
        await engine.start()
        try:
            want = await gen(engine, engine.tokenizer.encode(LONG_PROMPT), 12)
        finally:
            await engine.stop()
        pool = disagg_pool(ref, kv_quant="int8")
        await pool.start()
        try:
            _, out = await run(pool, LONG_PROMPT, "mig-int8")
        finally:
            await pool.stop()
        return pool, out, want

    pool, out, want = asyncio.run(main())
    assert out == want
    assert pool.migrations == {"ok": 1, "degraded": 0}
    assert_conserved(pool)
    src, dst = (r.engine for r in pool.replicas)
    ids = pool.tokenizer.encode(LONG_PROMPT)
    steps = list(src.allocator._chain_steps(ids, full=True))
    assert len(steps) == len(ids) // PS
    for key, *_ in steps:
        a, b = src.allocator._cached[key], dst.allocator._cached[key]
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            assert torch.equal(getattr(src.kv, name)[:, a], getattr(dst.kv, name)[:, b]), name


def test_pool_migrate_error_fault_degrades_to_decode_in_place(ref):
    async def main():
        configure_fault_plane(True).arm(FaultRule(point="pool.migrate", kind="error"))
        pool = disagg_pool(ref)
        await pool.start()
        try:
            request, out = await run(pool, LONG_PROMPT, "mig-err")
        finally:
            await pool.stop()
        return pool, request, out

    pool, request, out = asyncio.run(main())
    assert out == ref.long and request.finish_reason in ("stop", "length")
    assert pool.migrations == {"ok": 0, "degraded": 1}
    assert pool.migration_pages == {"spilled": 0, "restored": 0, "degraded": 0}
    assert_conserved(pool)
    assert [r.migrations_out for r in pool.replicas] == [0, 0]
    assert any(r["point"] == "pool.migrate" and r["fired"] >= 1
               for r in get_fault_plane().snapshot()["rules"])


def test_pool_migrate_corrupt_fault_degrades_via_verify_miss(ref):
    """A corrupt chain identity fails verify before serving: the pages were
    spilled, none restored, and the stream is whole."""
    async def main():
        configure_fault_plane(True).arm(FaultRule(point="pool.migrate", kind="corrupt"))
        pool = disagg_pool(ref)
        await pool.start()
        try:
            _, out = await run(pool, LONG_PROMPT, "mig-corrupt")
        finally:
            await pool.stop()
        return pool, out

    pool, out = asyncio.run(main())
    assert out == ref.long
    assert pool.migrations == {"ok": 0, "degraded": 1}
    pages = pool.migration_pages
    assert pages["spilled"] >= 1 and pages["restored"] == 0
    assert pages["degraded"] == pages["spilled"]
    assert_conserved(pool)


def test_kill_decode_target_at_handoff_falls_back_in_place(ref):
    async def main():
        pool = disagg_pool(ref)
        await pool.start()
        try:
            async def refuse(shadow):
                raise RuntimeError("injected: target killed at hand-off")
            pool.replicas[1].engine.submit = refuse
            request, out = await run(pool, LONG_PROMPT, "mig-kill")
        finally:
            await pool.stop()
        return pool, request, out

    pool, request, out = asyncio.run(main())
    assert out == ref.long and request.finish_reason in ("stop", "length")
    assert pool.migrations == {"ok": 0, "degraded": 1}
    pages = pool.migration_pages
    assert pages["spilled"] >= 1 and pages["restored"] == 0
    assert_conserved(pool)
    assert pool.replicas[1].state == "dead" and pool.replicas[0].migrations_out == 0


def test_tenant_conservation_across_the_migration_hop(ref):
    """The hop is invisible to billing: the JAX package's ledger (fed by
    the port's engines) sums to the engines' totals, and each tenant's
    generated tokens are what its clients received."""
    async def main():
        registry = PrometheusRegistry(tenant_clamp=TenantClamp(8))
        ledger = TenantLedger(clamp=registry.tenant_clamp, metrics=registry)
        pool = disagg_pool(ref, metrics=registry, ledger=ledger)
        await pool.start()
        try:
            results = await asyncio.gather(
                run(pool, LONG_PROMPT, "acct-long", tenant="team:mig"),
                run(pool, CHAT_PROMPT + " one", "acct-c1", tenant="team:chat"),
                run(pool, CHAT_PROMPT + " two", "acct-c2", tenant="team:chat"))
        finally:
            await pool.stop()
        return pool, ledger, results

    pool, ledger, results = asyncio.run(main())
    assert all(tokens for _, tokens in results)
    assert pool.migrations["ok"] + pool.migrations["degraded"] == 1
    assert_conserved(pool)
    sums, stats = ledger.column_sums(), pool.stats
    assert sums["prompt_tokens"] == stats.prompt_tokens
    assert sums["generated_tokens"] == stats.completion_tokens
    assert sums["cache_hit_tokens"] == sum(r.engine.allocator.prefix_hit_tokens
                                           for r in pool.replicas)
    delivered = {}
    for request, tokens in results:
        delivered[request.tenant] = delivered.get(request.tenant, 0) + len(tokens)
    totals = ledger.totals()
    for tenant, count in delivered.items():
        assert totals[tenant]["generated_tokens"] == count
    assert "unattributed" not in totals


# --------------------------------------------------------- the export seam

def test_verify_chain_rejects_a_corrupt_chain():
    """The pool's verify before serving, on the port's store and the JAX
    one, over the same pages: the whole chain verifies with the same page
    and byte counts; a chain whose first chunk is wrong verifies nothing,
    and its entry is dropped (a later true chain then misses too)."""
    ids = list(range(3, 3 + 3 * PS + 5))
    rng = np.random.default_rng(0)
    stores = (TieredPageStore(host_bytes=1 << 20), JaxStore(host_bytes=1 << 20, pin=False))
    for store, chain_fn, cls in zip(stores, (chain_pages, jax_chain_pages),
                                    (SpilledPage, JaxSpilledPage)):
        rng = np.random.default_rng(0)
        steps = chain_fn(ids, PS)
        for key_hash, parent, chunk in steps:
            store.put(key_hash, cls(
                chunk=chunk, parent=parent,
                k=rng.integers(-127, 128, (2, PS, 2, 8), dtype=np.int8),
                v=rng.integers(-127, 128, (2, PS, 2, 8), dtype=np.int8),
                k_scales=rng.random((2, 2), dtype=np.float32),
                v_scales=rng.random((2, 2), dtype=np.float32)))
    port_steps, jax_steps = chain_pages(ids, PS), jax_chain_pages(ids, PS)
    assert port_steps == jax_steps and len(port_steps) == 3
    whole = [store.verify_chain(steps) for store, steps in zip(stores, (port_steps, jax_steps))]
    assert whole[0] == whole[1] and whole[0][0] == 3 and whole[0][1] > 0
    for store, steps in zip(stores, (port_steps, jax_steps)):
        key_hash, parent, chunk = steps[0]
        bad = [(key_hash, parent, (chunk[0] + 1,) + tuple(chunk[1:]))] + steps[1:]
        assert store.verify_chain(bad) == (0, 0)
        assert store.verify_chain(steps) == (0, 0)   # the colliding entry dropped
        store.close()


def test_request_chain_export_fails_its_future_on_a_dead_engine(ref):
    """An export staged on an engine whose dispatch thread dies before it
    runs fails with RuntimeError (a migration then degrades, never hangs);
    the dead engine refuses further exports."""
    async def main():
        engine = TorchEngine(EngineConfig(**BASE, **DISAGG, device="cpu"), params=ref.params)
        await engine.start()
        try:
            ids = list(range(3, 3 + 2 * PS + 1))
            await gen(engine, ids, n=2)
            ok = await asyncio.wrap_future(engine.request_chain_export(ids))
            assert ok == 2

            def crash():
                raise RuntimeError("injected: dispatch thread dies")
            engine._apply_exports = crash
            fut = engine.request_chain_export(ids)
            with pytest.raises(RuntimeError, match="before the chain export ran"):
                await asyncio.wait_for(asyncio.wrap_future(fut), 30)
            assert not engine.dispatch_alive()
            with pytest.raises(RuntimeError):
                engine.request_chain_export(ids)
        finally:
            await engine.stop()

    asyncio.run(main())
