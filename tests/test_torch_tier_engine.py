"""``TorchEngine`` with the spill tiers on, beside ``TPUEngine`` on the same
llama3-test weights and requests, on the CPU, with a pool small enough
that shared prefixes are evicted (spilled) and restored (fetch-on-miss):

- greedy streams are equal, with the lossless spill (``tier_spill_quant=""``)
  of an f32 pool and with an int8 pool (its bytes spilled as they are),
  and so are ``tier_hits``/``tier_hit_tokens`` and ``tier_stats()``;
- a page's spill payload is bit for bit the JAX engine's (``_tier_read_fn``)
  in each mode (int8 quantized on spill of a bf16 or an f32 pool, the f32
  container, an int8 pool), and so is the page its upload writes back;
- the disk tier serves a restore after the host tier is emptied;
- a payload whose identity does not match (a collision) is a miss: the
  request gives the cold stream;
- ``spill_prefix_pages`` after ``stop()`` fills a shared store from which
  a new engine restores; a crash restart drops the replica's resident
  pages from the prefix index;
- the tier metric families and the ``tier.spill``/``tier.restore`` spans;
- ``prefix_tiers`` without ``prefix_cache`` raises as the reference does,
  and ``from_settings`` reads the tier settings.
"""

import asyncio
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.config import load_settings
from mcp_context_forge_tpu.observability import degradation as jax_degradation
from mcp_context_forge_tpu.observability.metrics import PrometheusRegistry
from mcp_context_forge_tpu.observability.tracing import Tracer
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import GenRequest as JaxRequest
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu.tpu_local.kv.prefix_index import ROOT_HASH, chain_hashes
from mcp_context_forge_tpu.tpu_local.kv.prefix_index import PrefixIndex as JaxIndex
from mcp_context_forge_tpu.tpu_local.kv.tiers import SpilledPage as JaxSpilledPage
from mcp_context_forge_tpu.tpu_local.kv.tiers import TieredPageStore as JaxStore
from mcp_context_forge_tpu_torch.observability import degradation as port_degradation
from mcp_context_forge_tpu_torch.observability import faults as port_faults
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, GenRequest, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.kv import PrefixIndex, SpilledPage, TieredPageStore
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax

PS = 16
BASE = dict(model="llama3-test", max_batch=2, max_seq_len=128, page_size=PS, num_pages=5,
            prefill_buckets=(16, 64), dtype="float32", prefix_cache=True)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def hermetic():
    """Both packages' breakers (process-global, shared by every store a
    worker builds) start and end at their defaults."""
    for module in (jax_degradation, port_degradation):
        module.configure_degradation()
    yield
    for module in (jax_degradation, port_degradation):
        module.configure_degradation()


def make_pair(tiers=True, **overrides):
    """A TPUEngine and a TorchEngine on the same weights and config, the
    spill tiers on (lossless spill by default)."""
    config = {**BASE, "prefix_tiers": tiers, "tier_spill_quant": "", **overrides}
    ref = TPUEngine(JaxConfig(**config, attn_impl="reference"))
    params = params_from_jax(jax.device_get(ref.params), MODEL_CONFIGS[config["model"]],
                             device="cpu", dtype=_DTYPES[config["dtype"]])
    port = TorchEngine(EngineConfig(**config, device="cpu"), params=params)
    return ref, port


def pressure_prompts(n_templates: int = 2):
    """Templates of two full pages and a tail over a pool too small to keep
    them all: round-robin reuse finds each template spilled in turn."""
    templates = [list(range(3 + 97 * g, 36 + 97 * g)) for g in range(n_templates)]
    prompts = [tmpl + [40 + 10 * r + g] for r in range(2) for g, tmpl in enumerate(templates)]
    return prompts + [templates[0] + [77]]


async def gen(engine, ids, n=6):
    return [t async for t in engine.generate(ids, max_tokens=n)]


def serve(engine, prompts, n=6, stats=None):
    """Greedy streams of ``prompts`` served one after another; ``stats``
    (a list) receives ``tier_stats()`` before the engine stops (which
    closes a private store)."""
    async def main():
        await engine.start()
        try:
            outs = [await gen(engine, ids, n) for ids in prompts]
            if stats is not None:
                stats.append(engine.tier_stats())
            return outs
        finally:
            await engine.stop()

    return asyncio.run(main())


def hit_split(engine):
    alloc = engine.allocator
    return dict(alloc.tier_hits), dict(alloc.tier_hit_tokens), alloc.prefix_hit_tokens


def counts(stats):
    """A tier_stats() dict without its latency."""
    return {k: v for k, v in stats.items() if k != "restore_p95_ms"}


@pytest.mark.parametrize("kv_quant,num_pages,n_templates",
                         [("", 5, 2), ("int8", 2, 3)])
def test_streams_and_hit_split_equal(kv_quant, num_pages, n_templates):
    """Lossless round trips under eviction: the streams, the per-tier hit
    split and the tier_stats() counts equal TPUEngine's, and the tiers
    really spilled and restored."""
    ref, port = make_pair(kv_quant=kv_quant, num_pages=num_pages)
    prompts = pressure_prompts(n_templates)
    stats: list = []
    want, got = serve(ref, prompts, stats=stats), serve(port, prompts, stats=stats)
    assert got == want
    assert hit_split(port) == hit_split(ref)
    hits, tokens, total = hit_split(port)
    assert tokens["host"] >= 2 * PS and sum(tokens.values()) == total
    assert counts(stats[1]) == counts(stats[0])
    assert stats[1]["spills"] >= 1 and stats[1]["restores"] >= 1 and stats[1]["enabled"]
    assert stats[1]["store"]["host_pages"] == stats[1]["store"]["spilled"] >= 1
    # stop() closed the private store: the tiers are off
    assert port.tier_stats()["enabled"] is False and ref.tier_stats()["enabled"] is False
    # a tier-less engine on the same pool gets fewer hits
    plain = TorchEngine(EngineConfig(**{**BASE, "kv_quant": kv_quant, "num_pages": num_pages},
                                     device="cpu"), params=port.params)
    assert serve(plain, prompts) == got
    assert plain.allocator.prefix_hit_tokens < total and plain.tier_stats() is None


def jax_pool_set(ref, page, k, v, ks=None, vs=None):
    kv = ref.kv
    kv = kv._replace(k_pages=kv.k_pages.at[:, page].set(jnp.asarray(k, kv.k_pages.dtype)),
                     v_pages=kv.v_pages.at[:, page].set(jnp.asarray(v, kv.v_pages.dtype)))
    if ks is not None:
        kv = kv._replace(k_scales=kv.k_scales.at[:, page].set(jnp.asarray(ks, kv.k_scales.dtype)),
                         v_scales=kv.v_scales.at[:, page].set(jnp.asarray(vs, kv.v_scales.dtype)))
    ref.kv = kv


def port_pool_set(port, page, k, v, ks=None, vs=None):
    kv = port.kv
    kv.k_pages[:, page] = torch.from_numpy(k).to(kv.k_pages.dtype)
    kv.v_pages[:, page] = torch.from_numpy(v).to(kv.v_pages.dtype)
    if ks is not None:
        kv.k_scales[:, page] = torch.from_numpy(ks).to(kv.k_scales.dtype)
        kv.v_scales[:, page] = torch.from_numpy(vs).to(kv.v_scales.dtype)


def as_f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype,kv_quant,spill", [("bfloat16", "", "int8"),
                                                  ("float32", "", "int8"),
                                                  ("float32", "", ""),
                                                  ("bfloat16", "int8", "int8")])
def test_spill_payload_and_upload_bit_for_bit(dtype, kv_quant, spill):
    """The same page contents in both pools: the spill payloads are equal
    bit for bit, and uploading the JAX payload into another page of each
    pool writes equal pages (dequantized on restore where it was
    quantized on spill)."""
    ref, port = make_pair(dtype=dtype, kv_quant=kv_quant, tier_spill_quant=spill,
                          num_pages=4)
    rng = np.random.default_rng(7)
    L, KV, hd = port.kv.k_pages.shape[0], port.kv.k_pages.shape[3], port.kv.k_pages.shape[4]
    shape = (L, PS, KV, hd)
    if kv_quant:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2))
        ks, vs = (rng.uniform(0.001, 0.05, (L, KV)).astype(np.float32) for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32) * 3 for _ in range(2))
        k[0, 0, 0, 0] = 0.0
        ks = vs = None
    jax_pool_set(ref, 2, k, v, ks, vs)
    port_pool_set(port, 2, k, v, ks, vs)
    want, got = ref._read_page_payload(2), port._read_page_payload(2)
    for name in ("k", "v", "k_scales", "v_scales"):
        a, b = np.asarray(getattr(want, name)), np.asarray(getattr(got, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert got.k.dtype == (np.float32 if spill == "" and not kv_quant else np.int8)
    # the upload of the same payload into page 1 of each pool
    ref._upload_page(1, want)
    port._upload_page(1, JaxSpilledPage(**dataclasses.asdict(want)))
    for ref_t, port_t in ((ref.kv.k_pages, port.kv.k_pages), (ref.kv.v_pages, port.kv.v_pages)):
        a, b = as_f32(ref_t[:, 1]), as_f32(port_t[:, 1])
        assert a.tobytes() == b.tobytes()
    if kv_quant:
        assert as_f32(ref.kv.k_scales[:, 1]).tobytes() == as_f32(port.kv.k_scales[:, 1]).tobytes()
        assert np.array_equal(port.kv.k_pages[:, 1].numpy(), k)
    elif spill == "":
        assert as_f32(port.kv.k_pages[:, 1]).tobytes() == as_f32(port.kv.k_pages[:, 2]).tobytes()


def test_disk_tier_serves_a_restore(tmp_path):
    """A host budget under one page pushes spills through the write-behind
    worker to disk; with the host tier emptied, a match is served from
    disk, with the streams of TPUEngine."""
    outs = []
    for engine in make_pair(tier_host_bytes=3000):
        engine.config.tier_disk_dir = ""

        async def main(engine=engine):
            await engine.start()
            try:
                prompts = pressure_prompts()
                out = [await gen(engine, ids) for ids in prompts]
                store = engine._tier_client.store
                # evict template A's chain the way pressure would
                probe = list(prompts[0][:33]) + [88]
                alloc = engine.allocator
                saved, alloc._free = alloc._free, []
                while alloc._walk_prefix(probe):
                    saved.append(alloc._take_page())
                alloc._free = saved
                assert all(store.probe(h) for h in chain_hashes(probe, PS))
                # every host entry through the write-behind path, landed
                with store._lock:
                    for key_hash in list(store._host):
                        page = store._host.pop(key_hash)
                        store._host_nbytes -= page.nbytes
                        store._pending[key_hash] = page
                        store._writeq.put(key_hash)
                store._ensure_writer()
                deadline = time.monotonic() + 20
                while ((store._pending or store.stats()["disk_pages"] < 1)
                       and time.monotonic() < deadline):
                    await asyncio.sleep(0.02)
                assert store.stats()["host_pages"] == 0
                reads = store.disk_reads
                out.append(await gen(engine, probe))
                assert store.disk_reads > reads
                return out, engine.allocator.tier_hit_tokens["disk"]
            finally:
                await engine.stop()

        outs.append(asyncio.run(main()))
    assert outs[1] == outs[0]
    assert outs[1][1] >= PS


def test_collision_is_a_miss_with_the_cold_stream():
    """A payload stored under a prompt's chain hash with another identity
    fails verification: a miss, the entry dropped, and the stream a cold
    admission gives, as TPUEngine's."""
    prompt = list(range(3, 68)) + [99]
    h0 = chain_hashes(prompt, PS)[0]
    ref, port = make_pair(num_pages=16)
    results = []
    for engine, cls in ((ref, JaxSpilledPage), (port, SpilledPage)):
        store = engine._tier_client.store
        k = np.ones((2, PS, 2, 16), np.float32)
        store.put(h0, cls(chunk=tuple(range(900, 916)), parent=ROOT_HASH, k=k, v=k,
                          k_scales=np.ones((2, 2), np.float32),
                          v_scales=np.ones((2, 2), np.float32)))
        out = serve(engine, [prompt])
        results.append((out, store.collisions, store.probe(h0), hit_split(engine)))
    assert results[1] == results[0]
    out, collisions, probed, (_, _, total) = results[1]
    assert collisions == 1 and probed is False and total == 0
    cold = TorchEngine(EngineConfig(**{**BASE, "num_pages": 16, "prefix_cache": False},
                                    device="cpu"), params=port.params)
    assert serve(cold, [prompt]) == out


def test_spill_prefix_pages_after_stop_and_a_new_engine_restores():
    """With a shared store and prefix index, ``spill_prefix_pages`` after
    ``stop()`` copies the resident prefix pages (as TPUEngine's does), and
    an engine built on the same store restores them on a miss."""
    prompts = pressure_prompts()[:2]
    jax_store, jax_index = JaxStore(host_bytes=1 << 24, pin=False), JaxIndex()
    port_store, port_index = TieredPageStore(host_bytes=1 << 24), PrefixIndex()
    config = {**BASE, "num_pages": 16, "prefix_tiers": True, "tier_spill_quant": ""}
    ref = TPUEngine(JaxConfig(**config, attn_impl="reference"), tier_store=jax_store,
                    prefix_index=jax_index)
    params = params_from_jax(jax.device_get(ref.params), MODEL_CONFIGS["llama3-test"],
                             device="cpu", dtype=torch.float32)
    port = TorchEngine(EngineConfig(**config, device="cpu"), params=params,
                       tier_store=port_store, prefix_index=port_index)
    try:
        assert serve(port, prompts) == serve(ref, prompts)
        assert port.spill_prefix_pages() == ref.spill_prefix_pages() == 4
        assert port_store.stats()["host_pages"] == jax_store.stats()["host_pages"] == 4
        assert port_index.stats() == jax_index.stats()
        fresh = TorchEngine(EngineConfig(**config, device="cpu", replica_id="1"), params=params,
                            tier_store=port_store, prefix_index=port_index)
        assert serve(fresh, [prompts[0]]) == serve(ref, [prompts[0]])
        assert fresh.allocator.tier_hit_tokens["host"] == 2 * PS
    finally:
        port_store.close()
        jax_store.close()


def test_crash_restart_drops_the_replica():
    """A crash restart resets the pool in place: the replica's resident
    pages leave the prefix index (TPUEngine's rebuilt pool does the same)
    and the hit counters and their export snapshot start again."""
    index = PrefixIndex()
    config = {**BASE, "num_pages": 16, "prefix_tiers": True, "tier_spill_quant": "",
              "auto_restart": True}
    port = TorchEngine(EngineConfig(**config, device="cpu"), prefix_index=index)
    prompts = pressure_prompts()[:2]

    async def main():
        await port.start()
        try:
            for ids in prompts:
                await gen(port, ids)
            published = index.stats()["keys_hbm"]
            plane = port_faults.configure_fault_plane(True)
            plane.arm(port_faults.FaultRule(point="engine.dispatch", kind="error",
                                            mode="once", scope="0"))
            port._wake.set()
            deadline = time.monotonic() + 30
            while port.stats.engine_restarts == 0 and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            return published
        finally:
            await port.stop()
            port_faults.configure_fault_plane(False)

    published = asyncio.run(main())
    assert published == 4 and port.stats.engine_restarts == 1
    assert index.stats()["keys_hbm"] == 0 and port._tier_hits_exported == {}
    assert port.allocator.tiers is port._tier_client
    jax_index = JaxIndex()
    ref = TPUEngine(JaxConfig(**config, attn_impl="reference"), prefix_index=jax_index)
    serve(ref, prompts)
    assert jax_index.stats()["keys_hbm"] == published
    ref._init_kv()
    assert jax_index.stats() == index.stats()


def test_tier_metrics_and_spans_equal_jax():
    """The tier families (hits by tier, bytes by tier, I/O latencies) and
    the tier.spill / tier.restore spans of requests with a trace context
    are the JAX engine's."""
    handles = [dict(tracer=Tracer(exporter="memory"), metrics=PrometheusRegistry())
               for _ in range(2)]
    config = {**BASE, "prefix_tiers": True, "tier_spill_quant": ""}
    ref = TPUEngine(JaxConfig(**config, attn_impl="reference"), **handles[0])
    params = params_from_jax(jax.device_get(ref.params), MODEL_CONFIGS["llama3-test"],
                             device="cpu", dtype=torch.float32)
    port = TorchEngine(EngineConfig(**config, device="cpu"), params=params, **handles[1])
    trace = ("ab" * 16, "cd" * 8)

    def run(engine, cls):
        async def main():
            await engine.start()
            try:
                for i, ids in enumerate(pressure_prompts()):
                    request = cls(request_id=f"r{i}", prompt_ids=ids, max_tokens=4,
                                  trace_ctx=trace)
                    await engine.submit(request)
                    while await asyncio.wait_for(request.stream.get(), 60) is not None:
                        pass
            finally:
                await engine.stop()

        asyncio.run(main())

    run(ref, JaxRequest)
    run(port, GenRequest)
    lines = []
    for h in handles:
        text = h["metrics"].render()[0].decode().splitlines()
        lines.append((sorted(line for line in text
                             if line.startswith(("mcpforge_llm_prefix_tier_hits_total",
                                                 "mcpforge_llm_prefix_tier_bytes"))),
                      sorted({line.split("{")[0].split(" ")[0] for line in text
                              if line.startswith("mcpforge_llm_prefix_tier")})))
    assert lines[1] == lines[0]
    assert any('tier="host"' in line for line in lines[1][0])
    spans = [sorted((s.name, s.attributes.get("tier.tier"), s.attributes.get("tier.tokens"))
                    for s in h["tracer"].finished if s.name.startswith("tier."))
             for h in handles]
    assert spans[1] == spans[0] and ("tier.restore", "host", PS) in spans[1]


def test_prefix_tiers_requires_prefix_cache():
    for engine_cls, config_cls, kwargs in ((TPUEngine, JaxConfig, {"attn_impl": "reference"}),
                                           (TorchEngine, EngineConfig, {"device": "cpu"})):
        with pytest.raises(ValueError, match="prefix_tiers requires"):
            engine_cls(config_cls(**{**BASE, "prefix_cache": False, "prefix_tiers": True},
                                  **kwargs))
        with pytest.raises(ValueError, match="tier_spill_quant"):
            engine_cls(config_cls(**{**BASE, "prefix_tiers": True, "tier_spill_quant": "fp8"},
                                  **kwargs))


def test_from_settings_reads_the_tier_settings(tmp_path):
    settings = load_settings(env={
        "MCPFORGE_TPU_LOCAL_PREFIX_TIERS": "true",
        "MCPFORGE_TPU_LOCAL_TIER_HOST_BYTES": "12345",
        "MCPFORGE_TPU_LOCAL_TIER_DISK_BYTES": "0",
        "MCPFORGE_TPU_LOCAL_TIER_DISK_DIR": str(tmp_path),
        "MCPFORGE_TPU_LOCAL_TIER_SPILL_QUANT": "",
        "MCPFORGE_TIER_IO_RETRY_MAX": "5",
        "MCPFORGE_TIER_IO_RETRY_BACKOFF_MS": "2.5",
        "MCPFORGE_TPU_LOCAL_TIER_OBJECT_URL": f"file://{tmp_path}/bucket",
        "MCPFORGE_TPU_LOCAL_FABRIC_NAMESPACE": "team-a",
    }, env_file=None)
    port, ref = EngineConfig.from_settings(settings), JaxConfig.from_settings(settings)
    names = ("prefix_tiers", "tier_host_bytes", "tier_disk_bytes", "tier_disk_dir",
             "tier_spill_quant", "tier_io_retry_max", "tier_io_retry_backoff_ms",
             "tier_object_url", "fabric_namespace")
    assert {n: getattr(port, n) for n in names} == {n: getattr(ref, n) for n in names}
    assert (port.prefix_tiers, port.tier_host_bytes, port.tier_spill_quant,
            port.tier_io_retry_max, port.fabric_namespace) == (True, 12345, "", 5, "team-a")
    engine = TorchEngine(dataclasses.replace(port, model="llama3-test", max_seq_len=128,
                                             page_size=PS, num_pages=8, prefill_buckets=(16, 64),
                                             dtype="float32", device="cpu"))
    store = engine._tier_client.store
    try:
        assert store.object_store.url == f"file://{tmp_path}/bucket"
        assert store.object_namespace == "team-a" and store.io_retry_max == 5
        assert store.host_budget == 12345 and store.disk_budget == 0
    finally:
        engine._close_owned_tiers()
