"""The spill tiers and the chain export over a multi-rank engine
(``TorchEngine(EngineConfig(mesh_shape=..., device="cpu"))``, one gloo
rank per process): a page's spill gathers its KV-head shards to rank 0 and
a restore sends each rank its heads, so the shared store holds whole
pages, the same bytes at any mesh.

- against the JAX ``TPUEngine`` at 1x2 on the virtual CPU devices: the
  greedy streams of prompts whose prefixes are evicted (spilled) and
  restored, f32 with the lossless spill, token for token, and the tier
  hit split; then a crash restart over the ranks, after which the engine
  serves the same stream again;
- against the port's one-device engine: payloads bit for bit at 1x2 and
  2x1, for f32 and int8 pools and for lossless and int8 spills; a page
  exported at 1x2 (``request_chain_export``) restored on one device, and
  one spilled on one device (``spill_prefix_pages``) restored at 1x2;
  Gemma's replicated pool (one KV head) at 1x2.

Every test here holds its engines in this process beside the JAX ones, and
none touches ``torch.distributed``'s default group.
"""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.observability import faults as port_faults
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.kv import PrefixIndex, TieredPageStore
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params
from test_torch_tp_serving import SHAPE
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

PS = SHAPE["page_size"]
# a pool too small to keep two templates of two full pages resident
TIERS = {**SHAPE, "num_pages": 5, "prefix_cache": True, "prefix_tiers": True,
         "tier_spill_quant": ""}
TEMPLATES = [list(range(3 + 97 * g, 36 + 97 * g)) for g in range(2)]
PRESSURE = ([t + [40 + 10 * r + g] for r in range(2) for g, t in enumerate(TEMPLATES)]
            + [TEMPLATES[0] + [77]])
FIELDS = ("k", "v", "k_scales", "v_scales")


async def gen(engine, ids, n=6):
    return [t async for t in engine.generate(ids, max_tokens=n)]


def serve(engine, prompts, n=6):
    async def main():
        await engine.start()
        try:
            return [await gen(engine, ids, n) for ids in prompts]
        finally:
            await engine.stop()
    return asyncio.run(main())


def hit_split(engine):
    alloc = engine.allocator
    return dict(alloc.tier_hits), dict(alloc.tier_hit_tokens), alloc.prefix_hit_tokens


@pytest.fixture(scope="module")
def pressure():
    """The JAX 1x2 engine's streams and hit split over the eviction
    prompts; the port's 1x2 engine on its weights over the same prompts,
    then a crash restart (an ``engine.dispatch`` error under
    ``auto_restart``) and the last prompt again."""
    ref = TPUEngine(JaxConfig(**TIERS, mesh_shape="1x2", attn_impl="reference"),
                    devices=jax.devices()[:2])
    params = params_from_jax(jax.device_get(ref.params), MODEL_CONFIGS["llama3-test"],
                             device="cpu", dtype=torch.float32)
    want = serve(ref, PRESSURE)
    want_hits = hit_split(ref)
    port = TorchEngine(EngineConfig(**TIERS, mesh_shape="1x2", auto_restart=True,
                                    device="cpu"), params=params)

    async def main():
        await port.start()
        try:
            got = [await gen(port, ids) for ids in PRESSURE]
            hits, stats = hit_split(port), port.tier_stats()
            plane = port_faults.configure_fault_plane(True)
            plane.arm(port_faults.FaultRule(point="engine.dispatch", kind="error",
                                            mode="once", scope="0"))
            port._wake.set()
            deadline = time.monotonic() + 30
            while port.stats.engine_restarts == 0 and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            port_faults.configure_fault_plane(False)
            again = await gen(port, PRESSURE[-1])
            return got, hits, stats, again
        finally:
            await port.stop()
            port_faults.configure_fault_plane(False)

    got, hits, stats, again = asyncio.run(main())
    return dict(params=params, want=want, want_hits=want_hits, got=got, hits=hits,
                stats=stats, again=again, port=port)


def test_eviction_restore_streams_equal_jax_at_1x2(pressure):
    assert pressure["got"] == pressure["want"]
    assert pressure["hits"] == pressure["want_hits"]
    hits, tokens, total = pressure["hits"]
    assert tokens["host"] >= 2 * PS and sum(tokens.values()) == total
    stats = pressure["stats"]
    assert stats["spills"] >= 1 and stats["restores"] >= 1
    assert pressure["port"].world == 2 and not dist.is_initialized()


def test_crash_restart_over_ranks_serves_again(pressure):
    """The restart zeroes every rank's pool in place (``_op_reset``) with
    the tiers bound; the engine then serves the last prompt's stream again,
    and every rank wrote the same tokens throughout."""
    port = pressure["port"]
    assert port.stats.engine_restarts == 1
    assert pressure["again"] == pressure["got"][-1]
    assert port.allocator.tiers is port._tier_client
    assert port.rank_digests is not None and len(set(port.rank_digests)) == 1


# ------------------------------------------- against the one-device engine

def _payloads(kv_quant: str, spill: str) -> list:
    """Real pages' payloads from a one-device engine that served two
    prompts: the source every engine below uploads."""
    engine = TorchEngine(EngineConfig(**{**TIERS, "num_pages": 16, "kv_quant": kv_quant,
                                         "tier_spill_quant": spill}, device="cpu"),
                         params=_weights("llama3-test"))
    serve(engine, [TEMPLATES[0] + [40], TEMPLATES[1] + [41]])
    return [engine._read_page_payload(p) for p in range(1, 5)]


_WEIGHTS: dict = {}


def _weights(model: str) -> dict:
    if model not in _WEIGHTS:
        _WEIGHTS[model] = init_params(MODEL_CONFIGS[model], torch.Generator().manual_seed(7),
                                      torch.float32, "cpu")
    return _WEIGHTS[model]


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
@pytest.mark.parametrize("kv_quant,spill", [("", ""), ("", "int8"), ("int8", "")])
def test_payload_bit_for_bit(mesh, kv_quant, spill):
    """A payload uploaded into a multi-rank engine and read back equals the
    one-device engine's after the same upload, bit for bit (and, but for an
    int8 spill's requantization, the payload itself): the shards'
    per-(layer, KV head) scales are the whole page's columns, and an int8
    pool's bytes and scales cross verbatim."""
    config = {**TIERS, "num_pages": 16, "kv_quant": kv_quant, "tier_spill_quant": spill,
              "device": "cpu"}
    one = TorchEngine(EngineConfig(**config), params=_weights("llama3-test"))
    ranked = TorchEngine(EngineConfig(**config, mesh_shape=mesh),
                         params=_weights("llama3-test"))
    try:
        for i, payload in enumerate(_payloads(kv_quant, spill)):
            one._upload_page(8 + i, payload)
            ranked._upload_page(8 + i, payload)
            a, b = one._read_page_payload(8 + i), ranked._read_page_payload(8 + i)
            for name in FIELDS:
                assert getattr(a, name).dtype == getattr(b, name).dtype
                assert np.array_equal(getattr(a, name), getattr(b, name)), name
                if not spill:   # a re-spill's scales round again: only one's equal
                    assert np.array_equal(getattr(b, name), getattr(payload, name)), name
    finally:
        ranked.close_ranks()
    assert not dist.is_initialized()


def _shared():
    index = PrefixIndex()
    store = TieredPageStore(host_bytes=64 << 20, disk_bytes=0, index=index)
    return store, index


def test_chain_exported_at_1x2_restores_on_one_device():
    """``request_chain_export`` at 1x2 fills a shared store; a one-device
    engine on the store restores the chain and gives the stream a cold
    one-device engine gives."""
    store, index = _shared()
    params = _weights("llama3-test")
    prompt = TEMPLATES[0] + [40]
    ranked = TorchEngine(EngineConfig(**TIERS, mesh_shape="1x2", replica_id="a", device="cpu"),
                         params=params, tier_store=store, prefix_index=index)

    async def export():
        await ranked.start()
        try:
            await gen(ranked, prompt)
            return await asyncio.wrap_future(ranked.request_chain_export(prompt))
        finally:
            await ranked.stop()

    assert asyncio.run(export()) == len(prompt) // PS
    one = TorchEngine(EngineConfig(**TIERS, replica_id="b", device="cpu"), params=params,
                      tier_store=store, prefix_index=index)
    cold = TorchEngine(EngineConfig(**{**TIERS, "prefix_tiers": False}, device="cpu"),
                       params=params)
    follow = TEMPLATES[0] + [41]
    assert serve(one, [follow], n=10) == serve(cold, [follow], n=10)
    assert one.allocator.tier_hit_tokens["host"] == 2 * PS
    store.close()


def test_page_spilled_on_one_device_restores_at_1x2():
    """The other way round: ``spill_prefix_pages`` of a one-device engine,
    restored into a 1x2 engine (each rank its heads), whose stream equals
    the cold one-device stream."""
    store, index = _shared()
    params = _weights("llama3-test")
    one = TorchEngine(EngineConfig(**TIERS, replica_id="a", device="cpu"), params=params,
                      tier_store=store, prefix_index=index)
    serve(one, [TEMPLATES[1] + [40]])
    assert one.spill_prefix_pages() >= 2
    ranked = TorchEngine(EngineConfig(**TIERS, mesh_shape="1x2", replica_id="b", device="cpu"),
                         params=params, tier_store=store, prefix_index=index)
    cold = TorchEngine(EngineConfig(**{**TIERS, "prefix_tiers": False}, device="cpu"),
                       params=params)
    follow = TEMPLATES[1] + [41]
    assert serve(ranked, [follow], n=10) == serve(cold, [follow], n=10)
    assert ranked.allocator.tier_hit_tokens["host"] == 2 * PS
    store.close()


def test_gemma_replicated_pool_at_1x2():
    """One KV head: every rank's pool holds the whole page. Rank 0 reads
    alone and every rank writes the whole page; payloads round-trip bit for
    bit, and the eviction prompts' streams equal the one-device engine's."""
    config = dict(**{**TIERS, "model": "gemma-test"}, device="cpu")
    params = _weights("gemma-test")
    one = TorchEngine(EngineConfig(**config), params=params)
    ranked = TorchEngine(EngineConfig(**config, mesh_shape="1x2"), params=params)
    assert ranked.kv.k_pages.shape[3] == 1 and not ranked._kv_sharded
    want = serve(one, PRESSURE)
    ranked_out = None
    try:
        for page in (1, 2):
            payload = one._read_page_payload(page)
            ranked._upload_page(page, payload)
            back = ranked._read_page_payload(page)
            for name in FIELDS:
                assert np.array_equal(getattr(back, name), getattr(payload, name)), name
        ranked_out = serve(ranked, PRESSURE)
    finally:
        ranked.close_ranks()
    assert ranked_out == want
    assert ranked.allocator.tier_hit_tokens["host"] >= 2 * PS
