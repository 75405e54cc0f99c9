"""Int8 KV pages in the port against the JAX package, on the CPU in f32.

The JAX writers are the golden values of the port's storage: the same
sequence of ``write_prefill_kv``/``write_decode_kv`` calls must leave the
same int8 pages and the same scales. Both sides divide in f32 by the same
f32 scale and round half to even, so no division tie can split them: the
storage tests allow NO differing element. Page 0 (the trash page) is left
out: masked rows write there with duplicate indices, whose order neither
package defines.

The round-trip test states the bound the algorithm has: a value stored
under n successive scales of its page (each growth of the running max
requantizes it) is off by at most n half-steps of the last one.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local import quantize as jax_quant
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu.tpu_local.kv import paged_cache as jax_kv
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local import quantize as port_quant
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.kv import paged_cache as port_kv
from mcp_context_forge_tpu_torch.tpu_local.models import (
    MODEL_CONFIGS as PORT_CONFIGS,
)
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax

CFG = "llama3-test"  # 2 layers, KV=2, hd=16
PAGE, NUM_PAGES, SLOTS, PER_SLOT = 8, 24, 3, 6


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_kv_primitives_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 2, 16)).astype(np.float32) * 3
    amax = np.abs(x).max(axis=-1)
    # exact half-step ties: x / s lands on k + 0.5 (round half to even)
    x[0, 0] = (np.arange(16) - 7.5) * (amax[0, 0] / 127.0)
    amax = np.abs(x).max(axis=-1)
    js = np.asarray(jax_quant.kv_int8_scale(jnp.asarray(amax)))
    ps = port_quant.kv_int8_scale(torch.from_numpy(amax)).numpy()
    np.testing.assert_array_equal(ps, js)
    for scale in (js, np.zeros_like(js)):      # zero scales hit the floor
        jq = np.asarray(jax_quant.kv_quantize(x, scale[..., None]))
        pq = port_quant.kv_quantize(*_t(x, scale[..., None])).numpy()
        np.testing.assert_array_equal(pq, jq)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jd = np.asarray(jax_quant.kv_dequantize(jq, js[..., None], jdt)
                        .astype(jnp.float32))
        pd = port_quant.kv_dequantize(*_t(jq, js[..., None]), tdt).float()
        np.testing.assert_array_equal(pd.numpy(), jd)


class _Pair:
    """The same int8 pool in both packages, written through the same calls."""

    def __init__(self, seq_lens):
        self.allocs = [jax_kv.PageAllocator(NUM_PAGES, PAGE, SLOTS, PER_SLOT),
                       port_kv.PageAllocator(NUM_PAGES, PAGE, SLOTS, PER_SLOT)]
        for slot, n in enumerate(seq_lens):
            assert all(a.allocate_slot(slot, n) for a in self.allocs)
        self.jkv = jax_kv.init_kv_state(
            MODEL_CONFIGS[CFG], NUM_PAGES, PAGE, SLOTS, PER_SLOT,
            dtype=jnp.float32, quant="int8")
        self.pkv = port_kv.init_kv_state(
            PORT_CONFIGS[CFG], NUM_PAGES, PAGE, SLOTS, PER_SLOT,
            dtype=torch.float32, device="cpu", quant="int8")
        self.sync_tables()

    def sync_tables(self):
        self.jkv = self.jkv._replace(block_tables=self.allocs[0].tables())
        self.pkv.block_tables.copy_(self.allocs[1].tables())

    def prefill(self, layer, k, v, slots, positions, valid):
        safe = np.where(valid, positions, 0).astype(np.int32)
        self.jkv = jax_kv.write_prefill_kv(self.jkv, layer, k, v, slots, safe,
                                           valid)
        port_kv.write_prefill_kv(self.pkv, layer, *_t(k, v, slots, safe, valid))

    def decode(self, layer, k, v, slots, positions, valid):
        self.jkv = jax_kv.write_decode_kv(self.jkv, layer, k, v, slots,
                                          positions, valid=valid)
        port_kv.write_decode_kv(self.pkv, layer, *_t(k, v, slots, positions),
                                valid=torch.from_numpy(valid))

    def assert_equal(self):
        for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
            want = np.asarray(getattr(self.jkv, name))[:, 1:]
            got = getattr(self.pkv, name).numpy()[:, 1:]
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_int8_storage_matches_jax():
    """Prefill with a padded row, decode appends whose magnitude grows (the
    page scale grows and resident values requantize) beside a masked row,
    a suffix prefill that starts mid-page, and a freed page reused from
    offset 0 with tiny values (its scale resets)."""
    rng = np.random.default_rng(1)
    pair = _Pair([30, 20])
    S = 12
    positions = np.tile(np.arange(S, dtype=np.int32), (2, 1))
    valid = np.ones((2, S), dtype=bool)
    valid[1, 7:] = False
    slots = np.array([0, 1], dtype=np.int32)
    for layer in range(2):
        k = rng.standard_normal((2, S, 2, 16), dtype=np.float32)
        pair.prefill(layer, k, -2 * k, slots, positions, valid)
    pair.assert_equal()
    for step in range(10):
        pos = np.array([12 + step, 7 + step, 0], dtype=np.int32)
        mask = np.array([True, True, False])      # slot 2 holds no pages
        for layer in range(2):
            k = rng.standard_normal((3, 2, 16), dtype=np.float32) * (1 + step)
            v = rng.standard_normal((3, 2, 16), dtype=np.float32)
            pair.decode(layer, k, v, np.arange(3, dtype=np.int32), pos, mask)
    pair.assert_equal()
    scales = pair.pkv.k_scales.numpy()
    assert not np.any(scales[:, 1:][:, ~np.isin(np.arange(1, NUM_PAGES),
                                                pair.pkv.block_tables.numpy())])
    positions = np.arange(22, 30, dtype=np.int32)[None]
    for layer in range(2):
        k = rng.standard_normal((1, 8, 2, 16), dtype=np.float32) * 5
        pair.prefill(layer, k, k, np.array([0], np.int32), positions,
                     np.ones((1, 8), dtype=bool))
    pair.assert_equal()
    # slot 1's pages go back to the free list; slot 2 takes them again
    reused = pair.pkv.block_tables.numpy()[1, 0]
    for alloc in pair.allocs:
        alloc.free_slot(1)
        assert alloc.allocate_slot(2, 9)
    pair.sync_tables()
    assert pair.pkv.block_tables.numpy()[2, 0] == reused
    before = float(pair.pkv.k_scales[0, reused].max())
    for layer in range(2):
        tiny = np.full((1, 2, 16), 0.01, dtype=np.float32)
        pair.decode(layer, tiny, tiny, np.array([2], np.int32),
                    np.array([0], np.int32), np.array([True]))
    pair.assert_equal()
    assert before > 10 * 0.01 / 127
    assert float(pair.pkv.k_scales[0, reused].max()) <= 0.01 / 127 * 1.001
    for slot in (0, 2):
        jk, jv = jax_kv.gather_kv(pair.jkv, 1, jnp.asarray([slot]))
        pk, pv = port_kv.gather_kv(pair.pkv, 1, torch.tensor([slot]))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_prefill_and_decode_writers_set_the_same_scales():
    """One [1, S] prefill scatter and S one-token decode writes of the same
    values: the running max is order-free, so both writers land the same
    scales, in both packages; the pages equal JAX's writer for writer."""
    rng = np.random.default_rng(2)
    S = 11
    k = rng.standard_normal((1, S, 2, 16), dtype=np.float32)
    one_shot, appended = _Pair([S]), _Pair([S])
    for layer in range(2):
        one_shot.prefill(layer, k, -k, np.array([0], np.int32),
                         np.arange(S, dtype=np.int32)[None],
                         np.ones((1, S), dtype=bool))
        for pos in range(S):
            appended.decode(layer, k[:, pos], -k[:, pos],
                            np.array([0], np.int32),
                            np.array([pos], np.int32), np.array([True]))
    one_shot.assert_equal()
    appended.assert_equal()
    np.testing.assert_array_equal(one_shot.pkv.k_scales.numpy(),
                                  appended.pkv.k_scales.numpy())
    np.testing.assert_array_equal(one_shot.pkv.v_scales.numpy(),
                                  appended.pkv.v_scales.numpy())


def test_masked_rows_only_touch_the_trash_page():
    pair = _Pair([8])
    before = [t.clone() for t in (pair.pkv.k_pages, pair.pkv.k_scales)]
    big = np.full((2, 2, 16), 100.0, dtype=np.float32)
    pair.decode(0, big, big, np.array([0, 0], np.int32),
                np.array([5, 3], np.int32), np.array([False, False]))
    pair.prefill(1, big[None], big[None], np.array([0], np.int32),
                 np.array([[4, 5]], np.int32), np.zeros((1, 2), dtype=bool))
    pair.assert_equal()
    for old, new in zip(before, (pair.pkv.k_pages, pair.pkv.k_scales)):
        assert torch.equal(old[:, 1:], new[:, 1:])
    assert pair.pkv.k_pages[:, 0].abs().sum() > 0   # they did land on page 0


def test_int8_page_budget_matches_jax():
    for name in ("llama3-8b", "llama3-test", "gemma-test", "qwen2-tiny"):
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            assert port_kv.kv_page_bytes(PORT_CONFIGS[name], 128, tdt, "int8") \
                == jax_kv.kv_page_bytes(MODEL_CONFIGS[name], 128, jdt, "int8")
            budget = 512 * port_kv.kv_page_bytes(PORT_CONFIGS[name], 128, tdt)
            assert port_kv.num_pages_for_budget(
                PORT_CONFIGS[name], 128, budget, tdt, "int8") == \
                jax_kv.num_pages_for_budget(MODEL_CONFIGS[name], 128, budget,
                                            jdt, "int8")
    # the serving pool of the long-context path: 512 bf16 pages of budget
    cfg = PORT_CONFIGS["llama3-8b"]
    assert port_kv.kv_page_bytes(cfg, 128, torch.bfloat16, "int8") == 8_389_632
    assert port_kv.num_pages_for_budget(
        cfg, 128, 512 * port_kv.kv_page_bytes(cfg, 128), torch.bfloat16,
        "int8") == 1023
    with pytest.raises(ValueError, match="int4"):
        port_kv.kv_page_bytes(cfg, 128, quant="int4")


def test_roundtrip_error_counts_requantization_hops():
    """The JAX reference's round-trip data (``_filled_pair``: seq_lens 13,
    5, 20 on pages of 8, one jax.random key split per token), written into
    the port's pool. Each value is within (number of scales it lived under)
    half-steps of its page's final scale; the one-hop bound of the JAX test
    (1.01 x the scale) does NOT hold on this data."""
    cfg = PORT_CONFIGS[CFG]
    seq_lens = [13, 5, 20]
    kv = port_kv.init_kv_state(cfg, 32, PAGE, 3, 8, dtype=torch.float32,
                               device="cpu", quant="int8")
    alloc = port_kv.PageAllocator(32, PAGE, 3, 8)
    for slot, n in enumerate(seq_lens):
        assert alloc.allocate_slot(slot, n)
    kv.block_tables.copy_(alloc.tables())
    tables = kv.block_tables.numpy()
    key = jax.random.PRNGKey(0)
    originals, hops = {}, {}
    for slot, n in enumerate(seq_lens):
        for pos in range(n):
            key, k1, k2 = jax.random.split(key, 3)
            kt = np.asarray(jax.random.normal(k1, (1, 2, 16), jnp.float32))
            vt = np.asarray(jax.random.normal(k2, (1, 2, 16), jnp.float32))
            page = tables[slot, pos // PAGE]
            before = kv.k_scales[0, page].clone()
            port_kv.write_decode_kv(kv, 0, *_t(kt, vt, [slot], [pos]))
            grew = (kv.k_scales[0, page] > before).numpy()
            for earlier in range(pos - pos % PAGE, pos):
                hops[(slot, earlier)] += grew
            originals[(slot, pos)] = kt[0]
            hops[(slot, pos)] = np.ones(2, dtype=np.int64)
    keys, _ = port_kv.gather_kv(kv, 0, torch.arange(3))
    scales = kv.k_scales[0].numpy()
    worst = 0.0
    for (slot, pos), want in originals.items():
        scale = scales[tables[slot, pos // PAGE]][:, None]
        err = np.abs(keys[slot, pos].numpy() - want)
        assert (err <= hops[(slot, pos)][:, None] * scale / 2 * (1 + 1e-5)
                + 1e-7).all(), (slot, pos)
        worst = max(worst, float((err / scale).max()))
    assert max(int(h.max()) for h in hops.values()) >= 3
    assert 1.01 < worst <= 1.6, worst


# ------------------------------------------------------------------ engine

SHAPE = dict(model="llama3-test", max_batch=4, max_seq_len=128, page_size=8,
             num_pages=64, prefill_buckets=(16, 64), dtype="float32",
             prefix_cache=True, kv_quant="int8")


def test_engine_int8_kv_streams_match_jax():
    """TPUEngine(kv_quant="int8") and TorchEngine(kv_quant="int8") on the
    same weights: the same pool size and the same greedy streams over cold
    prefills, a prefix-cache hit read from int8 pages, and decode."""
    ref = TPUEngine(JaxConfig(**SHAPE, attn_impl="reference"))
    port = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=params_from_jax(
        jax.device_get(ref.params), PORT_CONFIGS[CFG], device="cpu",
        dtype=torch.float32))
    assert port.num_kv_pages == ref.num_kv_pages == 248
    assert port.allocator.num_pages == port.kv.k_pages.shape[1] == 248
    assert port.kv.k_pages.dtype == torch.int8

    async def workload(engine):
        tok = engine.tokenizer
        system = tok.encode("You are a careful assistant. Answer briefly.")
        await engine.start()
        try:
            first = [t async for t in engine.generate(
                system + tok.encode(" Hi"), max_tokens=6)]
            jobs = [engine.generate(system + tok.encode(" MCP?"), max_tokens=9),
                    engine.generate(tok.encode("alpha bravo"), max_tokens=12),
                    engine.generate(tok.encode("a longer prompt about tools "
                                               "and servers"), max_tokens=10)]

            async def drain(gen):
                return [t async for t in gen]

            rest = await asyncio.wait_for(asyncio.gather(*map(drain, jobs)), 300)
        finally:
            await engine.stop()
        return [first, *rest], engine.allocator.prefix_hits

    ref_out, ref_hits = asyncio.run(workload(ref))
    port_out, port_hits = asyncio.run(workload(port))
    assert port_out == ref_out
    assert [len(o) for o in port_out] == [6, 9, 12, 10]
    assert ref_hits >= 1 and port_hits == ref_hits
