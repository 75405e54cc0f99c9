"""The port's paged KV cache against the JAX package's: the same writes give
the same page contents (f32, exactly), masked writes all land on page 0,
and the host-side PageAllocator makes the same decisions."""

import jax.numpy as jnp
import numpy as np
import torch

from mcp_context_forge_tpu.tpu_local.kv import paged_cache as jax_kv
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.kv import paged_cache as port_kv
from mcp_context_forge_tpu_torch.tpu_local.models import (
    MODEL_CONFIGS as PORT_CONFIGS,
)
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

CFG = "llama3-test"  # 2 layers, KV=2, hd=16
PAGE, NUM_PAGES, SLOTS, PER_SLOT = 4, 24, 3, 6


def _states():
    jax_alloc = jax_kv.PageAllocator(NUM_PAGES, PAGE, SLOTS, PER_SLOT)
    port_alloc = port_kv.PageAllocator(NUM_PAGES, PAGE, SLOTS, PER_SLOT)
    for alloc in (jax_alloc, port_alloc):
        assert alloc.allocate_slot(0, 10)
        assert alloc.allocate_slot(2, 15)
    jkv = jax_kv.init_kv_state(MODEL_CONFIGS[CFG], NUM_PAGES, PAGE, SLOTS,
                               PER_SLOT, dtype=jnp.float32)
    jkv = jkv._replace(block_tables=jax_alloc.tables())
    pkv = port_kv.init_kv_state(PORT_CONFIGS[CFG], NUM_PAGES, PAGE, SLOTS,
                                PER_SLOT, dtype=torch.float32, device="cpu")
    pkv.block_tables.copy_(port_alloc.tables())
    return jkv, pkv


def test_writes_match_jax_exactly():
    rng = np.random.default_rng(0)
    KV, hd = 2, 16
    jkv, pkv = _states()
    np.testing.assert_array_equal(np.asarray(jkv.block_tables),
                                  pkv.block_tables.numpy())
    # prefill: rows for slots 2 and 0, with trailing padding on slot 0
    slot_ids = np.array([2, 0], dtype=np.int32)
    S = 8
    positions = np.stack([np.arange(S), np.arange(S)]).astype(np.int32)
    valid = np.ones((2, S), dtype=bool)
    valid[1, 6:] = False
    safe = np.where(valid, positions, 0).astype(np.int32)
    for layer in range(2):
        k = rng.standard_normal((2, S, KV, hd), dtype=np.float32)
        v = rng.standard_normal((2, S, KV, hd), dtype=np.float32)
        jkv = jax_kv.write_prefill_kv(jkv, layer, k, v, slot_ids, safe, valid)
        port_kv.write_prefill_kv(pkv, layer, torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(slot_ids),
                                 torch.from_numpy(safe),
                                 torch.from_numpy(valid))
    # decode: slot 1 is allocated to no request and masked out
    for step in range(3):
        slots = np.array([0, 1, 2], dtype=np.int32)
        pos = np.array([6 + step, 0, 8 + step], dtype=np.int32)
        mask = np.array([True, False, True])
        for layer in range(2):
            k = rng.standard_normal((3, KV, hd), dtype=np.float32)
            v = rng.standard_normal((3, KV, hd), dtype=np.float32)
            jkv = jax_kv.write_decode_kv(jkv, layer, k, v, slots, pos,
                                         valid=mask)
            port_kv.write_decode_kv(pkv, layer, torch.from_numpy(k),
                                    torch.from_numpy(v),
                                    torch.from_numpy(slots),
                                    torch.from_numpy(pos),
                                    valid=torch.from_numpy(mask))
    for jpages, ppages in ((jkv.k_pages, pkv.k_pages),
                           (jkv.v_pages, pkv.v_pages)):
        jpages, ppages = np.asarray(jpages), ppages.numpy()
        np.testing.assert_array_equal(ppages[:, 1:], jpages[:, 1:])
        # every masked write went to page 0, offset 0, and nowhere else
        assert np.any(ppages[:, 0, 0] != 0)
        assert not np.any(ppages[:, 0, 1:])
        touched = np.flatnonzero(np.abs(ppages).sum(axis=(0, 2, 3, 4)))
        owned = set(pkv.block_tables.numpy()[[0, 2]].ravel()) | {0}
        assert set(touched.tolist()) <= owned
    for slot in (0, 2):
        jk, jv = jax_kv.gather_kv(jkv, 1, jnp.asarray([slot]))
        pk, pv = port_kv.gather_kv(pkv, 1, torch.tensor([slot]))
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_allocator_matches_jax():
    """One sequence of allocator operations, both allocators: the same
    tables, match results, refcount outcomes and eviction choices."""
    allocs = [cls(12, 4, 3, 5) for cls in (jax_kv.PageAllocator,
                                          port_kv.PageAllocator)]
    prompt_a = list(range(100, 113))          # 3 full pages + 1 token
    prompt_b = prompt_a[:8] + [7, 7, 7, 7, 7]  # shares 2 pages
    trace = []

    def both(fn):
        results = [fn(a) for a in allocs]
        trace.append(results)
        assert results[0] == results[1], (len(trace), results)

    def tables(a):
        return np.asarray(a.tables()).tolist()

    both(lambda a: a.allocate_slot(0, len(prompt_a) + 3))
    both(lambda a: a.register_prefix(0, prompt_a))
    both(tables)
    both(lambda a: a.probe_prefix(prompt_b))
    both(lambda a: a.match_prefix(prompt_b))
    both(lambda a: a.allocate_slot(1, len(prompt_b) + 2,
                                   prefix_pages=a._walk_prefix(prompt_b)))
    both(lambda a: (a.prefix_hits, a.prefix_hit_tokens, a.free_pages))
    both(tables)
    both(lambda a: a.grow_slot(1, 20))
    both(lambda a: a.dirty)
    both(tables)
    both(lambda a: a.free_slot(0))
    both(lambda a: (a.free_pages, a.pages_in_use, a.cached_pages))
    both(lambda a: a.allocate_slot(2, 16))      # may evict cached pages
    both(lambda a: a.match_prefix(prompt_a))
    both(lambda a: a.release_prefix(a._walk_prefix(prompt_a)))
    both(lambda a: a.free_slot(1))
    both(lambda a: a.free_slot(2))
    both(tables)
    both(lambda a: (a.free_pages, a.pages_in_use, a.peak_pages_in_use,
                    a._lru.victim(), len(a._lru)))
    both(lambda a: a.allocate_slot(0, 40))      # over max_pages_per_slot


def test_page_budget_matches_jax():
    for name in ("llama3-8b", "gemma-test", "qwen2-tiny"):
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            assert port_kv.kv_page_bytes(PORT_CONFIGS[name], 128, tdt) == \
                jax_kv.kv_page_bytes(MODEL_CONFIGS[name], 128, jdt)
            for budget in (0, 10**6, 8 * 2**30):
                assert port_kv.num_pages_for_budget(
                    PORT_CONFIGS[name], 128, budget, tdt) == \
                    jax_kv.num_pages_for_budget(MODEL_CONFIGS[name], 128,
                                                budget, jdt)
