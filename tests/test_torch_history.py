"""Suffix prefill over cached history when S spans more than one query tile.

On the card ``prefill_with_history`` hands all S queries of a layer to one
chunk-kernel call; the plain path on the CPU keeps the JAX package's query
tiles (``_history_tile``). These tests hold both against the reference on
the same seeded numpy inputs, in f32 on the CPU:

- the port's CPU ``prefill_with_history`` against the JAX function with its
  Pallas chunk kernel (``paged_chunk_attention_pallas`` in interpret mode,
  as the JAX package's own tests run it), at a geometry (G = 16) where
  S = 256 spans two tiles of 128 queries;
- the plain chunk version called once over all S against the same function
  called tile by tile, on f32 and int8 pages.

Tolerance: atol = 1e-4 on the logits (both sides in f32; the summation
orders differ), 1e-6 between one call and its tiles (the same sums, only
batched differently).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.kv import PageAllocator as JaxAllocator
from mcp_context_forge_tpu.tpu_local.kv import init_kv_state as jax_init_kv
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu.tpu_local.models import llama as jax_llama
from mcp_context_forge_tpu.tpu_local.ops import paged_attention as jax_paged
from mcp_context_forge_tpu_torch.tpu_local.kv import init_kv_state
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS as PORT
from mcp_context_forge_tpu_torch.tpu_local.models import llama
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as port_paged

ATOL = 1e-4
PAGE, NUM_PAGES, SLOTS, PER_SLOT = 8, 80, 2, 40
HIST, S = 40, 256


def _wide_group(configs):
    """llama3-test with 16 query heads on one KV head (hd 16): the history
    tile is 2048 / 16 = 128 queries, so S = 256 spans two."""
    return dataclasses.replace(configs["llama3-test"], name="llama3-test-g16",
                               n_heads=16, n_kv_heads=1, head_dim_override=16)


def test_history_prefill_matches_pallas_across_query_tiles(monkeypatch):
    jcfg, pcfg = _wide_group(MODEL_CONFIGS), _wide_group(PORT)
    assert llama._history_tile(S, 16) == S // 2
    tree = jax.device_get(jax_llama.init_params(jcfg, jax.random.PRNGKey(0),
                                                dtype=jnp.float32))
    params = params_from_jax(tree, pcfg, device="cpu", dtype=torch.float32)
    alloc = JaxAllocator(NUM_PAGES, PAGE, SLOTS, PER_SLOT)
    assert alloc.allocate_slot(0, HIST + S) and alloc.allocate_slot(1, HIST + S)
    tables = np.asarray(alloc.tables())
    jkv = jax_init_kv(jcfg, NUM_PAGES, PAGE, SLOTS, PER_SLOT,
                      dtype=jnp.float32)._replace(block_tables=jnp.asarray(tables))
    pkv = init_kv_state(pcfg, NUM_PAGES, PAGE, SLOTS, PER_SLOT,
                        dtype=torch.float32, device="cpu")
    pkv.block_tables.copy_(torch.tensor(tables))
    T = lambda a: torch.tensor(np.asarray(a))

    rng = np.random.default_rng(7)
    slots = np.array([0, 1], dtype=np.int32)
    prompt = rng.integers(0, jcfg.vocab_size, (2, HIST)).astype(np.int32)
    ppos = np.tile(np.arange(HIST, dtype=np.int32), (2, 1))
    _, jkv = jax_llama.prefill(tree, jcfg, prompt, ppos, jkv, slots,
                               attn_impl="reference")
    _, pkv = llama.prefill(params, pcfg, T(prompt), T(ppos), pkv, T(slots))

    # the suffix: row 0 fills both tiles, row 1 ends inside the second
    tokens = rng.integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    pos = np.tile(np.arange(HIST, HIST + S, dtype=np.int32), (2, 1))
    pos[1, 200:] = -1
    traced = []
    pallas = functools.partial(jax_paged.paged_chunk_attention_pallas,
                               interpret=True)

    def interpreted(q, *args, **kwargs):
        traced.append(q.shape[1])
        return pallas(q, *args, **kwargs)

    monkeypatch.setattr(jax_llama, "_use_pallas_paged", lambda config, kv: True)
    monkeypatch.setattr(jax_paged, "paged_chunk_attention_pallas", interpreted)
    history = jax.jit(jax_llama.prefill_with_history, static_argnums=(1,))
    jl, jkv = history(tree, jcfg, tokens, pos, jkv, slots)
    assert traced == [S // 2] * 2 * jcfg.n_layers   # two query tiles per layer
    pl_, pkv = llama.prefill_with_history(params, pcfg, T(tokens), T(pos), pkv,
                                          T(slots))
    valid = pos >= 0
    np.testing.assert_allclose(pl_[T(valid)].numpy(), np.asarray(jl)[valid],
                               atol=ATOL, rtol=0)
    for table_pages in tables[:2]:
        table_pages = table_pages[table_pages > 0]   # page 0 is the trash page
        for jp, pp in ((jkv.k_pages, pkv.k_pages), (jkv.v_pages, pkv.v_pages)):
            np.testing.assert_allclose(pp[:, T(table_pages).long()].numpy(),
                                       np.asarray(jp)[:, table_pages],
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant", ["", "int8"])
@pytest.mark.parametrize("G", [4, 16])
def test_one_chunk_call_equals_its_query_tiles(quant, G):
    """The plain chunk version over all S queries of a layer (the card's one
    call) equals the same version over ``_history_tile`` query tiles (the
    JAX package's calls)."""
    rng = np.random.default_rng(8)
    B, KV, hd, page = 2, 2, 16, 8
    S_ = 2 * llama._history_tile(4096, G)
    P = -(-(HIST + S_) // page)
    tables = torch.from_numpy((1 + rng.permutation(B * P)).reshape(B, P)
                              .astype(np.int32))
    shape = (B * P + 1, page, KV, hd)
    if quant:
        kp, vp = (torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
                  for _ in range(2))
        scales = [torch.from_numpy(rng.uniform(0.2, 2.0, (B * P + 1, KV))
                                   .astype(np.float32) / 127) for _ in range(2)]
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                  for _ in range(2))
        scales = []
    q = torch.from_numpy(rng.standard_normal((B, S_, KV, G, hd), dtype=np.float32))
    pos = torch.from_numpy(np.tile(np.arange(HIST, HIST + S_, dtype=np.int32),
                                   (B, 1)))
    pos[1, S_ - 100:] = -1
    whole = port_paged.paged_chunk_attention(q, kp, vp, tables, pos, *scales)
    tile = llama._history_tile(S_, G)
    assert tile < S_
    tiled = torch.cat([port_paged.paged_chunk_attention(
        q[:, t0:t0 + tile].contiguous(), kp, vp, tables,
        pos[:, t0:t0 + tile].contiguous(), *scales)
        for t0 in range(0, S_, tile)], dim=1)
    valid = pos >= 0
    torch.testing.assert_close(whole[valid], tiled[valid], atol=1e-6, rtol=1e-6)
    assert torch.isfinite(whole).all()
