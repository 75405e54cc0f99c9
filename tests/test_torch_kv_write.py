"""The fused int8 decode writer's plain model (``ops.kv_write``) against the
plain writer (``write_decode_kv_plain``, ``_quant_store``) and the JAX
package's writer, on the CPU, bit for bit on every page but the trash page
0 and on its scales: offset-0 resets of a page with an old scale, scale
growth that requantizes resident values, writes that do not grow the
scale, the last offset of a page, a zero token on a page whose scale is 0
over stale values, and invalid rows, in f32 and bf16 pools."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.kv import paged_cache as jax_kv
from mcp_context_forge_tpu.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.kv import paged_cache as port_kv
from mcp_context_forge_tpu_torch.tpu_local.models import (
    MODEL_CONFIGS as PORT_CONFIGS,
)
from mcp_context_forge_tpu_torch.tpu_local.ops.kv_write import (
    kv_quant_store_decode, kv_quant_store_decode_ref)

CFG = "llama3-test"  # 2 layers, KV=2, hd=16
PAGE, NUM_PAGES, SLOTS, PER_SLOT = 8, 32, 6, 4
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pools(dtype: str, seed: int):
    """Three copies of one int8 pool with random resident values and
    scales: the JAX writer's, the plain writer's and the plain model's.
    Page 12 (slot 5's second page) has scale 0 over stale values."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    L, KV, hd = 2, 2, 16
    pages = [rng.integers(-127, 128, (L, NUM_PAGES, PAGE, KV, hd), dtype=np.int8)
             for _ in range(2)]
    scales = [(rng.random((L, NUM_PAGES, KV), dtype=np.float32) + 0.5) / 127
              for _ in range(2)]
    for s in scales:
        s[:, 12] = 0.0
    table = np.zeros((SLOTS, PER_SLOT), dtype=np.int32)
    table[:, :2] = np.arange(1, 2 * SLOTS + 1, dtype=np.int32).reshape(SLOTS, 2)
    port = []
    for _ in range(2):
        kv = port_kv.init_kv_state(PORT_CONFIGS[CFG], NUM_PAGES, PAGE, SLOTS,
                                   PER_SLOT, dtype=tdt, device="cpu", quant="int8")
        kv.k_pages.copy_(torch.from_numpy(pages[0]))
        kv.v_pages.copy_(torch.from_numpy(pages[1]))
        kv.k_scales.copy_(torch.from_numpy(scales[0]).to(tdt))
        kv.v_scales.copy_(torch.from_numpy(scales[1]).to(tdt))
        kv.block_tables.copy_(torch.from_numpy(table))
        port.append(kv)
    jkv = jax_kv.init_kv_state(MODEL_CONFIGS[CFG], NUM_PAGES, PAGE, SLOTS,
                               PER_SLOT, dtype=jdt, quant="int8")
    jkv = jkv._replace(k_pages=jnp.asarray(pages[0]), v_pages=jnp.asarray(pages[1]),
                       k_scales=jnp.asarray(scales[0]).astype(jdt),
                       v_scales=jnp.asarray(scales[1]).astype(jdt),
                       block_tables=jnp.asarray(table))
    return jkv, port[0], port[1]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_equal(name, got, want):
    for key in ("k_pages", "v_pages", "k_scales", "v_scales"):
        np.testing.assert_array_equal(_np(getattr(got, key))[:, 1:],
                                      _np(getattr(want, key))[:, 1:],
                                      err_msg=f"{name}: {key}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_model_matches_plain_and_jax_writers(dtype):
    tdt, jdt = DTYPES[dtype]
    jkv, plain, model = _pools(dtype, seed=3)
    initial = model.k_scales.clone()
    rng = np.random.default_rng(4)
    slots = np.arange(SLOTS, dtype=np.int32)
    # rows: slot 0 at a page boundary (a new tenancy over an old scale),
    # slot 1 mid-page with large values (the scale grows), slot 2 mid-page
    # with tiny values (it does not), slot 3 invalid, slot 4 at the last
    # offset of its page, slot 5 a zero token on the page with scale 0
    positions = np.array([8, 13, 10, 3, 7, 11], dtype=np.int32)
    valid = np.array([True, True, True, False, True, True])
    magnitude = np.array([1.0, 40.0, 1e-3, 100.0, 1.0, 0.0], dtype=np.float32)
    for step in range(3):
        for layer in range(2):
            k = (rng.standard_normal((SLOTS, 2, 16), dtype=np.float32)
                 * magnitude[:, None, None] * (1 + step))
            v = -0.5 * k
            kt, vt = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
            jkv = jax_kv.write_decode_kv(
                jkv, layer, jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt),
                jnp.asarray(slots), jnp.asarray(positions),
                valid=jnp.asarray(valid))
            port_kv.write_decode_kv_plain(
                plain, layer, kt, vt, torch.from_numpy(slots),
                torch.from_numpy(positions), torch.from_numpy(valid))
            kv_quant_store_decode_ref(
                model.k_pages[layer], model.v_pages[layer], model.k_scales[layer],
                model.v_scales[layer], kt, vt, model.block_tables,
                torch.from_numpy(slots), torch.from_numpy(positions),
                torch.from_numpy(valid))
        positions = positions + valid
    _assert_equal("plain model vs JAX", model, jkv)
    _assert_equal("plain writer vs JAX", plain, jkv)
    # the cases happened: slot 1's page 4 grew, slot 2's page 6 did not,
    # slot 5's page 12 (scale 0) had its stale values requantized to 0
    ks = model.k_scales
    assert bool((ks[:, 4].float() > 0.1).all())
    assert torch.equal(ks[:, 6], initial[:, 6])
    assert torch.count_nonzero(model.k_pages[:, 12]) == 0


def test_wrapper_on_cpu_is_the_plain_model():
    """``kv_quant_store_decode`` on CPU tensors runs the plain model, and
    ``write_decode_kv`` on a CPU int8 pool keeps the plain writer; a
    position past the block table takes its last column, as JAX's gather
    clamps."""
    _, a, b = _pools("float32", seed=5)
    rng = np.random.default_rng(6)
    k = torch.from_numpy(rng.standard_normal((SLOTS, 2, 16), dtype=np.float32))
    slots = torch.arange(SLOTS, dtype=torch.int32)
    positions = torch.tensor([0, 9, 15, 2, PER_SLOT * PAGE, 1], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False, True, True])
    for layer in range(2):
        kv_quant_store_decode(a.k_pages[layer], a.v_pages[layer], a.k_scales[layer],
                              a.v_scales[layer], k, 2 * k, a.block_tables, slots,
                              positions, valid)
        port_kv.write_decode_kv(b, layer, k, 2 * k, slots, positions, valid)
    _assert_equal("wrapper vs plain writer", a, b)
