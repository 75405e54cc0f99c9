"""The int8 span writer's plain model (``ops.kv_write.kv_quant_store_span_ref``,
what the span kernel computes) and the plain prefill writer
(``write_prefill_kv_plain``, ``_quant_store``) against the JAX package's
``write_prefill_kv`` on int8 pools, on the CPU, bit for bit on every page
but the trash page 0 and on its scales. Spans of 1 to 130 tokens start at
offset 0 of a page reused from an earlier tenant (its old, larger scale is
dropped), mid-page with values that grow the page's scale (the resident
values are requantized), at a page's last offset after one padding column,
and a padding row writes nothing; spans cross one or many pages, in f32
and bf16 pools, over two calls per layer (the second continues each span
mid-page)."""

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
    kv_quant_store_span, kv_quant_store_span_ref, span_pages)
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

CFG = "llama3-test"  # 2 layers, KV=2, hd=16
L, KV, HD = 2, 2, 16
PAGE, PER_SLOT, B = 8, 40, 4
NUM_PAGES = 1 + B * PER_SLOT
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# each row's first position: offset 0, mid-page, a page's last offset (after
# a padding column), and a padding row
STARTS = (2 * PAGE, 3 * PAGE + 3, 4 * PAGE + PAGE - 1, 0)
MAGNITUDE = np.array([0.05, 40.0, 1e-3, 7.0], dtype=np.float32)


def _pools(dtype: str, seed: int):
    """Three copies of one int8 pool with random resident values and
    scales (every page an earlier tenant's): the JAX writer's, the plain
    writer's and the plain model's."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    pages = [rng.integers(-127, 128, (L, NUM_PAGES, PAGE, KV, HD), dtype=np.int8)
             for _ in range(2)]
    scales = [(rng.random((L, NUM_PAGES, KV), dtype=np.float32) + 0.5) / 127
              for _ in range(2)]
    table = np.arange(1, NUM_PAGES, dtype=np.int32).reshape(B, PER_SLOT)
    port = []
    for _ in range(2):
        kv = port_kv.init_kv_state(PORT_CONFIGS[CFG], NUM_PAGES, PAGE, B,
                                   PER_SLOT, dtype=tdt, device="cpu", quant="int8")
        kv.k_pages.copy_(torch.from_numpy(pages[0]))
        kv.v_pages.copy_(torch.from_numpy(pages[1]))
        kv.k_scales.copy_(torch.from_numpy(scales[0]).to(tdt))
        kv.v_scales.copy_(torch.from_numpy(scales[1]).to(tdt))
        kv.block_tables.copy_(torch.from_numpy(table))
        port.append(kv)
    jkv = jax_kv.init_kv_state(MODEL_CONFIGS[CFG], NUM_PAGES, PAGE, B,
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


def _block(S: int, call: int):
    """One call's [B, S] positions and valid flags, as the engine packs
    them (padding at position 0): row 0 S tokens from offset 0, row 1 S
    tokens from mid-page, row 2 S - 1 tokens after a padding column
    (one token at S = 1), row 3 padding; a second call continues each
    span where the first ended."""
    positions = np.zeros((B, S), dtype=np.int32)
    valid = np.zeros((B, S), dtype=bool)
    lead = [0, 0, 1 if S > 1 else 0]
    for row, skip in enumerate(lead):
        n = S - skip
        start = STARTS[row] + call * n
        positions[row, skip:] = np.arange(start, start + n)
        valid[row, skip:] = True
    return positions, valid


@pytest.mark.parametrize("S", [1, 3, 4, 17, 130])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_span_writers_match_jax(dtype, S):
    tdt, jdt = DTYPES[dtype]
    jkv, plain, model = _pools(dtype, seed=S)
    old_k_scales = model.k_scales.clone()
    old_k_pages = model.k_pages.clone()
    rng = np.random.default_rng(100 + S)
    slots = np.arange(B, dtype=np.int32)
    for call in range(2):
        positions, valid = _block(S, call)
        for layer in range(L):
            k = (rng.standard_normal((B, S, KV, HD), dtype=np.float32)
                 * MAGNITUDE[:, None, None, None] * (1 + call))
            v = 0.25 * rng.standard_normal((B, S, KV, HD), dtype=np.float32)
            kt, vt = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
            args = (torch.from_numpy(slots), torch.from_numpy(positions),
                    torch.from_numpy(valid))
            jkv = jax_kv.write_prefill_kv(
                jkv, layer, jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt),
                jnp.asarray(slots), jnp.asarray(positions), jnp.asarray(valid))
            port_kv.write_prefill_kv_plain(plain, layer, kt, vt, *args)
            kv_quant_store_span_ref(
                model.k_pages[layer], model.v_pages[layer], model.k_scales[layer],
                model.v_scales[layer], kt, vt, model.block_tables, *args)
    _assert_equal("plain model vs JAX", model, jkv)
    _assert_equal("plain writer vs JAX", plain, jkv)
    # the cases happened: row 0's first page (offset 0, small values) had
    # its old scale dropped; row 1's first page (mid-page, large values)
    # grew and its resident values before the span were requantized
    page0, page1 = 1 + STARTS[0] // PAGE, PER_SLOT + 1 + STARTS[1] // PAGE
    assert bool((model.k_scales[:, page0] < old_k_scales[:, page0]).all())
    assert bool((model.k_scales[:, page1] > old_k_scales[:, page1]).all())
    resident = slice(0, STARTS[1] % PAGE)
    assert not torch.equal(model.k_pages[:, page1, resident],
                           old_k_pages[:, page1, resident])
    # the padding row's pages are untouched by the model (the JAX writer
    # sends its tokens to page 0)
    row3 = slice(3 * PER_SLOT + 1, 4 * PER_SLOT + 1)
    assert torch.equal(model.k_pages[:, row3], old_k_pages[:, row3])


def test_span_pages_bounds_every_start():
    """The kernel's grid columns per row cover a span at every offset."""
    for page in (1, 8, 128):
        for S in (1, 2, 4, 127, 128, 129, 2048):
            touched = max((off + S - 1) // page + 1 for off in range(page))
            assert span_pages(S, page) == touched


def test_cpu_entry_points_take_the_plain_paths():
    """``kv_quant_store_span`` on CPU tensors runs the plain model, and
    ``write_prefill_kv`` on a CPU int8 pool runs the plain writer: the two
    agree on pages >= 1 and their scales."""
    _, a, b = _pools("float32", seed=9)
    rng = np.random.default_rng(10)
    S = 12
    positions, valid = _block(S, 0)
    k = torch.from_numpy(rng.standard_normal((B, S, KV, HD), dtype=np.float32))
    args = (torch.arange(B, dtype=torch.int32), torch.from_numpy(positions),
            torch.from_numpy(valid))
    for layer in range(L):
        kv_quant_store_span(a.k_pages[layer], a.v_pages[layer], a.k_scales[layer],
                            a.v_scales[layer], k, 3 * k, a.block_tables, *args)
        port_kv.write_prefill_kv(b, layer, k, 3 * k, *args)
    _assert_equal("wrapper vs plain writer", a, b)
