"""The mma.sync chunk route on the CPU: its plain model ``chunk_tiles_ref``
(key tiles of 64 keys, 32 at hd 256, each key looked up through the block
table, an online softmax across tiles) against the port's plain version
and against the JAX package's Pallas kernel in interpret mode, on f32, bf16
and int8 pages of 16, 96 and 128 tokens, at the gemma-test geometry (1 KV
head) and at G = 7; then greedy streams of a gemma-test ``TorchEngine``
against ``TPUEngine``'s with chunked prefill and a prefix hit.

Tolerances: f32 rtol = atol = 2e-5 (the same sums in another order and
tiling); bf16 rtol = atol = 2e-2 (inputs in bf16, one bf16 rounding of the
output); streams exact.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import GenRequest as JaxRequest
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu.tpu_local.ops.paged_attention import (
    paged_chunk_attention_pallas,
)
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig,
                                                          GenRequest,
                                                          TorchEngine)
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.ops import paged_attention as port_paged

GEMMA = MODEL_CONFIGS["gemma-test"]
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(rng, page, KV, G, hd, kind):
    """Three rows of S = 40 queries at different offsets over pages of one
    pool (row 1 half padding, row 2 starting past a page boundary), tables
    over distinct pages (page 0 stays the trash page)."""
    B, S = 3, 40
    starts, n_real = (2 * page + 3, 0, page - 5), (40, 20, 40)
    P = -(-max(st + n for st, n in zip(starts, n_real)) // page)
    num_pages = B * P + 1
    tables = (1 + rng.permutation(B * P)).reshape(B, P).astype(np.int32)
    pos = np.full((B, S), -1, np.int32)
    for b, (st, n) in enumerate(zip(starts, n_real)):
        pos[b, :n] = np.arange(st, st + n)
    q = rng.standard_normal((B, S, KV, G, hd), dtype=np.float32)
    if kind == "int8":
        kp, vp = (rng.integers(-127, 128, (num_pages, page, KV, hd), dtype=np.int8)
                  for _ in range(2))
        scales = tuple(rng.uniform(0.2, 2.0, (num_pages, KV)).astype(np.float32) / 127
                       for _ in range(2))
    else:
        kp, vp = (rng.standard_normal((num_pages, page, KV, hd), dtype=np.float32)
                  for _ in range(2))
        scales = ()
    return q, kp, vp, tables, pos, scales


def _cases():
    cases = []
    for page in (16, 96, 128):
        for kind in ("f32", "bf16", "int8"):
            cases.append((page, kind, GEMMA.n_kv_heads,
                          GEMMA.n_heads // GEMMA.n_kv_heads, GEMMA.head_dim))
    cases += [(16, "f32", 2, 7, 16), (96, "int8", 2, 7, 32), (128, "bf16", 1, 7, 32)]
    return cases


@pytest.mark.parametrize("page,kind,KV,G,hd", _cases())
def test_tile_walk_matches_plain_and_pallas(page, kind, KV, G, hd):
    rng = np.random.default_rng(page + KV * 10 + G)
    q, kp, vp, tables, pos, scales = _inputs(rng, page, KV, G, hd, kind)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    tq = torch.from_numpy(q).to(dtype)
    tk, tv = (torch.from_numpy(a) if kind == "int8" else torch.from_numpy(a).to(dtype)
              for a in (kp, vp))
    ts = tuple(torch.from_numpy(s) for s in scales)
    args = (tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(pos), *ts)
    out = port_paged.chunk_tiles_ref(*args)
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    plain = port_paged.paged_chunk_attention_ref(*args)
    jq, jk, jv = (np.asarray(t.float().numpy(), np.float32) if t.dtype == torch.bfloat16
                  else t.numpy() for t in (tq, tk, tv))
    if kind == "bf16":
        jq, jk, jv = (jax.numpy.asarray(a, jax.numpy.bfloat16) for a in (jq, jk, jv))
    kw = dict(zip(("k_scales", "v_scales"), scales))
    pallas = np.asarray(paged_chunk_attention_pallas(
        jq, jk, jv, tables, pos, page_size=page, interpret=True, **kw), np.float32)
    rows = pos >= 0
    tol = BF16 if kind == "bf16" else F32
    got = out.float().numpy()[rows]
    np.testing.assert_allclose(got, plain.float().numpy()[rows], **tol)
    np.testing.assert_allclose(got, pallas[rows], **tol)


def test_tile_keys_follow_the_head_dim_template():
    assert [port_paged.chunk_tile_keys(hd) for hd in (16, 32, 64, 128, 136, 256)] == \
        [64, 64, 64, 64, 32, 32]


SHAPE = dict(model="gemma-test", max_batch=4, max_seq_len=128, page_size=8,
             num_pages=64, prefill_buckets=(16,), prefill_max_batch=4,
             dtype="float32", prefix_cache=True)
BASE = [(5 + 11 * i) % 509 for i in range(40)]


def _serve(engine, make, batches):
    """Submit each batch of (prompt, max_tokens) before the engine starts,
    run it to the end, and return every request object."""
    served = []

    async def run(batch):
        requests = [make(request_id=f"r{len(served) + i}", prompt_ids=ids,
                         max_tokens=n) for i, (ids, n) in enumerate(batch)]
        for request in requests:
            await engine.submit(request)
        await engine.start()
        try:
            for request in requests:
                while await asyncio.wait_for(request.stream.get(), 300) is not None:
                    pass
        finally:
            await engine.stop()
        served.extend(requests)

    for batch in batches:
        asyncio.run(run(batch))
    return served


def test_gemma_chunked_streams_match_jax():
    """gemma-test (1 KV head, GeGLU, scaled embeddings, tied head) in f32:
    a 40-token prompt chunks alone and registers its pages; then a 70-token
    prompt hits those 40 tokens and chunks its suffix from position 40
    beside a fresh 45-token prompt chunking from 0 and a short prompt. The
    greedy streams equal the JAX engine's."""
    ref = TPUEngine(JaxConfig(**SHAPE, attn_impl="reference"))
    params = params_from_jax(jax.device_get(ref.params), GEMMA, device="cpu",
                             dtype=torch.float32)
    port = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=params)
    batches = [
        [(BASE, 6)],
        [(BASE + [(3 + 5 * i) % 509 for i in range(30)], 8),
         ([(17 + 3 * i) % 509 for i in range(45)], 7),
         ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 5)],
    ]
    want = _serve(ref, JaxRequest, batches)
    got = _serve(port, GenRequest, batches)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert [len(r.generated) for r in got] == [6, 8, 7, 5]
    assert [r.chunked for r in got] == [r.chunked for r in want] == [True, True, True, False]
    assert [r.hist for r in got] == [r.hist for r in want] == [0, 40, 0, 0]
    assert port.allocator.prefix_hits == ref.allocator.prefix_hits == 1
