"""Chunked prefill in the port against the JAX engine, on the CPU in f32.

One bucket of 16 tokens, so every prompt past 16 tokens prefills in chunk
rounds through the history path. TPUEngine(attn_impl="reference") and
TorchEngine on the same weights (``params_from_jax``) get the same
requests, submitted before the dispatch thread starts so that both admit
them in the same groups, and the greedy streams must be identical, on f32
pages and on int8 pages.
"""

import asyncio

import jax
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import GenRequest as JaxRequest
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig,
                                                          GenRequest,
                                                          TorchEngine)
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

SHAPE = dict(model="llama3-test", max_batch=4, max_seq_len=128, page_size=8,
             num_pages=64, prefill_buckets=(16,), prefill_max_batch=4,
             dtype="float32", prefix_cache=True)

# a 40-token prompt (5 full pages once prefilled)
BASE = [(7 + 13 * i) % 509 for i in range(40)]


@pytest.fixture(scope="module", params=["", "int8"], ids=["f32_pages", "int8_pages"])
def engines(request):
    shape = dict(SHAPE, kv_quant=request.param)
    ref = TPUEngine(JaxConfig(**shape, attn_impl="reference"))
    params = params_from_jax(jax.device_get(ref.params),
                             MODEL_CONFIGS["llama3-test"], device="cpu",
                             dtype=torch.float32)
    return ref, TorchEngine(EngineConfig(**shape, device="cpu"), params=params)


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
                while await asyncio.wait_for(request.stream.get(), 300) \
                        is not None:
                    pass
        finally:
            await engine.stop()
        served.extend(requests)

    for batch in batches:
        asyncio.run(run(batch))
    return served


def test_chunked_streams_match_jax(engines):
    """A 40-token prompt chunks alone (16 + 16 + 8) and registers its pages.
    Then, in one admission: a 70-token prompt that hits those 40 cached
    tokens and chunks its 30-token suffix FROM position 40, beside a fresh
    45-token prompt chunking from 0 (one round holds rows at offsets 40
    and 0, then 56 and 16); a short prompt; a prompt with no room for one
    generated token, which ends "length" with no tokens."""
    ref, port = engines
    batches = [
        [(BASE, 6)],
        [(BASE + [(3 + 5 * i) % 509 for i in range(30)], 8),
         ([(11 + 3 * i) % 509 for i in range(45)], 7),
         ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 5),
         ([9] * SHAPE["max_seq_len"], 4)],
    ]
    hits0 = [e.allocator.prefix_hits for e in (ref, port)]
    want = _serve(ref, JaxRequest, batches)
    got = _serve(port, GenRequest, batches)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert [r.finish_reason for r in got] == \
        [r.finish_reason for r in want] == ["length"] * 5
    assert [len(r.generated) for r in got] == [6, 8, 7, 5, 0]
    assert [r.chunked for r in got] == [r.chunked for r in want] \
        == [True, True, True, False, False]
    assert [r.hist for r in got] == [r.hist for r in want] == [0, 40, 0, 0, 0]
    assert port.allocator.prefix_hits - hits0[1] == \
        ref.allocator.prefix_hits - hits0[0] == 1
    assert port.stats.chunking == 0 and port.allocator.pages_in_use == 0


def test_chunked_equals_one_wide_bucket(engines):
    """Chunk rounds give the greedy stream of a single 64-wide prefill of
    the same prompt on the port (the JAX package pins the same for int8)."""
    _, port = engines
    wide = TorchEngine(EngineConfig(**dict(SHAPE, prefill_buckets=(64,),
                                           prefix_cache=False,
                                           kv_quant=port.config.kv_quant),
                                    device="cpu"), params=port.params)
    prompt = [(3 + i) % 509 for i in range(50)]
    chunks0 = port.stats.prefill_batches
    narrow, = _serve(port, GenRequest, [[(prompt, 8)]])
    assert port.stats.prefill_batches - chunks0 == 4      # 16 + 16 + 16 + 2
    one, = _serve(wide, GenRequest, [[(prompt, 8)]])
    assert narrow.chunked and not one.chunked
    assert narrow.generated == one.generated and len(one.generated) == 8


def test_chunking_capacity_defers_long_prompts(engines):
    """At most prefill_max_batch prompts chunk at once: with a limit of 1,
    the second long prompt steps aside, the short request behind it still
    admits, and every stream ends as on an unconstrained engine."""
    _, port = engines
    narrow = TorchEngine(EngineConfig(**dict(SHAPE, prefill_max_batch=1,
                                           kv_quant=port.config.kv_quant),
                                      device="cpu"), params=port.params)
    batch = [([(5 + 7 * i) % 509 for i in range(40)], 4),
             ([(2 + 9 * i) % 509 for i in range(33)], 4),
             ([4, 5, 6], 4)]
    got = _serve(narrow, GenRequest, [batch])
    want = _serve(port, GenRequest, [batch])
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 4 for r in got)
    # the short request's first token came before the deferred prompt's
    assert got[2].first_token_ts < got[1].first_token_ts


def test_cancel_mid_chunk_frees_the_slot(engines):
    """Driven step by step on the calling thread (no dispatch thread): a
    long prompt admitted to the chunk rounds, cancelled after one round,
    ends "cancelled" with no token, and its slot and pages are free."""
    _, port = engines
    engine = TorchEngine(EngineConfig(**dict(SHAPE, kv_quant=port.config.kv_quant),
                                      device="cpu"), params=port.params)
    request = GenRequest(request_id="long", prompt_ids=BASE * 2, max_tokens=4)
    asyncio.run(engine.submit(request))
    engine._drain_work()
    assert engine._admit_batch() and request.chunked
    assert engine._chunking == {request.slot: request}
    with torch.inference_mode():
        engine._chunk_round()
    assert request.chunk_pos == 16 and request.generated == []
    assert engine.allocator.pages_in_use > 0
    assert engine.request_cancel("long")
    engine._apply_cancels()
    engine._flush_emits()
    assert request.finish_reason == "cancelled" and request.generated == []
    assert request.stream.get_nowait() is None
    assert not engine._chunking and engine.allocator.pages_in_use == 0
