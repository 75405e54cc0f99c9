"""The port's engine and provider against the JAX package's, on the CPU:
the same weights (``params_from_jax``), the same requests, and the greedy
token streams must be identical — cold prefills, a prefix-cache hit, a
request ended by ``max_tokens`` and one ended by a stop id."""

import asyncio

import jax
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu.tpu_local.tpu_provider import TPULocalProvider
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig,
                                                          GenRequest,
                                                          TorchEngine)
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider

SHAPE = dict(model="llama3-test", max_batch=4, max_seq_len=128, page_size=8,
             num_pages=64, prefill_buckets=(16, 64), dtype="float32",
             prefix_cache=True)


@pytest.fixture(scope="module")
def engines():
    ref = TPUEngine(JaxConfig(**SHAPE, attn_impl="reference"))
    params = params_from_jax(jax.device_get(ref.params),
                             MODEL_CONFIGS["llama3-test"], device="cpu",
                             dtype=torch.float32)
    port = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=params)
    return ref, port


async def _stream(engine, prompt_ids, **kwargs):
    return [t async for t in engine.generate(prompt_ids, **kwargs)]


async def _workload(engine):
    """One request warms the prefix cache, then four run concurrently: one
    shares its 3-page prefix (a hit), one ends by max_tokens, one by a stop
    id, and they all differ in length."""
    tok = engine.tokenizer
    system = tok.encode("You are a careful assistant. Answer briefly.")
    assert len(system) >= 24   # three full 8-token pages
    await engine.start()
    try:
        first = await _stream(engine, system + tok.encode(" Hi"),
                              max_tokens=6)
        hits_before = engine.allocator.prefix_hits
        jobs = [
            _stream(engine, system + tok.encode(" MCP?"), max_tokens=7),
            _stream(engine, tok.encode("alpha"), max_tokens=9),
            _stream(engine, tok.encode("a slightly longer prompt here"),
                    max_tokens=12),
            _stream(engine, tok.encode("bravo charlie delta"), max_tokens=10),
        ]
        outs = await asyncio.wait_for(asyncio.gather(*jobs), timeout=300)
        hits = engine.allocator.prefix_hits - hits_before
    finally:
        await engine.stop()
    return [first] + outs, hits


def test_greedy_streams_identical(engines):
    ref, port = engines
    ref_out, ref_hits = asyncio.run(_workload(ref))
    port_out, port_hits = asyncio.run(_workload(port))
    assert port_out == ref_out
    assert ref_hits >= 1 and port_hits == ref_hits
    assert port.allocator.pages_in_use == ref.allocator.pages_in_use

    # stop ids: end a stream at a token it is known to produce
    stop_at = port_out[3][4]
    prompt = port.tokenizer.encode("a slightly longer prompt here")

    async def stopped(engine):
        await engine.start()
        try:
            return await _stream(engine, prompt, max_tokens=12,
                                 stop_ids=(stop_at,))
        finally:
            await engine.stop()

    ref_stop, port_stop = asyncio.run(stopped(ref)), asyncio.run(stopped(port))
    assert port_stop == ref_stop == port_out[3][:port_out[3].index(stop_at) + 1]


def test_provider_chat_matches_jax_provider(engines):
    ref, port = engines
    request = {"model": "llama3-test", "max_tokens": 10,
               "messages": [{"role": "system", "content": "Be terse."},
                            {"role": "user", "content": "Name a colour."}]}

    async def chat(provider, engine):
        await engine.start()
        try:
            reply = await provider.chat(dict(request))
            chunks = [c async for c in provider.chat_stream(dict(request))]
            return reply, chunks
        finally:
            await engine.stop()

    ref_reply, ref_chunks = asyncio.run(chat(TPULocalProvider("ref", ref),
                                             ref))
    port_reply, port_chunks = asyncio.run(chat(TorchLocalProvider("port", port),
                                               port))
    assert port_reply["choices"] == ref_reply["choices"]
    assert port_reply["usage"] == ref_reply["usage"]
    assert [c["choices"] for c in port_chunks] == \
        [c["choices"] for c in ref_chunks]


def test_refusals(engines):
    """No silent move to the CPU, no unknown storage mode, and a prompt
    that leaves no room for one generated token ends "length" at once (a
    prompt merely longer than every bucket is chunked instead)."""
    _, port = engines
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchEngine(EngineConfig(model="llama3-test", device="cuda"))
    with pytest.raises(ValueError, match="kv_quant"):
        TorchEngine(EngineConfig(model="llama3-test", device="cpu",
                                 kv_quant="int4"))
    too_long = GenRequest(request_id="long",
                          prompt_ids=[1] * SHAPE["max_seq_len"])

    async def main():
        await port.start()
        try:
            await port.submit(too_long)
            return await asyncio.wait_for(too_long.stream.get(), 60)
        finally:
            await port.stop()

    assert asyncio.run(main()) is None
    assert too_long.finish_reason == "length" and too_long.generated == []


def test_cancel_pending_and_running(engines):
    _, port = engines
    tok = port.tokenizer

    async def main():
        await port.start()
        try:
            assert not port.request_cancel("no-such-request")
            running = GenRequest(request_id="run", max_tokens=100,
                                 prompt_ids=tok.encode("keep talking"))
            await port.submit(running)
            first = await asyncio.wait_for(running.stream.get(), 60)
            assert first is not None
            assert port.request_cancel("run")
            rest = []
            while (token := await asyncio.wait_for(running.stream.get(), 60)) \
                    is not None:
                rest.append(token)
            return running, rest
        finally:
            await port.stop()

    running, rest = asyncio.run(main())
    assert running.finish_reason == "cancelled"
    assert len(running.generated) < 100
    assert port.allocator.pages_in_use == 0
