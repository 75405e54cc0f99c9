"""Helpers of the decode-machinery parity tests (``test_torch_superstep.py``,
``test_torch_overlap.py``, ``test_torch_spec_decode*.py``): a ``TPUEngine``
and a ``TorchEngine`` on the same ``llama3-test`` weights
(``params_from_jax``) and config, and a runner that queues every request
before the dispatch thread starts, so that admission groups, and with them
every dispatch, are the same in both engines."""

import asyncio

import jax
import torch

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import GenRequest as JaxRequest
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig,
                                                          GenRequest,
                                                          TorchEngine)
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax

# test_torch_engine.py's SHAPE
SHAPE = dict(model="llama3-test", max_batch=4, max_seq_len=128, page_size=8,
             num_pages=64, prefill_buckets=(16, 64), dtype="float32",
             prefix_cache=True)
TEXTS = ("alpha bravo", "charlie", "delta echo foxtrot golf",
         "hotel india juliet kilo lima mike")


def make_pair(**overrides) -> tuple[TPUEngine, TorchEngine]:
    config = {**SHAPE, **overrides}
    ref = TPUEngine(JaxConfig(**config, attn_impl="reference"))
    params = params_from_jax(jax.device_get(ref.params),
                             MODEL_CONFIGS[config["model"]], device="cpu",
                             dtype=torch.float32)
    return ref, TorchEngine(EngineConfig(**config, device="cpu"), params=params)


def serve(engine, jobs: list[tuple[list[int], dict]]):
    """Serve ``jobs`` ((prompt ids, request fields) each), all queued before
    the engine starts; returns each request's (tokens, finish reason)."""
    cls = JaxRequest if isinstance(engine, TPUEngine) else GenRequest
    requests = [cls(request_id=f"r{i}", prompt_ids=ids, **fields)
                for i, (ids, fields) in enumerate(jobs)]
    engine._pending.extend(requests)

    async def main():
        await engine.start()
        try:
            outs = []
            for request in requests:
                tokens = []
                while (token := await asyncio.wait_for(request.stream.get(),
                                                       120)) is not None:
                    tokens.append(token)
                outs.append((tokens, request.finish_reason))
            return outs
        finally:
            await engine.stop()

    return asyncio.run(main())


COUNTERS = ("decode_dispatches", "spec_steps", "spec_tokens")


def _counters(engine) -> dict:
    return {name: getattr(engine.stats, name) for name in COUNTERS}


def serve_both(pair, jobs) -> list:
    """Both engines serve ``jobs``: their streams and finish reasons must
    be equal, and so must the pages in use afterwards, the number of
    decode dispatches (the same scheduling) and the speculative counters.
    Returns the streams."""
    ref, port = pair
    before = [_counters(engine) for engine in pair]
    want, got = serve(ref, jobs), serve(port, jobs)
    assert got == want
    assert port.allocator.pages_in_use == ref.allocator.pages_in_use
    deltas = [{name: n - b[name] for name, n in _counters(engine).items()}
              for engine, b in zip(pair, before)]
    assert deltas[1] == deltas[0]
    return got


def serve_spec(pair, jobs) -> tuple[list, dict]:
    """``serve_both``; returns the streams and the port's counter deltas."""
    before = _counters(pair[1])
    got = serve_both(pair, jobs)
    return got, {name: n - before[name] for name, n in _counters(pair[1]).items()}


def prompt_jobs(tok):
    """The JAX spec tests' prompts (a repetitive one, a plain one, 40
    counting tokens) and a cyclic one whose trailing 2-gram always
    repeats."""
    prompts = [tok.encode("abc abc abc abc abc abc"),
               tok.encode("the quick brown fox"), list(range(5, 45)),
               [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]]
    return [(ids, dict(max_tokens=16)) for ids in prompts]


def first_new_token(stream: list[int], start: int) -> int:
    """The index of the first token at or after ``start`` that did not
    occur earlier in ``stream`` (a stop id there ends the stream there)."""
    return next(i for i in range(start, len(stream))
                if stream[i] not in stream[:i])
