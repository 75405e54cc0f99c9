"""Dispatch-thread crashes of the port, after
``tests/chaos/test_fault_injection.py``: without ``auto_restart`` a crash
fails the outstanding requests fast, the engine refuses new work, and a
stop/start cycle restores service; with it, a one-shot fault in the decode
launch fails the request mid-stream, the queued one survives and completes,
the pool is reset in place (the decode graphs keep their buffers) and the
same prompt gives the same tokens as before the crash; a failed restart
probe fails everything outstanding."""

import asyncio

import pytest

from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig, GenRequest,
                                                          TorchEngine)
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

SHAPE = dict(model="llama3-test", max_batch=2, max_seq_len=64, page_size=16,
             num_pages=32, prefill_buckets=(16,), dtype="float32", device="cpu")


async def _dispatch_thread_ended(engine, timeout: float = 10.0) -> bool:
    """Wait (bounded) for the dispatch thread to exit after a crash."""
    for _ in range(int(timeout / 0.01)):
        if engine._thread is None or not engine._thread.is_alive():
            return True
        await asyncio.sleep(0.01)
    return False


def test_crash_fails_fast_and_recovers():
    engine = TorchEngine(EngineConfig(**SHAPE))

    async def main():
        await engine.start()
        ids = engine.tokenizer.encode("ok")
        assert [t async for t in engine.generate(ids, max_tokens=2)]
        launch = engine._graphs.launch

        def boom(*args, **kwargs):
            raise RuntimeError("injected device fault")

        engine._graphs.launch = boom
        broken = [t async for t in engine.generate(ids, max_tokens=4)]
        assert len(broken) <= 1      # the prefill's token at most
        assert await _dispatch_thread_ended(engine)
        with pytest.raises(RuntimeError):
            await engine.submit(GenRequest(request_id="x", prompt_ids=ids))
        assert not engine.dispatch_alive()
        engine._graphs.launch = launch
        await engine.stop()
        await engine.start()
        healed = [t async for t in engine.generate(ids, max_tokens=3)]
        assert len(healed) >= 1
        assert engine.allocator.pages_in_use == 0
        await engine.stop()

    asyncio.run(main())


def _one_shot_fault(engine):
    launch = engine._graphs.launch
    fired = {"n": 0}

    def maybe_boom(*args, **kwargs):
        if fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("injected device fault")
        return launch(*args, **kwargs)

    engine._graphs.launch = maybe_boom
    return fired


def test_auto_restart_requeues_pending():
    engine = TorchEngine(EngineConfig(**{**SHAPE, "max_batch": 1}, auto_restart=True,
                                      auto_restart_max=2))
    buffers = dict(engine._graphs.buffers)
    pool = [engine.kv.k_pages, engine.kv.v_pages, engine.kv.block_tables]

    async def main():
        await engine.start()
        ids = engine.tokenizer.encode("ok")
        before = [t async for t in engine.generate(ids, max_tokens=6)]
        assert len(before) == 6
        fired = _one_shot_fault(engine)
        victim = GenRequest(request_id="victim", prompt_ids=ids, max_tokens=8)
        await engine.submit(victim)
        survivor = [t async for t in engine.generate(ids, max_tokens=3)]
        assert len(survivor) == 3 and survivor == before[:3]
        assert engine.stats.engine_restarts == 1 and fired["n"] == 1
        while await asyncio.wait_for(victim.stream.get(), 5.0) is not None:
            pass
        assert victim.finish_reason == "error"
        after = [t async for t in engine.generate(ids, max_tokens=6)]
        assert after == before
        assert engine.dispatch_alive()
        await engine.stop()

    asyncio.run(main())
    assert engine.allocator.pages_in_use == 0
    # reset in place: the same graphs' buffers and the same pool tensors
    assert engine._graphs.buffers == buffers
    assert all(a is b for a, b in zip(pool, [engine.kv.k_pages, engine.kv.v_pages,
                                             engine.kv.block_tables]))
    assert engine.compile_stats()["serving"]["count"] == 0


def test_failed_probe_fails_everything_outstanding():
    """A restart whose device probe fails (a poisoned context) does not
    loop: the crashed request and the queued one both end "error"."""
    engine = TorchEngine(EngineConfig(**{**SHAPE, "max_batch": 1}, auto_restart=True))
    _one_shot_fault(engine)

    def poisoned():
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    engine._reset_device_state = poisoned

    async def main():
        await engine.start()
        ids = engine.tokenizer.encode("ok")
        requests = [GenRequest(request_id=f"r{i}", prompt_ids=ids, max_tokens=5)
                    for i in range(2)]
        for request in requests:
            await engine.submit(request)
        for request in requests:
            while await asyncio.wait_for(request.stream.get(), 10) is not None:
                pass
        ended = await _dispatch_thread_ended(engine)
        alive = engine.dispatch_alive()
        await engine.stop()
        return requests, ended and not alive

    requests, down = asyncio.run(main())
    assert [r.finish_reason for r in requests] == ["error", "error"]
    assert engine.stats.engine_restarts == 1
    assert down


def test_kill_refuses_new_work():
    engine = TorchEngine(EngineConfig(**SHAPE))

    async def main():
        await engine.start()
        engine.kill()
        with pytest.raises(RuntimeError, match="killed"):
            await engine.submit(GenRequest(request_id="x", prompt_ids=[1, 2]))
        assert await _dispatch_thread_ended(engine)
        assert not engine.dispatch_alive()

    asyncio.run(main())
