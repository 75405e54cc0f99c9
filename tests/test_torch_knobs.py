"""The port's serving knobs against the JAX engine's, on the CPU:
``request_knobs`` accepts and refuses the same moves as a warmed TPUEngine
whose grid holds what the port captured (K rungs, widths, spec), and
``knob_state`` has the same keys and values; a K move mid-stream lands at
a drain barrier and leaves the greedy streams equal to TPUEngine's plain
run; a width floor bounds the decode width's shrink; spec decoding turns
off and on; the config validation refuses what the JAX engine refuses."""

import asyncio

import pytest

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig, GenRequest,
                                                          TorchEngine)
from torch_engine_pair import SHAPE, TEXTS, make_pair, serve

CASES = [dict(superstep=1), dict(superstep=4), dict(superstep=2), dict(superstep=0),
         dict(spec_enabled=False), dict(width_floor=0), dict(width_floor=8),
         dict(width_floor=16), dict(width_floor=5),
         dict(superstep=4, spec_enabled=True, width_floor=8)]


def _warmed_ref(**config) -> TPUEngine:
    """An unwarmed TPUEngine given the warmed grid and posture its warmup
    would set (every K rung at every width, the width at max): what the
    port captures when built."""
    ref = TPUEngine(JaxConfig(**config, attn_impl="reference"))
    ref._warmed_k = set(ref.config.k_rungs())
    ref._warmed_widths = set(ref._batch_buckets() if ref.config.batch_buckets
                             else [ref.config.max_batch])
    ref._batch_width = ref.config.max_batch
    return ref


@pytest.mark.parametrize("config", [
    dict(k_ladder=(1, 4)),
    dict(k_ladder=(4,), batch_buckets=True, max_batch=16),
    dict(spec_decode=True),
], ids=["ladder", "ladder-buckets", "spec"])
def test_request_knobs_and_state_equal_jax(config):
    config = {**SHAPE, **config}
    ref = _warmed_ref(**config)
    port = TorchEngine(EngineConfig(**config, device="cpu"))
    assert port.knob_state() == ref.knob_state()
    for case in CASES:
        assert port.request_knobs(**case) == ref.request_knobs(**case), case
    assert port._pending_knobs == ref._pending_knobs
    port._apply_knobs()
    ref._apply_knobs()
    assert port.knob_state() == ref.knob_state()


def _serve_with_knob_move(engine, jobs, move: dict):
    """Serve preloaded ``jobs``; once the first request has streamed a
    token, stage ``move``. Returns the streams and whether it was accepted."""
    requests = [GenRequest(request_id=f"r{i}", prompt_ids=ids, **fields)
                for i, (ids, fields) in enumerate(jobs)]
    engine._pending.extend(requests)

    async def main():
        await engine.start()
        try:
            first = await asyncio.wait_for(requests[0].stream.get(), 60)
            accepted = engine.request_knobs(**move)
            outs = []
            for i, request in enumerate(requests):
                tokens = [first] if i == 0 else []
                while (token := await asyncio.wait_for(request.stream.get(), 60)) is not None:
                    tokens.append(token)
                outs.append((tokens, request.finish_reason))
            return outs, accepted
        finally:
            await engine.stop()

    return asyncio.run(main())


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
def test_k_move_mid_stream_keeps_greedy_streams(overlap):
    ref, port = make_pair(k_ladder=(1, 4), decode_overlap=overlap)
    jobs = [(port.tokenizer.encode(t), dict(max_tokens=m))
            for t, m in zip(TEXTS, (17, 11, 9, 20))]
    want = serve(ref, jobs)
    got, accepted = _serve_with_knob_move(port, jobs, dict(superstep=4))
    assert accepted == {"superstep": True}
    assert got == want
    assert port.knob_state()["superstep"] == 4
    ks = [s["superstep"] for s in port.recent_steps() if s["kind"] == "decode"]
    assert ks[0] == 1 and 4 in ks
    assert ks == sorted(ks), "a K = 1 dispatch followed a K = 4 one"
    assert port.allocator.pages_in_use == 0


def test_unknown_k_is_refused_and_nothing_moves():
    port = TorchEngine(EngineConfig(**SHAPE, device="cpu", k_ladder=(1, 4)))
    assert port.request_knobs(superstep=8) == {"superstep": False}
    assert not port._pending_knobs
    assert sorted(b.key.k for b in port._graphs.buffers.values()) == [1, 1, 4, 4]


def test_width_floor_bounds_the_shrink():
    """batch_buckets at max_batch 16 (widths 8 and 16) with a one-step
    shrink streak: two requests shrink the width to 8, unless a floor of
    16 holds it."""
    widths = {}
    for floor in (0, 16):
        engine = TorchEngine(EngineConfig(**{**SHAPE, "max_batch": 16, "num_pages": 128},
                                          device="cpu", batch_buckets=True,
                                          batch_shrink_steps=1))
        assert engine.request_knobs(width_floor=floor) == {"width_floor": True}
        engine._apply_knobs()
        serve(engine, [(engine.tokenizer.encode(t), dict(max_tokens=6)) for t in TEXTS[:2]])
        widths[floor] = {s["width"] for s in engine.recent_steps() if s["kind"] == "decode"}
    assert 8 in widths[0]
    assert widths[16] == {16}


def test_spec_toggle():
    """A spec engine with spec_enabled off serves plain decode steps, and
    back on, verifies again; the streams stay the same."""
    port = TorchEngine(EngineConfig(**SHAPE, device="cpu", spec_decode=True))
    jobs = [(port.tokenizer.encode("abc abc abc abc abc abc"), dict(max_tokens=12))]
    on = serve(port, jobs)
    verifies = port.stats.spec_steps
    assert verifies > 0
    assert port.request_knobs(spec_enabled=False) == {"spec_enabled": True}
    port._apply_knobs()
    assert serve(port, jobs) == on
    assert port.stats.spec_steps == verifies
    assert port.knob_state()["spec_enabled"] is False
    port.request_knobs(spec_enabled=True)
    port._apply_knobs()
    assert serve(port, jobs) == on
    assert port.stats.spec_steps > verifies


@pytest.mark.parametrize("bad", [
    dict(superstep=2, decode_block=4),
    dict(decode_block=0),
    dict(spec_decode=True, k_ladder=(1, 2)),
    dict(spec_decode=True, decode_block=2),
    dict(superstep=0),
])
def test_config_validation_equals_jax(bad):
    config = {**SHAPE, **bad}
    with pytest.raises(ValueError):
        TPUEngine(JaxConfig(**config, attn_impl="reference"))
    with pytest.raises(ValueError):
        TorchEngine(EngineConfig(**config, device="cpu"))


def test_decode_block_alias_and_rungs():
    config = EngineConfig(decode_block=2, k_ladder=(8, 1, 8, 0))
    assert config.fused_steps == 2 and config.k_rungs() == (1, 2, 8)
    assert EngineConfig(superstep=4, decode_block=4).fused_steps == 4
    assert EngineConfig().k_rungs() == (1,)
