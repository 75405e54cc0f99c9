"""Multi-rank serving of the port (``mesh_shape``; ``ranks.py``): greedy
streams of ``TorchEngine(EngineConfig(mesh_shape=..., device="cpu"))``,
which runs one gloo rank per process, against the JAX ``TPUEngine`` at the
same mesh on the virtual CPU devices ``tests/conftest.py`` sets, and
against the port's one-rank engine, on the same weights
(``params_from_jax``, cut on rank 0 and sent to each follower).

One engine serves every prompt of a case, in order (so that the prefix of
one is registered before the next hits it): a cold prompt, a prompt that
registers a two-page prefix, one that hits it, one chunked past the
largest bucket, and ``test_sp_serving.py``'s 100-token prompt, whose bucket
is above ``sp_threshold``. Also: Mixtral's grouped kernel and Gemma's
single KV head at 1x2, int8 weights and pages (with each rank's q/s exact
against the JAX tree's ``addressable_shards``), the data axis, speculative
decoding, the sampled tokens every rank writes, a follower that dies, the
construction errors, and the pieces that need no process (settings, the
pool's mesh fallback, the roofline's world, a sharded checkpoint load).
"""

import asyncio
import dataclasses
import logging
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.tpu_local.checkpoint import load_params, save_params
from mcp_context_forge_tpu_torch.tpu_local.engine import (EngineConfig, GenRequest,
                                                          TorchEngine, _shard_tree)
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params, params_logical
from mcp_context_forge_tpu_torch.tpu_local.parallel.collectives import SERVING_CALLS
from mcp_context_forge_tpu_torch.tpu_local.parallel.sharding import shard_leaf
from mcp_context_forge_tpu_torch.tpu_local.pool import EnginePool
from mcp_context_forge_tpu_torch.tpu_local.roofline import step_cost
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

SHAPE = dict(model="llama3-test", max_batch=2, max_seq_len=256, page_size=16,
             num_pages=96, prefill_buckets=(32, 128), prefill_max_batch=2,
             dtype="float32")
SP_PROMPT = [(7 * i + 3) % 500 for i in range(100)]      # test_sp_serving.py's
PREFIX = [(5 * i + 11) % 500 for i in range(32)]         # two pages of 16
PROMPTS = {
    "cold": [(3 * i + 1) % 500 for i in range(10)],
    "register": PREFIX + [401, 402, 403],
    "hit": PREFIX + [201, 202, 203, 204, 205, 206],
    "chunked": [(11 * i + 5) % 500 for i in range(150)],  # > the 128 bucket
    "sp": SP_PROMPT,
}
TOKENS = 6


def _jax_engine(mesh: str, **overrides) -> TPUEngine:
    data, model = (int(n) for n in mesh.split("x"))
    config = {**SHAPE, **overrides}
    return TPUEngine(JaxConfig(**config, mesh_shape=mesh, attn_impl="reference"),
                     devices=jax.devices()[:data * model])


def _params(ref: TPUEngine) -> dict:
    return params_from_jax(jax.device_get(ref.params), MODEL_CONFIGS[ref.config.model],
                           device="cpu", dtype=torch.float32)


def _port(params=None, **overrides) -> TorchEngine:
    return TorchEngine(EngineConfig(**{**SHAPE, **overrides}, device="cpu"), params=params)


def _serve(engine, prompts: list[list[int]], sampled: list[int] | None = None
           ) -> list[list[int]]:
    """Each prompt's greedy stream, one request after another; then, with
    ``sampled``, one sampled request of that prompt (returned last)."""
    async def main():
        await engine.start()
        try:
            outs = [[t async for t in engine.generate(p, max_tokens=TOKENS)]
                    for p in prompts]
            if sampled is not None:
                outs.append([t async for t in engine.generate(
                    sampled, max_tokens=TOKENS, temperature=0.9, top_k=40)])
            return outs
        finally:
            await engine.stop()
    return asyncio.run(main())


@pytest.fixture(scope="module")
def llama():
    """The JAX 1x2 ring engine's streams of every prompt, the weights, and
    the port's one-rank (dense) streams."""
    ref = _jax_engine("1x2", sp_impl="ring", sp_threshold=32)
    params = _params(ref)
    prompts = list(PROMPTS.values())
    want = _serve(ref, prompts)
    dense = _serve(_port(params), prompts)
    return SimpleNamespace(params=params, want=want, dense=dense, prompts=prompts)


def test_one_rank_engine_equals_jax(llama):
    assert llama.dense == llama.want


@pytest.mark.parametrize("mesh,sp_impl", [("1x2", "ring"), ("1x4", "ulysses")])
def test_tensor_parallel_streams(llama, mesh, sp_impl):
    """Cold, registering, hit, chunked and sequence-parallel prompts at 1x2
    (KV heads split) and 1x4 (a replicated pool; k/v cut mid-head), with a
    sampled request last: every rank wrote the same tokens, and no follower
    is left once the engine stopped."""
    ref = (None if mesh == "1x2"
           else _jax_engine(mesh, sp_impl=sp_impl, sp_threshold=32))
    want = llama.want if ref is None else _serve(ref, llama.prompts)
    engine = _port(llama.params, mesh_shape=mesh, sp_impl=sp_impl, sp_threshold=32)
    assert engine.world == int(mesh[-1]) and len(engine._ranks.procs) == engine.world - 1
    # KV 2: split at 1x2, every head on every rank at 1x4
    assert engine.kv.k_pages.shape[3] == (1 if mesh == "1x2" else 2)
    calls = SERVING_CALLS["count"]
    *got, drawn = _serve(engine, llama.prompts, sampled=PROMPTS["cold"])
    assert got == want == llama.dense
    assert SERVING_CALLS["count"] > calls
    assert engine.allocator.prefix_hits >= 1
    assert engine.stats.prefill_batches > len(llama.prompts)   # the chunk rounds
    # the hash of every (token, position) each rank wrote, greedy and sampled
    assert len(drawn) == TOKENS
    digests = engine.rank_digests
    assert digests is not None and len(digests) == engine.world
    assert len(set(digests)) == 1, digests
    assert all(p.poll() is not None for p in engine._ranks.procs)


@pytest.mark.parametrize("mesh,sp_impl", [("1x2", "ulysses"), ("1x4", "ring")])
def test_sequence_parallel_prefill(llama, mesh, sp_impl):
    """The 100-token prompt's bucket (128) is above sp_threshold 32: its
    attention runs sequence-parallel; the stream equals JAX's SP engine's
    and the dense one's."""
    want = _serve(_jax_engine(mesh, sp_impl=sp_impl, sp_threshold=32), [SP_PROMPT])
    got = _serve(_port(llama.params, mesh_shape=mesh, sp_impl=sp_impl, sp_threshold=32),
                 [SP_PROMPT])
    assert got == want == [llama.dense[-1]]


@pytest.mark.parametrize("model,overrides", [
    ("mixtral-test", dict(moe_impl="grouped_pallas", moe_block=8)),
    ("gemma-test", {}),
])
def test_model_families_at_1x2(model, overrides):
    """Mixtral: each expert's hidden dim split, its prefill through the
    grouped kernel's plain version on this rank's slice (T*k >= E*block);
    the JAX engine runs the same config at 1x2. Gemma: one KV head, so
    every rank holds the whole pool and reads head 0."""
    prompts = [PROMPTS["cold"], PROMPTS["register"], PROMPTS["hit"]]
    ref = _jax_engine("1x2", model=model, **overrides)
    want = _serve(ref, prompts)
    engine = _port(_params(ref), model=model, mesh_shape="1x2", **overrides)
    if model == "gemma-test":
        assert engine.kv.k_pages.shape[3] == 1      # the whole (replicated) pool
    got = _serve(engine, prompts)
    assert got == want


def test_int8_weights_and_pages():
    """quant and kv_quant int8 at 1x2: streams equal JAX's; each rank's q
    and s equal the JAX tree's shard on the same mesh position (rank 0's
    live, rank 1's as rank 0 cut and sent it); int8 pool scales live with
    their KV heads."""
    prompts = [PROMPTS["cold"], PROMPTS["register"], PROMPTS["hit"]]
    ref = _jax_engine("1x2", quant="int8", kv_quant="int8")
    full = _params(ref)
    engine = _port(full, mesh_shape="1x2", quant="int8", kv_quant="int8")
    logical = params_logical(MODEL_CONFIGS["llama3-test"])
    sizes = {"data": 1, "model": 2}
    cut = [_shard_tree(full, logical, sizes, {"data": 0, "model": r}) for r in range(2)]
    jax_tree = ref.params

    def check(port_leaf, jax_leaf, rank):
        shard = next(s for s in jax_leaf.addressable_shards if s.device == jax.devices()[rank])
        np.testing.assert_array_equal(port_leaf.numpy(), np.asarray(shard.data))

    layer = 0
    for name in ("wq", "wk", "wo", "w1", "w2"):
        for key in ("q", "s"):
            check(engine.params["layers"][layer][name][key],
                  jax_tree["layers"][layer][name][key], 0)
            for rank in range(2):
                check(cut[rank]["layers"][layer][name][key],
                      jax_tree["layers"][layer][name][key], rank)
    for key in ("q", "s"):
        for rank in range(2):
            check(cut[rank]["embed"][key], jax_tree["embed"][key], rank)
    assert engine.kv.k_pages.dtype == torch.int8 and engine.kv.k_pages.shape[3] == 1
    assert engine.kv.k_scales.shape[2] == 1
    assert _serve(engine, prompts) == _serve(ref, prompts)


def test_data_axis(llama, tmp_path):
    """2x1: two data replicas, each the whole model, computing the same;
    each rank reads its weights from the checkpoint itself."""
    prompts = [PROMPTS["cold"], PROMPTS["register"], PROMPTS["hit"]]
    want = _serve(_jax_engine("2x1"), prompts)
    save_params(str(tmp_path), llama.params)
    engine = _port(mesh_shape="2x1", checkpoint=str(tmp_path))
    assert engine.kv.k_pages.shape[3] == 2
    assert _serve(engine, prompts) == want == llama.dense[:3]


def test_followers_build_rank_zeros_model_config(llama, monkeypatch):
    """A registered config that rank 0's process changed under its own
    name (here rope_theta) is the one every follower builds: the 1x2
    stream equals the one-rank engine's under the same change."""
    cfg = MODEL_CONFIGS["llama3-test"]
    monkeypatch.setitem(MODEL_CONFIGS, "llama3-test", dataclasses.replace(cfg, rope_theta=10.0))
    prompts = [PROMPTS["cold"], PROMPTS["chunked"]]
    want = _serve(_port(llama.params), prompts)
    assert want != [llama.dense[0], llama.dense[3]]    # the change shows in the streams
    assert _serve(_port(llama.params, mesh_shape="1x2"), prompts) == want


def test_spec_decode_equals_plain():
    """Speculative verify steps at 1x2 (the history path with the
    collectives) emit plain decoding's stream. Both engines draw their
    weights from the seed: each rank keeps its blocks of the same draws."""
    prompts = [[7, 8, 9, 10] * 6, PROMPTS["cold"]]
    plain = _serve(_port(), prompts)
    engine = _port(mesh_shape="1x2", spec_decode=True, spec_k=3)
    assert _serve(engine, prompts) == plain
    assert engine.stats.spec_steps > 0


def test_dead_follower_ends_streams(llama, caplog):
    """A follower killed mid-decode: the stream ends with the error
    terminal within the group timeout, the engine reads dead, stop()
    returns and no process is left."""
    caplog.set_level(logging.CRITICAL)
    engine = _port(llama.params, mesh_shape="1x2", init_timeout_s=30.0, auto_restart=True)

    async def main():
        await engine.start()
        request = GenRequest(request_id="long", prompt_ids=PROMPTS["cold"], max_tokens=200)
        await engine.submit(request)
        for _ in range(3):
            assert await asyncio.wait_for(request.stream.get(), 60) is not None
        engine._ranks.procs[0].kill()
        killed = time.monotonic()
        while await asyncio.wait_for(request.stream.get(), 30.0) is not None:
            pass
        ended = time.monotonic() - killed
        alive = engine.dispatch_alive()
        await asyncio.wait_for(engine.stop(), 30.0)
        return request, ended, alive

    request, ended, alive = asyncio.run(main())
    assert request.finish_reason == "error" and ended < 30.0
    assert not alive and engine.stats.engine_restarts == 0
    assert all(p.poll() is not None for p in engine._ranks.procs)


@pytest.mark.parametrize("overrides,error,message", [
    (dict(mesh_shape="1x3", prefill_buckets=(32, 100), sp_impl="ring", sp_threshold=32),
     ValueError, "sp_impl='ring': prefill buckets [100] not divisible by mesh model axis 3"),
    (dict(mesh_shape="1x8"), ValueError,
     "llama3-test: 4 query heads do not split over 8 model ranks"),
    (dict(mesh_shape="1x2", prefix_tiers=True, prefix_cache=False), ValueError,
     "prefix_tiers requires prefix_cache"),
])
def test_construction_errors(overrides, error, message):
    """Raised before any process starts. (The spill tiers themselves are
    carried over ranks: ``test_torch_rank_tiers.py``.)"""
    with pytest.raises(error) as info:
        _port(**overrides)
    assert message in str(info.value)
    if "sp_impl" in overrides:   # the JAX engine's message, word for word
        with pytest.raises(ValueError) as jax_info:
            _jax_engine("1x3", **{k: v for k, v in overrides.items() if k != "mesh_shape"})
        assert str(jax_info.value) == str(info.value)


# ------------------------------------------------------- without processes

def test_from_settings_reads_mesh_and_sp():
    settings = SimpleNamespace(
        tpu_local_model="llama3-test", tpu_local_checkpoint="", tpu_local_max_batch=2,
        tpu_local_max_seq_len=256, tpu_local_page_size=16, tpu_local_num_pages=96,
        tpu_local_prefill_buckets=[32, 128], tpu_local_dtype="float32",
        tpu_local_mesh_shape="1x4", tpu_local_sp_impl="ulysses", tpu_local_sp_threshold=64)
    port, ref = EngineConfig.from_settings(settings), JaxConfig.from_settings(settings)
    for name in ("mesh_shape", "sp_impl", "sp_threshold"):
        assert getattr(port, name) == getattr(ref, name)
    assert (port.mesh_shape, port.sp_impl, port.sp_threshold) == ("1x4", "ulysses", 64)


def test_full_machine_mesh_shape_falls_back_per_replica(caplog):
    """The JAX pool's test: a mesh shape sized for the whole machine does
    not fit a replica's subset, so each replica takes the auto mesh, and
    ``status()`` reports its real device count."""
    caplog.set_level(logging.WARNING)
    pool = EnginePool(EngineConfig(**SHAPE, device="cpu", mesh_shape="1x8"), replicas=2)
    assert "using the auto" in caplog.text
    for replica in pool.replicas:
        assert replica.engine.config.mesh_shape == ""
        assert replica.engine.world == 1 and replica.engine._ranks is None
        assert replica.status()["mesh_devices"] == 1


def test_pool_of_several_replicas_serves_one_device_each(caplog):
    """Two replicas over four devices (the JAX pool builds this): each
    replica spreads over its subset as a 1x2 engine of its own groups, both
    held by this process, with no default group."""
    pool = EnginePool(EngineConfig(**SHAPE, device="cpu"), replicas=2,
                      devices=[torch.device("cpu")] * 4)
    try:
        assert [r.status()["mesh_devices"] for r in pool.replicas] == [2, 2]
        assert all(len(r.engine._ranks.procs) == 1 for r in pool.replicas)
        assert pool.replicas[0].engine._mesh is not pool.replicas[1].engine._mesh
        assert not torch.distributed.is_initialized()
    finally:
        asyncio.run(pool.stop())
    assert all(p.poll() is not None for r in pool.replicas for p in r.engine._ranks.procs)


@pytest.mark.parametrize("overrides", [dict(mesh_shape="1x2"), dict(sp_impl="ring")])
def test_pool_of_several_rank_path_replicas_refuses(overrides):
    """Replicas that each take the rank path (a mesh shape that fits the
    subset, an ``sp_impl``) no longer refuse: the pool builds them on
    their subsets, and they serve the stream the one-device engine does."""
    pool = EnginePool(EngineConfig(**{**SHAPE, **overrides}, device="cpu"), replicas=2,
                      devices=[torch.device("cpu")] * 4)
    assert [r.engine.world for r in pool.replicas] == [2, 2]
    assert all(r.engine._ranks is not None for r in pool.replicas)

    async def main():
        await pool.start()
        try:
            return [t async for t in pool.generate(PROMPTS["cold"], max_tokens=TOKENS)]
        finally:
            await pool.stop()

    assert len(asyncio.run(main())) == TOKENS
    assert all(p.poll() is not None for r in pool.replicas for p in r.engine._ranks.procs)


def test_roofline_divides_by_the_world():
    engine = _port()
    cost = step_cost(engine.model_config, "decode", 2, 1, [40, 50], "float32", "float32",
                     page_size=16, compute_dtype="float32")
    one = engine._observe_roofline("decode", 2, 4, 3.0, cost)
    engine.world = 4
    four = engine._observe_roofline("decode", 2, 4, 3.0, cost)
    assert four[0] == pytest.approx(one[0] / 4) and four[1] == pytest.approx(one[1] / 4)
    assert "world" not in engine.roofline_snapshot()   # one device: no rank path


@pytest.mark.parametrize("model,fmt,quant", [
    ("llama3-test", "params.pt", ""), ("llama3-test", "params.pt", "int8"),
    ("qwen2-tiny", "hf", ""), ("mixtral-test", "hf", "int8"),
])
def test_sharded_checkpoint_load_keeps_blocks(tmp_path, model, fmt, quant):
    """A rank's load (``shard``) holds exactly its blocks of the whole
    load, and no more: each leaf a block of its own memory. ``params.pt``
    and full-precision HF leaves are cut on the host; int8 HF leaves after
    their quantization (each scale its whole channel's); expert stacks
    once complete."""
    from test_torch_checkpoint import draw_tree, hf_tensors, write_hf

    cfg = MODEL_CONFIGS[model]
    if fmt == "hf":
        path = write_hf(str(tmp_path), hf_tensors(draw_tree(model, 4)))
    else:
        path = str(tmp_path)
        save_params(path, init_params(cfg, torch.Generator().manual_seed(3), torch.float32,
                                      "cpu", quant=quant))
    sizes, coords = {"data": 1, "model": 2}, {"data": 0, "model": 1}
    whole = load_params(path, cfg, "cpu", torch.float32, quant=quant)
    got = load_params(path, cfg, "cpu", torch.float32, quant=quant,
                      shard=lambda leaf, name: shard_leaf(leaf, name, sizes, coords))
    want = jax.tree_util.tree_leaves(_shard_tree(whole, params_logical(cfg), sizes, coords))
    got = jax.tree_util.tree_leaves(got)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.is_contiguous()
        assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
    assert sum(t.numel() for t in got) < sum(
        t.numel() for t in jax.tree_util.tree_leaves(whole))


def test_seeded_blocks_equal_blocks_of_the_tree():
    """Seeded weights drawn leaf by leaf with ``place`` keep exactly the
    blocks of the tree drawn whole (the rank path's seeded weights)."""
    cfg = MODEL_CONFIGS["mixtral-test"]
    logical = params_logical(cfg)
    sizes, coords = {"data": 1, "model": 2}, {"data": 0, "model": 1}
    full = init_params(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu", quant="int8")
    kept = init_params(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu", quant="int8",
                       place=lambda leaf, name: shard_leaf(leaf, name, sizes, coords))
    want = _shard_tree(full, logical, sizes, coords)
    for got, expect in zip(jax.tree_util.tree_leaves(kept), jax.tree_util.tree_leaves(want)):
        assert torch.equal(got, expect)
