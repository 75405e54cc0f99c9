"""A pool of multi-rank replicas, and a multi-rank owner of the shared
engine plane: every replica's rank 0 in this process, each with process
groups of its own, none on ``torch.distributed``'s default group.

- against the JAX ``EnginePool(..., replicas=2, devices=jax.devices()[:4])``
  (two 1x2 replicas on the virtual CPU devices): a long prompt prefills on
  the prefill replica, its KV chain migrates through the shared tiers and
  it decodes on the decode replica; a short chat stays put. The streams
  equal the JAX pool's and the unmigrated JAX engine's at 1x2, token for
  token, and so do the migration counters (``migration_pages``
  conserved);
- an int8 pool's migration between two 1x2 replicas restores the chain's
  pages bit for bit (the payloads gathered on each side);
- spill on drain across a reload of a 1x2 replica, whose groups are torn
  down and built anew in this process;
- the shared plane's owner serving a 1x2 engine (its survivor builds its
  own): the forwarded streams equal those of an owner on one device; and a
  multi-rank owner killed outright (SIGKILL) leaves no follower behind.
"""

import asyncio
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import GenRequest as JaxRequest
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu.tpu_local.pool import EnginePool as JaxPool
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, GenRequest, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.models.llama import init_params
from mcp_context_forge_tpu_torch.tpu_local.pool import EnginePool
from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider
from test_torch_shared_plane import SHAPE as PLANE_SHAPE
from test_torch_shared_plane import run_fleet
from test_torch_tp_serving import SHAPE
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

PS = SHAPE["page_size"]
DISAGG = {**SHAPE, "prefix_cache": True, "prefix_tiers": True,
          "tier_host_bytes": 64 << 20, "tier_disk_bytes": 0}
# ~88 byte tokens: 5 full pages, past the prefill threshold (PS)
LONG_PROMPT = "the quick brown fox jumps over the lazy dog " * 2
CHAT_PROMPT = "hi there"   # 8 tokens < PS: stays on the decode tier
TEMPLATE = list(range(3, 36))   # two full pages and a tail
CPU4 = [torch.device("cpu")] * 4


async def gen(engine, ids, n=6):
    return [t async for t in engine.generate(ids, max_tokens=n)]


async def run(pool, prompt, rid, max_tokens=12, cls=GenRequest):
    request = cls(request_id=rid, prompt_ids=pool.tokenizer.encode(prompt),
                  max_tokens=max_tokens)
    await pool.submit(request)
    out = []
    while (token := await asyncio.wait_for(request.stream.get(), 120)) is not None:
        out.append(token)
    return request, out


def migration_counts(pool) -> dict:
    return {"migrations": dict(pool.migrations), "pages": dict(pool.migration_pages),
            "bytes": pool.migration_bytes, "requeues": pool.requeues,
            "out": [r.migrations_out for r in pool.replicas],
            "in": [r.migrations_in for r in pool.replicas]}


def port_pool(params, replicas=2, devices=CPU4, **overrides):
    def factory(cfg, tracer, metrics, ledger=None, tier_store=None, prefix_index=None,
                devices=None):
        return TorchEngine(cfg, params=params, tracer=tracer, metrics=metrics, ledger=ledger,
                           tier_store=tier_store, prefix_index=prefix_index, devices=devices)

    roles = overrides.pop("roles", "prefill,decode")
    return EnginePool(EngineConfig(**{**DISAGG, **overrides}, device="cpu"),
                      replicas=replicas, roles=roles, disagg_prompt_tokens=PS,
                      health_interval_s=0.05, engine_factory=factory, devices=devices)


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: the disaggregated pool of two 1x2 replicas over
    four devices migrates the long prompt and serves the chat; an
    unmigrated, tier-less 1x2 engine serves both, then the template twice
    (the second a prefix hit)."""
    def config(**overrides):
        return JaxConfig(**{**DISAGG, **overrides}, attn_impl="reference")

    pool = JaxPool(config(), replicas=2, roles="prefill,decode", disagg_prompt_tokens=PS,
                   health_interval_s=0.05, devices=jax.devices()[:4])
    engine = TPUEngine(config(mesh_shape="1x2", prefix_tiers=False),
                       devices=jax.devices()[:2])
    tok = engine.tokenizer

    async def main():
        await pool.start()
        try:
            _, long_out = await run(pool, LONG_PROMPT, "mig-1", cls=JaxRequest)
            _, chat_out = await run(pool, CHAT_PROMPT, "chat-1", cls=JaxRequest)
        finally:
            await pool.stop()
        await engine.start()
        try:
            plain = [await gen(engine, tok.encode(LONG_PROMPT), 12),
                     await gen(engine, tok.encode(CHAT_PROMPT), 12),
                     await gen(engine, TEMPLATE + [40]),
                     await gen(engine, TEMPLATE + [41], 12)]
        finally:
            await engine.stop()
        return long_out, chat_out, plain

    long_out, chat_out, plain = asyncio.run(main())
    params = params_from_jax(jax.device_get(engine.params), MODEL_CONFIGS["llama3-test"],
                             device="cpu", dtype=torch.float32)
    return SimpleNamespace(params=params, pool_long=long_out, pool_chat=chat_out,
                           long=plain[0], chat=plain[1], template=plain[3],
                           worlds=[r.engine.mesh.size for r in pool.replicas],
                           counts=migration_counts(pool))


@pytest.fixture(scope="module")
def served(ref):
    """The port's pool of two 1x2 replicas over four devices, through the
    same two requests."""
    pool = port_pool(ref.params)

    async def main():
        await pool.start()
        try:
            request, long_out = await run(pool, LONG_PROMPT, "mig-1")
            _, chat_out = await run(pool, CHAT_PROMPT, "chat-1")
            initialized = dist.is_initialized()
        finally:
            await pool.stop()
        return request, long_out, chat_out, initialized

    request, long_out, chat_out, initialized = asyncio.run(main())
    return SimpleNamespace(pool=pool, request=request, long=long_out, chat=chat_out,
                           initialized=initialized)


def test_each_replica_spreads_over_its_subset(ref, served):
    """As the JAX pool places them: each replica a 1x2 engine on its two
    devices, its rank 0 in this process with groups of its own; no default
    group, and no follower left once the pool stopped."""
    engines = [r.engine for r in served.pool.replicas]
    assert [e.world for e in engines] == ref.worlds == [2, 2]
    assert [r.status()["mesh_devices"] for r in served.pool.replicas] == [2, 2]
    assert engines[0]._mesh is not engines[1]._mesh
    assert engines[0]._mesh.get_group("model") is not engines[1]._mesh.get_group("model")
    assert not served.initialized and not dist.is_initialized()
    assert all(p.poll() is not None for e in engines for p in e._ranks.procs)
    assert all(e.rank_digests is not None and len(set(e.rank_digests)) == 1 for e in engines)


def test_migration_streams_equal_jax_pool(ref, served):
    assert served.long == ref.pool_long == ref.long
    assert served.chat == ref.pool_chat == ref.chat
    assert served.request.finish_reason in ("stop", "length")


def test_migration_counters_equal_jax_pool(ref, served):
    pool = served.pool
    assert migration_counts(pool) == ref.counts
    expected = len(pool.tokenizer.encode(LONG_PROMPT)) // PS
    assert pool.migration_pages == {"spilled": expected, "restored": expected, "degraded": 0}
    assert pool.migration_bytes > 0


def test_int8_migration_between_1x2_replicas_is_bit_exact(ref):
    """An int8 pool spills its pages as they are: the decode replica's
    restored chain pages, gathered from both its ranks, equal the prefill
    replica's bit for bit, and the stream is an unmigrated int8 1x2
    engine's."""
    async def main():
        engine = TorchEngine(EngineConfig(**{**SHAPE, "kv_quant": "int8", "mesh_shape": "1x2"},
                                          device="cpu"), params=ref.params)
        await engine.start()
        try:
            want = await gen(engine, engine.tokenizer.encode(LONG_PROMPT), 12)
        finally:
            await engine.stop()
        pool = port_pool(ref.params, kv_quant="int8")
        await pool.start()
        try:
            _, out = await run(pool, LONG_PROMPT, "mig-int8")
            src, dst = (r.engine for r in pool.replicas)
            await pool.health.stop()    # a stopped replica is not a failure here
            for engine in (src, dst):   # the groups stay for the reads below
                await engine.stop(keep_group=True)
            ids = pool.tokenizer.encode(LONG_PROMPT)
            steps = list(src.allocator._chain_steps(ids, full=True))
            pages = [(src._read_page_payload(src.allocator._cached[key]),
                      dst._read_page_payload(dst.allocator._cached[key]))
                     for key, *_ in steps]
        finally:
            await pool.stop()
        return pool, out, want, pages, len(ids)

    pool, out, want, pages, n_ids = asyncio.run(main())
    assert out == want
    assert pool.migrations == {"ok": 1, "degraded": 0}
    pages_moved = pool.migration_pages
    assert pages_moved["spilled"] == pages_moved["restored"] + pages_moved["degraded"]
    assert len(pages) == n_ids // PS
    for a, b in pages:
        assert a.k.dtype == np.int8
        for name in ("k", "v", "k_scales", "v_scales"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name


def test_spill_on_drain_across_a_reload_at_1x2(ref):
    """drain -> reload of a 1x2 replica spills its resident prefix pages
    over its group before the group closes; the rebuilt replica (new
    followers, new groups) serves the template from the tiers with the JAX
    engine's stream (lossless spill)."""
    async def main():
        pool = port_pool(ref.params, replicas=1, devices=CPU4[:2], roles=None,
                         tier_spill_quant="")
        await pool.start()
        try:
            r0 = pool.replicas[0].engine
            await gen(r0, TEMPLATE + [40])
            spilled0 = pool.tier_store.stats()["spilled"]
            assert r0.world == 2 and r0.allocator.cached_pages >= 2
            await pool.reload("0")
            engine = pool.replicas[0].engine
            out = await gen(engine, TEMPLATE + [41], 12)
            return pool, r0, engine, spilled0, out
        finally:
            await pool.stop()

    pool, old, engine, spilled0, out = asyncio.run(main())
    assert pool.tier_store.stats()["spilled"] > spilled0
    assert engine is not old and engine.world == 2
    assert all(p.poll() is not None for p in old._ranks.procs)
    assert engine._ranks.procs[0].pid != old._ranks.procs[0].pid
    assert out == ref.template
    hits = engine.allocator.tier_hit_tokens
    assert hits["host"] + hits["disk"] >= 2 * PS


def test_multi_rank_owner_of_the_shared_plane():
    """``test_torch_shared_plane.py``'s three planes over a TCP hub, the
    owner's engine a 1x2 one (and so the survivor's, built after the
    owner's stop ended its followers): every forwarded reply and stream,
    the tenant's ledger and the refusals equal those of owners on one
    device."""
    params = init_params(MODEL_CONFIGS["llama3-test"], torch.Generator().manual_seed(11),
                         torch.float32, "cpu")
    engines = []

    def provider_of(mesh):
        async def make(ledger, served):
            config = EngineConfig(**PLANE_SHAPE, device="cpu", mesh_shape=mesh)
            engine = TorchEngine(config, params=params, ledger=ledger)
            engines.append(engine)
            submit = engine.submit

            async def recording(request):
                served.append(request)
                return await submit(request)

            engine.submit = recording
            await engine.start()
            return TorchLocalProvider("tpu_local", engine)
        return make

    async def stop_all():
        # a plane left running while the fleet stops may win the lease and
        # build once more: every engine built here ends
        for engine in engines:
            await engine.stop()

    try:
        want = asyncio.run(run_fleet("port", provider_of("")))
        got = asyncio.run(run_fleet("port", provider_of("1x2")))
    finally:
        asyncio.run(stop_all())
    assert got == want
    assert got["builds"] == 2 and [len(g) for _, g, _ in got["streams"]] == [10, 8]
    owners = [e for e in engines if e.world == 2]
    assert len(owners) >= 2 and owners[0]._mesh is not owners[1]._mesh
    assert all(p.poll() is not None for e in owners for p in e._ranks.procs)
    assert not dist.is_initialized()


OWNER = """
import time
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
engine = TorchEngine(EngineConfig(model="llama3-test", max_batch=2, max_seq_len=64, page_size=16,
                                  num_pages=16, prefill_buckets=(32,), dtype="float32",
                                  device="cpu", mesh_shape="1x2"))
print(engine._ranks.procs[0].pid, flush=True)
time.sleep(120)
"""


def _exited(pid: int) -> bool:
    """The process ended (an orphan may stay a zombie until it is reaped)."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_followers_exit_when_a_multi_rank_owner_is_killed():
    """The plane's failover kills an owner outright: its followers (whose
    control socket closes) leave within seconds, so a survivor can build
    on the same devices."""
    root = str(Path(__file__).resolve().parent.parent)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in (
        root, os.environ.get("PYTHONPATH", "")) if p)}
    owner = subprocess.Popen([sys.executable, "-c", OWNER], stdout=subprocess.PIPE, env=env,
                             text=True)
    try:
        follower = int(owner.stdout.readline())
        assert not _exited(follower)
        owner.send_signal(signal.SIGKILL)
        owner.wait(10)
        deadline = time.monotonic() + 20
        while not _exited(follower) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert _exited(follower)
    finally:
        owner.kill()
        owner.wait()
