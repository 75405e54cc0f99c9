"""The port's shared engine plane (``tpu_local/pool_rpc.py``): first the
cases of the JAX package's ``tests/unit/test_shared_plane.py`` on the port
(one owner serves the other workers with the tenant carried, failover to a
survivor that builds its own pool, the refusal with no owner, the
provider facade and remote errors, the owner's queue state read by a
non-owner); then the slice as a whole against the JAX planes: three
planes over one bus, whose owner serves a real provider (llama3-test, f32,
CPU), ``TorchLocalProvider`` over ``TorchEngine`` on the JAX engine's
weights (``params_from_jax``) and ``TPULocalProvider`` over ``TPUEngine``:
the forwarded greedy streams are equal token for token, the tenant
reaches the owner's ledger, the survivor of the owner's stop rebuilds and
serves the same stream, and with no owner both refuse with
``LLMUnavailable`` and the same ``retry_after_s``.

The JAX side keeps one ``TPUEngine`` for the module (its compiled
functions are the expensive part); its survivor's factory starts it again
on a fresh KV pool (``_init_kv``), as a rebuilt engine has. The port's
survivor builds a new ``TorchEngine``. Every wait is on a state."""

import asyncio
from types import SimpleNamespace

import jax
import pytest
import torch

from mcp_context_forge_tpu.coordination import hub as jax_hub
from mcp_context_forge_tpu.coordination import rpc as jax_rpc
from mcp_context_forge_tpu.observability import tenant as jax_tenant
from mcp_context_forge_tpu.tpu_local import pool_rpc as jax_plane
from mcp_context_forge_tpu.tpu_local import provider as jax_provider
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu.tpu_local.tpu_provider import TPULocalProvider
from mcp_context_forge_tpu_torch import observability as tenant_ctx
from mcp_context_forge_tpu_torch.coordination import hub as port_hub
from mcp_context_forge_tpu_torch.coordination import rpc as port_rpc
from mcp_context_forge_tpu_torch.coordination.bus import MemoryEventBus
from mcp_context_forge_tpu_torch.coordination.heartbeat import WorkerHeartbeat
from mcp_context_forge_tpu_torch.coordination.leases import MemoryLeaseManager
from mcp_context_forge_tpu_torch.coordination.rpc import BusRpc
from mcp_context_forge_tpu_torch.gateway.flight_recorder import queue_state
from mcp_context_forge_tpu_torch.tpu_local import pool_rpc as port_plane
from mcp_context_forge_tpu_torch.tpu_local import provider as port_provider
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from mcp_context_forge_tpu_torch.tpu_local.pool_rpc import (LEASE_NAME, SharedEnginePlane,
                                                            SharedPoolProvider)
from mcp_context_forge_tpu_torch.tpu_local.provider import LLMError, LLMUnavailable
from mcp_context_forge_tpu_torch.tpu_local.tpu_provider import TorchLocalProvider
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)


class FakeProvider:
    """Engine-pool stand-in recording who served what."""

    def __init__(self, name):
        self.name = name
        self.chats = []
        self.tenants = []
        self.shutdowns = 0

    async def chat(self, request):
        self.chats.append(request)
        self.tenants.append(tenant_ctx.current_tenant())
        return {"id": "c1", "served_by": self.name,
                "choices": [{"message": {"content": "hi"}}]}

    async def chat_stream(self, request):
        self.tenants.append(tenant_ctx.current_tenant())
        for i in range(3):
            yield {"served_by": self.name, "i": i}

    async def embed(self, texts, model=None):
        return [[0.0] * 3 for _ in texts]

    async def classify(self, texts):
        return [0.1 for _ in texts]

    async def models(self):
        return ["fake"]

    async def shutdown(self):
        self.shutdowns += 1


async def _plane(rpc, leases, worker_id, providers, ttl=0.4):
    provider = FakeProvider(worker_id)

    async def factory():
        providers[worker_id] = provider
        return provider

    plane = SharedEnginePlane(rpc, leases, worker_id, factory, lease_ttl=ttl,
                              rpc_timeout_s=5.0, stream_idle_timeout_s=0.5)
    await plane.start()
    return plane


async def _settle(planes, timeout=30.0):
    """Wait until one plane owns a BUILT pool."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        owners = [p for p in planes if p.ready_local]
        if owners:
            return owners[0]
        await asyncio.sleep(0.02)
    raise AssertionError("no plane ever built the pool")


async def _fake_fleet(n, ttl=0.4):
    bus, leases, providers = MemoryEventBus(), MemoryLeaseManager(), {}
    rpcs = [BusRpc(bus, f"w{i}", leases=leases) for i in range(n)]
    beats = [WorkerHeartbeat(leases, f"w{i}", ttl=30.0) for i in range(n)]
    for rpc, beat in zip(rpcs, beats):
        await rpc.start()
        await beat.start()
    planes = [await _plane(rpcs[i], leases, f"w{i}", providers, ttl=ttl) for i in range(n)]
    return SimpleNamespace(bus=bus, leases=leases, providers=providers, rpcs=rpcs,
                           beats=beats, planes=planes)


async def _stop_fleet(fleet):
    for plane in fleet.planes:
        await plane.stop()
    for rpc, beat in zip(fleet.rpcs, fleet.beats):
        await rpc.stop()
        await beat.stop()


async def test_one_owner_serves_remote_workers_with_tenant():
    fleet = await _fake_fleet(3)
    try:
        owner = await _settle(fleet.planes)
        non_owners = [p for p in fleet.planes if p is not owner]
        assert len(fleet.providers) == 1, "only the OWNER builds HBM state"
        assert await fleet.leases.holder(LEASE_NAME) == owner.worker_id
        token = tenant_ctx.set_current_tenant("team:alpha")
        try:
            result = await non_owners[0].chat({"model": "fake"})
        finally:
            tenant_ctx.reset_current_tenant(token)
        assert result["served_by"] == owner.worker_id
        assert fleet.providers[owner.worker_id].tenants[-1] == "team:alpha"
        chunks = [c async for c in non_owners[1].chat_stream({"m": 1})]
        assert [c["i"] for c in chunks] == [0, 1, 2]
        assert chunks[0]["served_by"] == owner.worker_id
        assert await non_owners[0].embed(["x", "y"]) == [[0.0] * 3] * 2
        assert await non_owners[0].classify(["x"]) == [0.1]
        # the owner serves itself locally, without a hop
        assert (await owner.chat({}))["served_by"] == owner.worker_id
        status = await non_owners[0].rpc.call(owner.worker_id, "pool.status", {})
        assert status == {"worker_id": owner.worker_id, "is_owner": True,
                          "provider_ready": True, "models": ["fake"]}
        assert owner.stats()["elections_won"] == 1 and owner.stats()["build_failures"] == 0
    finally:
        await _stop_fleet(fleet)


async def test_leader_failover_survivor_rebuilds_and_serves():
    """The owner stops: its lease goes, a survivor re-elects, builds its
    OWN pool, and requests flow again."""
    fleet = await _fake_fleet(2, ttl=0.3)
    try:
        owner = await _settle(fleet.planes)
        survivor = next(p for p in fleet.planes if p is not owner)
        assert (await survivor.chat({}))["served_by"] == owner.worker_id
        await owner.stop()
        await fleet.rpcs[fleet.planes.index(owner)].stop()
        assert fleet.providers[owner.worker_id].shutdowns == 1
        assert await _settle([survivor], timeout=8.0) is survivor
        assert survivor.elections_won >= 1
        assert len(fleet.providers) == 2, "survivor built a fresh pool"
        assert (await survivor.chat({}))["served_by"] == survivor.worker_id
    finally:
        await _stop_fleet(fleet)


async def test_no_owner_refuses_with_retry_after():
    bus, leases = MemoryEventBus(), MemoryLeaseManager()
    rpc = BusRpc(bus, "w0", leases=leases)
    await rpc.start()

    async def never_factory():
        raise AssertionError("must not build")

    plane = SharedEnginePlane(rpc, leases, "w0", never_factory, lease_ttl=0.2)
    with pytest.raises(LLMUnavailable) as excinfo:   # plane NOT started: no owner anywhere
        await plane.chat({})
    assert excinfo.value.retry_after_s >= 1
    with pytest.raises(LLMUnavailable):
        async for _chunk in plane.chat_stream({}):
            pass
    await rpc.stop()


async def test_failed_build_releases_the_lease_for_a_peer():
    """A worker whose build raises releases ownership; a peer builds."""
    bus, leases, providers = MemoryEventBus(), MemoryLeaseManager(), {}
    rpcs = [BusRpc(bus, f"w{i}", leases=leases) for i in range(2)]
    for rpc in rpcs:
        await rpc.start()

    async def broken():
        raise RuntimeError("no device")

    bad = SharedEnginePlane(rpcs[0], leases, "w0", broken, lease_ttl=0.3)
    await bad.start()
    try:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 10
        while bad.build_failures == 0:
            assert loop.time() < deadline
            await asyncio.sleep(0.01)
        good = await _plane(rpcs[1], leases, "w1", providers, ttl=0.3)
        try:
            assert await _settle([good], timeout=10.0) is good
            assert not bad.ready_local and (await bad.chat({}))["served_by"] == "w1"
        finally:
            await good.stop()
    finally:
        await bad.stop()
        for rpc in rpcs:
            await rpc.stop()


async def test_a_build_longer_than_the_lease_keeps_it():
    """The elector renews while the owner builds (the reference awaits the
    build inside its loop and loses the lease to a peer): a build of three
    TTLs ends with one owner and one pool."""
    bus, leases, providers = MemoryEventBus(), MemoryLeaseManager(), {}
    rpcs = [BusRpc(bus, f"w{i}", leases=leases) for i in range(2)]
    for rpc in rpcs:
        await rpc.start()
    release = asyncio.Event()

    async def slow():
        await release.wait()
        providers["w0"] = FakeProvider("w0")
        return providers["w0"]

    first = SharedEnginePlane(rpcs[0], leases, "w0", slow, lease_ttl=0.3)
    await first.start()
    try:
        while not first._building:
            await asyncio.sleep(0.01)
        second = await _plane(rpcs[1], leases, "w1", providers, ttl=0.3)
        try:
            await asyncio.sleep(0.9)                # three TTLs into the build
            assert await leases.holder(LEASE_NAME) == "w0" and "w1" not in providers
            release.set()
            assert await _settle([first], timeout=5.0) is first
            assert (await second.chat({}))["served_by"] == "w0"
        finally:
            await second.stop()
    finally:
        await first.stop()
        for rpc in rpcs:
            await rpc.stop()


async def test_a_build_that_lost_the_lease_is_shut_down():
    """If the lease went to a peer while the pool was built (the owner's
    renewals failed), the pool built is shut down, not served."""
    bus, leases = MemoryEventBus(), MemoryLeaseManager()
    rpc = BusRpc(bus, "w0", leases=leases)
    await rpc.start()
    release, built = asyncio.Event(), FakeProvider("w0")

    async def slow():
        await release.wait()
        return built

    plane = SharedEnginePlane(rpc, leases, "w0", slow, lease_ttl=30.0)
    await plane.start()
    try:
        while not plane._building:
            await asyncio.sleep(0.01)
        await leases.force_release(LEASE_NAME)
        assert await leases.acquire(LEASE_NAME, "peer", 30.0)
        plane.is_owner = False                      # what its next renewal finds
        release.set()
        while plane._building:
            await asyncio.sleep(0.01)
        assert built.shutdowns == 1 and plane.local_provider is None
        assert not plane.ready_local and await plane.owner() == "peer"
    finally:
        await plane.stop()
        await rpc.stop()


async def test_provider_facade_and_remote_app_errors():
    fleet = await _fake_fleet(2)
    try:
        owner = await _settle(fleet.planes)
        remote = next(p for p in fleet.planes if p is not owner)

        async def bad_chat(request):
            raise LLMError("model 'nope' is not served")

        async def refusing_chat(request):
            raise LLMUnavailable("draining", retry_after_s=4)

        facade = SharedPoolProvider("tpu_local", remote)
        fleet.providers[owner.worker_id].chat = bad_chat
        with pytest.raises(LLMError, match="not served"):
            await facade.chat({"model": "nope"})
        fleet.providers[owner.worker_id].chat = refusing_chat
        with pytest.raises(LLMUnavailable) as excinfo:
            await facade.chat({})
        assert excinfo.value.retry_after_s == 4
        assert facade.provider_type == "tpu_local_shared"
        await facade.shutdown()
        assert not remote.is_owner and remote._task is None
    finally:
        await _stop_fleet(fleet)


async def test_non_owner_queue_state_reads_the_leaders_pool():
    """A non-owner's queue state is the OWNER's (None until read, never a
    worker-local zero), and so is its app's ``queue_state``."""
    fleet = await _fake_fleet(2)
    try:
        owner = await _settle(fleet.planes)
        remote = next(p for p in fleet.planes if p is not owner)
        fleet.providers[owner.worker_id].engine = SimpleNamespace(
            stats=SimpleNamespace(queue_depth=7), config=SimpleNamespace(max_queue=10))
        assert owner.queue_state_sync() == {"depth": 7, "capacity": 10, "saturation": 0.7}
        state = remote.queue_state_sync()
        assert state is None or state["depth"] == 7
        for _ in range(100):
            state = remote.queue_state_sync()
            if state is not None:
                break
            await asyncio.sleep(0.05)
        assert state == {"depth": 7, "capacity": 10, "saturation": 0.7}
        assert queue_state({"engine_plane": remote}) == state
    finally:
        await _stop_fleet(fleet)


async def test_set_role_reaches_the_owners_pool():
    fleet = await _fake_fleet(2)
    try:
        owner = await _settle(fleet.planes)
        remote = next(p for p in fleet.planes if p is not owner)
        calls = []

        def set_role(replica, role):
            calls.append((replica, role))
            if role not in ("prefill", "decode", "any"):
                raise ValueError(f"bad role {role!r}")
            return {"id": replica, "role": role}

        fleet.providers[owner.worker_id].engine = SimpleNamespace(set_role=set_role)
        assert await remote.set_role("0", "prefill") == {"id": "0", "role": "prefill"}
        with pytest.raises(LLMError, match="bad role"):
            await remote.set_role("0", "sideways")
        assert calls == [("0", "prefill"), ("0", "sideways")]
    finally:
        await _stop_fleet(fleet)


# ------------------------------------------------- the slice against JAX

SHAPE = dict(model="llama3-test", max_batch=4, max_seq_len=128, page_size=8, num_pages=64,
             prefill_buckets=(16, 64), dtype="float32", prefix_cache=True)
CHAT_A = {"model": "llama3-test", "max_tokens": 10, "temperature": 0,
          "messages": [{"role": "system", "content": "Be terse."},
                       {"role": "user", "content": "Name a colour."}]}
CHAT_B = {"model": "llama3-test", "max_tokens": 8, "temperature": 0,
          "messages": [{"role": "user", "content": "Count to three."}]}
# long enough that an owner on a loaded box keeps its lease; a stopping
# owner releases it at once
PLANE_TTL = 8.0


class Ledger:
    def __init__(self):
        self.totals = {}

    def add(self, tenant, **counts):
        row = self.totals.setdefault(tenant, {})
        for key, value in counts.items():
            row[key] = row.get(key, 0) + value


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine, its programs compiled before any plane runs: a JAX
    engine traces and compiles holding the GIL, which would stall the
    owner's lease renewals on a loaded box."""
    engine = TPUEngine(JaxConfig(**SHAPE, attn_impl="reference"))

    async def warm():
        await engine.start()
        try:
            provider = TPULocalProvider("warm", engine)
            await provider.chat(dict(CHAT_A))
            [c async for c in provider.chat_stream(dict(CHAT_B))]
        finally:
            await engine.stop()

    asyncio.run(warm())
    return engine


@pytest.fixture(scope="module")
def params(jax_engine):
    return params_from_jax(jax.device_get(jax_engine.params), MODEL_CONFIGS["llama3-test"],
                           device="cpu", dtype=torch.float32)


SIDES = {"jax": SimpleNamespace(hub=jax_hub, rpc=jax_rpc, plane=jax_plane,
                                errors=jax_provider, tenant=jax_tenant),
         "port": SimpleNamespace(hub=port_hub, rpc=port_rpc, plane=port_plane,
                                 errors=port_provider, tenant=tenant_ctx)}


async def run_fleet(side: str, make_provider) -> dict:
    """Three planes of ``side``, each worker on its own connection to a TCP
    hub of that side (every frame JSON on the wire); ``make_provider(ledger,
    served)`` builds an owner's provider (``served`` collects each request
    its engine admits). W0 is elected first; W1 sends CHAT_A as
    ``team:alpha`` (unary) and W2 streams CHAT_B; W0 stops; the survivor
    rebuilds and the non-owner sends CHAT_A again."""
    mods = SIDES[side]
    hub = mods.hub.CoordinationHub("127.0.0.1", 0, secret="plane")
    await hub.start()
    ids = [f"w{i}" for i in range(3)]
    clients = [mods.hub.HubClient("127.0.0.1", hub.bound_port, secret="plane") for _ in ids]
    buses = [mods.hub.TcpEventBus(c) for c in clients]
    for bus in buses:
        await bus.start()
    leases = mods.hub.TcpLeaseManager(clients[0])
    rpc_cls, plane_cls = mods.rpc.BusRpc, mods.plane.SharedEnginePlane
    ledger, served, builds = Ledger(), [], []
    rpcs = [rpc_cls(bus, w, leases=mods.hub.TcpLeaseManager(c), default_timeout_s=60.0)
            for bus, c, w in zip(buses, clients, ids)]

    def factory(worker):
        async def build():
            builds.append(worker)
            return await make_provider(ledger, served)
        return build

    planes = [plane_cls(rpc, rpc.leases, w, factory(w), lease_ttl=PLANE_TTL, rpc_timeout_s=60.0,
                        stream_idle_timeout_s=0.5) for rpc, w in zip(rpcs, ids)]
    for rpc, w in zip(rpcs, ids):
        await rpc.start()
        # the workers' heartbeat leases (the liveness check reads them)
        await leases.acquire(f"worker:{w}", w, 300.0)
    out: dict = {}
    try:
        await planes[0].start()
        assert await _settle(planes[:1]) is planes[0]
        for plane in planes[1:]:
            await plane.start()
        token = mods.tenant.set_current_tenant("team:alpha")
        try:
            reply = await planes[1].chat(dict(CHAT_A))
        finally:
            mods.tenant.reset_current_tenant(token)
        chunks = [c async for c in planes[2].chat_stream(dict(CHAT_B))]
        state = None
        for _ in range(200):
            state = planes[2].queue_state_sync()
            if state is not None:
                break
            await asyncio.sleep(0.02)
        out.update(reply=(reply["choices"], reply["usage"]),
                   chunks=[c["choices"] for c in chunks], queue_state=state,
                   owner_queue_state=planes[0].queue_state_sync(),
                   streams=[(r.prompt_ids, r.generated, r.finish_reason) for r in served],
                   tenants=sorted(ledger.totals),
                   alpha=(ledger.totals["team:alpha"]["requests"],
                          ledger.totals["team:alpha"]["generated_tokens"]))
        # the owner stops (its lease released, its rpc silent)
        await planes[0].stop()
        await rpcs[0].stop()
        await leases.release("worker:w0", "w0")
        new_owner = await _settle(planes[1:])
        other = next(p for p in planes[1:] if p is not new_owner)
        served.clear()
        again = await other.chat(dict(CHAT_A))
        out.update(builds=len(builds), failover_reply=(again["choices"], again["usage"]),
                   failover_streams=[(r.prompt_ids, r.generated) for r in served])
    finally:
        for plane in planes:
            await plane.stop()
        for rpc in rpcs:
            await rpc.stop()
    # no owner anywhere: a plane that never started refuses
    try:
        lone_rpc = rpc_cls(buses[0], "lone", leases=leases)
        await lone_rpc.start()
        lone = plane_cls(lone_rpc, leases, "lone", factory("lone"), lease_ttl=0.5)
        refusals = []
        for call in (lambda: lone.chat(dict(CHAT_A)),
                     lambda: lone.chat_stream(dict(CHAT_B)).__anext__()):
            with pytest.raises(mods.errors.LLMUnavailable) as excinfo:
                await call()
            refusals.append((type(excinfo.value).__name__, excinfo.value.retry_after_s))
        await lone_rpc.stop()
        out["refusals"] = refusals
    finally:
        for bus in buses:
            await bus.stop()
        await hub.stop()
    return out


def test_forwarded_streams_equal_jax(jax_engine, params):
    async def jax_provider_of(ledger, served):
        assert not jax_engine._started, "two owners at once"
        jax_engine._init_kv()            # the rebuilt engine's fresh pool
        jax_engine.ledger = ledger
        submit = TPUEngine.submit.__get__(jax_engine)

        async def recording(request):
            served.append(request)
            return await submit(request)

        jax_engine.submit = recording
        await jax_engine.start()
        return TPULocalProvider("tpu_local", jax_engine)

    async def port_provider_of(ledger, served):
        engine = TorchEngine(EngineConfig(**SHAPE, device="cpu"), params=params, ledger=ledger)
        submit = engine.submit

        async def recording(request):
            served.append(request)
            return await submit(request)

        engine.submit = recording
        await engine.start()
        return TorchLocalProvider("tpu_local", engine)

    try:
        want = asyncio.run(run_fleet("jax", jax_provider_of))
    finally:
        jax_engine.__dict__.pop("submit", None)
    got = asyncio.run(run_fleet("port", port_provider_of))
    assert got == want
    # what the equality covers
    assert [len(g) for _, g, _ in got["streams"]] == [10, 8]
    assert got["tenants"] == ["", "team:alpha"] and got["alpha"] == (1, 10)
    # the non-owner reads the owner's queue (none waiting), not a zero of its own
    assert got["queue_state"] == got["owner_queue_state"]
    assert got["queue_state"]["depth"] == 0 and got["queue_state"]["capacity"] > 0
    assert got["builds"] == 2
    assert got["failover_streams"][0][1] == got["streams"][0][1]   # the same stream
    assert got["failover_reply"] == got["reply"]
    assert got["refusals"] == [("LLMUnavailable", 1), ("LLMUnavailable", 1)]
