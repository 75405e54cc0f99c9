"""The port's fabric publisher (``tpu_local/kv/fabric/publisher.py``) against
the JAX package's, on the CPU:

- the gossip round trip of ``tests/tpu_local/test_kv_fabric.py``
  (``publish_once`` over a bus peer and an HTTP peer, the HTTP reply merged
  back, malformed frames refused, a publisher with no store idle) gives
  the same reports, counters and coverage on both packages' stores;
- the cross-host object hit of the same file, on ``TorchEngine``: host A
  prefills a template whose pages reach the object tier through the real
  spill and write-behind path, its publisher advertises them over
  ``BusRpc`` to host B's ``fabric.advert`` handler, and host B serves the
  match from the object tier. The streams, ``tier_hit_tokens`` and
  ``object_reads`` equal the JAX engines' run of the same steps, the
  conservation law holds with three tiers, the tenant ledger meters the
  hit, and B's stream is a cold engine's; an advert under another
  namespace is merged but covers nothing B may serve."""

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.coordination.bus import MemoryEventBus as JaxBus
from mcp_context_forge_tpu.coordination.rpc import BusRpc as JaxRpc
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu.tpu_local.kv import fabric as jax_fabric
from mcp_context_forge_tpu.tpu_local.kv import prefix_index as jax_prefix
from mcp_context_forge_tpu.tpu_local.kv import tiers as jax_tiers
from mcp_context_forge_tpu_torch.coordination.bus import MemoryEventBus
from mcp_context_forge_tpu_torch.coordination.rpc import BusRpc
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from mcp_context_forge_tpu_torch.tpu_local.kv import fabric as port_fabric
from mcp_context_forge_tpu_torch.tpu_local.kv import prefix_index as port_prefix
from mcp_context_forge_tpu_torch.tpu_local.kv import tiers as port_tiers
from mcp_context_forge_tpu_torch.tpu_local.models import MODEL_CONFIGS
from mcp_context_forge_tpu_torch.tpu_local.models.convert import params_from_jax
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

PS = 16


def _payload(tiers_mod, prefix_mod, chunk, fill=1):
    shape = (2, 4, 2, 8)  # [L, page, KV, hd]
    return tiers_mod.SpilledPage(chunk=tuple(chunk), parent=prefix_mod.ROOT_HASH,
                                 k=np.full(shape, fill, dtype=np.int8),
                                 v=np.full(shape, fill, dtype=np.int8),
                                 k_scales=np.ones((2, 2), dtype=np.float32),
                                 v_scales=np.ones((2, 2), dtype=np.float32))


def _hash(prefix_mod, chunk):
    return prefix_mod.chain_hashes(list(chunk) + [99], 4)[0]


def _drain(store, deadline_s=10):
    deadline = time.monotonic() + deadline_s
    while (not store._writeq.empty() or store._pending) and time.monotonic() < deadline:
        time.sleep(0.01)


def gossip_round_trip(tmp_path, side: str) -> list:
    """The JAX test's publisher gossip on one package's stores."""
    tiers_mod, prefix_mod, fabric_mod = {
        "jax": (jax_tiers, jax_prefix, jax_fabric),
        "port": (port_tiers, port_prefix, port_fabric)}[side]
    extra = {"pin": False} if side == "jax" else {}

    def store():
        one = _payload(tiers_mod, prefix_mod, (0,) * 4).nbytes
        return tiers_mod.TieredPageStore(
            host_bytes=one + 1, disk_bytes=0,
            object_store=fabric_mod.FileObjectStore(str(tmp_path / side / "bucket")),
            object_namespace="shared", **extra)

    a, b = store(), store()
    try:
        chunk = tuple(range(4))
        h = _hash(prefix_mod, chunk)
        a.put(h, _payload(tiers_mod, prefix_mod, chunk))
        other = (50, 51, 52, 53)
        a.put(_hash(prefix_mod, other), _payload(tiers_mod, prefix_mod, other))
        _drain(a)                      # displacement pushed h to the object tier
        pub_b = fabric_mod.FabricIndexPublisher(b, "hostB", ttl_s=60.0)
        calls = []

        class _Rpc:
            async def call(self, worker, method, params, timeout_s=0):
                calls.append((worker, method))
                return await pub_b.handle_advert(params)

        async def post_json(url, payload):
            assert url.endswith("/admin/fabric/adverts")
            return await pub_b.handle_advert(payload)

        pub_a = fabric_mod.FabricIndexPublisher(
            a, "hostA", rpc=_Rpc(), bus_peers=lambda: ["hostA", "w2"],
            http_peers=["http://peer-b:4444/"], post_json=post_json, ttl_s=60.0)
        report = asyncio.run(pub_a.publish_once())
        out = [report, calls, b.fabric.covers(h, "shared"), b.probe(h),
               pub_a.stats()["sent"], pub_b.merged_in]
        with pytest.raises(ValueError):
            asyncio.run(pub_b.handle_advert({"nope": 1}))
        idle = fabric_mod.FabricIndexPublisher(lambda: None, "hostC")
        out.append(asyncio.run(idle.publish_once()))
        # a failing peer is counted, not raised
        async def down(url, payload):
            raise ConnectionError("peer down")

        flaky = fabric_mod.FabricIndexPublisher(a, "hostA", http_peers=["http://gone:1/"],
                                                post_json=down, ttl_s=60.0)
        out += [asyncio.run(flaky.publish_once()), flaky.send_failures]
        stats = {k: v for k, v in pub_a.stats().items() if k != "http_peers"}
        out.append(stats)
        return out
    finally:
        a.close()
        b.close()


def test_publisher_gossip_round_trip_equals_jax(tmp_path):
    want, got = gossip_round_trip(tmp_path, "jax"), gossip_round_trip(tmp_path, "port")
    assert got == want
    assert got[:6] == [{"sent": 2, "hashes": 1}, [("w2", "fabric.advert")], True, True, 2, 1]
    assert got[6] == {"sent": 0, "hashes": 0} and got[7:9] == [{"sent": 0, "hashes": 1}, 1]
    assert port_fabric.ADVERT_METHOD == jax_fabric.publisher.ADVERT_METHOD == "fabric.advert"


# --------------------------------- the cross-host object hit on the engines

TEMPLATE = list(range(3, 36))              # two full pages and a tail


class Ledger:
    def __init__(self):
        self.rows = {}

    def add(self, tenant, **counts):
        row = self.rows.setdefault(tenant, {})
        for key, value in counts.items():
            row[key] = row.get(key, 0) + value


def _config(url, prefix_cache=True):
    return dict(model="llama3-test", max_batch=2, max_seq_len=128, page_size=PS,
                num_pages=12, prefill_buckets=(16, 64), dtype="float32",
                prefix_cache=prefix_cache, prefix_tiers=prefix_cache, tier_host_bytes=1 << 30,
                tier_disk_bytes=0, tier_spill_quant="", tier_object_url=url)


async def _gen(engine, ids, n=6, **kw):
    return [t async for t in engine.generate(ids, max_tokens=n, **kw)]


async def cross_host(make_engine, rpc_cls, bus_cls, fabric_mod, advert_tenant="shared"):
    """Host A serves TEMPLATE and pushes its pages to the object tier; A's
    publisher advertises them (``publish_once`` over bus RPC) to host B's
    ``fabric.advert`` handler; B serves TEMPLATE. Both stay up meanwhile."""
    ledger = Ledger()
    host_a, host_b = make_engine(), make_engine(ledger=ledger)
    await host_a.start()
    await host_b.start()
    bus = bus_cls()
    rpcs = [rpc_cls(bus, "hostA", default_timeout_s=10.0),
            rpc_cls(bus, "hostB", default_timeout_s=10.0)]
    try:
        out_a = await _gen(host_a, TEMPLATE + [40])
        store_a, store_b = host_a._tier_client.store, host_b._tier_client.store
        local = host_a.allocator
        saved, local._free = local._free, []
        while local._walk_prefix(TEMPLATE + [88]):
            saved.append(local._take_page())
        local._free = saved
        with store_a._lock:
            for key_hash in list(store_a._host):
                payload = store_a._host.pop(key_hash)
                store_a._host_nbytes -= payload.nbytes
                store_a._pending[key_hash] = payload
                store_a._writeq.put(key_hash)
        store_a._ensure_writer()
        deadline = time.monotonic() + 20
        while store_a.stats()["object_pages"] < 2 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        pub_a = fabric_mod.FabricIndexPublisher(store_a, "hostA", rpc=rpcs[0],
                                                bus_peers=lambda: ["hostA", "hostB"])
        pub_b = fabric_mod.FabricIndexPublisher(lambda: store_b, "hostB", rpc=rpcs[1])
        if advert_tenant != "shared":
            store_a.object_namespace = advert_tenant   # a planted fault: the wrong tenant
        rpcs[1].register("fabric.advert", pub_b.handle_advert)
        for rpc in rpcs:
            await rpc.start()
        report = await pub_a.publish_once()
        out_b = await _gen(host_b, TEMPLATE + [40], tenant="team:x")
        alloc = host_b.allocator
        return {"out_a": out_a, "out_b": out_b, "report": report,
                "object_pages": store_a.stats()["object_pages"],
                "tier_hit_tokens": dict(alloc.tier_hit_tokens),
                "prefix_hit_tokens": alloc.prefix_hit_tokens,
                "object_reads": store_b.stats()["object_reads"],
                "merged_in": pub_b.merged_in,
                "cache_hit_tokens": ledger.rows.get("team:x", {}).get("cache_hit_tokens", 0)}
    finally:
        for rpc in rpcs:
            await rpc.stop()
        await host_a.stop()
        await host_b.stop()


@pytest.fixture(scope="module")
def jax_result(tmp_path_factory):
    url = f"file://{tmp_path_factory.mktemp('jax')}/bucket"

    def make(ledger=None):
        return TPUEngine(JaxConfig(**_config(url), attn_impl="reference"), ledger=ledger)

    engines = []

    def tracked(ledger=None):
        engines.append(make(ledger))
        return engines[-1]

    result = asyncio.run(cross_host(tracked, JaxRpc, JaxBus, jax_fabric))
    return result, engines[0].params


@pytest.mark.parametrize("advert_tenant", ["shared", "team-b"])
def test_cross_host_object_hit_equals_jax(tmp_path, jax_result, advert_tenant):
    want, jax_params = jax_result
    url = f"file://{tmp_path}/bucket"
    params = params_from_jax(jax.device_get(jax_params), MODEL_CONFIGS["llama3-test"],
                             device="cpu", dtype=torch.float32)

    def make(ledger=None, prefix_cache=True):
        return TorchEngine(EngineConfig(**_config(url, prefix_cache), device="cpu"),
                           params=params, ledger=ledger)

    got = asyncio.run(cross_host(make, BusRpc, MemoryEventBus, port_fabric, advert_tenant))
    cold = make(prefix_cache=False)

    async def cold_run():
        await cold.start()
        try:
            return await _gen(cold, TEMPLATE + [40])
        finally:
            await cold.stop()

    assert got["out_b"] == got["out_a"] == asyncio.run(cold_run())
    if advert_tenant == "shared":
        assert got == want
        assert got["report"] == {"sent": 1, "hashes": got["object_pages"]}
        assert got["object_pages"] >= 2 and got["merged_in"] == got["object_pages"]
        hits = got["tier_hit_tokens"]
        assert hits["object"] == 2 * PS and got["object_reads"] >= 2
        assert set(hits) == {"hbm", "host", "disk", "object"}
        assert sum(hits.values()) == got["prefix_hit_tokens"] == got["cache_hit_tokens"]
    else:
        # the advert crossed, but under another tenant's namespace: B's
        # probe for its own namespace misses, and B prefills cold
        assert got["merged_in"] == got["object_pages"] >= 2
        assert got["tier_hit_tokens"]["object"] == 0 and got["object_reads"] == 0
        assert got["prefix_hit_tokens"] == 0
