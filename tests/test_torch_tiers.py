"""The port's spill tiers, prefix index and cache fabric against the JAX
package's, on the CPU: every scenario runs alike through the reference
classes and the port's (each with its own fault plane and breakers) and
gives the same results and stats dicts.

- chain hashes are byte-identical (sha256 over the parent digest and the
  chunk as int64 bytes);
- ``PrefixIndex`` locations and reachability;
- ``TieredPageStore``: put/get/probe, the host budget, the disk write-behind
  and re-onlining, identity verification (a collision is a miss and the
  entry is dropped), and the fault cases of the reference's disk I/O
  hardening (``tier.disk.write``, ``tier.disk.read``, ``tier.host.get``);
- ``FileObjectStore`` keys, the traversal rejection, the object tier's
  cross-store fetch, its verify gate and tenant namespaces;
- ``FabricIndex`` merge, TTL, tenant isolation and the wire adverts;
- the allocator's tier paths (spill on eviction, the probe capped by what
  a match can restore, fetch-on-miss, the per-tier hit split) over a
  stand-in device, and the hash-free walk without tiers;
- ``pin_host``: a CPU engine's array as it is, a CUDA engine's pinned or
  an error, never pageable memory.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcp_context_forge_tpu.observability import degradation as jax_degradation
from mcp_context_forge_tpu.observability import faults as jax_faults
from mcp_context_forge_tpu.tpu_local.kv import paged_cache as jax_paged
from mcp_context_forge_tpu.tpu_local.kv import prefix_index as jax_prefix
from mcp_context_forge_tpu.tpu_local.kv import tiers as jax_tiers
from mcp_context_forge_tpu.tpu_local.kv.fabric import index as jax_fabric_index
from mcp_context_forge_tpu.tpu_local.kv.fabric import object_store as jax_objects
from mcp_context_forge_tpu_torch.observability import degradation as port_degradation
from mcp_context_forge_tpu_torch.observability import faults as port_faults
from mcp_context_forge_tpu_torch.tpu_local.kv import paged_cache as port_paged
from mcp_context_forge_tpu_torch.tpu_local.kv import prefix_index as port_prefix
from mcp_context_forge_tpu_torch.tpu_local.kv import tiers as port_tiers
from mcp_context_forge_tpu_torch.tpu_local.kv.fabric import index as port_fabric_index
from mcp_context_forge_tpu_torch.tpu_local.kv.fabric import object_store as port_objects

SIDES = {
    "jax": SimpleNamespace(tiers=jax_tiers, prefix=jax_prefix, faults=jax_faults,
                           degradation=jax_degradation, index=jax_fabric_index,
                           objects=jax_objects, paged=jax_paged,
                           store_kwargs={"pin": False}),
    "port": SimpleNamespace(tiers=port_tiers, prefix=port_prefix, faults=port_faults,
                            degradation=port_degradation, index=port_fabric_index,
                            objects=port_objects, paged=port_paged,
                            store_kwargs={}),
}


@pytest.fixture(autouse=True)
def hermetic():
    """Both packages' fault planes and breakers start and end clean."""
    for side in SIDES.values():
        side.degradation.configure_degradation()
    yield
    for side in SIDES.values():
        side.faults.configure_fault_plane(False)
        side.degradation.configure_degradation()


def alike(scenario, *args):
    """Run ``scenario(side, *args)`` on both sides; their results must be
    equal. Returns the port's."""
    want = scenario(SIDES["jax"], *args)
    got = scenario(SIDES["port"], *args)
    assert got == want
    return got


def payload(side, chunk, parent=None, fill=1):
    shape = (2, 4, 2, 8)  # [L, page, KV, hd]
    return side.tiers.SpilledPage(
        chunk=tuple(chunk), parent=side.prefix.ROOT_HASH if parent is None else parent,
        k=np.full(shape, fill, dtype=np.int8), v=np.full(shape, fill, dtype=np.int8),
        k_scales=np.ones((2, 2), dtype=np.float32),
        v_scales=np.ones((2, 2), dtype=np.float32))


def key_of(side, chunk):
    return side.prefix.chain_hashes(list(chunk) + [99], 4)[0]


def store(side, **kwargs):
    return side.tiers.TieredPageStore(**{**side.store_kwargs, **kwargs})


def one_page(side) -> int:
    return payload(side, (0,) * 4).nbytes


def drain(st, deadline_s=10):
    deadline = time.monotonic() + deadline_s
    while (not st._writeq.empty() or st._pending) and time.monotonic() < deadline:
        time.sleep(0.01)


def arm(side, **rule):
    plane = side.faults.configure_fault_plane(True)
    plane.arm(side.faults.FaultRule(**rule))
    return plane


def got_page(hit):
    """A hit as plain values: (tier, chunk, first K value), or None."""
    if hit is None:
        return None
    page, tier = hit
    return tier, page.chunk, int(np.asarray(page.k)[0, 0, 0, 0])


# ------------------------------------------------------------- chain hashes

def test_chain_hashes_are_byte_identical():
    rng = np.random.default_rng(0)
    for n, page in ((1, 4), (33, 16), (200, 16), (129, 128), (1000, 7)):
        prompt = [int(t) for t in rng.integers(0, 50_000, n)]
        assert port_prefix.chain_hashes(prompt, page) == jax_prefix.chain_hashes(prompt, page)
        assert port_prefix.chain_pages(prompt, page) == jax_prefix.chain_pages(prompt, page)
    assert port_prefix.ROOT_HASH == jax_prefix.ROOT_HASH
    chunk = np.arange(16, dtype=np.int32)   # numpy ids hash as int64 too
    assert (port_prefix.chain_hash(port_prefix.ROOT_HASH, chunk)
            == jax_prefix.chain_hash(jax_prefix.ROOT_HASH, list(range(16))))


def test_prefix_index_locations_and_reachability():
    def scenario(side):
        index = side.prefix.PrefixIndex()
        prompt = list(range(33))            # 2 matchable pages at 16
        hashes = side.prefix.chain_hashes(prompt, 16)
        out = []
        for h in hashes:
            index.publish_hbm(h, "1")
        chain = index.chain_locations(prompt, 16)
        out.append([index.reachable_tokens(chain, r, 16) for r in ("0", "1")])
        index.unpublish_hbm(hashes[0], "1")
        index.publish_tier(hashes[0], "host")
        index.publish_object(hashes[1], "ns/x.npz")
        chain = index.chain_locations(prompt, 16)
        out.append([index.reachable_tokens(chain, r, 16) for r in ("0", "1")])
        loc = index.locations(hashes[1])
        out.append((sorted(loc["hbm"]), sorted(loc["tiers"]), loc["object"]))
        index.drop_replica("1")
        index.unpublish_object(hashes[1])
        index.unpublish_tier(hashes[0], "disk")   # not there: a no-op
        chain = index.chain_locations(prompt, 16)
        out.append([index.reachable_tokens(chain, r, 16) for r in ("0", "1")])
        return out, index.stats()

    out, stats = alike(scenario)
    assert out[0] == [0, 32] and out[1] == [32, 32] and out[3] == [16, 16]
    assert stats == {"keys_hbm": 0, "keys_tiered": 1, "keys_object": 0}


# ----------------------------------------------------------------- the store

def test_store_put_get_verifies_identity_and_counts():
    def scenario(side):
        st = store(side, host_bytes=1 << 20, disk_bytes=0)
        try:
            chunk = tuple(range(4))
            h = key_of(side, chunk)
            st.put(h, payload(side, chunk))
            st.put(h, payload(side, chunk, fill=9))    # a duplicate: no-op
            out = [st.probe(h), got_page(st.get(h, side.prefix.ROOT_HASH, chunk))]
            # another chunk (or parent) under the same key is a collision:
            # a miss, and the entry is dropped so no probe promises it
            out.append(st.get(h, side.prefix.ROOT_HASH, (9, 9, 9, 9)))
            out.append((st.collisions, st.probe(h)))
            st.put(h, payload(side, chunk))
            out.append(st.get(h, b"\x00" * 32, chunk))
            out.append((st.collisions, st.probe(h)))
            return out, st.stats()
        finally:
            st.close()

    out, stats = alike(scenario)
    assert out[1] == ("host", (0, 1, 2, 3), 1) and out[3] == (1, False)
    assert stats["dropped"] == 2 and stats["spilled"] == 2


def test_store_disk_writeback_and_reonline():
    """T1 overflow goes to the write-behind worker; a disk hit re-onlines
    into T1 with the payload as it was."""
    def scenario(side):
        st = store(side, host_bytes=one_page(side) + 1, disk_bytes=1 << 20)
        try:
            chunks = [tuple(range(i, i + 4)) for i in range(0, 12, 4)]
            hashes = [key_of(side, c) for c in chunks]
            for h, c in zip(hashes, chunks):
                st.put(h, payload(side, c, fill=c[0] + 1))
            drain(st)
            before = st.stats()
            hit = got_page(st.get(hashes[0], side.prefix.ROOT_HASH, chunks[0]))
            drain(st)
            return before, hit, st.stats()
        finally:
            st.close()

    before, hit, after = alike(scenario)
    assert before["disk_pages"] == 2 and before["disk_writes"] == 2
    assert hit == ("disk", (0, 1, 2, 3), 1)
    # re-onlined into T1, which displaced its one entry to disk
    assert after["disk_reads"] == 1 and after["host_pages"] == 1
    assert after["disk_pages"] == 3


def test_store_disk_budget_drops_oldest():
    def scenario(side):
        one = one_page(side)
        st = store(side, host_bytes=one + 1, disk_bytes=2 * one + 1)
        try:
            chunks = [tuple(range(i, i + 4)) for i in range(0, 24, 4)]
            for c in chunks:
                st.put(key_of(side, c), payload(side, c))
            drain(st)
            return st.stats()
        finally:
            st.close()

    stats = alike(scenario)
    assert stats["disk_pages"] == 2 and stats["dropped"] == 3


# ------------------------------------------- disk and host I/O fault cases

def spill_three(side, st):
    """Three one-page spills into a T1 sized for one page: two overflow to
    the write-behind worker."""
    chunks = [tuple(range(i, i + 4)) for i in range(0, 12, 4)]
    hashes = [key_of(side, c) for c in chunks]
    for h, c in zip(hashes, chunks):
        st.put(h, payload(side, c, fill=c[0] + 1))
    return hashes, chunks


def disk_write_fault_quarantines(side):
    """A persistent write error exhausts the retries, drops the entry to
    a clean miss, counts it and opens the tier.disk breaker; T1 serves."""
    arm(side, point="tier.disk.write", kind="error", mode="always")
    st = store(side, host_bytes=one_page(side) + 1, disk_bytes=1 << 20,
               io_retry_max=1, io_retry_backoff_ms=1.0)
    try:
        hashes, chunks = spill_three(side, st)
        drain(st)
        root = side.prefix.ROOT_HASH
        return (st.stats(), side.degradation.get_degradation().component_state("tier.disk"),
                got_page(st.get(hashes[-1], root, chunks[-1])),
                got_page(st.get(hashes[0], root, chunks[0])))
    finally:
        st.close()


def disk_write_transient_fault_recovers(side):
    arm(side, point="tier.disk.write", kind="error", mode="one_in_n", n=2)
    st = store(side, host_bytes=one_page(side) + 1, disk_bytes=1 << 20,
               io_retry_max=2, io_retry_backoff_ms=1.0)
    try:
        spill_three(side, st)
        drain(st)
        return st.stats()
    finally:
        st.close()


def disk_breaker_half_open_recovers(side):
    arm(side, point="tier.disk.write", kind="error", mode="always")
    st = store(side, host_bytes=one_page(side) + 1, disk_bytes=1 << 20,
               io_retry_max=0, io_retry_backoff_ms=1.0)
    try:
        spill_three(side, st)
        drain(st)
        opened = st.stats()["disk_breaker"]["state"]
        side.faults.get_fault_plane().disarm("tier.disk.write")
        time.sleep(0.06)                     # the cooldown elapses
        for c in [tuple(range(i, i + 4)) for i in range(100, 112, 4)]:
            st.put(key_of(side, c), payload(side, c))
        drain(st)
        transitions = [t["to"] for t in
                       side.degradation.get_degradation().transitions("tier.disk")]
        return opened, st.stats(), transitions[:3]
    finally:
        st.close()


def disk_read_fault_is_a_clean_miss(side):
    arm(side, point="tier.disk.read", kind="error", mode="always")
    st = store(side, host_bytes=one_page(side) + 1, disk_bytes=1 << 20,
               io_retry_max=1, io_retry_backoff_ms=1.0)
    try:
        hashes, chunks = spill_three(side, st)
        drain(st)
        miss = st.get(hashes[0], side.prefix.ROOT_HASH, chunks[0])
        return miss, st.stats()
    finally:
        st.close()


def disk_read_corruption_quarantines(side):
    arm(side, point="tier.disk.read", kind="corrupt", mode="once")
    st = store(side, host_bytes=one_page(side) + 1, disk_bytes=1 << 20,
               io_retry_max=3, io_retry_backoff_ms=1.0)
    try:
        hashes, chunks = spill_three(side, st)
        drain(st)
        root = side.prefix.ROOT_HASH
        return (st.get(hashes[0], root, chunks[0]), st.stats()["io_errors"],
                got_page(st.get(hashes[1], root, chunks[1])))
    finally:
        st.close()


def host_get_fault_degrades_to_miss(side):
    st = store(side, host_bytes=1 << 20, disk_bytes=0)
    try:
        chunk = tuple(range(4))
        h = key_of(side, chunk)
        root = side.prefix.ROOT_HASH
        st.put(h, payload(side, chunk))
        plane = arm(side, point="tier.host.get", kind="error", mode="once")
        out = [st.get(h, root, chunk), st.stats()["io_errors"]["host.get"],
               got_page(st.get(h, root, chunk))]
        plane.arm(side.faults.FaultRule(point="tier.host.get", kind="corrupt", mode="once"))
        out += [st.get(h, root, chunk), st.probe(h)]
        return out, st.stats()
    finally:
        st.close()


FAULT_CASES = {f.__name__: f for f in (
    disk_write_fault_quarantines, disk_write_transient_fault_recovers,
    disk_breaker_half_open_recovers, disk_read_fault_is_a_clean_miss,
    disk_read_corruption_quarantines, host_get_fault_degrades_to_miss)}


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_io_fault_cases_alike(case):
    for side in SIDES.values():
        side.degradation.configure_degradation(failure_threshold=2, cooldown_s=0.05)
    got = alike(FAULT_CASES[case])
    if case == "disk_write_fault_quarantines":
        stats, state, newest, oldest = got
        assert stats["disk_pages"] == 0 and stats["io_errors"]["disk.write"] == 2
        assert stats["disk_breaker"]["state"] == state == "open"
        assert newest is not None and oldest is None
    elif case == "disk_write_transient_fault_recovers":
        assert got["disk_pages"] == 2 and got["io_errors"]["disk.write"] == 0
    elif case == "disk_breaker_half_open_recovers":
        assert got[0] == "open" and got[1]["disk_breaker"]["state"] == "closed"
        assert got[2] == ["open", "half_open", "closed"]
    elif case == "disk_read_fault_is_a_clean_miss":
        assert got[0] is None and got[1]["io_errors"]["disk.read"] == 1
        assert got[1]["disk_pages"] == 1
    elif case == "disk_read_corruption_quarantines":
        assert got[0] is None and got[1]["disk.read"] == 1 and got[2] is not None
    else:
        out, _ = got
        assert out == [None, 1, ("host", (0, 1, 2, 3), 1), None, False]


# ---------------------------------------------------------- the object tier

def test_file_object_store_put_get_delete(tmp_path):
    def scenario(side, root):
        st = side.objects.FileObjectStore(str(root / side.tiers.__name__))
        out = [st.get("ns/missing.npz")]
        st.put("ns/a.npz", b"payload")
        out.append(st.get("ns/a.npz"))
        st.put("ns/a.npz", b"replaced")
        out.append(st.get("ns/a.npz"))
        st.delete("ns/a.npz")
        st.delete("ns/a.npz")
        out.append(st.get("ns/a.npz"))
        return out, st.stats()["backend"]

    out, backend = alike(scenario, tmp_path)
    assert out == [None, b"payload", b"replaced", None] and backend == "file"


@pytest.mark.parametrize("bad", ["", "../escape", "a/../b", "a//b", "/abs", "a b",
                                 "a\x00b", "ns/"])
def test_object_keys_reject_traversal_and_junk(bad):
    for side in SIDES.values():
        with pytest.raises(ValueError):
            side.objects._check_key(bad)
    assert port_objects._check_key("ns/abc.npz") == "ns/abc.npz"


def test_build_object_store_schemes(tmp_path):
    for name, side in SIDES.items():
        assert isinstance(side.objects.build_object_store(f"file://{tmp_path}/{name}"),
                          side.objects.FileObjectStore)
        for bad in ("s3://nope/unsupported", "gcs://bucket/prefix"):
            if bad.startswith("gcs") and side.objects.gcs_available():
                continue
            with pytest.raises(ValueError):
                side.objects.build_object_store(bad)
        assert side.objects.object_store_or_none("") is None
        assert side.objects.object_store_or_none("s3://nope") is None


def object_store_of(side, root, namespace="shared", **kwargs):
    return store(side, host_bytes=one_page(side) + 1, disk_bytes=0,
                 object_store=side.objects.FileObjectStore(str(root)),
                 object_namespace=namespace, **kwargs)


def test_object_writeback_and_cross_store_fetch(tmp_path):
    """Displaced T1 pages land in the object store; a second store that
    shares only the backend serves them once it merges the first's
    advert, and re-onlines them."""
    def scenario(side, root):
        bucket = root / f"cross-{side.tiers.__name__}"
        a, b = object_store_of(side, bucket), object_store_of(side, bucket)
        try:
            chunks = [tuple(range(i, i + 4)) for i in range(0, 12, 4)]
            hashes = [key_of(side, c) for c in chunks]
            for h, c in zip(hashes, chunks):
                a.put(h, payload(side, c, fill=c[0] + 1))
            drain(a)
            out = [sorted(h.hex() for h in a.object_hashes()), b.probe(hashes[0])]
            out.append(b.fabric.merge(side.index.FabricAdvert(
                tenant="shared", host="hostA", hashes=a.object_hashes())))
            out.append(b.probe(hashes[0]))
            out.append(got_page(b.get(hashes[0], side.prefix.ROOT_HASH, chunks[0])))
            out.append(hashes[0] in b.object_hashes())
            stats = {k: v for k, v in b.stats().items() if k not in ("object_url",)}
            stats["fabric"] = {k: v for k, v in stats["fabric"].items()}
            return out, stats
        finally:
            a.close()
            b.close()

    out, stats = alike(scenario, tmp_path)
    assert out[1] is False and out[2] == 2 and out[3] is True
    assert out[4] == ("object", (0, 1, 2, 3), 1) and out[5] is True
    assert stats["object_reads"] == 1 and stats["host_pages"] == 1


def test_object_hit_verify_gate_and_tenant_namespaces(tmp_path):
    """A wrong chunk under an advertised hash is a miss, the blob is
    deleted and the advert invalidated; another namespace can neither see
    nor reach a page over the same backend."""
    def scenario(side, root):
        bucket = root / f"gate-{side.tiers.__name__}"
        a, b = object_store_of(side, bucket, "team-a"), object_store_of(side, bucket, "team-a")
        other = object_store_of(side, bucket, "team-b")
        try:
            chunk, filler = tuple(range(4)), (50, 51, 52, 53)
            h = key_of(side, chunk)
            a.put(h, payload(side, chunk))
            a.put(key_of(side, filler), payload(side, filler))
            drain(a)
            root_hash = side.prefix.ROOT_HASH
            other.fabric.merge(side.index.FabricAdvert(tenant="team-b", host="A", hashes=[h]))
            out = [other.get(h, root_hash, chunk)]
            b.fabric.merge(side.index.FabricAdvert(tenant="team-a", host="A", hashes=[h]))
            out.append(b.get(h, root_hash, (9, 9, 9, 9)))
            out.append((b.collisions, b.probe(h), b.fabric.stats()["invalidated"]))
            out.append(a.object_store.get(a._object_key(h)))
            return out
        finally:
            for st in (a, b, other):
                st.close()

    assert alike(scenario, tmp_path) == [None, None, (1, False, 1), None]


# ------------------------------------------------------------- fabric index

def test_fabric_index_merge_ttl_and_first_registration_wins():
    def scenario(side):
        clock = [100.0]
        idx = side.index.FabricIndex(default_ttl_s=10.0, clock=lambda: clock[0])
        h1, h2 = b"\x01" * 32, b"\x02" * 32
        out = [idx.merge(side.index.FabricAdvert(tenant="t", host="A", hashes=[h1, h2]))]
        out.append((idx.covers(h1, "t"), idx.lookup(h1, "t")))
        clock[0] = 105.0
        out.append(idx.merge(side.index.FabricAdvert(tenant="t", host="B", hashes=[h1])))
        out.append((idx.lookup(h1, "t"), idx.refreshed))
        clock[0] = 111.0
        out.append((idx.covers(h2, "t"), idx.covers(h1, "t")))
        out.append([a.to_wire() for a in idx.adverts("relay")])
        clock[0] = 120.0
        out.append(idx.sweep())
        return out, idx.stats()

    out, stats = alike(scenario)
    assert out[:5] == [2, (True, "A"), 0, ("A", 1), (False, True)]
    assert stats["keys"] == 0 and stats["expired"] == 2


def test_fabric_index_tenant_isolation_and_wire():
    def scenario(side):
        idx = side.index.FabricIndex(default_ttl_s=60.0)
        h = b"\x0a" * 32
        idx.merge(side.index.FabricAdvert(tenant="team-a", host="A", hashes=[h]))
        out = [idx.covers(h, "team-a"), idx.covers(h, "team-b"), idx.lookup(h, "team-b"),
               idx.hashes("team-a"), idx.hashes("team-b")]
        idx.invalidate(h, "team-b")
        out.append(idx.covers(h, "team-a"))
        idx.invalidate(h, "team-a")
        out += [idx.covers(h, "team-a"), idx.invalidated]
        advert = side.index.FabricAdvert(tenant="t", host="A", hashes=[b"\x03" * 32], ttl_s=5.0)
        out.append(side.index.FabricAdvert.from_wire(advert.to_wire()) == advert)
        for bad in ("not a dict", {"tenant": "t"}, {"tenant": "t", "host": ""},
                    {"tenant": "t", "host": "A", "hashes": ["zz"]},
                    {"tenant": "t", "host": "A", "hashes": ["ab"]}):
            with pytest.raises(ValueError):
                side.index.FabricAdvert.from_wire(bad)
        big = {"tenant": "t", "host": "A",
               "hashes": [bytes([i % 256]).hex() * 32
                          for i in range(side.index.MAX_ADVERT_HASHES + 5)]}
        out.append(len(side.index.FabricAdvert.from_wire(big).hashes))
        out.append(side.index.merge_wire_adverts(idx, [advert.to_wire()]))
        return out, idx.stats()

    out, _ = alike(scenario)
    assert out[:8] == [True, False, None, [b"\x0a" * 32], [], True, False, 1]
    assert out[9] == port_fabric_index.MAX_ADVERT_HASHES and out[10] == 1


# ---------------------------------------------------------- the allocator

class FakeTiers:
    """A TierClient stand-in recording spills; probes and restores miss."""

    active = True

    def __init__(self):
        self.spilled: list[int] = []

    def probe(self, key_hash):
        return False

    def spill(self, key_hash, parent, chunk, page):
        self.spilled.append(page)
        return True

    def restore(self, key_hash, parent, chunk, page):
        return None

    def publish_hbm(self, key_hash):
        pass

    def unpublish_hbm(self, key_hash):
        pass


def test_eviction_never_takes_a_page_in_use():
    """Pages held by slots never spill: pressure fails the allocation,
    and only ref == 0 resident pages are reclaimed (and spilled)."""
    def scenario(side):
        tiers = FakeTiers()
        alloc = side.paged.PageAllocator(num_pages=8, page_size=4, max_slots=4,
                                         max_pages_per_slot=8, tiers=tiers)
        prompt = list(range(12))
        out = [alloc.allocate_slot(0, 13)]
        alloc.register_prefix(0, prompt)
        hist, shared = alloc.match_prefix(prompt + [50])
        out += [hist, alloc.allocate_slot(1, 13, prefix_pages=shared),
                alloc.allocate_slot(2, 12), list(tiers.spilled)]
        alloc.free_slot(1)
        out += [alloc.allocate_slot(2, 16), list(tiers.spilled)]
        alloc.free_slot(0)
        out += [alloc.allocate_slot(2, 24), list(tiers.spilled)]
        return out, alloc.tier_hits, alloc.tier_hit_tokens

    out, hits, tokens = alike(scenario)
    assert out[:6] == [True, 12, True, False, [], False] and len(out[-1]) >= 2
    assert hits["hbm"] == 3 and tokens["hbm"] == 12


class Pool:
    """A stand-in device pool for ``TierClient``: one int8 array per page,
    read and written by page index (what the engine's I/O does on the
    card's pages)."""

    def __init__(self, side, pages: int):
        self.side = side
        self.k = np.zeros((pages, 2, 4, 2, 8), dtype=np.int8)

    def read(self, page):
        return self.side.tiers.SpilledPage(
            chunk=(), parent=b"", k=self.k[page].copy(), v=-self.k[page],
            k_scales=np.ones((2, 2), np.float32), v_scales=np.ones((2, 2), np.float32))

    def write(self, page, payload):
        self.k[page] = payload.k


def test_spill_on_evict_and_fetch_on_miss():
    """A prefix evicted under pressure spills; a later prompt sharing it
    restores it into fresh pages (fetch-on-miss) with its bytes; the probe
    never promises more than the free and evictable pages can restore;
    the hits split by tier and sum to prefix_hit_tokens."""
    def scenario(side):
        st = store(side, host_bytes=1 << 20, disk_bytes=0)
        client = side.tiers.TierClient("0", store=st)
        pool = Pool(side, 6)
        client.read_fn, client.write_fn = pool.read, pool.write
        alloc = side.paged.PageAllocator(num_pages=6, page_size=4, max_slots=2,
                                         max_pages_per_slot=4, tiers=client)
        a, b = list(range(100, 109)), list(range(200, 215))
        try:
            assert alloc.allocate_slot(0, len(a))
            for i, page in enumerate(alloc._slots[0]):
                pool.k[page] = i + 1                  # the prompt's "KV"
            alloc.register_prefix(0, a)
            alloc.free_slot(0)                        # 2 registered pages stay
            assert alloc.allocate_slot(1, len(b))     # 4 pages: evicts one of them
            out = [st.stats()["spilled"], alloc.probe_prefix(a)]
            alloc.register_prefix(1, b)
            alloc.free_slot(1)
            out.append(alloc.probe_prefix(a))
            hist, shared = alloc.match_prefix(a)
            out += [hist, [int(pool.k[p][0, 0, 0, 0]) for p in shared]]
            out.append(alloc.allocate_slot(0, len(a), prefix_pages=shared))
            out += [dict(alloc.tier_hits), alloc.prefix_hit_tokens,
                    client.spills, client.restores, alloc.spill_resident_prefix(),
                    alloc.spill_chain(a)]
            return out
        finally:
            st.close()

    out = alike(scenario)
    assert out[0] >= 1 and out[3] == 8 and out[4] == [1, 2] and out[5] is True
    assert out[6]["host"] >= 1 and sum(out[6].values()) * 4 == out[7]


def test_probe_is_capped_by_restorable_pages():
    def scenario(side):
        st = store(side, host_bytes=1 << 20, disk_bytes=0)
        client = side.tiers.TierClient("0", store=st)
        pool = Pool(side, 4)
        client.read_fn, client.write_fn = pool.read, pool.write
        prompt = list(range(17))
        for (h, parent, chunk) in side.prefix.chain_pages(prompt, 4):
            page = side.tiers.SpilledPage(chunk=chunk, parent=parent, **{
                k: v for k, v in vars(pool.read(0)).items() if k not in ("chunk", "parent")})
            st.put(h, page)
        alloc = side.paged.PageAllocator(num_pages=4, page_size=4, max_slots=2,
                                         max_pages_per_slot=8, tiers=client)
        try:
            out = [alloc.probe_prefix(prompt)]
            hist, shared = alloc.match_prefix(prompt)
            return out + [hist, len(shared), alloc.free_pages]
        finally:
            st.close()

    assert alike(scenario) == [12, 12, 3, 0]


def test_tier_less_walk_does_not_hash(monkeypatch):
    """Without tiers the allocator keys pages by their chunks alone: no
    chain hash on the admission path."""
    def no_hash(*args):
        raise AssertionError("chain_hash called without tiers")

    monkeypatch.setattr(port_paged, "chain_hash", no_hash)
    alloc = port_paged.PageAllocator(num_pages=16, page_size=4, max_slots=4,
                                     max_pages_per_slot=8)
    prompt = list(range(9))
    assert alloc.allocate_slot(0, 9)
    alloc.register_prefix(0, prompt)
    assert alloc.probe_prefix(prompt) == 8
    hist, pages = alloc.match_prefix(prompt)
    assert alloc.allocate_slot(1, 9, prefix_pages=pages)
    assert hist == 8 and alloc.tier_hit_tokens["hbm"] == alloc.prefix_hit_tokens == 8


def test_pin_host_pins_for_cuda_or_raises():
    arr = np.arange(24, dtype=np.int8).reshape(2, 3, 4)
    assert port_tiers.pin_host(arr, "cpu") is arr
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            port_tiers.pin_host(arr, "cuda")
        return
    pinned = port_tiers.pin_host(arr, "cuda")
    assert pinned.base.is_pinned() and np.array_equal(pinned, arr)
    assert port_tiers.pin_host(pinned, "cuda") is pinned
