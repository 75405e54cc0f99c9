"""Spill tiers for the prefix/KV page cache: pinned host RAM, disk, objects.

The HBM prefix cache (``PageAllocator``) evicts cold pages under
allocation pressure; with a :class:`TieredPageStore` attached, eviction
SPILLS instead of drops:

- **T1 (host)**: evicted pages land in a bounded host-RAM map as int8
  bytes + per-(layer, kv-head) dequant scales. Engines whose resident
  pool is already int8 spill their bytes verbatim (a T1/T2 round trip is
  bit-exact); bf16 pools quantize-on-spill (int8 + running-max page
  scale — the same scheme the resident int8 mode uses, whose greedy
  parity is pinned in tests). A store that serves a CUDA engine keeps
  its T1 arrays in page-locked host memory (:func:`pin_host`), so the
  spill's device->host read and the restore's host->device upload run
  as DMA without a bounce copy; a CPU engine's store keeps plain numpy.
- **T2 (disk)**: when T1 overflows its byte budget, the oldest entries
  hand off to a write-behind worker thread that persists them as
  ``.npz`` files under a bounded disk budget. Entries stay readable throughout (the pending map serves reads
  until the file lands). A T2 hit at match time re-onlines the payload
  into T1 on its way back to HBM.
- **T3 (object)**: with an :class:`~.fabric.object_store.ObjectStore`
  attached, the write-behind worker ALSO
  persists every displaced page as a content-addressed blob
  (``<namespace>/<chain-hash>.npz``) in the shared store — the
  cross-HOST hop. The local ``_object`` map plus the advert-fed
  :class:`~.fabric.index.FabricIndex` tell probe/get which chains are
  object-reachable; a fabric hit fetches a page another HOST prefilled
  and re-onlines it here, behind the same verify gate. T3 has its own
  ``tier.object`` breaker: open means object reads MISS and writebacks
  drop (counted) while HBM/T1/T2 keep serving.

The store is POOL-SHARED: every replica spills into and restores from
the same instance, which is what makes admission-time **fetch-on-miss**
work across replicas — a prefix prefilled (then evicted) on replica 1
restores into replica 0's HBM inside replica 0's allocate path. The
pool-global :class:`~.prefix_index.PrefixIndex` learns tier residency
from the store (publish/unpublish on every transition) so the router
can score tier hits as affinity.

Collision safety: entries are keyed by the 32-byte chain hash, but every
payload carries its exact page tokens + parent hash, and ``get``
verifies both against the requester's expectation. A colliding key can
therefore only produce a MISS, never wrong pages.

Thread model: ``put``/``get``/``probe`` run on engine dispatch threads
(admission/eviction); the write-behind loop owns the disk state, with
the store lock guarding the cross-thread handoffs; a router reads only
the index, never the store.
"""

from __future__ import annotations

import io
import logging
import os
import queue
import shutil
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Sequence

import numpy as np
import torch

from ...observability.degradation import get_degradation
from ...observability.faults import FaultAction, FaultError, fault_point

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .fabric.index import FabricIndex
    from .fabric.object_store import ObjectStore
    from .prefix_index import PrefixIndex

logger = logging.getLogger(__name__)

TIERS = ("hbm", "host", "disk", "object")


def _backoff_s(base_ms: float, attempt: int, salt: int) -> float:
    """Bounded jittered backoff for transient disk-IO retries: doubles
    per attempt with a deterministic ±25% jitter derived from ``salt``
    (no RNG state — the same failure sequence retries identically)."""
    jitter = 0.75 + 0.5 * ((salt * 2654435761 + attempt) % 100) / 100.0
    return (base_ms / 1e3) * (2 ** attempt) * jitter


@dataclass
class SpilledPage:
    """One spilled prefix page: int8 K/V bytes + per-(layer, kv-head)
    dequant scales, plus the identity evidence ``get`` verifies."""

    chunk: tuple[int, ...]     # the page's exact prompt tokens
    parent: bytes              # parent chain hash (prefix_index.chain_hash)
    k: np.ndarray              # [L, page, KV, hd] int8
    v: np.ndarray              # [L, page, KV, hd] int8
    k_scales: np.ndarray       # [L, KV] float32
    v_scales: np.ndarray       # [L, KV] float32

    @property
    def nbytes(self) -> int:
        return int(self.k.nbytes + self.v.nbytes
                   + self.k_scales.nbytes + self.v_scales.nbytes)


_TORCH_DTYPES = {np.dtype(np.int8): torch.int8,
                 np.dtype(np.float32): torch.float32}


def pin_host(arr: np.ndarray, device: torch.device | str) -> np.ndarray:
    """Page-locked placement of a spill buffer for an engine on
    ``device``. For a CUDA engine the result is a numpy view of a
    ``torch.empty(..., pin_memory=True)`` tensor (the view keeps the
    tensor alive), so the upload DMAs without a bounce copy; an array
    that already is such a view (a spill read straight into pinned
    memory) is returned as it is. If the memory cannot be pinned this
    raises: a CUDA engine's tiers never run on pageable memory
    unnoticed. A CPU engine's array is returned unchanged. Only the
    device's type matters: PyTorch pins through ``cudaHostAlloc``, whose
    memory every card of the process maps (portable under unified
    addressing), so a store pinned for one card stages the payloads of
    an engine on another (a pool's replica on the next cards)."""
    if torch.device(device).type != "cuda":
        return arr
    base = arr.base
    if isinstance(base, torch.Tensor) and base.is_pinned():
        return arr
    pinned = torch.empty(arr.shape, dtype=_TORCH_DTYPES[arr.dtype],
                         pin_memory=True)
    view = pinned.numpy()
    view[...] = arr
    return view


class TieredPageStore:
    """Bounded host-RAM + disk store for spilled prefix pages (module doc)."""

    def __init__(self, host_bytes: int, disk_bytes: int = 0,
                 disk_dir: str = "", index: "PrefixIndex | None" = None,
                 metrics=None, device: torch.device | str = "cpu",
                 io_retry_max: int = 2,
                 io_retry_backoff_ms: float = 10.0,
                 object_store: "ObjectStore | None" = None,
                 object_namespace: str = "shared",
                 fabric: "FabricIndex | None" = None) -> None:
        self.host_budget = max(0, int(host_bytes))
        self.disk_budget = max(0, int(disk_bytes))
        self.index = index
        self.metrics = metrics
        # the device of the engines this store serves: T1 payloads of a
        # CUDA engine live in page-locked memory (pin_host)
        self.device = torch.device(device)
        # T3 object fabric: the shared backend, the tenant namespace
        # every key is qualified by, and the advert-fed index of chains
        # OTHER hosts have persisted
        self.object_store = object_store
        self.object_namespace = object_namespace or "shared"
        if fabric is None and object_store is not None:
            from .fabric.index import FabricIndex as _FabricIndex
            fabric = _FabricIndex()
        self.fabric = fabric
        # disk IO hardening: transient read/write errors retry with
        # bounded jittered backoff, then the ENTRY is
        # quarantined — dropped to a clean MISS, never a hang or a
        # poisoned serve; repeated failures open the tier.disk breaker
        # and the whole disk tier quarantines (HBM/T1 keep serving)
        # until a half-open probe succeeds
        self.io_retry_max = max(0, int(io_retry_max))
        self.io_retry_backoff_ms = max(0.0, float(io_retry_backoff_ms))
        self._disk_breaker = get_degradation().breaker("tier.disk")
        self._object_breaker = get_degradation().breaker("tier.object")
        self.io_errors = {("disk", "read"): 0, ("disk", "write"): 0,
                          ("host", "get"): 0,
                          ("object", "read"): 0, ("object", "write"): 0}
        self._lock = threading.Lock()
        # T1: insertion-ordered = LRU-by-last-use (get() re-inserts)
        self._host: dict[bytes, SpilledPage] = {}
        self._host_nbytes = 0
        # handed to the writer but not yet on disk: still served from RAM
        self._pending: dict[bytes, SpilledPage] = {}
        # T2 residency: hash -> (path, nbytes), insertion-ordered (FIFO
        # eviction when the disk budget overflows)
        self._disk: dict[bytes, tuple[str, int]] = {}
        self._disk_nbytes = 0
        # T3 LOCAL knowledge: hashes THIS host wrote (or fetched) from
        # the object store, hash -> nbytes. Remote residency lives in
        # self.fabric; the union is what probe/get consult.
        self._object: dict[bytes, int] = {}
        self._object_nbytes = 0
        self._writeq: "queue.Queue[bytes | None]" = queue.Queue()
        self._writer: threading.Thread | None = None
        self._closed = False
        self._disk_dir = disk_dir
        self._owns_dir = False
        # counters (read by stats surfaces; int ops are GIL-atomic)
        self.spilled = 0
        self.dropped = 0          # evicted past the last tier (truly gone)
        self.collisions = 0       # key matched, payload identity did not
        self.disk_writes = 0
        self.disk_reads = 0
        self.object_writes = 0
        self.object_reads = 0
        self.object_write_drops = 0  # writebacks dropped: breaker open

    # ------------------------------------------------------------- lifecycle

    def _ensure_dir(self) -> str:
        if not self._disk_dir:
            self._disk_dir = tempfile.mkdtemp(prefix="mcpforge-kv-tier-")
            self._owns_dir = True
        os.makedirs(self._disk_dir, exist_ok=True)
        return self._disk_dir

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._writer = threading.Thread(
                target=self._writer_loop, name="kv-tier-spill", daemon=True)
            self._writer.start()

    def close(self) -> None:
        """Stop the write-behind worker and drop disk state this store
        owns (an operator-provided disk_dir is left in place — it may be
        a shared cache another pool still reads)."""
        self._closed = True
        writer = self._writer
        if writer is not None and writer.is_alive():
            self._writeq.put(None)
            writer.join(timeout=5.0)
        with self._lock:
            self._pending.clear()
            self._host.clear()
            self._host_nbytes = 0
            disk, self._disk = dict(self._disk), {}
            self._disk_nbytes = 0
        if self._owns_dir and self._disk_dir:
            shutil.rmtree(self._disk_dir, ignore_errors=True)
        elif disk:
            for path, _ in disk.values():
                try:
                    os.unlink(path)
                except OSError:
                    pass

    # ------------------------------------------------------------------ write

    def put(self, key_hash: bytes, payload: SpilledPage) -> None:
        """Admit a spilled page into T1, displacing LRU entries toward T2
        (write-behind) when the host budget overflows. Duplicate keys
        are a no-op — shared prefixes spill from many replicas."""
        if self._closed or self.host_budget <= 0:
            return
        payload.k = pin_host(payload.k, self.device)
        payload.v = pin_host(payload.v, self.device)
        with self._lock:
            if (key_hash in self._host or key_hash in self._pending
                    or key_hash in self._disk or key_hash in self._object):
                return
            self._host[key_hash] = payload
            self._host_nbytes += payload.nbytes
            overflow = self._trim_host_locked()
        self.spilled += 1
        if self.index is not None:
            self.index.publish_tier(key_hash, "host")
        self._dispatch_overflow(overflow)

    def _trim_host_locked(self) -> list[bytes]:
        """Enforce the T1 byte budget (caller holds the lock): displace
        LRU entries toward the write-behind queue (or drop them when the
        disk tier is off). Returns the keys to hand to the worker —
        queueing happens OUTSIDE the lock."""
        overflow: list[bytes] = []
        while self._host_nbytes > self.host_budget and len(self._host) > 1:
            old_key, old = next(iter(self._host.items()))
            del self._host[old_key]
            self._host_nbytes -= old.nbytes
            if old_key in self._disk or old_key in self._object:
                # a displaced RE-ONLINED entry: its disk/object copy is
                # already durable — rewriting would double-count bytes
                if self.index is not None:
                    self.index.unpublish_tier(old_key, "host")
            elif self.disk_budget > 0 or self.object_store is not None:
                self._pending[old_key] = old  # the caller holds self._lock
                overflow.append(old_key)
            else:
                self.dropped += 1
                if self.index is not None:
                    self.index.unpublish_tier(old_key, "host")
        return overflow

    def _dispatch_overflow(self, overflow: list[bytes]) -> None:
        if overflow:
            self._ensure_writer()
            for old_key in overflow:
                self._writeq.put(old_key)

    # ------------------------------------------------------------------- read

    def probe(self, key_hash: bytes) -> bool:
        """True iff some tier holds the key (no payload verification —
        the probe sizes buckets; the match verifies). Fabric-advertised
        chains count too — the allocator caps probes at its restore
        capacity, so a stale advert costs one failed fetch at match
        time (a clean MISS), never an admission livelock — UNLESS the
        object breaker is open: a quarantined T3 must not promise
        capacity its reads will refuse to deliver."""
        with self._lock:
            if (key_hash in self._host or key_hash in self._pending
                    or key_hash in self._disk
                    or key_hash in self._object):
                return True
        return (self.object_store is not None and self.fabric is not None
                and self._object_breaker.state != "open"
                and self.fabric.covers(key_hash, self.object_namespace))

    def get(self, key_hash: bytes, parent: bytes,
            chunk: Sequence[int]) -> tuple[SpilledPage, str] | None:
        """Fetch + VERIFY one page: the stored payload must carry exactly
        ``(parent, chunk)`` or the result is a miss (hash collision —
        wrong pages are never served). A disk hit re-onlines into T1.
        Returns ``(payload, source_tier)``.

        Fault points: ``tier.host.get`` covers the T1 fetch (error =
        clean MISS, corrupt = the payload fails identity verification
        and the entry quarantines — the collision path); the disk load
        below rides ``tier.disk.read`` inside :meth:`_read_disk`."""
        expected = tuple(chunk)
        corrupt_host = False
        act = fault_point("tier.host.get", scope=key_hash.hex())
        if act is not None:
            if act.kind == "corrupt":
                corrupt_host = True  # forces the verify-failure path
            else:
                try:
                    act.apply()
                except FaultError:
                    # an injected T1 fault degrades to a MISS — the
                    # match ends at the pages already secured, never a
                    # crash inside the admission path
                    self._count_io_error("host", "get")
                    return None
        path = None
        collided = False
        with self._lock:
            payload = self._host.get(key_hash)
            if payload is not None:
                # LRU touch: re-insert at the MRU end
                del self._host[key_hash]
                self._host[key_hash] = payload
                hit = None if corrupt_host \
                    else self._verify(payload, parent, expected, "host")
                if hit is None:  # collision: drop it, or probe() keeps
                    del self._host[key_hash]   # promising an unrestorable
                    self._host_nbytes -= payload.nbytes  # hist (livelock)
                    collided = True
            else:
                payload = self._pending.get(key_hash)
                if payload is not None:
                    hit = None if corrupt_host \
                        else self._verify(payload, parent, expected, "host")
                    if hit is None:
                        self._pending.pop(key_hash, None)
                        collided = True
                else:
                    hit = None
                    entry = self._disk.get(key_hash)
                    if entry is not None:
                        path = entry[0]
        if collided:
            # the dropped T1 copy must leave the index too, or the
            # router keeps scoring phantom tier affinity for the hash
            self.dropped += 1
            if corrupt_host:
                self._count_io_error("host", "get")
            if self.index is not None:
                self.index.unpublish_tier(key_hash, "host")
            return None
        if payload is not None and path is None:
            return hit
        if path is None:
            # T1/T2 miss: the object fabric is the last hop — locally
            # written blobs or chains a peer host advertised
            return self._get_object(key_hash, parent, expected)
        if not self._disk_breaker.allow():
            # disk tier quarantined (breaker open): clean MISS; the
            # entry STAYS — it may serve again once a half-open probe
            # closes the breaker
            return None
        payload = self._read_disk(path)
        if payload is None:
            self._disk_breaker.record_failure("disk read")
            self._count_io_error("disk", "read")
            with self._lock:
                entry = self._disk.pop(key_hash, None)
                if entry is not None:
                    self._disk_nbytes -= entry[1]
            if self.index is not None:
                self.index.unpublish_tier(key_hash, "disk")
            return None
        self._disk_breaker.record_success()
        self.disk_reads += 1
        hit = self._verify(payload, parent, expected, "disk")
        if hit is None:
            # collision on the disk copy: drop it too (see host path)
            with self._lock:
                entry = self._disk.pop(key_hash, None)
                if entry is not None:
                    self._disk_nbytes -= entry[1]
            try:
                os.unlink(path)
            except OSError:
                pass
            if self.index is not None:
                self.index.unpublish_tier(key_hash, "disk")
            return None
        if hit is not None:
            # re-online on match: later matches (any replica) serve from
            # RAM; the disk copy stays for durability until budget churn.
            # The SAME budget trim as put() applies — a restore-heavy
            # phase must not grow T1 past tier_host_bytes just because
            # the bytes arrived via re-onlining instead of spilling
            overflow: list[bytes] = []
            with self._lock:
                if key_hash not in self._host and not self._closed:
                    self._host[key_hash] = payload
                    self._host_nbytes += payload.nbytes
                    overflow = self._trim_host_locked()
            if self.index is not None:
                self.index.publish_tier(key_hash, "host")
            self._dispatch_overflow(overflow)
        return hit

    def _verify(self, payload: SpilledPage, parent: bytes,
                chunk: tuple[int, ...],
                tier: str) -> tuple[SpilledPage, str] | None:
        if payload.parent != parent or payload.chunk != chunk:
            self.collisions += 1
            logger.warning(
                "kv tier store: chain-hash collision (tier=%s) — "
                "payload identity mismatch, serving a miss", tier)
            return None
        return payload, tier

    # -------------------------------------------------------- T3 object fabric

    def _object_key(self, key_hash: bytes) -> str:
        """Content-addressed, tenant-namespaced blob key: the namespace
        segment is part of the KEY, so tenants in different namespaces
        cannot reach each other's pages even through a forged advert."""
        return f"{self.object_namespace}/{key_hash.hex()}.npz"

    def object_hashes(self) -> list[bytes]:
        """Chain hashes THIS host knows are object-resident (what the
        publisher advertises to peers)."""
        with self._lock:
            return list(self._object)

    def _drop_object_entry(self, key_hash: bytes) -> None:
        """Forget one object promise everywhere probes look: the local
        map, the fabric index, and the pool index — or every probe of
        the chain re-attempts the dead fetch."""
        with self._lock:
            nbytes = self._object.pop(key_hash, None)
            if nbytes is not None:
                self._object_nbytes -= nbytes
        if self.fabric is not None:
            self.fabric.invalidate(key_hash, self.object_namespace)
        if self.index is not None:
            self.index.unpublish_object(key_hash)

    def _get_object(self, key_hash: bytes, parent: bytes,
                    expected: tuple[int, ...]
                    ) -> tuple[SpilledPage, str] | None:
        """The T3 fetch: serve a page from the shared object store —
        written by THIS host (local ``_object`` map) or prefilled by a
        PEER host (fabric advert) — behind the same verify gate as
        every other tier. A hit re-onlines into T1 exactly like a disk
        hit, so the cross-host fetch happens once per chain, not once
        per request."""
        if self.object_store is None:
            return None
        with self._lock:
            known = key_hash in self._object
        if not known and (self.fabric is None or not self.fabric.covers(
                key_hash, self.object_namespace)):
            return None
        if not self._object_breaker.allow():
            # T3 quarantined (breaker open): clean MISS; local knowledge
            # and adverts STAY — the blob may serve again after a
            # half-open probe closes the breaker
            return None
        status, payload = self._read_object(key_hash)
        if status == "miss":
            # the blob is gone (stale advert / external cleanup): not an
            # IO failure — drop the promise, leave the breaker alone
            self._object_breaker.record_success()
            self._drop_object_entry(key_hash)
            return None
        if payload is None:
            self._object_breaker.record_failure("object read")
            self._count_io_error("object", "read")
            self._drop_object_entry(key_hash)
            return None
        self._object_breaker.record_success()
        self.object_reads += 1
        hit = self._verify(payload, parent, expected, "object")
        if hit is None:
            # collision/corrupt blob: a bad payload must stop being
            # findable (and servable) fabric-wide
            self._drop_object_entry(key_hash)
            self.object_store.delete(self._object_key(key_hash))
            return None
        # re-online on match (same budget discipline as the disk path);
        # a fabric-fetched page is PROOF of object residency — learn it
        # locally so a later displacement skips the redundant writeback
        # and this host's publisher re-advertises the chain
        overflow: list[bytes] = []
        with self._lock:
            if key_hash not in self._object:
                self._object[key_hash] = payload.nbytes
                self._object_nbytes += payload.nbytes
            if key_hash not in self._host and not self._closed:
                self._host[key_hash] = payload
                self._host_nbytes += payload.nbytes
                overflow = self._trim_host_locked()
        if self.index is not None:
            self.index.publish_object(key_hash, self._object_key(key_hash))
            self.index.publish_tier(key_hash, "host")
        self._dispatch_overflow(overflow)
        return hit

    def _read_object(self, key_hash: bytes
                     ) -> tuple[str, SpilledPage | None]:
        """One object fetch with bounded retries. Returns ``(status,
        payload)`` — ``("hit", page)``, ``("miss", None)`` for a clean
        not-found, ``("error", None)`` after exhausted retries or
        corrupt content. The ``tier.object.get`` fault point fires per
        ATTEMPT; a ``corrupt`` rule mangles the fetched bytes so the
        payload either fails to parse or fails identity verification —
        a MISS, never a served page."""
        key = self._object_key(key_hash)
        for attempt in range(self.io_retry_max + 1):
            corrupt = False
            act = fault_point("tier.object.get", scope=key)
            try:
                if act is not None:
                    if act.kind == "corrupt":
                        corrupt = True
                    else:
                        act.apply()
                raw = self.object_store.get(key)
                if raw is None:
                    return "miss", None
                if corrupt:
                    raw = FaultAction.corrupt_bytes(raw)
                with np.load(io.BytesIO(raw)) as data:
                    return "hit", self._payload_from(data)
            except OSError:
                if attempt >= self.io_retry_max:
                    return "error", None
                time.sleep(_backoff_s(self.io_retry_backoff_ms, attempt,
                                      len(key)))
            except Exception:
                # corrupt blob content: retrying cannot fix it
                logger.warning("kv tier store: corrupt object blob %s",
                               key)
                return "error", None
        return "error", None

    def _write_object_tier(self, key_hash: bytes,
                           payload: SpilledPage) -> bool:
        """One T3 writeback with bounded retries (write-behind worker
        only). Breaker open = drop immediately, counted — no retry
        storm against a dead backend. The ``tier.object.put`` fault
        point fires per attempt; a ``corrupt`` rule uploads mangled
        bytes, which every reader's verify gate turns into a MISS."""
        if self.object_store is None:
            return False
        if not self._object_breaker.allow():
            self.object_write_drops += 1
            return False
        key = self._object_key(key_hash)
        data = self._serialize(payload)
        started = time.monotonic()
        for attempt in range(self.io_retry_max + 1):
            blob = data
            act = fault_point("tier.object.put", scope=key)
            try:
                if act is not None:
                    if act.kind == "corrupt":
                        blob = FaultAction.corrupt_bytes(data)
                    else:
                        act.apply()
                self.object_store.put(key, blob)
            except OSError:
                if attempt >= self.io_retry_max:
                    self._object_breaker.record_failure("object write")
                    self._count_io_error("object", "write")
                    logger.warning(
                        "kv tier store: object write failed after %d "
                        "attempt(s) (%s); page stays local-only",
                        self.io_retry_max + 1, key)
                    return False
                time.sleep(_backoff_s(self.io_retry_backoff_ms, attempt,
                                      len(key)))
                continue
            self._object_breaker.record_success()
            if self.metrics is not None:
                self.metrics.llm_prefix_tier_io.labels(
                    op="writeback", tier="object").observe(
                    time.monotonic() - started)
            return True
        return False

    @staticmethod
    def _serialize(payload: SpilledPage) -> bytes:
        buf = io.BytesIO()
        np.savez(buf,
                 chunk=np.asarray(payload.chunk, dtype=np.int64),
                 parent=np.frombuffer(payload.parent, dtype=np.uint8),
                 k=np.asarray(payload.k), v=np.asarray(payload.v),
                 k_scales=np.asarray(payload.k_scales),
                 v_scales=np.asarray(payload.v_scales))
        return buf.getvalue()

    # ----------------------------------------------------------- spill worker

    def _writer_loop(self) -> None:
        """Write-behind: persist pending T1 overflow to disk (bounded by
        the disk budget, oldest files evicted) AND — write-through —
        to the shared object store when one is attached. A page is
        dropped only when EVERY lower tier refused it; a disk-evicted
        page whose blob survives in T3 is still fetchable, so only a
        blob-less eviction counts as truly gone.

        Hardened: transient write errors — real or
        injected at the ``tier.disk.write`` / ``tier.object.put`` fault
        points — retry with bounded jittered backoff, then that
        DESTINATION quarantines for the entry (clean skip, counted);
        repeated failures open the ``tier.disk`` / ``tier.object``
        breaker, after which writebacks to that tier drop immediately
        (no retry storm against a dead backend) until a half-open probe
        recovers. The tiers fail independently: an open object breaker
        never blocks disk writeback, and vice versa."""
        while True:
            key_hash = self._writeq.get()
            if key_hash is None:
                return
            with self._lock:
                payload = self._pending.get(key_hash)
            if payload is None:
                continue
            started = time.monotonic()
            wrote_disk = False
            path = ""
            if self.disk_budget > 0:
                path = os.path.join(self._ensure_dir(),
                                    key_hash.hex() + ".npz")
                if not self._disk_breaker.allow():
                    # disk tier quarantined: skip cleanly (stay bounded,
                    # never wedge the writer on a dead disk)
                    pass
                elif self._write_disk(path, payload):
                    self._disk_breaker.record_success()
                    wrote_disk = True
                else:
                    self._disk_breaker.record_failure("disk write")
                    self._count_io_error("disk", "write")
                    logger.warning(
                        "kv tier store: disk write failed after %d "
                        "attempt(s) (%s); dropping page",
                        self.io_retry_max + 1, path)
            wrote_object = self._write_object_tier(key_hash, payload)
            if not wrote_disk and not wrote_object:
                # no lower tier took the page: truly gone
                with self._lock:
                    self._pending.pop(key_hash, None)
                self.dropped += 1
                if self.index is not None:
                    self.index.unpublish_tier(key_hash, "host")
                continue
            nbytes = payload.nbytes
            evicted: list[tuple[bytes, str, bool]] = []
            with self._lock:
                self._pending.pop(key_hash, None)
                if wrote_disk:
                    self._disk[key_hash] = (path, nbytes)
                    self._disk_nbytes += nbytes
                    while self._disk_nbytes > self.disk_budget \
                            and len(self._disk) > 1:
                        old_key, (old_path, old_nbytes) = \
                            next(iter(self._disk.items()))
                        del self._disk[old_key]
                        self._disk_nbytes -= old_nbytes
                        evicted.append((old_key, old_path,
                                        old_key in self._object))
                if wrote_object and key_hash not in self._object:
                    self._object[key_hash] = nbytes
                    self._object_nbytes += nbytes
            if wrote_disk:
                self.disk_writes += 1
                if self.metrics is not None:
                    self.metrics.llm_prefix_tier_io.labels(
                        op="writeback", tier="disk").observe(
                        time.monotonic() - started)
            if wrote_object:
                self.object_writes += 1
            if self.index is not None:
                if wrote_disk:
                    self.index.publish_tier(key_hash, "disk")
                if wrote_object:
                    self.index.publish_object(
                        key_hash, self._object_key(key_hash))
                self.index.unpublish_tier(key_hash, "host")
            for old_key, old_path, still_object in evicted:
                try:
                    os.unlink(old_path)
                except OSError:
                    pass
                if not still_object:
                    # past the last tier — the blob-backed case is NOT a
                    # drop: the page is one object fetch away
                    self.dropped += 1
                if self.index is not None:
                    self.index.unpublish_tier(old_key, "disk")

    def _count_io_error(self, tier: str, op: str) -> None:
        self.io_errors[(tier, op)] += 1
        if self.metrics is not None:
            try:
                self.metrics.llm_prefix_tier_io_errors.labels(
                    tier=tier, op=op).inc()
            except Exception:
                pass  # accounting must never mask the IO failure itself

    def _write_disk(self, path: str, payload: SpilledPage) -> bool:
        """One writeback with bounded retries. The ``tier.disk.write``
        fault point fires per ATTEMPT (an ``error`` rule in ``always``
        mode exhausts the retries; ``one_in_n`` exercises the retry
        succeeding); a ``corrupt`` rule mangles the file AFTER a clean
        write — the read side's verification must turn it into a MISS."""
        corrupt_after = False
        for attempt in range(self.io_retry_max + 1):
            act = fault_point("tier.disk.write", scope=path)
            try:
                if act is not None:
                    if act.kind == "corrupt":
                        corrupt_after = True
                    else:
                        act.apply()
                self._write_file(path, payload)
            except OSError:
                if attempt >= self.io_retry_max:
                    return False
                time.sleep(_backoff_s(self.io_retry_backoff_ms, attempt,
                                      len(path)))
                continue
            if corrupt_after:
                try:
                    with open(path, "r+b") as fh:
                        data = fh.read()
                        fh.seek(0)
                        fh.write(FaultAction.corrupt_bytes(data))
                except OSError:
                    pass
            return True
        return False

    def _read_disk(self, path: str) -> SpilledPage | None:
        """One disk load with bounded retries: transient ``OSError``
        (or an injected ``tier.disk.read`` error) retries with jittered
        backoff; structurally corrupt content (real bit rot or an
        injected ``corrupt`` rule) quarantines immediately — retrying
        cannot fix a bad file, and the caller drops the entry to a
        clean MISS."""
        for attempt in range(self.io_retry_max + 1):
            data_override = None
            act = fault_point("tier.disk.read", scope=path)
            try:
                if act is not None:
                    if act.kind == "corrupt":
                        with open(path, "rb") as fh:
                            data_override = FaultAction.corrupt_bytes(
                                fh.read())
                    else:
                        act.apply()
                if data_override is not None:
                    with np.load(io.BytesIO(data_override)) as data:
                        return self._payload_from(data)
                with np.load(path) as data:
                    return self._payload_from(data)
            except OSError:
                if attempt >= self.io_retry_max:
                    return None
                time.sleep(_backoff_s(self.io_retry_backoff_ms, attempt,
                                      len(path)))
            except Exception:
                # corrupt content (BadZipFile / KeyError / ValueError /
                # truncated pickle): unrecoverable, quarantine now
                logger.warning("kv tier store: corrupt spill file %s",
                               path)
                return None
        return None

    @staticmethod
    def _payload_from(data) -> SpilledPage:
        return SpilledPage(
            chunk=tuple(int(t) for t in data["chunk"]),
            parent=data["parent"].tobytes(),
            k=data["k"], v=data["v"],
            k_scales=data["k_scales"], v_scales=data["v_scales"])

    @staticmethod
    def _write_file(path: str, payload: SpilledPage) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh,
                     chunk=np.asarray(payload.chunk, dtype=np.int64),
                     parent=np.frombuffer(payload.parent, dtype=np.uint8),
                     k=np.asarray(payload.k), v=np.asarray(payload.v),
                     k_scales=np.asarray(payload.k_scales),
                     v_scales=np.asarray(payload.v_scales))
        os.replace(tmp, path)

    def verify_chain(self, steps: Sequence[tuple[bytes, bytes, tuple[int, ...]]]
                     ) -> tuple[int, int]:
        """Verify before serving a whole exported chain (a pool's
        migration): fetch and verify each ``(key_hash, parent, chunk)``
        through :meth:`get`, the identity check admission uses, so a corrupt
        or colliding payload is a miss here as it would be at the decode
        replica's fetch-on-miss. Returns ``(pages_verified,
        bytes_verified)``; stops at the first miss (nothing deeper can
        restore without its parent)."""
        pages = 0
        nbytes = 0
        for key_hash, parent, chunk in steps:
            hit = self.get(key_hash, parent, chunk)
            if hit is None:
                break
            pages += 1
            nbytes += hit[0].nbytes
        return pages, nbytes

    # ------------------------------------------------------------------ stats

    def stats(self) -> dict[str, Any]:
        with self._lock:
            host_entries = len(self._host) + len(self._pending)
            host_nbytes = self._host_nbytes + sum(
                p.nbytes for p in self._pending.values())
            disk_entries = len(self._disk)
            disk_nbytes = self._disk_nbytes
            object_entries = len(self._object)
            object_nbytes = self._object_nbytes
        out: dict[str, Any] = {
            "host_pages": host_entries, "host_bytes": host_nbytes,
            "host_budget_bytes": self.host_budget,
            "disk_pages": disk_entries, "disk_bytes": disk_nbytes,
            "disk_budget_bytes": self.disk_budget,
            "spilled": self.spilled, "dropped": self.dropped,
            "disk_writes": self.disk_writes, "disk_reads": self.disk_reads,
            "collisions": self.collisions,
            "io_errors": {f"{tier}.{op}": count for (tier, op), count
                          in self.io_errors.items()},
            "disk_breaker": self._disk_breaker.snapshot(),
        }
        if self.object_store is not None:
            out["object_pages"] = object_entries
            out["object_bytes"] = object_nbytes
            out["object_url"] = self.object_store.url
            out["object_namespace"] = self.object_namespace
            out["object_writes"] = self.object_writes
            out["object_reads"] = self.object_reads
            out["object_write_drops"] = self.object_write_drops
            out["object_breaker"] = self._object_breaker.snapshot()
            if self.fabric is not None:
                out["fabric"] = self.fabric.stats()
        return out


class TierClient:
    """One engine's binding to the (pool-shared) store + index.

    Owns the engine-provided device I/O callbacks — ``read_fn(page) ->
    SpilledPage-shaped arrays`` (device->host, quantize-on-spill under a
    bf16 pool) and ``write_fn(page, payload)`` (host->device upload into
    the admitting replica's HBM) — plus the spill/restore latency
    windows the stats surfaces report. The allocator calls ``spill`` at
    eviction and ``restore`` at match time; both run on the engine's
    dispatch thread (the only thread allowed to touch device state). On
    a multi-rank engine the callbacks are rank 0's announced device calls,
    so an eviction inside ``_take_page`` reaches every rank in call order,
    and ``read_fn`` returns the whole page whatever the mesh."""

    def __init__(self, replica_id: str,
                 store: TieredPageStore | None = None,
                 index: "PrefixIndex | None" = None,
                 metrics=None, tracer=None) -> None:
        self.replica_id = replica_id
        self.store = store
        self.index = index
        self.metrics = metrics
        self.tracer = tracer
        # trace attribution handoff: the engine's admission path sets
        # this to the admitting request's (trace_id, span_id) around
        # match/allocate so spill/restore IO lands as tier.spill /
        # tier.restore spans inside that request's waterfall (set and
        # read on the same dispatch thread; None = unattributed, no span)
        self.trace_ctx: tuple[str, str] | None = None
        self.read_fn: Callable[[int], SpilledPage] | None = None
        self.write_fn: Callable[[int, SpilledPage], None] | None = None
        self.spills = 0
        self.restores = 0
        self.spill_ms: deque[float] = deque(maxlen=256)
        self.restore_ms: deque[float] = deque(maxlen=256)

    def _emit_io_span(self, name: str, wall_start: float,
                      attrs: dict[str, Any]) -> None:
        if self.tracer is None or self.trace_ctx is None:
            return
        try:
            self.tracer.emit_span(
                name, wall_start, time.time(), trace_ctx=self.trace_ctx,
                attributes={"llm.replica_id": self.replica_id, **attrs})
        except Exception:
            pass  # telemetry must never break the dispatch thread

    @property
    def active(self) -> bool:
        """True when spill/restore are actually wired (store + device IO);
        a client with only an index still publishes HBM residency for
        the router but never moves page bytes."""
        return (self.store is not None and self.read_fn is not None
                and self.write_fn is not None)

    # ------------------------------------------------------- index publication

    def publish_hbm(self, key_hash: bytes) -> None:
        if self.index is not None:
            self.index.publish_hbm(key_hash, self.replica_id)

    def unpublish_hbm(self, key_hash: bytes) -> None:
        if self.index is not None:
            self.index.unpublish_hbm(key_hash, self.replica_id)

    def drop_replica(self) -> None:
        if self.index is not None:
            self.index.drop_replica(self.replica_id)

    # ---------------------------------------------------------- byte movement

    def probe(self, key_hash: bytes) -> bool:
        return self.store is not None and self.store.probe(key_hash)

    def spill(self, key_hash: bytes, parent: bytes, chunk: Sequence[int],
              page: int) -> bool:
        """Evicted-page handoff: read the page's bytes off the device and
        admit them into T1. Skips the device read when some tier already
        holds the key (another replica spilled the same chain)."""
        if not self.active:
            return False
        if self.store.probe(key_hash):
            return True
        started = time.monotonic()
        wall_start = time.time()
        payload = self.read_fn(page)
        payload.chunk = tuple(chunk)
        payload.parent = parent
        self.store.put(key_hash, payload)
        elapsed = time.monotonic() - started
        self.spills += 1
        self.spill_ms.append(elapsed * 1e3)
        if self.metrics is not None:
            self.metrics.llm_prefix_tier_io.labels(
                op="spill", tier="host").observe(elapsed)
        self._emit_io_span("tier.spill", wall_start, {
            "tier.tier": "host", "tier.tokens": len(payload.chunk),
            "tier.bytes": payload.nbytes})
        return True

    def restore(self, key_hash: bytes, parent: bytes, chunk: Sequence[int],
                page: int) -> str | None:
        """Fetch-on-miss: verify + fetch the spilled page and upload it
        into ``page`` of THIS replica's HBM pool. Returns the source
        tier ("host"/"disk"/"object") or None (miss / collision)."""
        if not self.active:
            return None
        started = time.monotonic()
        wall_start = time.time()
        hit = self.store.get(key_hash, parent, chunk)
        if hit is None:
            return None
        payload, tier = hit
        self.write_fn(page, payload)
        elapsed = time.monotonic() - started
        self.restores += 1
        self.restore_ms.append(elapsed * 1e3)
        if self.metrics is not None:
            self.metrics.llm_prefix_tier_io.labels(
                op="restore", tier=tier).observe(elapsed)
        self._emit_io_span("tier.restore", wall_start, {
            "tier.tier": tier, "tier.tokens": len(payload.chunk),
            "tier.bytes": payload.nbytes})
        return tier

    # ------------------------------------------------------------------ stats

    def restore_p95_ms(self) -> float | None:
        if not self.restore_ms:
            return None
        window = sorted(self.restore_ms)
        return round(window[min(len(window) - 1,
                                int(len(window) * 0.95))], 3)

    def stats(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "replica": self.replica_id,
            "spills": self.spills, "restores": self.restores,
            "restore_p95_ms": self.restore_p95_ms(),
        }
        if self.store is not None:
            out["store"] = self.store.stats()
        return out
