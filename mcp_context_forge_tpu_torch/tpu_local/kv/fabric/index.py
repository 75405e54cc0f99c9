"""Replicated fabric index: which prefix chains exist in the shared
object store, learned from cross-host advertisements.

Each host gossips a :class:`FabricAdvert` (the tenant namespace, the
advertising host, and the chain hashes that host has persisted to T3);
receivers :meth:`merge <FabricIndex.merge>` them here, and the local
:class:`~..tiers.TieredPageStore` consults :meth:`covers` on probe so a
chain prefilled on host A scores as restorable capacity on host B. The
gossip loop, ``kv/fabric/publisher.py`` (``FabricIndexPublisher``),
delivers the adverts through :func:`merge_wire_adverts`; a caller may also
:meth:`FabricIndex.merge` them itself.

Semantics:

- **tenant-namespace isolation**: entries key on ``(tenant, hash)``;
  ``covers``/``lookup`` never cross namespaces — a tenant's cached
  pages are invisible (and, because the object KEY embeds the
  namespace, unreachable) from any other namespace;
- **TTL expiry**: every entry expires ``ttl_s`` after its last merge;
  an expired entry is exactly a miss. Staleness is therefore bounded —
  and harmless anyway: a stale ``covers`` only costs a failed object
  fetch, which invalidates the entry (verify-before-serve means a
  WRONG payload is impossible, see tiers.py);
- **first-registration-wins**: re-advertising a hash refreshes its
  expiry but never reassigns its origin host — the host attribution is
  stable for the life of the entry (mirrors the allocator's
  first-registration-wins page identity rule);
- **merge is monotone**: merging never removes entries; only expiry
  (``sweep`` or a lazy ``covers`` miss) does.

Thread model: merged from the gateway loop and read from engine
dispatch threads (store probe) — every
access takes the internal lock; all operations are dict-sized.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

#: adverts larger than this are truncated at the wire boundary — one
#: advert carries at most this many chain hashes (a 32-page chain at
#: 16 tokens/page is a 512-token prefix; 4096 hashes ≈ 2 MB of prompt)
MAX_ADVERT_HASHES = 4096


@dataclass
class FabricAdvert:
    """One host's chain-head advertisement: "these hashes exist in the
    shared object store under this tenant namespace"."""

    tenant: str
    host: str
    hashes: list[bytes] = field(default_factory=list)
    ttl_s: float = 0.0          # 0 = receiver's default TTL

    def to_wire(self) -> dict[str, Any]:
        return {"tenant": self.tenant, "host": self.host,
                "ttl_s": self.ttl_s,
                "hashes": [h.hex() for h in self.hashes]}

    @classmethod
    def from_wire(cls, payload: dict[str, Any]) -> "FabricAdvert":
        """Parse one wire advert; raises ``ValueError`` on a frame that
        is not advert-shaped (the bus/HTTP handlers turn that into a
        clean protocol error, never a crash)."""
        if not isinstance(payload, dict):
            raise ValueError("advert must be an object")
        tenant = payload.get("tenant")
        host = payload.get("host")
        raw = payload.get("hashes", [])
        if not isinstance(tenant, str) or not isinstance(host, str) \
                or not host or not isinstance(raw, list):
            raise ValueError("advert needs tenant/host/hashes fields")
        hashes: list[bytes] = []
        for item in raw[:MAX_ADVERT_HASHES]:
            try:
                digest = bytes.fromhex(item)
            except (TypeError, ValueError) as exc:
                raise ValueError(f"bad advert hash {item!r}") from exc
            if len(digest) != 32:
                raise ValueError("advert hashes must be 32 bytes")
            hashes.append(digest)
        try:
            ttl_s = float(payload.get("ttl_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            ttl_s = 0.0
        return cls(tenant=tenant, host=host, hashes=hashes,
                   ttl_s=max(0.0, ttl_s))


class FabricIndex:
    """TTL'd (tenant, chain-hash) -> origin-host map (module doc)."""

    def __init__(self, default_ttl_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.default_ttl_s = max(1.0, float(default_ttl_s))
        self._clock = clock
        self._lock = threading.Lock()
        # (tenant, hash) -> (origin host, expires_at)
        self._entries: dict[tuple[str, bytes], tuple[str, float]] = {}
        self.merged = 0        # hashes newly inserted by merge()
        self.refreshed = 0     # hashes whose expiry a merge extended
        self.expired = 0       # entries dropped by sweep/lazy expiry
        self.invalidated = 0   # entries dropped after a failed fetch

    # ------------------------------------------------------------------ write

    def merge(self, advert: FabricAdvert) -> int:
        """Fold one advert in; returns the number of NEW hashes."""
        ttl = advert.ttl_s if advert.ttl_s > 0 else self.default_ttl_s
        expires = self._clock() + ttl
        fresh = 0
        with self._lock:
            for digest in advert.hashes[:MAX_ADVERT_HASHES]:
                key = (advert.tenant, digest)
                entry = self._entries.get(key)
                if entry is None:
                    self._entries[key] = (advert.host, expires)
                    fresh += 1
                    self.merged += 1
                else:
                    # first-registration-wins on the origin host; the
                    # re-advert only extends (never shortens) the expiry
                    self._entries[key] = (entry[0],
                                          max(entry[1], expires))
                    self.refreshed += 1
        return fresh

    def invalidate(self, key_hash: bytes, tenant: str) -> None:
        """Drop one entry after a failed object fetch — a fabric promise
        the store could not keep must stop scoring as capacity, or every
        probe of the chain re-attempts the dead fetch."""
        with self._lock:
            if self._entries.pop((tenant, key_hash), None) is not None:
                self.invalidated += 1

    def sweep(self) -> int:
        """Drop expired entries eagerly (a gossip loop ticks this)."""
        now = self._clock()
        with self._lock:
            dead = [k for k, (_host, exp) in self._entries.items()
                    if exp <= now]
            for key in dead:
                del self._entries[key]
            self.expired += len(dead)
        return len(dead)

    # ----------------------------------------------------------------- lookup

    def covers(self, key_hash: bytes, tenant: str) -> bool:
        """True iff an unexpired advert covers ``(tenant, key_hash)``.
        Lazy-expires on read so a dead entry never outlives its TTL by
        more than one probe."""
        now = self._clock()
        with self._lock:
            entry = self._entries.get((tenant, key_hash))
            if entry is None:
                return False
            if entry[1] <= now:
                del self._entries[(tenant, key_hash)]
                self.expired += 1
                return False
            return True

    def lookup(self, key_hash: bytes, tenant: str) -> str | None:
        """The advertising origin host, or None (missing/expired)."""
        with self._lock:
            entry = self._entries.get((tenant, key_hash))
            if entry is None or entry[1] <= self._clock():
                return None
            return entry[0]

    def hashes(self, tenant: str) -> list[bytes]:
        """Unexpired hashes under one tenant namespace (wire echo for
        the HTTP gossip exchange)."""
        now = self._clock()
        with self._lock:
            return [h for (t, h), (_host, exp) in self._entries.items()
                    if t == tenant and exp > now]

    def adverts(self, host: str) -> list[FabricAdvert]:
        """Re-advertisable view of everything unexpired, grouped by
        tenant (the HTTP exchange returns the RECEIVER's view so a
        one-way peer config still converges both ways). ``host`` labels
        the relay, not the origin — origins stay pinned per entry on
        the receiving side only for entries it saw first."""
        now = self._clock()
        grouped: dict[str, list[bytes]] = {}
        with self._lock:
            for (tenant, digest), (_origin, exp) in self._entries.items():
                if exp > now:
                    grouped.setdefault(tenant, []).append(digest)
        return [FabricAdvert(tenant=tenant, host=host, hashes=hashes)
                for tenant, hashes in sorted(grouped.items())]

    # ------------------------------------------------------------------ stats

    def stats(self) -> dict[str, Any]:
        now = self._clock()
        with self._lock:
            live = sum(1 for _h, exp in self._entries.values()
                       if exp > now)
            hosts = {host for (host, exp) in self._entries.values()
                     if exp > now}
            tenants = {t for (t, _h), (_host, exp)
                       in self._entries.items() if exp > now}
        return {"keys": live, "hosts": sorted(hosts),
                "tenants": sorted(tenants), "merged": self.merged,
                "refreshed": self.refreshed, "expired": self.expired,
                "invalidated": self.invalidated,
                "default_ttl_s": self.default_ttl_s}


def merge_wire_adverts(index: FabricIndex,
                       payloads: Iterable[dict[str, Any]]) -> int:
    """Parse + merge a wire batch; returns new-hash count. Raises
    ``ValueError`` on the first malformed advert (the transport handler
    maps it to a protocol error)."""
    fresh = 0
    for payload in payloads:
        fresh += index.merge(FabricAdvert.from_wire(payload))
    return fresh
