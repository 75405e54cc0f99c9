"""Fabric gossip: advertise this host's object-resident chains (a copy of
the JAX package's ``tpu_local/kv/fabric/publisher.py``).

One :class:`FabricIndexPublisher` runs per gateway host (asyncio task on
the gateway loop). Each tick it:

1. sweeps the local :class:`~.index.FabricIndex` (TTL expiry);
2. snapshots the chain hashes the local
   :class:`~..tiers.TieredPageStore` has durably persisted to the T3
   object store;
3. pushes them as one :class:`~.index.FabricAdvert` to every peer —
   in-fleet workers over the ``fabric.advert`` bus-RPC method (the hub
   relays frames between supervised worker processes), cross-supervisor
   hosts over ``POST /admin/fabric/adverts`` (the HTTP exchange returns
   the peer's own adverts, so a ONE-WAY peer list still converges both
   ways).

Receiving side: :meth:`handle_advert` is the bus-RPC handler AND the
HTTP endpoint's core — merge the batch, reply with the local view.

Delivery is best-effort and the protocol is idempotent (merge is
monotone, expiry is the only eviction): a dropped advert only delays
cross-host hits by one interval, never corrupts anything. Failures are
counted, logged once per peer transition, and never raised into the
gateway loop.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Awaitable, Callable, Iterable

from .index import FabricAdvert, FabricIndex, merge_wire_adverts

logger = logging.getLogger(__name__)

#: bus-RPC method name (``tpu_local/server.py`` ``build_llm_app`` registers
#: ``handle_advert`` under it)
ADVERT_METHOD = "fabric.advert"


class FabricIndexPublisher:
    """Advertise local T3 residency; merge what peers advertise back."""

    def __init__(self, store: Any, host_id: str,
                 rpc: Any = None,
                 bus_peers: Callable[[], Iterable[str]] | None = None,
                 http_peers: Iterable[str] = (),
                 post_json: Callable[[str, dict[str, Any]],
                                     Awaitable[dict[str, Any] | None]]
                 | None = None,
                 interval_s: float = 2.0, ttl_s: float = 300.0,
                 rpc_timeout_s: float = 5.0,
                 metrics: Any = None) -> None:
        # the store may materialize AFTER the publisher (leader-elected
        # shared pool builds lazily): accept a zero-arg resolver too
        self._store_src = store
        self.host_id = host_id
        self.rpc = rpc
        self.bus_peers = bus_peers
        self.http_peers = [u.rstrip("/") for u in http_peers if u]
        self.post_json = post_json
        self.interval_s = max(0.05, float(interval_s))
        self.ttl_s = max(1.0, float(ttl_s))
        self.rpc_timeout_s = max(0.1, float(rpc_timeout_s))
        self.metrics = metrics
        self._task: asyncio.Task | None = None
        self._peer_down: set[str] = set()  # log once per peer transition
        self.sent = 0          # adverts pushed to peers
        self.merged_in = 0     # hashes learned from peers
        self.send_failures = 0

    # -------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run(),
                                             name="fabric-advert")

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while True:
            try:
                await self.publish_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("fabric advert tick failed")
            await asyncio.sleep(self.interval_s)

    # ------------------------------------------------------------------ sends

    @property
    def store(self) -> Any:
        src = self._store_src
        return src() if callable(src) else src

    def _fabric(self) -> FabricIndex | None:
        return getattr(self.store, "fabric", None)

    def _local_advert(self) -> FabricAdvert | None:
        store = self.store
        if store is None or getattr(store, "object_store", None) is None:
            return None
        fabric: FabricIndex | None = getattr(store, "fabric", None)
        if fabric is not None:
            fabric.sweep()
        hashes = store.object_hashes()
        if not hashes:
            return None
        return FabricAdvert(tenant=store.object_namespace,
                            host=self.host_id, hashes=hashes,
                            ttl_s=self.ttl_s)

    async def publish_once(self) -> dict[str, Any]:
        """One gossip round; returns a small report (tests/bench)."""
        advert = self._local_advert()
        if advert is None:
            return {"sent": 0, "hashes": 0}
        frame = {"adverts": [advert.to_wire()]}
        pushed = 0
        if self.rpc is not None and self.bus_peers is not None:
            for worker in sorted(set(self.bus_peers())):
                if worker == self.host_id:
                    continue
                pushed += await self._push_bus(worker, frame)
        for url in self.http_peers:
            pushed += await self._push_http(url, frame)
        return {"sent": pushed, "hashes": len(advert.hashes)}

    async def _push_bus(self, worker: str, frame: dict[str, Any]) -> int:
        try:
            await self.rpc.call(worker, ADVERT_METHOD, frame,
                                timeout_s=self.rpc_timeout_s)
        except Exception as exc:
            self._note_failure(f"bus:{worker}", exc)
            return 0
        self._note_success(f"bus:{worker}")
        return 1

    async def _push_http(self, url: str, frame: dict[str, Any]) -> int:
        if self.post_json is None:
            return 0
        try:
            reply = await self.post_json(url + "/admin/fabric/adverts",
                                         frame)
        except Exception as exc:
            self._note_failure(url, exc)
            return 0
        self._note_success(url)
        # the exchange reply carries the PEER's adverts: merge them so a
        # one-way peer configuration still converges in both directions
        if isinstance(reply, dict) and isinstance(reply.get("adverts"),
                                                  list):
            try:
                self._merge_in(reply["adverts"])
            except ValueError:
                logger.warning("fabric peer %s returned a malformed "
                               "advert reply", url)
        return 1

    def _note_failure(self, peer: str, exc: Exception) -> None:
        self.send_failures += 1
        if peer not in self._peer_down:
            self._peer_down.add(peer)
            logger.warning("fabric advert to %s failed: %s", peer, exc)

    def _note_success(self, peer: str) -> None:
        self.sent += 1
        self._peer_down.discard(peer)
        if self.metrics is not None:
            try:
                self.metrics.llm_fabric_adverts.labels(
                    direction="sent").inc()
            except Exception:
                pass

    # ---------------------------------------------------------------- receive

    def _merge_in(self, payloads: list[dict[str, Any]]) -> int:
        fabric = self._fabric()
        if fabric is None:
            return 0
        fresh = merge_wire_adverts(fabric, payloads)
        self.merged_in += fresh
        if fresh and self.metrics is not None:
            try:
                self.metrics.llm_fabric_adverts.labels(
                    direction="merged").inc(fresh)
            except Exception:
                pass
        return fresh

    async def handle_advert(self, params: dict[str, Any]) -> dict[str, Any]:
        """``fabric.advert`` bus-RPC handler / HTTP endpoint core: merge
        the sender's batch, answer with the local view (the gossip
        exchange). Malformed adverts raise ``ValueError`` — the bus
        layer maps it to an RPC error frame, the HTTP handler to 400."""
        payloads = params.get("adverts")
        if not isinstance(payloads, list):
            raise ValueError("fabric.advert params need an 'adverts' list")
        merged = self._merge_in(payloads)
        fabric = self._fabric()
        local: list[dict[str, Any]] = []
        if fabric is not None:
            local = [a.to_wire() for a in fabric.adverts(self.host_id)]
        advert = self._local_advert()
        if advert is not None:
            local.append(advert.to_wire())
        return {"merged": merged, "adverts": local}

    # ------------------------------------------------------------------ stats

    def stats(self) -> dict[str, Any]:
        return {"host": self.host_id, "interval_s": self.interval_s,
                "ttl_s": self.ttl_s, "sent": self.sent,
                "merged_in": self.merged_in,
                "send_failures": self.send_failures,
                "bus": self.rpc is not None,
                "http_peers": list(self.http_peers)}
