"""TTL cache for entity list endpoints (a copy of the JAX package's
``gateway/registry_cache.py``), under the ``registry_cache_*`` settings:
``registry_cache_enabled`` and a TTL per entity (tools, resources, prompts,
servers, gateways).

Design: the cache subscribes to the SAME ``<entity>.changed`` bus topics
that drive cross-worker sync and listChanged notifications, so a write
on any worker flushes every worker's cache immediately — the TTL only
bounds staleness for changes the bus cannot see (direct DB edits).
Values are the service-layer lists, keyed by the query flags (and, for
the team-scoped tool list, the viewer's team set) that change the
result.

A per-entity generation counter closes the miss-load-put race: a load
that started before an invalidation must not re-cache its pre-write
snapshot after the event fired, so ``put`` drops the value unless the
generation captured at miss time is still current.
"""

from __future__ import annotations

import time
from typing import Any

ENTITIES = ("tools", "resources", "prompts", "servers", "gateways")


class RegistryCache:
    def __init__(self, ctx) -> None:
        self._ctx = ctx
        self._store: dict[tuple[str, str], tuple[Any, float]] = {}
        self._gen: dict[str, int] = {e: 0 for e in ENTITIES}
        self.hits = 0
        self.misses = 0

    def wire(self) -> None:
        """Subscribe invalidation to the per-entity change topics."""
        for entity in ENTITIES:
            async def _handler(_topic, _msg, entity=entity):
                self.invalidate(entity)
            self._ctx.bus.subscribe(f"{entity}.changed", _handler)

    def _ttl(self, entity: str) -> float:
        settings = self._ctx.settings
        return getattr(settings, f"registry_cache_{entity}_ttl_s",
                       settings.registry_cache_default_ttl_s)

    def generation(self, entity: str) -> int:
        return self._gen.get(entity, 0)

    def get(self, entity: str, key: str) -> Any | None:
        hit = self._store.get((entity, key))
        if hit is not None and hit[1] <= time.monotonic():
            # evict on expiry: team-scoped keys churn, and dead entries
            # would otherwise accumulate until the next change event
            del self._store[(entity, key)]
            hit = None
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        return hit[0]

    def put(self, entity: str, key: str, value: Any,
            generation: int | None = None) -> None:
        if generation is not None and generation != self._gen.get(entity, 0):
            return  # invalidated while the loader ran: stale snapshot
        ttl = self._ttl(entity)
        if ttl > 0:
            self._store[(entity, key)] = (value, time.monotonic() + ttl)

    def invalidate(self, entity: str | None = None) -> None:
        for name in ([entity] if entity else list(ENTITIES)):
            self._gen[name] = self._gen.get(name, 0) + 1
        if entity is None:
            self._store.clear()
            return
        for k in [k for k in self._store if k[0] == entity]:
            del self._store[k]
