"""Replica routing for the EnginePool (a copy of the JAX package's
``tpu_local/pool/router.py``).

Two signals, in order:

1. **prefix-cache affinity**: each replica owns its own KV pool and prefix
   cache, so a request whose prompt prefix is resident on replica R
   prefills only its suffix there and the whole prompt anywhere else.
   Affinity is scored from both views of residency: the replica's own
   read-only ``allocator.probe_prefix`` (its pool, plus the shared spill
   store it could restore from when tiers are on) and the pool-wide prefix
   index (``kv/prefix_index.py``). A prefix resident only on replica 1's
   pool raises replica 1's score whichever replica is examined first, and
   a chain spilled to the shared tiers counts as a hit for every replica
   (fetch-on-miss restores it at admission, so tier hits are real but
   placement-neutral: the load signal below breaks the tie). No probe
   takes a page reference. A win counts only when it is worth at least one
   full page: a shorter match saves no prefill.
2. **least outstanding decode tokens**: among equally affine replicas, the
   one with the least budgeted work (the sum of its in-flight requests'
   remaining ``max_tokens``). Ties break round-robin so cold starts spread.

With roles assigned, a third signal runs first: a classed request
("prefill"/"decode", or any fleet class behind the same field) is scored
only over replicas holding that exact role plus the "any" generalists,
which carry an outstanding-token penalty, so an oversubscribed exact-role
tier spills onto idle generalists but never loses to them at load parity.
A class no replica serves falls back to the whole routable set: roles
shape placement, they never refuse capacity.

Priority rides through the router untouched: admission classes are each
replica's scheduler's concern, not placement's.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..kv.prefix_index import PrefixIndex
    from .pool import EngineReplica


class ReplicaRouter:
    """Scores routable replicas; owns the routing counters the admin
    surface reports. Runs on the pool's event loop."""

    def __init__(self, affinity: bool = True,
                 index: "PrefixIndex | None" = None,
                 page_size: int = 0,
                 role_penalty_tokens: int = 256) -> None:
        self.affinity_routing = affinity
        self._index = index
        self._page_size = page_size
        self.role_penalty_tokens = max(0, int(role_penalty_tokens))
        self.routed = 0
        self.affinity_hits = 0
        self.index_hits = 0       # routes the pool index steered
        self.role_routed = 0      # classed routes an exact role served
        self.role_spills = 0      # classed routes an "any" replica took
        self._rr = 0              # round-robin tiebreak cursor

    def route(self, replicas: Sequence["EngineReplica"],
              prompt_ids: list[int],
              route_class: str = "") -> tuple["EngineReplica", bool]:
        """Pick a replica for ``prompt_ids`` among ``replicas`` (routable,
        non-empty). Returns (replica, affinity_hit). Host-side scoring only
        (dict walks over the allocators and the pool index), no device
        sync. A single routable replica still scores, so the affinity
        counts stay true when the pool is down to one survivor. A non-empty
        ``route_class`` narrows the candidates to exact-role and "any"
        replicas, falling back to all when the class is unserved."""
        candidates: Sequence["EngineReplica"] = replicas
        if route_class:
            narrowed = [r for r in replicas if r.role in (route_class, "any")]
            if narrowed:
                candidates = narrowed
        choice, hit = self._score(candidates, prompt_ids, route_class)
        self.routed += 1
        if hit:
            self.affinity_hits += 1
        if route_class:
            if choice.role == route_class:
                self.role_routed += 1
            elif choice.role == "any":
                self.role_spills += 1
        return choice, hit

    def _score(self, replicas: Sequence["EngineReplica"],
               prompt_ids: list[int],
               route_class: str = "") -> tuple["EngineReplica", bool]:
        best = None
        best_key = None
        best_hist = 0
        chain = None
        if self.affinity_routing and self._index is not None and self._page_size > 0:
            chain = self._index.chain_locations(prompt_ids, self._page_size)
            if not any(hbm or tiered for hbm, tiered in chain):
                chain = None  # nothing indexed: skip the per-replica fold
        best_from_index = False
        self._rr += 1
        for i, replica in enumerate(replicas):
            hist = 0
            from_index = False
            if self.affinity_routing:
                engine = replica.engine
                if engine.config.prefix_cache:
                    hist = engine.allocator.probe_prefix(prompt_ids)
                    if chain is not None:
                        # the pool-wide view: pages resident on THIS
                        # replica's pool or restorable from a shared tier
                        idx_hist = self._index.reachable_tokens(
                            chain, replica.id, self._page_size)
                        if idx_hist > hist:
                            hist = idx_hist
                            from_index = True
                    if hist < engine.config.page_size:
                        hist = 0  # a sub-page match saves no prefill
            # most affinity, then least outstanding tokens (generalists pay
            # the role penalty), then round-robin
            load = replica.outstanding_tokens()
            if route_class and replica.role != route_class:
                load += self.role_penalty_tokens
            key = (-hist, load, (i + self._rr) % len(replicas))
            if best_key is None or key < best_key:
                best, best_key, best_hist = replica, key, hist
                best_from_index = from_index and hist > 0
        if best_from_index:
            self.index_hits += 1
        return best, best_hist > 0

    def counters(self) -> dict[str, int]:
        return {"routed": self.routed, "affinity_hits": self.affinity_hits,
                "index_hits": self.index_hits,
                "role_routed": self.role_routed,
                "role_spills": self.role_spills}
