"""Pool-global prefix index: hashed full-page prefix chains -> locations.

One instance is shared by every replica in an ``EnginePool`` (and by the
pool's router). Each entry maps the chained hash of a full-page prompt
prefix (see :func:`chain_hash`) to WHERE that page's KV is currently
materialized:

- ``hbm`` locations name the replica(s) whose resident prefix cache
  holds the page — the router treats those as affinity targets, because
  only that replica's own allocator can serve the page without a
  restore;
- ``tier`` locations name the pool-shared spill tiers (``host``/
  ``disk`` — ``tpu_local/kv/tiers.py``) — ANY replica can fetch-on-miss
  from them at admission, so a tier hit is affinity-neutral for
  placement but still counts as a hit for routing accounting;
- ``object:<key>`` locations name the chain's blob in the cross-host
  object fabric (``tpu_local/kv/fabric/``) — like a shared tier for
  routing purposes, but host-global: the key is the tenant-namespaced
  blob name any host sharing the store can fetch.

The index stores ONLY hashes, never token content: a hash collision can
therefore mis-route (the chosen replica's local probe then finds
nothing — harmless) or trigger a tier fetch whose payload verification
fails (tiers.py compares the stored parent hash + exact chunk tokens
before serving — the fetch degrades to a miss). Wrong pages are never
served on a collision; the payload check is the gate.

Thread model: published from engine dispatch threads (register/evict/
spill) and the store's spill worker, read from the gateway loop (router
scoring). Every access takes the internal lock; all operations are
dict-sized, never device-touching.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Iterable, Sequence

import numpy as np

#: chain root: the hash "parent" of the first page of every prompt.
ROOT_HASH = hashlib.sha256(b"mcpforge-prefix-chain-root").digest()


def chain_hash(parent: bytes, chunk: Sequence[int]) -> bytes:
    """Chained digest of one full page of prompt tokens under ``parent``
    (the previous page's chain hash, ``ROOT_HASH`` for the first page).
    Two prefixes share a chain hash iff they share every token of every
    page up to that depth — modulo sha256 collisions, which the tier
    payload verification (not this index) guards against."""
    h = hashlib.sha256(parent)
    h.update(np.asarray(list(chunk), dtype=np.int64).tobytes())
    return h.digest()


def chain_hashes(prompt_ids: Sequence[int], page_size: int) -> list[bytes]:
    """Chain hash per matchable full page of ``prompt_ids`` (matches never
    cover the prompt's last token — same rule as the allocator's walk)."""
    max_pages = max(0, (len(prompt_ids) - 1) // page_size)
    out: list[bytes] = []
    parent = ROOT_HASH
    for i in range(max_pages):
        parent = chain_hash(parent,
                            prompt_ids[i * page_size:(i + 1) * page_size])
        out.append(parent)
    return out


def chain_pages(prompt_ids: Sequence[int], page_size: int
                ) -> list[tuple[bytes, bytes, tuple[int, ...]]]:
    """``(key_hash, parent, chunk)`` per FULL page of ``prompt_ids`` —
    the registration-depth walk (``len // page_size`` pages, one deeper
    than :func:`chain_hashes`' matchable walk). This is the identity
    evidence the tier store's verify-before-serve compares, so the
    pool's migration path can verify an exported chain without touching
    any allocator state."""
    out: list[tuple[bytes, bytes, tuple[int, ...]]] = []
    parent = ROOT_HASH
    for i in range(len(prompt_ids) // page_size):
        chunk = tuple(int(t) for t in
                      prompt_ids[i * page_size:(i + 1) * page_size])
        key_hash = chain_hash(parent, chunk)
        out.append((key_hash, parent, chunk))
        parent = key_hash
    return out


class PrefixIndex:
    """Pool-global location map for prefix-chain pages (see module doc)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hbm: dict[bytes, set[str]] = {}   # hash -> replica ids
        self._tier: dict[bytes, set[str]] = {}  # hash -> {"host","disk"}
        self._object: dict[bytes, str] = {}     # hash -> object blob key

    # ------------------------------------------------------------ publication

    def publish_hbm(self, key_hash: bytes, replica: str) -> None:
        with self._lock:
            self._hbm.setdefault(key_hash, set()).add(replica)

    def unpublish_hbm(self, key_hash: bytes, replica: str) -> None:
        with self._lock:
            replicas = self._hbm.get(key_hash)
            if replicas is not None:
                replicas.discard(replica)
                if not replicas:
                    del self._hbm[key_hash]

    def drop_replica(self, replica: str) -> None:
        """Forget every HBM entry of one replica — called when its KV pool
        is rebuilt (crash restart, reload): the resident pages are gone
        and stale entries would mis-route until they aged out."""
        with self._lock:
            for key_hash in [k for k, v in self._hbm.items()
                             if replica in v]:
                self._hbm[key_hash].discard(replica)
                if not self._hbm[key_hash]:
                    del self._hbm[key_hash]

    def publish_tier(self, key_hash: bytes, tier: str) -> None:
        with self._lock:
            self._tier.setdefault(key_hash, set()).add(tier)

    def unpublish_tier(self, key_hash: bytes, tier: str) -> None:
        with self._lock:
            tiers = self._tier.get(key_hash)
            if tiers is not None:
                tiers.discard(tier)
                if not tiers:
                    del self._tier[key_hash]

    def publish_object(self, key_hash: bytes, object_key: str) -> None:
        """Record the chain page's blob in the shared object fabric.
        The ``object:<key>`` location class is host-global: unlike
        ``host``/``disk`` it survives this process and is reachable
        from any host sharing the store."""
        with self._lock:
            self._object[key_hash] = object_key

    def unpublish_object(self, key_hash: bytes) -> None:
        with self._lock:
            self._object.pop(key_hash, None)

    # ----------------------------------------------------------------- lookup

    def locations(self, key_hash: bytes) -> dict[str, Any]:
        with self._lock:
            object_key = self._object.get(key_hash)
            return {"hbm": set(self._hbm.get(key_hash, ())),
                    "tiers": set(self._tier.get(key_hash, ())),
                    "object": f"object:{object_key}"
                    if object_key is not None else None}

    def chain_locations(self, prompt_ids: Sequence[int], page_size: int
                        ) -> list[tuple[set[str], bool]]:
        """Per matchable full page of ``prompt_ids`` (depth order):
        ``(replicas_with_hbm_copy, shared_tier_available)``. The router
        folds this into per-replica affinity: replica R can serve depth i
        without prefill iff every depth <= i is in R's HBM set or in a
        shared tier (fetch-on-miss restores the latter at admission)."""
        hashes = chain_hashes(prompt_ids, page_size)
        with self._lock:
            return [(set(self._hbm.get(h, ())),
                     bool(self._tier.get(h)) or h in self._object)
                    for h in hashes]

    def reachable_tokens(self, chain: Iterable[tuple[set[str], bool]],
                         replica: str, page_size: int) -> int:
        """Tokens of the chain ``replica`` could serve without dense
        prefill: consecutive depths available locally (HBM) or from a
        shared tier. Stops at the first page only ANOTHER replica's HBM
        holds — cross-replica HBM reads don't exist (the router routes
        TO that replica instead)."""
        depth = 0
        for hbm, tiered in chain:
            if replica in hbm or tiered:
                depth += 1
            else:
                break
        return depth * page_size

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"keys_hbm": len(self._hbm),
                    "keys_tiered": len(self._tier),
                    "keys_object": len(self._object)}
