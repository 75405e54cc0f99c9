"""Shared key-value store, the Redis-keys analog beside pub/sub and leases
(a copy of the JAX package's ``coordination/kv.py``; stdlib only). Its
backends follow the event bus's:

- ``MemoryKVStore``: one process;
- ``FileKVStore``: N workers on one host share a directory;
- ``TcpKVStore``: across hosts, through the coordination hub (``hub.py``).

Values are JSON-serializable objects; ``ttl`` seconds (0 = no expiry).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import os
import time
from abc import ABC, abstractmethod
from typing import Any

from .bus import default_directory


class KVStore(ABC):
    @abstractmethod
    async def set(self, key: str, value: Any, ttl: float = 0.0) -> None: ...

    @abstractmethod
    async def get(self, key: str) -> Any:
        """Returns the stored value, or None when absent/expired."""

    @abstractmethod
    async def delete(self, key: str) -> None: ...

    async def purge_expired(self) -> int:
        """Drop expired entries eagerly. get() already expires lazily, but
        abandoned keys that are never read again (stale chat sessions)
        would otherwise accumulate forever — the gateway's periodic
        sweeper calls this. Returns the number purged. The hub backend
        no-ops (the hub sweeps server-side)."""
        return 0


class MemoryKVStore(KVStore):
    def __init__(self) -> None:
        self._data: dict[str, tuple[Any, float]] = {}

    async def set(self, key: str, value: Any, ttl: float = 0.0) -> None:
        self._data[key] = (value, time.monotonic() + ttl if ttl else 0.0)

    async def get(self, key: str) -> Any:
        entry = self._data.get(key)
        if entry is None:
            return None
        if entry[1] and entry[1] <= time.monotonic():
            del self._data[key]
            return None
        return entry[0]

    async def delete(self, key: str) -> None:
        self._data.pop(key, None)

    async def purge_expired(self) -> int:
        now = time.monotonic()
        dead = [k for k, (_, exp) in self._data.items()
                if exp and exp <= now]
        for k in dead:
            del self._data[k]
        return len(dead)


class FileKVStore(KVStore):
    """One JSON file per key under ``dir/kv/`` — atomic via rename, so a
    concurrent reader sees the old or the new value, never a torn write."""

    def __init__(self, directory: str):
        self._dir = os.path.join(directory, "kv")
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, key: str) -> str:
        # collision-free: distinct keys must never share a file (client-
        # supplied session ids flow in here), so hash rather than sanitize;
        # a short readable prefix keeps the directory debuggable
        prefix = "".join(c if c.isalnum() or c in "-_." else "_"
                         for c in key)[:40]
        digest = hashlib.sha256(key.encode()).hexdigest()[:24]
        return os.path.join(self._dir, f"{prefix}.{digest}.json")

    def _legacy_path(self, key: str) -> str | None:
        # pre-hash naming: fallback so entries written before the
        # collision fix (and by older workers sharing bus_dir during a
        # rolling restart) stay visible — but ONLY for keys whose
        # sanitized form is lossless: a lossy key's legacy filename is
        # ambiguous (several keys collapse onto it), so reading or
        # deleting it could cross into a DIFFERENT key's entry
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in key)
        if safe != key:
            return None
        return os.path.join(self._dir, safe + ".json")

    # sync bodies run via asyncio.to_thread: these sit on the gateway
    # request path (chat session state), and a slow/contended disk would
    # otherwise stall every in-flight request on the loop

    def _set_sync(self, key: str, value: Any, ttl: float) -> None:
        path = self._path(key)
        payload = {"value": value,
                   "expires": time.time() + ttl if ttl else 0.0}
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)

    async def set(self, key: str, value: Any, ttl: float = 0.0) -> None:
        await asyncio.to_thread(self._set_sync, key, value, ttl)

    def _read_sync(self, key: str) -> Any:
        for path in (self._path(key), self._legacy_path(key)):
            if path is None:
                continue
            try:
                with open(path) as fh:
                    return json.load(fh)
            except (FileNotFoundError, json.JSONDecodeError):
                continue
        return None

    async def get(self, key: str) -> Any:
        payload = await asyncio.to_thread(self._read_sync, key)
        if payload is None:
            return None
        if payload["expires"] and payload["expires"] <= time.time():
            await self.delete(key)
            return None
        return payload["value"]

    def _delete_sync(self, key: str) -> None:
        for path in (self._path(key), self._legacy_path(key)):
            if path is None:
                continue
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    async def delete(self, key: str) -> None:
        await asyncio.to_thread(self._delete_sync, key)

    def _purge_sync(self) -> int:
        purged = 0
        now = time.time()
        for entry in os.listdir(self._dir):
            path = os.path.join(self._dir, entry)
            try:
                with open(path) as fh:
                    payload = json.load(fh)
                if payload.get("expires") and payload["expires"] <= now:
                    os.unlink(path)
                    purged += 1
            except (OSError, json.JSONDecodeError):
                continue  # concurrent writer/deleter; next sweep retries
        return purged

    async def purge_expired(self) -> int:
        return await asyncio.to_thread(self._purge_sync)


class TcpKVStore(KVStore):
    """Hub-backed KV (CoordinationHub kv_set/kv_get/kv_del frames)."""

    def __init__(self, client):
        self._client = client

    async def set(self, key: str, value: Any, ttl: float = 0.0) -> None:
        await self._client.kv_set(key, value, ttl)

    async def get(self, key: str) -> Any:
        try:
            return await self._client.kv_get(key)
        except (ConnectionError, TimeoutError):
            return None

    async def delete(self, key: str) -> None:
        try:
            await self._client.kv_del(key)
        except (ConnectionError, TimeoutError):
            pass


def make_kv(backend: str, directory: str | None = None) -> KVStore:
    if backend == "file":
        return FileKVStore(directory or default_directory())
    return MemoryKVStore()
