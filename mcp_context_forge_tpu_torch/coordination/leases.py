"""Leases and leader election, the Redis ``SET NX EX`` analog (a copy of the
JAX package's ``coordination/leases.py``; stdlib only).

acquire = SET NX EX (take the lease iff it is free, expired or already
ours); renew = compare-owner-and-extend; a follower acquires when the
leader's lease expires. The same contract over three backends: memory
(one process), file (sqlite compare-and-set, N processes on one host) and
the TCP hub (``hub.py`` ``TcpLeaseManager``).
"""

from __future__ import annotations

import asyncio
import os
import sqlite3
import time
from abc import ABC, abstractmethod
from typing import Awaitable, Callable

from .bus import default_directory


class LeaseManager(ABC):
    @abstractmethod
    async def acquire(self, name: str, owner: str, ttl: float) -> bool:
        """Take the lease iff free or expired. True on success."""

    @abstractmethod
    async def renew(self, name: str, owner: str, ttl: float) -> bool:
        """Extend iff still owned by ``owner`` (compare-and-renew)."""

    @abstractmethod
    async def release(self, name: str, owner: str) -> None: ...

    async def force_release(self, name: str) -> None:
        """Break a lease regardless of owner (dead-owner cleanup only)."""
        holder = await self.holder(name)
        if holder is not None:
            await self.release(name, holder)

    @abstractmethod
    async def holder(self, name: str) -> str | None: ...


class MemoryLeaseManager(LeaseManager):
    def __init__(self) -> None:
        self._leases: dict[str, tuple[str, float]] = {}  # name -> (owner, expires)

    async def acquire(self, name: str, owner: str, ttl: float) -> bool:
        now = time.monotonic()
        cur = self._leases.get(name)
        if cur is None or cur[1] <= now or cur[0] == owner:
            self._leases[name] = (owner, now + ttl)
            return True
        return False

    async def renew(self, name: str, owner: str, ttl: float) -> bool:
        now = time.monotonic()
        cur = self._leases.get(name)
        if cur is not None and cur[0] == owner and cur[1] > now:
            self._leases[name] = (owner, now + ttl)
            return True
        return False

    async def release(self, name: str, owner: str) -> None:
        cur = self._leases.get(name)
        if cur is not None and cur[0] == owner:
            del self._leases[name]

    async def holder(self, name: str) -> str | None:
        cur = self._leases.get(name)
        if cur is None or cur[1] <= time.monotonic():
            return None
        return cur[0]


class FileLeaseManager(LeaseManager):
    """sqlite-backed leases for multi-worker single-host (wall-clock based)."""

    def __init__(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        self._db_path = os.path.join(directory, "leases.db")
        with self._connect() as conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS leases ("
                " name TEXT PRIMARY KEY, owner TEXT NOT NULL, expires REAL NOT NULL)"
            )

    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self._db_path, timeout=5.0)
        conn.execute("PRAGMA journal_mode=WAL")
        return conn

    async def _run(self, fn: Callable, *args):
        return await asyncio.get_running_loop().run_in_executor(None, fn, *args)

    def _acquire_sync(self, name: str, owner: str, ttl: float) -> bool:
        now = time.time()
        with self._connect() as conn:
            conn.execute("BEGIN IMMEDIATE")
            row = conn.execute("SELECT owner, expires FROM leases WHERE name=?", (name,)).fetchone()
            if row is None or row[1] <= now or row[0] == owner:
                conn.execute(
                    "INSERT INTO leases (name, owner, expires) VALUES (?,?,?)"
                    " ON CONFLICT(name) DO UPDATE SET owner=excluded.owner, expires=excluded.expires",
                    (name, owner, now + ttl),
                )
                conn.commit()
                return True
            conn.commit()
            return False

    def _renew_sync(self, name: str, owner: str, ttl: float) -> bool:
        now = time.time()
        with self._connect() as conn:
            cur = conn.execute(
                "UPDATE leases SET expires=? WHERE name=? AND owner=? AND expires>?",
                (now + ttl, name, owner, now),
            )
            conn.commit()
            return cur.rowcount > 0

    async def acquire(self, name: str, owner: str, ttl: float) -> bool:
        return await self._run(self._acquire_sync, name, owner, ttl)

    async def renew(self, name: str, owner: str, ttl: float) -> bool:
        return await self._run(self._renew_sync, name, owner, ttl)

    async def release(self, name: str, owner: str) -> None:
        def _release() -> None:
            with self._connect() as conn:
                conn.execute("DELETE FROM leases WHERE name=? AND owner=?", (name, owner))
                conn.commit()

        await self._run(_release)

    async def holder(self, name: str) -> str | None:
        def _holder() -> str | None:
            with self._connect() as conn:
                row = conn.execute(
                    "SELECT owner FROM leases WHERE name=? AND expires>?", (name, time.time())
                ).fetchone()
                return row[0] if row else None

        return await self._run(_holder)


class LeaderElector:
    """Background loop that keeps trying to hold a named lease.

    ``on_elected``/``on_lost`` fire on transitions; ``is_leader`` gates
    singleton work (federation health checks, metric rollups) exactly like
    the reference's leader-gated loops."""

    def __init__(
        self,
        leases: LeaseManager,
        name: str,
        owner: str,
        ttl: float = 15.0,
        on_elected: Callable[[], Awaitable[None]] | None = None,
        on_lost: Callable[[], Awaitable[None]] | None = None,
    ) -> None:
        self._leases = leases
        self._name = name
        self._owner = owner
        self._ttl = ttl
        self._on_elected = on_elected
        self._on_lost = on_lost
        self._task: asyncio.Task | None = None
        self.is_leader = False

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self.is_leader:
            await self._leases.release(self._name, self._owner)
            self.is_leader = False

    async def _loop(self) -> None:
        while True:
            try:
                if self.is_leader:
                    ok = await self._leases.renew(self._name, self._owner, self._ttl)
                    if not ok:
                        self.is_leader = False
                        if self._on_lost:
                            await self._on_lost()
                else:
                    ok = await self._leases.acquire(self._name, self._owner, self._ttl)
                    if ok:
                        self.is_leader = True
                        if self._on_elected:
                            await self._on_elected()
            except Exception:
                pass
            await asyncio.sleep(self._ttl / 3.0)


def make_lease_manager(backend: str, directory: str | None = None) -> LeaseManager:
    if backend == "file":
        return FileLeaseManager(directory or default_directory())
    return MemoryLeaseManager()
