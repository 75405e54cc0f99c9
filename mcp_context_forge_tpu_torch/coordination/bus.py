"""Pub/sub event bus, the Redis pub/sub analog (a copy of the JAX package's
``coordination/bus.py``; stdlib only).

- ``MemoryEventBus``: one process; publish fans out to local subscribers.
- ``FileEventBus``: N processes on one host share an append-only sqlite
  message log, polled every ``POLL_INTERVAL`` seconds, so a message to
  another process waits up to that long.
- ``TcpEventBus`` (``hub.py``): through the TCP coordination hub.

Messages are JSON objects. The memory bus passes them through as they are;
the file and TCP buses encode them, so a value JSON cannot encode (a numpy
or torch scalar) fails on the publisher's side only on those buses.
"""

from __future__ import annotations

import asyncio
import json
import os
import sqlite3
import time
from abc import ABC, abstractmethod
import tempfile
from typing import Any, Awaitable, Callable

Handler = Callable[[str, dict[str, Any]], Awaitable[None]]


class EventBus(ABC):
    """Topic-based pub/sub. Messages are JSON objects."""

    @abstractmethod
    async def publish(self, topic: str, message: dict[str, Any]) -> None: ...

    @abstractmethod
    def subscribe(self, topic: str, handler: Handler) -> Callable[[], None]:
        """Register handler; returns an unsubscribe callable."""

    async def start(self) -> None:  # pragma: no cover - default no-op
        return None

    async def stop(self) -> None:  # pragma: no cover - default no-op
        return None


class MemoryEventBus(EventBus):
    """In-process bus: publish fans out to local subscribers on the loop."""

    def __init__(self) -> None:
        self._subs: dict[str, list[Handler]] = {}

    async def publish(self, topic: str, message: dict[str, Any]) -> None:
        for handler in list(self._subs.get(topic, ())):
            try:
                await handler(topic, message)
            except Exception:  # subscriber errors must not break publishers
                pass

    def subscribe(self, topic: str, handler: Handler) -> Callable[[], None]:
        self._subs.setdefault(topic, []).append(handler)

        def _unsub() -> None:
            try:
                self._subs.get(topic, []).remove(handler)
            except ValueError:
                pass

        return _unsub


class FileEventBus(EventBus):
    """Shared-filesystem bus: append-only sqlite message log + pollers.

    Good enough for N gateway workers on one host.
    """

    POLL_INTERVAL = 0.2

    def __init__(self, directory: str) -> None:
        self._dir = directory
        self._subs: dict[str, list[Handler]] = {}
        self._task: asyncio.Task | None = None
        self._cursor = 0
        self._own_ids: set[int] = set()  # delivered locally at publish; poller skips
        os.makedirs(directory, exist_ok=True)
        self._db_path = os.path.join(directory, "bus.db")
        self._init_db()

    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self._db_path, timeout=5.0)
        conn.execute("PRAGMA journal_mode=WAL")
        return conn

    def _init_db(self) -> None:
        with self._connect() as conn:
            conn.execute(
                "CREATE TABLE IF NOT EXISTS messages ("
                " id INTEGER PRIMARY KEY AUTOINCREMENT, topic TEXT NOT NULL,"
                " payload TEXT NOT NULL, ts REAL NOT NULL)"
            )
            row = conn.execute("SELECT COALESCE(MAX(id), 0) FROM messages").fetchone()
            self._cursor = row[0]

    async def publish(self, topic: str, message: dict[str, Any]) -> None:
        payload = json.dumps(message, separators=(",", ":"))

        def _write() -> int:
            with self._connect() as conn:
                cur = conn.execute(
                    "INSERT INTO messages (topic, payload, ts) VALUES (?,?,?)",
                    (topic, payload, time.time()),
                )
                return cur.lastrowid or 0

        rowid = await asyncio.get_running_loop().run_in_executor(None, _write)
        self._own_ids.add(rowid)
        # also deliver locally without waiting for the poll cycle
        for handler in list(self._subs.get(topic, ())):
            try:
                await handler(topic, message)
            except Exception:
                pass

    def subscribe(self, topic: str, handler: Handler) -> Callable[[], None]:
        self._subs.setdefault(topic, []).append(handler)

        def _unsub() -> None:
            try:
                self._subs.get(topic, []).remove(handler)
            except ValueError:
                pass

        return _unsub

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._poll_loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _poll_loop(self) -> None:
        while True:
            await asyncio.sleep(self.POLL_INTERVAL)
            rows = await asyncio.get_running_loop().run_in_executor(None, self._fetch_new)
            for mid, topic, payload in rows:
                if mid in self._own_ids:
                    self._own_ids.discard(mid)
                    continue
                for handler in list(self._subs.get(topic, ())):
                    try:
                        await handler(topic, json.loads(payload))
                    except Exception:
                        pass

    def _fetch_new(self) -> list[tuple[int, str, str]]:
        with self._connect() as conn:
            rows = conn.execute(
                "SELECT id, topic, payload FROM messages WHERE id > ? ORDER BY id",
                (self._cursor,),
            ).fetchall()
        if rows:
            self._cursor = rows[-1][0]
        return [(i, t, p) for i, t, p in rows]


def default_directory() -> str:
    """The file backends' shared directory when none is given: under the
    process's temporary directory (``TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), "mcpforge-bus")


def make_bus(backend: str, directory: str | None = None) -> EventBus:
    if backend == "file":
        return FileEventBus(directory or default_directory())
    return MemoryEventBus()
