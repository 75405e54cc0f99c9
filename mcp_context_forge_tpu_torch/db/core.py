"""Async sqlite3 database core (a copy of the JAX package's ``db/core.py``).

sqlite3 is synchronous; statements run on dedicated executor threads
(sqlite connections are not thread-safe across threads, and a shared
in-memory database needs one connection), so the event loop never blocks
on I/O.

Connection pool (``pool_size > 1``, file-backed WAL databases only): every
write stays on ONE writer lane (sqlite has a single write lock), while
read-only statements fan out over ``pool_size - 1`` reader lanes, each its
own connection on its own executor thread. A statement cache memoizes the
read/write routing decision per SQL text and sizes sqlite's native
prepared-statement cache (``cached_statements``) to match.

Each statement charges the request's phase clock (``db.execute``: in-lock
statement time, ``db.acquire``: the wait for the lock) and rides the
``db.execute`` fault point; ``query_log_capture`` collects (sql, ms) for
the enclosed code.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import sqlite3
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Iterable, Iterator, Sequence

# module-top, not per-statement: execute() is the gateway's hottest DB
# path and the fault point's disabled cost must stay one dict miss
from ..observability.faults import fault_point
from ..observability.phases import current_phases

# per-task query telemetry (db_query_logging_middleware): None = off;
# a list collects (normalized sql, elapsed ms) for every statement the
# current task runs. ContextVar so concurrent requests never interleave.
_query_capture: contextvars.ContextVar[list | None] = \
    contextvars.ContextVar("db_query_capture", default=None)


@contextmanager
def query_log_capture() -> Iterator[list[tuple[str, float]]]:
    """Collect (sql, ms) for every query the enclosed code runs."""
    token = _query_capture.set([])
    try:
        yield _query_capture.get()
    finally:
        _query_capture.reset(token)


def iter_outside_literal_segments(sql: str):
    """Yield ``(offset, segment)`` for every stretch of ``sql`` OUTSIDE
    single-quoted string literals (sqlite/PG '' escapes fall out of the
    parity naturally). THE one implementation of the literal-skipping
    idiom, for the dialect translators to share."""
    offset = 0
    for i, segment in enumerate(sql.split("'")):
        if i % 2 == 0:
            yield offset, segment
        offset += len(segment) + 1


def map_outside_literals(sql: str, fn) -> str:
    """Rewrite only the outside-literal segments with ``fn``."""
    parts = sql.split("'")
    for i in range(0, len(parts), 2):
        parts[i] = fn(parts[i])
    return "'".join(parts)


@dataclass(frozen=True)
class Migration:
    version: int
    name: str
    sql: str  # multiple statements allowed


# SQL verbs that never write; WITH needs a body scan (sqlite allows
# WITH ... INSERT/UPDATE/DELETE), EXPLAIN is read-only by construction
_READ_VERBS = frozenset({"select", "explain", "values"})
_WRITE_TOKENS = ("insert", "update", "delete", "replace", "create",
                 "drop", "alter", "vacuum", "reindex")


def _is_read_only(sql: str) -> bool:
    head = sql.lstrip().split(None, 1)
    verb = head[0].lower() if head else ""
    if verb in _READ_VERBS:
        return True
    if verb != "with":
        return False
    lowered = " ".join(seg.lower() for _off, seg in
                       iter_outside_literal_segments(sql))
    return not any(tok in lowered.split() for tok in _WRITE_TOKENS)


class _StatementCache:
    """SQL text -> routing decision + hit counts.

    The expensive prepared-statement reuse itself lives inside sqlite
    (``cached_statements``, sized from this cache's capacity); this layer
    memoizes the Python-side per-statement work — the read/write lane
    routing decision — and keeps honest hit/miss counters so the
    diagnostics surface can say whether the cache is actually hot."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(8, capacity)
        self._entries: dict[str, bool] = {}  # sql -> is_read_only
        self.hits = 0
        self.misses = 0

    def is_read(self, sql: str) -> bool:
        cached = self._entries.get(sql)
        if cached is not None:
            self.hits += 1
            return cached
        self.misses += 1
        decision = _is_read_only(sql)
        if len(self._entries) >= self.capacity:
            # drop the oldest insertion (dict preserves order); hot
            # statements re-enter immediately so FIFO is fine here
            self._entries.pop(next(iter(self._entries)))
        self._entries[sql] = decision
        return decision

    def stats(self) -> dict[str, int | float]:
        total = self.hits + self.misses
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "capacity": self.capacity,
                "hit_rate": round(self.hits / total, 4) if total else 0.0}


class _Lane:
    """One sqlite connection pinned to one executor thread."""

    __slots__ = ("executor", "conn", "lock")

    def __init__(self, name: str):
        self.executor = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix=name)
        self.conn: sqlite3.Connection | None = None
        self.lock = threading.Lock()


class Database:
    """One writer connection (+ optional WAL reader lanes), async API."""

    # RETURNING landed in sqlite 3.35; serving images commonly ship older
    # (3.34 observed) — callers needing claim semantics branch on this
    supports_returning = sqlite3.sqlite_version_info >= (3, 35, 0)

    def __init__(self, path: str = ":memory:",
                 busy_timeout_ms: int = 10000, max_retries: int = 3,
                 retry_interval_ms: float = 50.0, pool_size: int = 1,
                 statement_cache_size: int = 256):
        self._path = path
        self._busy_timeout_ms = busy_timeout_ms
        self._max_retries = max(0, max_retries)
        self._retry_interval_s = max(0.0, retry_interval_ms) / 1000.0
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="db")
        self._conn: sqlite3.Connection | None = None
        self._closed = False
        self._lock = threading.Lock()
        # reader lanes: file-backed WAL databases only — an in-memory DB
        # (and the URI forms) needs exactly one connection, and readers
        # on the writer's journal mode (rollback) would just block on it
        pooled = (max(1, pool_size) > 1 and path not in (":memory:", "")
                  and not path.startswith("file:"))
        self._readers: list[_Lane] = (
            [_Lane(f"db-r{i}") for i in range(max(1, pool_size) - 1)]
            if pooled else [])
        self._rr = 0  # round-robin cursor over reader lanes
        self.statement_cache = _StatementCache(statement_cache_size)
        # optional per-query timing sink: Callable[[float], None], ms.
        # Set by the app to feed the PerformanceTracker "db.query" series.
        self.on_query = None

    @property
    def pool_size(self) -> int:
        return 1 + len(self._readers)

    # -- lifecycle -----------------------------------------------------------

    def _connect(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self._path, check_same_thread=False,
                               timeout=self._busy_timeout_ms / 1000.0,
                               cached_statements=max(
                                   128, self.statement_cache.capacity))
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA foreign_keys=ON")
        if self._path not in (":memory:", ""):
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
        return conn

    def connect_sync(self) -> None:
        if self._conn is None:
            self._conn = self._connect()

    async def connect(self) -> None:
        await self._run(self.connect_sync)

    async def close(self) -> None:
        """Close the connections and their threads; a second close is a
        no-op (the app's cleanup closes a database an operator closed)."""
        if self._closed:
            return
        self._closed = True

        def _close() -> None:
            if self._conn is not None:
                self._conn.close()
                self._conn = None

        await self._run(_close)
        self._executor.shutdown(wait=False)
        for lane in self._readers:
            def _close_lane(lane: _Lane = lane) -> None:
                if lane.conn is not None:
                    lane.conn.close()
                    lane.conn = None
            try:
                lane.executor.submit(_close_lane).result(timeout=5)
            except Exception:
                pass
            lane.executor.shutdown(wait=False)

    async def _run(self, fn, *args):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._executor, fn, *args)

    def _pick_reader(self) -> _Lane:
        self._rr = (self._rr + 1) % len(self._readers)
        return self._readers[self._rr]

    # -- statements ----------------------------------------------------------

    def _execute_reader_sync(self, lane: _Lane, sql: str,
                             params: Sequence[Any],
                             timing: list[float] | None = None
                             ) -> list[dict[str, Any]]:
        """Read-only statement on a reader lane (own thread, own conn).

        Lazy connect: the lane's connection is created on ITS thread the
        first time a read routes here, so boot stays one connection."""
        if lane.conn is None:
            lane.conn = self._connect()
        wait_start = time.monotonic() if timing is not None else 0.0
        with lane.lock:
            started = time.monotonic() if timing is not None else 0.0
            attempt = 0
            while True:
                try:
                    cur = lane.conn.execute(sql, params)
                    rows = [dict(r) for r in cur.fetchall()]
                    break
                except sqlite3.OperationalError as exc:
                    # readers can still hit transient busy during WAL
                    # checkpoints — same bounded retry as the writer
                    message = str(exc).lower()
                    transient = "locked" in message or "busy" in message
                    if not transient or attempt >= self._max_retries:
                        raise
                    attempt += 1
                    time.sleep(self._retry_interval_s)  # bounded WAL retry; the lane lock serializes
            if timing is not None:
                timing.append((time.monotonic() - started) * 1000)
                timing.append((started - wait_start) * 1000)
            return rows

    def _execute_sync(self, sql: str, params: Sequence[Any],
                      timing: list[float] | None = None
                      ) -> list[dict[str, Any]]:
        assert self._conn is not None, "Database not connected"
        wait_start = time.monotonic() if timing is not None else 0.0
        with self._lock:
            # clock inside the lock: executor/lock queue wait is a
            # concurrency signal, not query time — a 1 ms SELECT queued
            # behind a 200 ms statement must not WARN as a slow query.
            # The wait itself is still attributed: it becomes the
            # db.acquire sub-phase (timing[1]) so the flight recorder can
            # say "queued behind the writer" vs "the statement was slow"
            started = time.monotonic() if timing is not None else 0.0
            attempt = 0
            while True:
                try:
                    # the retry must cover COMMIT too: cross-process WAL
                    # contention surfaces at statement finalization as
                    # often as at execution
                    cur = self._conn.execute(sql, params)
                    rows = [dict(r) for r in cur.fetchall()]
                    self._conn.commit()
                    break
                except sqlite3.OperationalError as exc:
                    # transient cross-process contention (WAL writers from
                    # another worker): bounded retry (db_max_retries)
                    message = str(exc).lower()
                    transient = "locked" in message or "busy" in message
                    if not transient or attempt >= self._max_retries:
                        raise
                    try:
                        self._conn.rollback()
                    except sqlite3.Error:
                        pass
                    attempt += 1
                    time.sleep(self._retry_interval_s)  # bounded WAL retry; the writer lock serializes
            if timing is not None:
                timing.append((time.monotonic() - started) * 1000)
                timing.append((started - wait_start) * 1000)
            return rows

    def _executemany_sync(self, sql: str, seq: list[Sequence[Any]]) -> None:
        assert self._conn is not None, "Database not connected"
        with self._lock:
            self._conn.executemany(sql, seq)
            self._conn.commit()

    def _executescript_sync(self, script: str) -> None:
        assert self._conn is not None, "Database not connected"
        with self._lock:
            self._conn.executescript(script)
            self._conn.commit()

    async def execute(self, sql: str, params: Sequence[Any] = ()) -> list[dict[str, Any]]:
        # fault point db.execute (docs/resilience.md): scope = the SQL
        # text, so a chaos rule can target one table's statements (the
        # db-outage scenario faults tenant_usage writes without touching
        # the auth path). Unarmed: one dict miss.
        act = fault_point("db.execute", scope=sql)
        if act is not None:
            await act.async_apply()
        log = _query_capture.get()
        cb = self.on_query
        clock = current_phases()  # flight-recorder db-phase attribution
        # lane routing: read-only statements fan out over the WAL reader
        # pool (decision memoized per SQL text); writes keep the single
        # writer lane so sqlite's one write lock is never fought over
        if self._readers and self.statement_cache.is_read(sql):
            lane = self._pick_reader()
            loop = asyncio.get_running_loop()

            def _run_read(*args):
                return loop.run_in_executor(
                    lane.executor, self._execute_reader_sync, lane, *args)
        else:
            _run_read = None
        if log is None and cb is None and clock is None:
            if _run_read is not None:
                return await _run_read(sql, params)
            return await self._run(self._execute_sync, sql, params)
        timing: list[float] = []  # filled under the lock on the db thread
        try:
            if _run_read is not None:
                return await _run_read(sql, params, timing)
            return await self._run(self._execute_sync, sql, params, timing)
        finally:
            # timing stays empty when the statement raised — a failed query
            # must not record a 0.0 ms sample into the db.query series
            if timing:
                if cb is not None:
                    # app-level timing sink (PerformanceTracker); in-lock
                    # query time only, so queue wait can't masquerade as a
                    # slow query
                    cb(timing[0])
                if log is not None:
                    log.append((" ".join(sql.split()), timing[0]))
                if clock is not None:
                    # phase vector (GET /admin/gateway/requests) gets the
                    # SPLIT buckets: db.execute = in-lock statement time,
                    # db.acquire = lock-acquire wait (writer contention).
                    # Executor queue wait still lands in the handler
                    # residue — it is loop/pool contention, not DB time
                    clock.add("db.execute", timing[0] / 1e3)
                    if len(timing) > 1:
                        clock.add("db.acquire", timing[1] / 1e3)
            elif log is not None:
                log.append((" ".join(sql.split()), 0.0))

    async def executemany(self, sql: str, seq: list[Sequence[Any]]) -> None:
        act = fault_point("db.execute", scope=sql)  # same point as execute
        if act is not None:
            await act.async_apply()
        await self._run(self._executemany_sync, sql, seq)

    async def fetchone(self, sql: str, params: Sequence[Any] = ()) -> dict[str, Any] | None:
        rows = await self.execute(sql, params)
        return rows[0] if rows else None

    async def fetchall(self, sql: str, params: Sequence[Any] = ()) -> list[dict[str, Any]]:
        return await self.execute(sql, params)

    async def transaction(self, statements: Iterable[tuple[str, Sequence[Any]]]) -> None:
        """Run several statements atomically."""

        def _tx() -> None:
            assert self._conn is not None
            with self._lock:
                try:
                    self._conn.execute("BEGIN")
                    for sql, params in statements:
                        self._conn.execute(sql, params)
                    self._conn.commit()
                except BaseException:
                    self._conn.rollback()
                    raise

        await self._run(_tx)

    # -- migrations ----------------------------------------------------------

    @staticmethod
    def _split_statements(script: str) -> list[str]:
        """Split a multi-statement SQL script on statement boundaries
        (sqlite3.complete_statement-aware, so ';' inside literals/triggers is safe)."""
        statements: list[str] = []
        buf = ""
        for line in script.splitlines():
            buf += line + "\n"
            if sqlite3.complete_statement(buf):
                if buf.strip():
                    statements.append(buf)
                buf = ""
        if buf.strip():
            statements.append(buf)
        return statements

    def migrate_sync(self, migrations: Sequence[Migration]) -> int:
        """Apply pending migrations in version order; returns count applied.

        Each migration script runs atomically: a failure mid-script rolls the
        whole migration back (executescript would autocommit per statement and
        wedge the schema between versions)."""
        self.connect_sync()
        assert self._conn is not None
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS schema_migrations ("
                " version INTEGER PRIMARY KEY, name TEXT NOT NULL,"
                " applied_at REAL NOT NULL)"
            )
            applied = 0
            for mig in sorted(migrations, key=lambda m: m.version):
                try:
                    # BEGIN IMMEDIATE takes the write lock up front so two
                    # processes booting against the same file (multi-worker
                    # supervisor) serialize; the in-transaction re-check
                    # makes the loser skip instead of double-applying
                    self._conn.execute("BEGIN IMMEDIATE")
                    row = self._conn.execute(
                        "SELECT 1 FROM schema_migrations WHERE version=?",
                        (mig.version,)).fetchone()
                    if row is not None:
                        self._conn.rollback()
                        continue
                    for stmt in self._split_statements(mig.sql):
                        self._conn.execute(stmt)
                    self._conn.execute(
                        "INSERT INTO schema_migrations (version, name, applied_at) VALUES (?,?,?)",
                        (mig.version, mig.name, time.time()),
                    )
                    self._conn.commit()
                except BaseException:
                    self._conn.rollback()
                    raise
                applied += 1
            return applied

    async def migrate(self, migrations: Sequence[Migration]) -> int:
        return await self._run(self.migrate_sync, migrations)


def to_json(value: Any) -> str:
    return json.dumps(value, separators=(",", ":"), ensure_ascii=False)


def from_json(value: str | None, default: Any = None) -> Any:
    if value is None or value == "":
        return default
    try:
        return json.loads(value)
    except (json.JSONDecodeError, TypeError):
        return default
