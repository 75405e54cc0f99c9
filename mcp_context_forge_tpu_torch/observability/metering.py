"""Per-tenant usage metering (a copy of the JAX package's
``observability/metering.py``: ``TenantLedger``, ``TenantUsageRollup``;
stdlib only).

``TenantLedger`` says whose tokens the engine served: prompt tokens,
generated tokens, prefix-cache-hit tokens and KV-page-seconds of device
residency. The engine feeds it at the sites that feed its own untagged
counters (``submit`` beside ``stats.prompt_tokens``, ``_emit`` beside
``stats.completion_tokens``, the admission prefix match beside the
allocator's hit count), so summing a column over every tenant gives the
engine's untagged total. The ledger keeps exact rows per tenant (bounded at
``max_tenants``, overflow into ``other``) whatever the shared
``TenantClamp`` lets the metric labels show. Each row has cumulative totals
(``GET /admin/tenants/usage``) and a window since the last ``take_window``,
which feeds ``mcpforge_gw_tenant_quota_used_ratio`` and the shedder's and
limiter's quota checks. ``TenantUsageRollup`` (the JAX package's) drains
that window every rollup interval into the ``tenant_usage`` table, each
window under its own stamps.

Thread-safety: ``add()`` runs on engine dispatch threads and the event
loop; everything mutates under one lock (counter adds, no I/O).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Any

from .tenant import OTHER, UNATTRIBUTED, TenantClamp

logger = logging.getLogger(__name__)

_COLUMNS = ("requests", "prompt_tokens", "generated_tokens",
            "cache_hit_tokens", "kv_page_seconds")


def _zero_row() -> dict[str, float]:
    return {c: 0 for c in _COLUMNS}


class TenantLedger:
    """Per-tenant usage counters with exact conservation semantics."""

    def __init__(self, clamp: TenantClamp | None = None,
                 metrics: Any = None, max_tenants: int = 512,
                 quota_tokens_per_window: int = 0) -> None:
        self.clamp = clamp or TenantClamp()
        self.metrics = metrics
        self.max_tenants = max(1, int(max_tenants))
        self.quota_tokens_per_window = max(0, int(quota_tokens_per_window))
        self._lock = threading.Lock()
        self._totals: dict[str, dict[str, float]] = {}
        self._window: dict[str, dict[str, float]] = {}
        # window tokens aggregated per CLAMPED LABEL: several tenants
        # share "other", and the quota gauge must report their SUM —
        # last-writer-wins per tenant would flap the shared series and
        # understate overflow consumption for the rate limiter reading
        # it. Exact because clamp labels are sticky.
        self._label_window_tokens: dict[str, float] = {}
        # hot-path caches: clamp labels are sticky and metric children
        # are stable, so the per-token add() on the engine dispatch
        # thread costs ONE ledger lock + dict ops, not a clamp lock and
        # a labels() resolution per token (the retire loop bills every
        # generated token — K x batch calls per super-step dispatch)
        self._label_cache: dict[str, str] = {}
        self._child_cache: dict[tuple, Any] = {}
        self._window_started = time.time()
        self.rollups_written = 0

    def _key(self, tenant: str) -> str:
        """Exact tenant key, overflowing into ``other`` only past the
        ledger's own (large) bound — tokens are conserved either way."""
        tenant = tenant or UNATTRIBUTED
        if tenant in self._totals or len(self._totals) < self.max_tenants:
            return tenant
        return OTHER

    def _label_for(self, key: str) -> str:
        """Cached clamp label (caller holds self._lock; labels are
        sticky, so the first resolution is final — the clamp's own lock
        is touched once per KEY, not once per token). Lock order
        ledger→clamp is safe: the clamp never calls back into the
        ledger."""
        label = self._label_cache.get(key)
        if label is None:
            label = self._label_cache[key] = self.clamp.label(key)
        return label

    def _child(self, metric: Any, **labels: str) -> Any:
        """Cached prometheus child (caller holds self._lock): labels()
        resolution is a lock + dict work per call — cache it so the
        per-token path pays a plain inc()."""
        cache_key = (id(metric), tuple(sorted(labels.items())))
        child = self._child_cache.get(cache_key)
        if child is None:
            child = self._child_cache[cache_key] = metric.labels(**labels)  # values pre-clamped by _label_for
        return child

    def add(self, tenant: str, *, requests: int = 0, prompt_tokens: int = 0,
            generated_tokens: int = 0, cache_hit_tokens: int = 0,
            kv_page_seconds: float = 0.0) -> None:
        """Charge usage to a tenant. Mirrors the engine's untagged
        counters one-to-one — call it at the SAME site as the untagged
        increment or the conservation gate breaks. One lock acquisition;
        the quota gauge is set UNDER the lock so concurrent adds (engine
        dispatch thread vs gateway loop) cannot apply sets out of order
        and regress the exported ratio."""
        metrics = self.metrics
        with self._lock:  # ledger -> clamp only (_label_for)
            key = self._key(tenant)
            totals = self._totals.setdefault(key, _zero_row())
            window = self._window.setdefault(key, _zero_row())
            for row in (totals, window):
                row["requests"] += requests
                row["prompt_tokens"] += prompt_tokens
                row["generated_tokens"] += generated_tokens
                row["cache_hit_tokens"] += cache_hit_tokens
                row["kv_page_seconds"] += kv_page_seconds
            label = self._label_for(key)
            self._label_window_tokens[label] = label_tokens = (
                self._label_window_tokens.get(label, 0.0)
                + prompt_tokens + generated_tokens)
            if metrics is None:
                return
            if prompt_tokens:
                self._child(metrics.llm_tenant_tokens, tenant=label,
                            kind="prompt").inc(prompt_tokens)
            if generated_tokens:
                self._child(metrics.llm_tenant_tokens, tenant=label,
                            kind="generated").inc(generated_tokens)
            if cache_hit_tokens:
                self._child(metrics.llm_tenant_tokens, tenant=label,
                            kind="cache_hit").inc(cache_hit_tokens)
            if kv_page_seconds:
                self._child(metrics.llm_tenant_kv_page_seconds,
                            tenant=label).inc(kv_page_seconds)
            if self.quota_tokens_per_window and (prompt_tokens
                                                 or generated_tokens):
                # the future distributed rate limiter's admission signal:
                # 1.0 = this LABEL consumed its whole window allowance
                # (summed over every tenant sharing the label — "other"
                # reports the overflow pool's aggregate, not whichever
                # clamped tenant happened to write last)
                self._child(metrics.gw_tenant_quota_used_ratio,
                            tenant=label).set(
                    label_tokens / self.quota_tokens_per_window)

    # ------------------------------------------------------------- reporting

    def totals(self) -> dict[str, dict[str, float]]:
        """Cumulative per-tenant rows (copy)."""
        with self._lock:
            return {t: dict(row) for t, row in self._totals.items()}

    def column_sums(self) -> dict[str, float]:
        """Each column summed over every tenant — the left side of the
        conservation invariant (== the engine's untagged totals)."""
        with self._lock:
            sums = _zero_row()
            for row in self._totals.values():
                for c in _COLUMNS:
                    sums[c] += row[c]
            return sums

    def quota_ratio(self, tenant: str) -> float:
        """Current-window token consumption vs the configured quota
        (0.0 when no quota is set)."""
        if not self.quota_tokens_per_window:
            return 0.0
        with self._lock:
            row = self._window.get(self._key(tenant))
            if row is None:
                return 0.0
            return ((row["prompt_tokens"] + row["generated_tokens"])
                    / self.quota_tokens_per_window)

    def take_window(self) -> tuple[float, dict[str, dict[str, float]]]:
        """Drain the rollup window: returns (window_start_ts, rows) and
        resets the window counters + quota ratios. Called by the rollup
        task; the cumulative totals are untouched."""
        with self._lock:
            started = self._window_started
            rows = {t: dict(row) for t, row in self._window.items()
                    if any(row[c] for c in _COLUMNS)}
            self._window.clear()
            # gauge resets stay UNDER the lock: an add() interleaved
            # between clear and reset would have its fresh ratio
            # clobbered to 0 while the new window already holds tokens
            labels = set(self._label_window_tokens)
            self._label_window_tokens.clear()
            self._window_started = time.time()
            if self.metrics is not None and self.quota_tokens_per_window:
                for label in labels:
                    self._child(self.metrics.gw_tenant_quota_used_ratio,
                                tenant=label).set(0.0)
        return started, rows

    def snapshot(self, limit: int = 64) -> dict[str, Any]:
        """The /admin/tenants/usage live view: cumulative + current
        window per tenant, heaviest (by total tokens) first."""
        with self._lock:
            window_started = self._window_started
            tenants = []
            for tenant, row in self._totals.items():
                window = self._window.get(tenant, _zero_row())
                tenants.append({
                    "tenant": tenant,
                    "label": None,  # filled below, outside the lock
                    **{c: row[c] for c in _COLUMNS},
                    "window_tokens": (window["prompt_tokens"]
                                      + window["generated_tokens"]),
                })
        for entry in tenants:
            entry["label"] = self.clamp.peek(entry["tenant"])
            if self.quota_tokens_per_window:
                entry["quota_used_ratio"] = round(
                    entry["window_tokens"] / self.quota_tokens_per_window, 4)
        tenants.sort(key=lambda e: -(e["prompt_tokens"]
                                     + e["generated_tokens"]))
        return {
            "tenants": tenants[:max(1, limit)],
            "tenant_count": len(tenants),
            "window_started": window_started,
            "quota_tokens_per_window": self.quota_tokens_per_window,
            "rollups_written": self.rollups_written,
            "clamp": self.clamp.snapshot(),
        }


class TenantUsageRollup:
    """Periodic async drain of the ledger's rollup window into the
    ``tenant_usage`` DB table (schema v9). Runs on the gateway loop.

    DB-outage behavior: a window whose write fails
    parks in a BOUNDED pending buffer carrying its ORIGINAL
    ``(window_start, window_end)`` stamps — a retried flush writes the
    usage against the window it was actually consumed in, not the
    post-recovery clock. Under a sustained outage the buffer never
    grows past ``pending_max`` windows: the OLDEST drops with its loss
    COUNTED (``windows_dropped`` / ``tokens_dropped`` — reported, never
    hidden) instead of unbounded memory growth. Repeated failures open
    the ``ledger.rollup`` breaker, which skips DB attempts until the
    cooldown admits a half-open probe (no retry storm against a dead
    DB); the ledger's cumulative per-tenant totals are untouched
    throughout, so token conservation holds across the whole outage.
    The DB write rides the ``ledger.rollup.flush`` fault point."""

    def __init__(self, db: Any, ledger: TenantLedger,
                 interval_s: float = 60.0, pending_max: int = 8) -> None:
        self.db = db
        self.ledger = ledger
        self.interval_s = max(0.05, float(interval_s))
        self.pending_max = max(1, int(pending_max))
        # failed-but-unflushed windows, oldest first:
        # (window_start, window_end, rows)
        self._pending: list[tuple[float, float, dict[str, dict[str, float]]]] = []
        # reentrancy guard (plain flag: all callers share the gateway
        # loop): two overlapping flushes — the interval task racing a
        # scenario/shutdown flush suspended at the DB await — would both
        # write pending[0] and then double-pop, silently losing a window
        # the loss counters never saw
        self._flushing = False
        self.windows_dropped = 0
        self.tokens_dropped = 0
        self.consecutive_failures = 0
        from .degradation import get_degradation
        self._breaker = get_degradation().breaker("ledger.rollup")
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="tenant-usage-rollup")

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        # final flush so the last window's usage survives shutdown —
        # forced past an open breaker (one last attempt beats certain loss)
        try:
            await self.flush(force=True)
        except Exception:
            logger.exception("tenant usage final flush failed")

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.flush()
            except Exception:
                logger.exception("tenant usage rollup failed")

    def _trim_pending(self) -> None:
        """Bound the outage buffer: drop the OLDEST windows past
        ``pending_max``, counting exactly what was lost."""
        while len(self._pending) > self.pending_max:
            started, ended, rows = self._pending.pop(0)
            self.windows_dropped += 1
            lost = sum(int(r["prompt_tokens"] + r["generated_tokens"])
                       for r in rows.values())
            self.tokens_dropped += lost
            logger.error(
                "tenant usage rollup: dropped window [%0.1f, %0.1f] "
                "(%d tenant rows, %d tokens) — pending buffer full at "
                "%d windows during DB outage", started, ended, len(rows),
                lost, self.pending_max)

    async def flush(self, force: bool = False) -> int:
        """Drain the live window into the pending buffer, then write
        every pending window (oldest first, original stamps). Raises on
        the first write failure with everything unwritten still parked
        (bounded); returns rows written."""
        from .faults import fault_point
        started, rows = self.ledger.take_window()
        if rows:
            self._pending.append((started, time.time(), rows))
            self._trim_pending()
        if self._flushing:
            # another flush is mid-write: the fresh window is parked
            # above and the running flush (or the next tick) drains it —
            # overlapping writers would double-insert one window and
            # silently lose another
            return 0
        if not self._pending:
            return 0
        if not self._breaker.allow() and not force:
            # breaker open, cooldown pending: don't hammer the dead DB;
            # windows stay parked for the half-open probe
            return 0
        self._flushing = True
        written = 0
        try:
            while self._pending:
                w_started, w_ended, w_rows = self._pending[0]
                try:
                    act = fault_point("ledger.rollup.flush", scope="flush")
                    if act is not None:
                        await act.async_apply()
                    await self.db.executemany(
                        "INSERT INTO tenant_usage (tenant, window_start,"
                        " window_end, requests, prompt_tokens,"
                        " generated_tokens, cache_hit_tokens,"
                        " kv_page_seconds)"
                        " VALUES (?,?,?,?,?,?,?,?)",
                        [(tenant, w_started, w_ended, int(row["requests"]),
                          int(row["prompt_tokens"]),
                          int(row["generated_tokens"]),
                          int(row["cache_hit_tokens"]),
                          round(row["kv_page_seconds"], 6))
                         for tenant, row in sorted(w_rows.items())])
                except Exception:
                    self.consecutive_failures += 1
                    self._breaker.record_failure("rollup flush")
                    raise
                self._pending.pop(0)
                written += len(w_rows)
                self.ledger.rollups_written += len(w_rows)
        finally:
            self._flushing = False
        self.consecutive_failures = 0
        self._breaker.record_success()
        return written

    def outage_stats(self) -> dict[str, Any]:
        """The degradation surface's view of the rollup path."""
        return {
            "pending_windows": len(self._pending),
            "pending_max": self.pending_max,
            "windows_dropped": self.windows_dropped,
            "tokens_dropped": self.tokens_dropped,
            "consecutive_failures": self.consecutive_failures,
            "breaker": self._breaker.snapshot(),
        }

    async def recent(self, limit: int = 100) -> list[dict[str, Any]]:
        rows = await self.db.fetchall(
            "SELECT tenant, window_start, window_end, requests,"
            " prompt_tokens, generated_tokens, cache_hit_tokens,"
            " kv_page_seconds FROM tenant_usage"
            " ORDER BY window_end DESC, tenant LIMIT ?",
            (max(1, min(int(limit), 1000)),))
        return [dict(r) for r in rows]
