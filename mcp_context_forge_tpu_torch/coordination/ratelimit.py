"""Distributed per-tenant rate limiter: one budget, N admitting workers (a
copy of the JAX package's ``coordination/ratelimit.py``; stdlib only).

The overload shedder's own quota check reads the worker's local
``TenantLedger``, so N workers would each admit a whole quota. Here:

- the budget lives in ONE shared window counter (the coordination hub's
  ``rl_take`` op on the tcp backend; a file and an in-process twin
  below), so grants are totally ordered;
- each worker draws prepaid grants of ``burst`` tokens from the shared
  budget and admits requests against its grant: the steady-state check is
  a dict lookup, not a hub round trip;
- a reconciliation task drains each tenant's ledger token deltas and
  squares them against the admission-time estimates: actuals above the
  outstanding estimates are force-charged to the shared counter, and
  unsettled estimates stay debited (estimate error can under-admit, never
  over-admit).

A grant is only issued while the shared counter reads under the quota Q,
and each adds at most ``burst``, so granted tokens never exceed Q + burst,
whatever N is. Every refusal carries ``retry_after_s``, the time to the
shared window's reset, so quota 429s from every worker advise the same
horizon.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any

logger = logging.getLogger(__name__)


class MemoryRateCounter:
    """Single-process twin of the hub ``rl_take`` op (memory bus)."""

    def __init__(self) -> None:
        self._rl: dict[str, tuple[float, float]] = {}

    async def take(self, key: str, cost: float, limit: float,
                   window_s: float, force: bool = False) -> dict[str, Any]:
        now = time.monotonic()
        consumed, started = self._rl.get(key, (0.0, now))
        if now - started >= window_s:
            consumed, started = 0.0, now
        ok = force or limit <= 0 or consumed < limit
        if ok:
            consumed += cost
        self._rl[key] = (consumed, started)
        return {"ok": ok, "consumed": consumed,
                "retry_after": round(max(0.0, window_s - (now - started)),
                                     3)}


class FileRateCounter:
    """File-backed shared window for the ``file`` bus backend (N workers,
    one host): one flock-serialized JSON file per key under
    ``dir/ratelimit/``. The read-modify-write runs in a thread so a
    contended lock never stalls the gateway loop."""

    def __init__(self, directory: str) -> None:
        self._dir = os.path.join(directory, "ratelimit")
        os.makedirs(self._dir, exist_ok=True)

    def _take_sync(self, key: str, cost: float, limit: float,
                   window_s: float, force: bool) -> dict[str, Any]:
        import fcntl
        import hashlib
        digest = hashlib.sha256(key.encode()).hexdigest()[:24]
        path = os.path.join(self._dir, f"rl.{digest}.json")
        with open(path, "a+") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            fh.seek(0)
            raw = fh.read()
            now = time.time()  # wall clock: shared across processes
            try:
                state = json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                state = {}
            consumed = float(state.get("consumed", 0.0))
            started = float(state.get("started", now))
            if now - started >= window_s:
                consumed, started = 0.0, now
            ok = force or limit <= 0 or consumed < limit
            if ok:
                consumed += cost
            fh.seek(0)
            fh.truncate()
            fh.write(json.dumps({"consumed": consumed, "started": started}))
            fh.flush()
        return {"ok": ok, "consumed": consumed,
                "retry_after": round(max(0.0, window_s - (now - started)),
                                     3)}

    async def take(self, key: str, cost: float, limit: float,
                   window_s: float, force: bool = False) -> dict[str, Any]:
        return await asyncio.to_thread(self._take_sync, key, cost, limit,
                                       window_s, force)


class HubRateCounter:
    """Hub-backed shared window (tcp bus backend)."""

    def __init__(self, client: Any) -> None:
        self._client = client

    async def take(self, key: str, cost: float, limit: float,
                   window_s: float, force: bool = False) -> dict[str, Any]:
        resp = await self._client.rl_take(key, cost, limit, window_s,
                                          force=force)
        return {"ok": bool(resp.get("ok")),
                "consumed": float(resp.get("consumed") or 0.0),
                "retry_after": float(resp.get("retry_after") or 1.0)}


def make_rate_counter(backend: str, directory: str,
                      hub_client: Any = None) -> Any:
    if backend == "tcp" and hub_client is not None:
        return HubRateCounter(hub_client)
    if backend == "file":
        return FileRateCounter(directory)
    return MemoryRateCounter()


class _Grant:
    __slots__ = ("tokens", "expires", "refused_until", "retry_after")

    def __init__(self) -> None:
        self.tokens = 0.0
        # grants DIE with the shared window they were drawn from: a
        # residual grant carried across the window reset would let N
        # workers admit N x leftover on top of the fresh budget,
        # breaking the quota + one-burst bound at every rollover
        self.expires = 0.0         # monotonic: the window's reset time
        self.refused_until = 0.0   # monotonic: cached refusal horizon
        self.retry_after = 1.0


class DistributedTenantLimiter:
    """Grant-based tenant quota enforcement over a shared counter.

    ``decide(tenant, est_tokens)`` is the admission seam the shedder
    calls; None admits, else a shed verdict shaped exactly like the
    ledger-quota verdict the shedder's 429 path renders (status/retry_after_s/
    reason/slo_class filled by the shedder)."""

    def __init__(self, counter: Any, ledger: Any,
                 quota_tokens: int, window_s: float,
                 burst_tokens: int = 2048,
                 sync_interval_s: float = 0.25,
                 key_prefix: str = "rl:tenant:") -> None:
        self.counter = counter
        self.ledger = ledger
        self.quota_tokens = max(0, int(quota_tokens))
        self.window_s = max(0.05, float(window_s))
        self.burst_tokens = max(1, int(burst_tokens))
        self.sync_interval_s = max(0.02, float(sync_interval_s))
        self.key_prefix = key_prefix
        self._grants: dict[str, _Grant] = {}
        # reconciliation cursors: tenant -> (ledger tokens seen,
        # estimate-charged tokens)
        self._ledger_seen: dict[str, float] = {}
        self._est_charged: dict[str, float] = {}
        self._task: asyncio.Task | None = None
        self.grants_taken = 0
        self.refusals = 0
        self.reconciled_tokens = 0.0

    @property
    def enabled(self) -> bool:
        return self.quota_tokens > 0

    async def start(self) -> None:
        if self._task is None and self.enabled and self.ledger is not None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="tenant-limiter-sync")

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    # -------------------------------------------------------------- admission

    async def decide(self, tenant: str,
                     est_tokens: float = 1.0) -> dict[str, Any] | None:
        """None = admit (grant debited by the estimate); else a quota
        verdict with the shared window's retry horizon."""
        if not self.enabled:
            return None
        tenant = tenant or "unattributed"
        est = max(1.0, float(est_tokens))
        grant = self._grants.setdefault(tenant, _Grant())
        now = time.monotonic()
        if now >= grant.expires:
            grant.tokens = 0.0  # the window this grant came from is gone
        if grant.tokens >= est:
            grant.tokens -= est
            self._est_charged[tenant] = (
                self._est_charged.get(tenant, 0.0) + est)
            return None
        if now < grant.refused_until:
            # cached refusal: no hub round trip per shed storm request
            self.refusals += 1
            return {"reason": "quota",
                    "retry_after_s": max(1, int(grant.retry_after)),
                    "quota_used_ratio": None}
        cost = max(float(self.burst_tokens), est)
        try:
            resp = await self.counter.take(
                self.key_prefix + tenant, cost, float(self.quota_tokens),
                self.window_s)
        except Exception as exc:
            # unreachable counter: fail OPEN per-worker (the local ledger
            # quota check in the shedder still applies) — availability
            # beats exactness when the coordination plane is down
            logger.warning("tenant limiter counter unreachable: %s", exc)
            return None
        if resp["ok"]:
            self.grants_taken += 1
            grant.tokens += cost - est
            # the counter reports the window's remaining life; the grant
            # expires with it
            grant.expires = now + max(0.05, resp["retry_after"])
            grant.refused_until = 0.0
            self._est_charged[tenant] = (
                self._est_charged.get(tenant, 0.0) + est)
            return None
        self.refusals += 1
        grant.retry_after = max(1.0, resp["retry_after"])
        # cache the refusal for a slice of the window so a shed storm
        # costs one counter op per interval, not per request
        grant.refused_until = now + min(grant.retry_after,
                                        max(self.sync_interval_s, 0.25))
        ratio = (resp["consumed"] / self.quota_tokens
                 if self.quota_tokens else None)
        return {"reason": "quota",
                "retry_after_s": max(1, int(grant.retry_after)),
                "quota_used_ratio": round(ratio, 3) if ratio else None}

    # --------------------------------------------------------- reconciliation

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.sync_interval_s)
            try:
                await self.reconcile()
            except Exception:
                logger.exception("tenant limiter reconciliation failed")

    async def reconcile(self) -> None:
        """Square admission-time estimates against the ledger's actual
        (conservation-gated) token counts. Actual > outstanding
        estimates: the drift is force-charged to the shared counter
        (usage the estimates missed must still consume budget).
        Outstanding estimates settle against future actuals (in-flight
        requests bill on retire) — unsettled estimate stays debited,
        which can only under-admit, never over-admit."""
        if self.ledger is None:
            return
        totals = self.ledger.totals()
        for tenant, row in totals.items():
            actual_seen = row["prompt_tokens"] + row["generated_tokens"]
            prev = self._ledger_seen.get(tenant, 0.0)
            actual_delta = actual_seen - prev
            if actual_delta <= 0:
                continue
            self._ledger_seen[tenant] = actual_seen
            est = self._est_charged.get(tenant, 0.0)
            settled = min(est, actual_delta)
            self._est_charged[tenant] = est - settled
            drift = actual_delta - settled
            if drift > 0:
                try:
                    await self.counter.take(
                        self.key_prefix + tenant, drift,
                        float(self.quota_tokens), self.window_s,
                        force=True)
                    self.reconciled_tokens += drift
                except Exception:
                    logger.debug("limiter drift charge failed",
                                 exc_info=True)

    def stats(self) -> dict[str, Any]:
        return {"enabled": self.enabled,
                "quota_tokens": self.quota_tokens,
                "window_s": self.window_s,
                "burst_tokens": self.burst_tokens,
                "grants_taken": self.grants_taken,
                "refusals": self.refusals,
                "reconciled_tokens": round(self.reconciled_tokens, 1),
                "tenants": len(self._grants)}
