"""The gateway's flight recorder, loop-lag sampler and engine-admission
backpressure (a copy of the JAX package's ``gateway/flight_recorder.py``;
stdlib only):

- ``FlightRecorder``: a bounded ring of completed requests (the recent
  window and the slowest N by duration), each with the phase vector its
  ``PhaseClock`` accumulated, mirrored into ``gw_request_phase{route,phase,
  tenant}``, with ``gw_slow_requests`` and a warning past the slow bar; and
  a registry of requests in flight, the sampler's culprit;
- ``LoopLagSampler``: how late the event loop runs a timer that asked for
  ``interval_s``, observed into ``gw_loop_lag`` and pushed as
  ``gw.loop_lag_ms`` onto a signal bus; a lag past ``warn_s`` warns,
  naming the longest request in flight;
- ``queue_state``: queue depth, capacity and saturation of one engine or
  of a replica pool, the Retry-After it advises, and the headers that carry
  them.

The recorder and the sampler run on the gateway's event loop.
"""

from __future__ import annotations

import asyncio
import bisect
import itertools
import logging
import math
import time
from collections import deque
from typing import Any

from ..observability.logging import trace_extra

logger = logging.getLogger(__name__)


class FlightRecorder:
    """Bounded request-attribution rings and the in-flight registry.

    ``recent`` keeps the last ``ring_size`` completed requests in arrival
    order; ``slowest`` keeps the ``slowest_size`` worst by wall duration
    over the worker's life (a recency ring alone forgets the tail within
    seconds at 1k rps). Both are mutated only on the event loop."""

    def __init__(self, metrics: Any = None, ring_size: int = 256,
                 slowest_size: int = 32, slow_request_s: float = 1.0,
                 worker: str = "") -> None:
        self.metrics = metrics
        # every row carries the serving worker's id, so a merged fleet view
        # says which process served an outlier
        self.worker = worker
        self.ring_size = max(1, int(ring_size))
        self.slowest_size = max(1, int(slowest_size))
        self.slow_request_s = max(0.0, float(slow_request_s))
        self.recent: deque[dict[str, Any]] = deque(maxlen=self.ring_size)
        self._slowest: list[tuple[float, int, dict[str, Any]]] = []
        self._seq = itertools.count()
        self.recorded = 0
        self.slow_requests = 0
        # request id -> {started, path, trace} of requests being handled
        self.inflight: dict[int, dict[str, Any]] = {}

    def start_request(self, path: str, trace: tuple[str, str] | None) -> int:
        rid = next(self._seq)
        self.inflight[rid] = {"started": time.monotonic(), "path": path, "trace": trace}
        return rid

    def finish_request(self, rid: int) -> None:
        self.inflight.pop(rid, None)

    def longest_inflight(self) -> dict[str, Any] | None:
        """The oldest request still being handled: the loop-lag sampler's
        best guess at who blocked the loop."""
        if not self.inflight:
            return None
        entry = min(self.inflight.values(), key=lambda e: e["started"])
        return {"path": entry["path"], "trace": entry["trace"],
                "age_s": round(time.monotonic() - entry["started"], 3)}

    def record(self, *, method: str, path: str, route: str, status: int,
               duration_s: float, phases_ms: dict[str, float],
               trace_id: str | None = None, span_id: str | None = None,
               correlation_id: str | None = None, tenant: str | None = None,
               error: str | None = None,
               client_disconnected: bool = False) -> dict[str, Any]:
        """Append one completed request to the rings and the registry."""
        entry = {
            "ts": time.time(),
            "method": method,
            "path": path,
            "route": route,
            "status": status,
            "duration_ms": round(duration_s * 1e3, 3),
            "phases_ms": phases_ms,
        }
        if self.worker:
            entry["worker"] = self.worker
        if tenant:
            # rows keep the exact tenant (a bounded ring); only the
            # registry's label is clamped
            entry["tenant"] = tenant
        if trace_id:
            entry["trace_id"] = trace_id
            if span_id:
                entry["span_id"] = span_id
        if correlation_id:
            entry["correlation_id"] = correlation_id
        if error:
            entry["error"] = error
        if client_disconnected:
            entry["client_disconnected"] = True
        self.recorded += 1
        self.recent.append(entry)
        # slowest N: sorted ascending by duration, the fastest evicted
        key = (entry["duration_ms"], next(self._seq))
        if len(self._slowest) < self.slowest_size or key[0] > self._slowest[0][0]:
            bisect.insort(self._slowest, (key[0], key[1], entry))
            if len(self._slowest) > self.slowest_size:
                self._slowest.pop(0)
        metrics = self.metrics
        if metrics is not None:
            tenant_label = metrics.tenant_clamp.label(tenant or "anonymous")
            for phase_name, ms in phases_ms.items():
                metrics.gw_request_phase.labels(route=route, phase=phase_name,
                                                tenant=tenant_label).observe(ms / 1e3)
        # strictly greater: one bar with the performance tracker's
        slow = self.slow_request_s and duration_s > self.slow_request_s
        if slow:
            self.slow_requests += 1
            if metrics is not None:
                metrics.gw_slow_requests.labels(route=route).inc()
            # the phase vector says where the milliseconds went; the explicit
            # trace ctx joins the line to its trace
            logger.warning(
                "slow request %s %s -> %s: %.1f ms (threshold %.1f ms) phases=%s",
                method, path, status, duration_s * 1e3, self.slow_request_s * 1e3,
                phases_ms,
                extra=trace_extra((trace_id, span_id or "") if trace_id else None))
        return entry

    def slowest(self) -> list[dict[str, Any]]:
        """Worst duration first."""
        return [entry for _, _, entry in reversed(self._slowest)]

    def find_trace(self, trace_id: str) -> dict[str, Any] | None:
        """The row of one trace id (the slowest ring first; a row in both
        rings is the same dict)."""
        for entry in self.slowest():
            if entry.get("trace_id") == trace_id:
                return entry
        for entry in reversed(self.recent):
            if entry.get("trace_id") == trace_id:
                return entry
        return None

    def snapshot(self, limit: int = 64, tenant: str | None = None) -> dict[str, Any]:
        """The rings' contents; ``tenant`` filters both to one tenant's
        rows (exact match on the row's unclamped tenant)."""
        limit = max(1, limit)
        slowest = self.slowest()
        recent = list(self.recent)[::-1]  # newest first
        if tenant:
            slowest = [r for r in slowest if r.get("tenant") == tenant]
            recent = [r for r in recent if r.get("tenant") == tenant]
        out = {
            "worker": self.worker or None,
            "recorded": self.recorded,
            "slow_requests": self.slow_requests,
            "slow_request_ms": round(self.slow_request_s * 1e3, 1),
            "ring_size": self.ring_size,
            "inflight": len(self.inflight),
            "slowest": slowest[:limit],
            "recent": recent[:limit],
        }
        if tenant:
            out["tenant"] = tenant
        return out


class LoopLagSampler:
    """Event-loop health by scheduled-callback delta sampling: each tick
    asks the loop for ``interval_s`` of sleep and measures how much later it
    ran, the time the loop could not service timers (blocked in somebody's
    callback). Observed into ``gw_loop_lag``, kept as a high-water mark, and
    pushed onto ``signals`` (a ``SignalBus``) as ``gw.loop_lag_ms``; a lag
    of ``warn_s`` or more counts a long callback and warns (at most once in
    5 s), naming the longest request in flight with its trace ids."""

    def __init__(self, metrics: Any = None, interval_s: float = 0.25,
                 warn_s: float = 0.25, recorder: FlightRecorder | None = None) -> None:
        self.metrics = metrics
        self.interval_s = max(0.01, float(interval_s))
        self.warn_s = max(0.0, float(warn_s))
        self.recorder = recorder
        self.signals = None
        self.samples = 0
        self.long_callbacks = 0
        self.max_lag_s = 0.0
        self.last_lag_s = 0.0
        self._task: asyncio.Task | None = None
        self._warn_bucket = 0.0  # rate limit: at most one warning in 5 s

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="gw-loop-lag-sampler")

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            before = loop.time()
            await asyncio.sleep(self.interval_s)
            self._observe(max(0.0, loop.time() - before - self.interval_s))

    def _observe(self, lag: float) -> None:
        self.samples += 1
        self.last_lag_s = lag
        self.max_lag_s = max(self.max_lag_s, lag)
        if self.metrics is not None:
            self.metrics.gw_loop_lag.observe(lag)
        if self.signals is not None:
            self.signals.publish("gw.loop_lag_ms", lag * 1e3)
        if self.warn_s and lag >= self.warn_s:
            self.long_callbacks += 1
            now = time.monotonic()
            if now >= self._warn_bucket:
                self._warn_bucket = now + 5.0
                culprit = (self.recorder.longest_inflight()
                           if self.recorder is not None else None)
                logger.warning(
                    "event loop lagged %.1f ms (bar %.1f ms) — a callback blocked the loop%s",
                    lag * 1e3, self.warn_s * 1e3,
                    (f"; longest in-flight: {culprit['path']} ({culprit['age_s']} s)"
                     if culprit else ""),
                    extra=trace_extra(culprit["trace"] if culprit else None))

    def snapshot(self) -> dict[str, Any]:
        return {
            "interval_s": self.interval_s,
            "warn_ms": round(self.warn_s * 1e3, 1),
            "samples": self.samples,
            "last_lag_ms": round(self.last_lag_s * 1e3, 3),
            "max_lag_ms": round(self.max_lag_s * 1e3, 3),
            "long_callbacks": self.long_callbacks,
        }


def compute_queue_state(pool: Any, engine: Any) -> dict[str, Any] | None:
    """Depth/capacity/saturation from a replica pool (summed over its
    routable replicas) or one engine; None without either."""
    no_replicas = False
    if pool is not None:
        ready = [r for r in pool.replicas if r.state == "ready"]
        depth = sum(r.engine.stats.queue_depth for r in ready)
        capacity = sum(r.engine.config.max_queue for r in ready)
        no_replicas = not ready   # every replica dead or draining
    elif engine is not None:
        depth = engine.stats.queue_depth
        capacity = engine.config.max_queue
    else:
        return None
    if no_replicas:
        saturation = 1.0   # nothing routable: saturated by definition
    elif capacity > 0:
        saturation = min(1.0, depth / capacity)
    else:
        # max_queue <= 0 is an unbounded admission queue (queue.Queue
        # maxsize semantics): never full
        saturation = 0.0
    return {"depth": int(depth), "capacity": int(capacity),
            "saturation": round(saturation, 4)}


def queue_state(app: Any) -> dict[str, Any] | None:
    """The app's admission state (``app["tpu_engine_pool"]`` when it has a
    pool, else ``app["tpu_engine"]``; on a worker of the shared engine plane,
    which has neither, the owner's state through
    ``app["engine_plane"].queue_state_sync()``, None until the plane has
    read it: never a worker-local zero); refreshes the
    ``gw_engine_saturation`` gauge when the app carries metrics."""
    state = compute_queue_state(app.get("tpu_engine_pool"), app.get("tpu_engine"))
    if state is None:
        plane = app.get("engine_plane")
        if plane is not None:
            state = plane.queue_state_sync()
    if state is None:
        return None
    metrics = app.get("metrics")
    if metrics is not None:
        metrics.gw_engine_saturation.set(state["saturation"])
    return state


def retry_after_s(saturation: float, advisory_at: float = 0.8) -> int:
    """Suggested client backoff once saturation crosses the advisory bar:
    1 s at the bar up to 8 s at full saturation."""
    at = min(advisory_at, 1.0 - 1e-6)  # a bar AT 1.0 still ramps
    frac = max(0.0, saturation - at) / (1.0 - at)
    return max(1, min(8, math.ceil(frac * 8.0)))


def backpressure_headers(state: dict[str, Any] | None,
                         settings: Any) -> dict[str, str]:
    """The backpressure header contract: X-Queue-Depth always, Retry-After
    past ``settings.gw_backpressure_retry_after_at``."""
    if state is None:
        return {}
    headers = {"X-Queue-Depth": str(state["depth"])}
    advisory_at = settings.gw_backpressure_retry_after_at
    if state["saturation"] >= advisory_at:
        headers["Retry-After"] = str(
            retry_after_s(state["saturation"], advisory_at))
    return headers
