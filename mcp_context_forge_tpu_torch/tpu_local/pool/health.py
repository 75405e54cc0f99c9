"""Replica health monitoring for the EnginePool (a copy of the JAX
package's ``tpu_local/pool/health.py``).

Two failure modes, two host-side, read-only signals:

- **crashed**: the dispatch thread died (a fault without ``auto_restart``,
  or restarts exhausted), so ``engine.dispatch_alive()`` is false. The
  engine's ``_fail_outstanding`` already ended every stream with
  ``finish_reason="error"`` and the pool's pumps requeue them; the monitor
  marks the replica dead so the router stops sending it work, and catches
  any record whose pump raced the crash.
- **wedged**: the thread lives but is stuck inside a device call, so the
  dispatch loop's heartbeat goes stale while the replica holds in-flight
  work. An idle engine beats too (its wait is bounded at 50 ms), so
  staleness is read only against replicas with outstanding requests, and
  only against WARMED engines: an engine that could still build a kernel
  or capture a graph on its dispatch thread may sit in that longer than
  any heartbeat bar. A ``TorchEngine`` captures every graph at
  construction, so it is warmed from the start, provided every kernel
  library was built before the pool serves (a first-use ``nvcc`` build on
  a dispatch thread would read as a wedge).

On detection the monitor kills the engine (a signal, no join: a wedged
thread must not delay failover), marks the replica dead, and has the pool
requeue its in-flight requests onto healthy replicas.

Runs as an asyncio task on the pool's loop, so all pool state stays on one
thread; the engines' dispatch threads are reached only through their
read-only liveness reads and ``kill()``.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .pool import EnginePool

logger = logging.getLogger(__name__)


class HealthMonitor:
    """Periodic liveness sweep over the pool's replicas."""

    def __init__(self, pool: "EnginePool", interval_s: float = 0.5,
                 heartbeat_timeout_s: float = 10.0) -> None:
        self.pool = pool
        self.interval_s = max(0.01, interval_s)
        self.heartbeat_timeout_s = max(0.05, heartbeat_timeout_s)
        self._task: asyncio.Task | None = None
        self.sweeps = 0
        self.failures = 0

    async def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="engine-pool-health")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                self.sweep()
            except Exception:  # the monitor must outlive a bad sweep
                logger.exception("engine pool health sweep failed")

    def sweep(self) -> None:
        """One liveness pass; synchronous so tests can drive it directly."""
        self.sweeps += 1
        for replica in self.pool.replicas:
            if replica.state not in ("ready", "draining"):
                continue
            verdict = self.verdict(replica)
            if verdict is not None:
                self.failures += 1
                logger.error("engine pool: replica %s (role %s) %s - failing over",
                             replica.id, replica.role, verdict)
                self.pool.fail_replica(replica, reason=verdict)

    def verdict(self, replica) -> str | None:
        """None = healthy; otherwise a short reason."""
        engine = replica.engine
        if not engine.dispatch_alive():
            return "dispatch thread dead"
        if replica.outstanding and engine.warmed:
            # wedge detection is armed only on warmed engines (module doc):
            # an unwarmed one may legitimately sit in a build or capture
            age = engine.heartbeat_age()
            step_age = engine.last_step_age()
            if step_age is None:
                # no step retired yet: a stale heartbeat is a wedge before
                # the first step (without this arm the request would hang,
                # since step_age never becomes non-None on such a replica)
                if age > self.heartbeat_timeout_s:
                    return (f"wedged: heartbeat stale {age:.1f}s before first "
                            f"step with {len(replica.outstanding)} in-flight")
            # once the replica has retired steps both signals must agree
            elif age > self.heartbeat_timeout_s and step_age > self.heartbeat_timeout_s:
                return (f"wedged: heartbeat stale {age:.1f}s with "
                        f"{len(replica.outstanding)} in-flight")
        return None
