"""The worker heartbeat: hold the ``worker:<id>`` lease while the worker
lives.

This is the heartbeat half of the JAX package's
``services/session_affinity.py`` (``SessionAffinityService._heartbeat_loop``
and ``HEARTBEAT_TTL``), taken alone: the port does not port session
affinity. ``BusRpc._peer_alive`` reads this lease to tell a live peer that
is slow (a long prefill, a build) from a dead one, and an unknown lease
reads as dead, so a worker that serves RPC must run its heartbeat. The TTL
is a parameter here, where the reference fixes it at 15 s; the lease is
renewed every TTL/3, so a dead worker's lease lapses within one TTL.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

logger = logging.getLogger(__name__)

HEARTBEAT_TTL = 15.0


def lease_name(worker_id: str) -> str:
    return f"worker:{worker_id}"


class WorkerHeartbeat:
    """Acquire (and so renew) ``worker:<id>`` every ``ttl / 3`` seconds;
    release it at ``stop()``."""

    def __init__(self, leases: Any, worker_id: str,
                 ttl: float = HEARTBEAT_TTL) -> None:
        self.leases = leases
        self.worker_id = worker_id
        self.ttl = float(ttl)
        self.beats = 0
        self._task: asyncio.Task | None = None

    async def start(self) -> None:
        """Take the lease once before returning, so that a peer that calls
        this worker right after sees it alive, then keep it."""
        if self._task is None:
            await self._beat()
            self._task = asyncio.get_running_loop().create_task(
                self._loop(), name=f"heartbeat-{self.worker_id}")

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            await self.leases.release(lease_name(self.worker_id),
                                      self.worker_id)

    async def _beat(self) -> None:
        try:
            if await self.leases.acquire(lease_name(self.worker_id),
                                         self.worker_id, self.ttl):
                self.beats += 1
        except Exception:
            logger.exception("worker heartbeat failed")

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.ttl / 3)
            await self._beat()
