"""The run cancellation registry (a copy of the JAX package's
``services/cancellation_service.py``): ``notifications/cancelled`` cancels
the matching in-flight tools/call; an id with no such run is handed to the
engine (the pool's ``cancel`` or the engine's ``request_cancel``)."""

from __future__ import annotations

import asyncio
from typing import Any

from .base import AppContext


class CancellationService:
    def __init__(self, ctx: AppContext):
        self.ctx = ctx
        self._runs: dict[Any, asyncio.Task] = {}

    def register(self, request_id: Any, task: asyncio.Task) -> None:
        if request_id is not None:
            self._runs[request_id] = task
            task.add_done_callback(lambda _: self._runs.pop(request_id, None))

    async def cancel(self, request_id: Any) -> bool:
        task = self._runs.pop(request_id, None)
        if task is not None and not task.done():
            task.cancel()
            return True
        # the engine side: a generation whose request id matches. The pool
        # knows the logical id on every replica (a requeued shadow's id
        # carries a ~rN suffix); one engine is read through the live
        # accessor, so that a pool reload cannot strand a stale reference
        from .diagnostics_service import live_tpu_engine
        pool = self.ctx.extras.get("tpu_engine_pool")
        if pool is not None:
            return pool.cancel(request_id)
        engine = live_tpu_engine(self.ctx.extras)
        if engine is not None:
            return engine.request_cancel(request_id)
        return False

    @property
    def active_runs(self) -> int:
        return len(self._runs)
