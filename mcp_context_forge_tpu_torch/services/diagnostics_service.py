"""Engine diagnostics for the operator routes (the engine part of the JAX
package's ``services/diagnostics_service.py``): the live engine behind a
single-engine or pooled app, the step ring with the scheduler counters an
operator needs to read it, and ``TorchProfilerCapture``, the
``torch.profiler`` counterpart of the JAX gateway's ``jax.profiler``
capture. The system stats and the support bundle need the database and
are not here."""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

from .base import ConflictError   # a transition the capture refuses (409)


def live_tpu_engine(container: Any) -> Any:
    """The current engine behind the single-engine admin routes: with a
    replica pool, replica 0's engine of now (a reload swaps the engine
    object, so one captured at build time would go stale), else
    ``container["tpu_engine"]``. ``container`` is the app, or any mapping."""
    pool = container.get("tpu_engine_pool")
    if pool is not None:
        return pool.replicas[0].engine
    return container.get("tpu_engine")


def engine_introspection(engine: Any, limit: int = 64) -> dict[str, Any]:
    """The engine's step ring and the scheduler counters that read it
    (``GET /admin/engine/steps``); the builds and graph captures of
    ``compile_stats()`` under the JAX key ``xla_compiles``."""
    stats = engine.stats
    return {
        "model": engine.config.model,
        "max_batch": engine.config.max_batch,
        "queue_depth": stats.queue_depth,
        "decode_steps": stats.decode_steps,
        "decode_dispatches": stats.decode_dispatches,
        "superstep": engine.config.fused_steps,
        "prefill_batches": stats.prefill_batches,
        "chunking": stats.chunking,
        "overlap_steps": stats.overlap_steps,
        "pipeline_drains": stats.pipeline_drains,
        "dispatch_gap_ms_total": round(stats.dispatch_gap_ms_total, 3),
        "device_idle_fraction": round(engine.device_idle_fraction(), 4),
        "phase_sampling": {
            "every": engine.config.step_sample_every,
            "samples": getattr(stats, "phase_samples", 0),
        },
        "roofline": (engine.roofline_snapshot()
                     if hasattr(engine, "roofline_snapshot") else None),
        "xla_compiles": (engine.compile_stats()
                         if hasattr(engine, "compile_stats") else None),
        "kv": {
            "pages_in_use": engine.allocator.pages_in_use,
            "free_pages": engine.allocator.free_pages,
            # the dtype-aware pool size (an int8 pool holds ~2x the pages)
            "num_pages": engine.num_kv_pages,
            "page_size": engine.config.page_size,
            "quant": engine.config.kv_quant or "off",
            "bytes_in_use": engine.kv_bytes_in_use(),
            "bytes_capacity": engine.kv_bytes_capacity(),
        },
        "steps": engine.recent_steps(limit),
    }


class TorchProfilerCapture:
    """An opt-in ``torch.profiler`` capture of the live engine: ``start()``
    and ``stop()`` bracket the traffic an operator cares about, with the CPU
    ops of every thread (the engine's dispatch thread among them) and, when
    ``device`` is a CUDA device, the card's kernels, graph replays'
    included. The trace lands as a Chrome trace JSON in the
    server-configured ``trace_dir`` only (never a path a client supplies:
    that would be a file-write primitive). The profiler is process-global,
    so the mutex serializes every transition, and both run on one thread of
    the capture's own (Kineto wants a session stopped on the thread that
    started it); the routes call them in ``asyncio.to_thread``, since a stop
    writes the trace file."""

    def __init__(self, trace_dir: str, device: Any = "cpu") -> None:
        self.trace_dir = trace_dir
        self.device = str(device)
        self._started_at: float | None = None
        self._profile = None
        self._mutex = threading.Lock()
        self._thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torch-profiler")

    @property
    def active(self) -> bool:
        return self._started_at is not None

    def status(self) -> dict[str, Any]:
        return {"active": self.active, "trace_dir": self.trace_dir,
                "started_at": self._started_at}

    def start(self) -> dict[str, Any]:
        with self._mutex:
            if self.active:
                raise ConflictError("a profiler capture is already running")
            self._profile = self._thread.submit(self._start_profile).result()
            self._started_at = time.time()
            return self.status()

    def _start_profile(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities,
                           experimental_config=_ExperimentalConfig(profile_all_threads=True))
        profiler.start()
        return profiler

    def stop(self, expect_started_at: float | None = None) -> dict[str, Any]:
        """Stop the capture and write its trace. ``expect_started_at`` stops
        only the capture that started then: a timed capture must not stop
        one an operator started in its window."""
        with self._mutex:
            if not self.active:
                raise ConflictError("no profiler capture is running")
            if expect_started_at is not None and self._started_at != expect_started_at:
                raise ConflictError("the running capture belongs to another caller; "
                                    "leaving it alone")
            started, profiler = self._started_at, self._profile
            path = os.path.join(self.trace_dir,
                                f"torch-trace-{int(started * 1e6)}-{os.getpid()}.json")
            try:
                self._thread.submit(self._stop_profile, profiler, path).result()
            finally:
                self._started_at = self._profile = None
            return {"active": False, "trace_dir": self.trace_dir, "trace_file": path,
                    "duration_ms": round((time.time() - started) * 1e3, 1),
                    "hint": "a Chrome trace: open it in Perfetto or chrome://tracing; "
                            "its kernel events are the card's prefill and decode launches"}

    def _stop_profile(self, profiler, path: str) -> None:
        profiler.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        profiler.export_chrome_trace(path)
