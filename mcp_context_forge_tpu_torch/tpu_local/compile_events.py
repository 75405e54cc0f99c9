"""Kernel-build and graph-capture tracking: the port's twin of the JAX
package's XLA compile tracking.

The port compiles nothing per shape: its device code is built by ``nvcc``
(``ops/_build.py`` ``build``) and its decode steps are CUDA graphs
captured once (``decode_graphs.py``). Either one on the serving path
stalls traffic for seconds, so each is an event here: ``record_event``
counts and times it for the engine (and lifecycle stage) whose thread
started it. The engine's constructor registers its thread as stage
``warmup`` for the construction; the dispatch thread registers itself as
``serving`` for its life. Events on unregistered threads (a script that
builds every kernel up front) are ignored. Loading a built library with
``ctypes`` is not an event.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

KINDS = ("kernel_build", "graph_capture")

_lock = threading.Lock()
_by_thread: dict[int, tuple["CompileTracker", str]] = {}


class CompileTracker:
    """One engine's event counters, bumped from whichever thread builds or
    captures (own lock)."""

    STAGES = ("warmup", "serving")

    def __init__(self, on_event: Callable[[str, float, str], None] | None = None
                 ) -> None:
        self._lock = threading.Lock()
        self._counts = {stage: 0 for stage in self.STAGES}
        self._ms_totals = {stage: 0.0 for stage in self.STAGES}
        self._kinds = {(stage, kind): 0 for stage in self.STAGES for kind in KINDS}
        self._last_ts = 0.0
        self._recent: deque[dict[str, Any]] = deque(maxlen=32)
        # (stage, duration_s, kind) callback for metrics and spans; wrapped
        # so that telemetry never breaks the building thread
        self._on_event = on_event

    def record(self, stage: str, duration_s: float, kind: str) -> None:
        now = time.time()
        with self._lock:
            self._counts[stage] = self._counts.get(stage, 0) + 1
            self._ms_totals[stage] = (self._ms_totals.get(stage, 0.0)
                                      + duration_s * 1000.0)
            self._kinds[(stage, kind)] = self._kinds.get((stage, kind), 0) + 1
            self._last_ts = now
            self._recent.append({"ts": now, "stage": stage, "kind": kind,
                                 "duration_ms": round(duration_s * 1000, 3)})
        if self._on_event is not None:
            try:
                self._on_event(stage, duration_s, kind)
            except Exception:
                pass

    def snapshot(self) -> dict[str, Any]:
        """The JAX tracker's keys; each stage also counts its events by
        kind (``kernel_build``, ``graph_capture``)."""
        with self._lock:
            return {
                stage: {"count": self._counts.get(stage, 0),
                        "ms_total": round(self._ms_totals.get(stage, 0.0), 3),
                        **{kind: self._kinds.get((stage, kind), 0) for kind in KINDS}}
                for stage in self.STAGES
            } | {"last_compile_ts": self._last_ts, "recent": list(self._recent)}

    def serving_compiles(self) -> int:
        with self._lock:
            return self._counts.get("serving", 0)


def record_event(kind: str, duration_s: float) -> None:
    """Attribute one build or capture on the current thread to the tracker
    registered for it, if any."""
    registration = _by_thread.get(threading.get_ident())
    if registration is not None:
        tracker, stage = registration
        tracker.record(stage, float(duration_s), kind)


def track_thread(tracker: CompileTracker, stage: str
                 ) -> tuple[int, tuple[CompileTracker, str] | None]:
    """Attribute the current thread's events to ``tracker`` as ``stage``;
    returns a token for :func:`restore_thread` (nested attributions
    unwind cleanly)."""
    ident = threading.get_ident()
    with _lock:
        previous = _by_thread.get(ident)
        _by_thread[ident] = (tracker, stage)
    return ident, previous


def restore_thread(token: tuple[int, tuple[CompileTracker, str] | None]) -> None:
    ident, previous = token
    with _lock:
        if previous is None:
            _by_thread.pop(ident, None)
        else:
            _by_thread[ident] = previous
