"""Live signal bus: push-published serving telemetry for the controller (a
copy of the JAX package's ``observability/signals.py``; stdlib only).

Producers (engine retire, the gateway, an SLO evaluator) call
:meth:`SignalBus.publish` at their own cadence; the serving controller
reads smoothed aggregates at its tick.

- **Push, not scrape.** Publish is O(1): one lock, one deque append, one
  EWMA multiply.
- **Bounded.** Per-(signal, replica) state is a fixed-length window plus
  a few floats; the series table is capped at ``max_series`` (overflow
  publishes are counted and dropped).
- **Percentiles at read time** (the controller's tick), never at publish
  time (the engine's retire path).
- **Self-describing staleness.** Each aggregate carries the age of its
  last publish; consumers decide how stale is too stale.

Signal names are dotted strings, conventionally::

    llm.mfu                  llm.hbm_roofline_frac   llm.tokens_per_dispatch
    llm.ttft_ms              llm.tpot_ms             llm.queue_wait_ms
    llm.saturation           llm.idle_frac           llm.dispatch_gap_ms
    llm.spec_accept          llm.occupancy           gw.loop_lag_ms
    slo.burn_rate            tenant.quota_ratio

The ``replica`` key scopes per-engine signals ("0", "1", ...); gateway-
scope signals use replica ``"-"``; per-class slices suffix the name
(``slo.burn_rate.premium``) so the series cap bounds them too.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

GATEWAY_REPLICA = "-"  # replica key for signals with no engine scope


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (same convention
    as the SLO evaluator's window percentiles)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


class _Series:
    """One (signal, replica) aggregate: bounded window + EWMA."""

    __slots__ = ("window", "ewma", "last", "count", "ts")

    def __init__(self, maxlen: int):
        self.window: deque[float] = deque(maxlen=maxlen)
        self.ewma: float | None = None
        self.last: float = 0.0
        self.count: int = 0
        self.ts: float = 0.0

    def add(self, value: float, alpha: float, ts: float) -> None:
        self.window.append(value)
        self.ewma = value if self.ewma is None \
            else alpha * value + (1.0 - alpha) * self.ewma
        self.last = value
        self.count += 1
        self.ts = ts

    def view(self, now: float) -> dict[str, Any]:
        vals = sorted(self.window)
        return {
            "last": self.last,
            "ewma": self.ewma if self.ewma is not None else 0.0,
            "p50": _percentile(vals, 0.50),
            "p95": _percentile(vals, 0.95),
            "min": vals[0] if vals else 0.0,
            "max": vals[-1] if vals else 0.0,
            "n": len(vals),
            "count": self.count,
            "age_s": max(0.0, now - self.ts),
        }


class SignalBus:
    """Bounded, lock-cheap aggregate table for live serving signals."""

    def __init__(self, window: int = 64, ewma_alpha: float = 0.3,
                 max_series: int = 256,
                 clock: Callable[[], float] = time.monotonic):
        self._window = max(1, int(window))
        self._alpha = min(1.0, max(0.0, float(ewma_alpha)))
        self._max_series = max(1, int(max_series))
        self._clock = clock
        self._lock = threading.Lock()
        self._series: dict[tuple[str, str], _Series] = {}
        self._dropped = 0  # publishes past the series cap

    # -- producer side ----------------------------------------------------

    def publish(self, name: str, value: float,
                replica: str = GATEWAY_REPLICA) -> None:
        """O(1) push of one sample. Safe from any thread, including the
        engine dispatch thread (one short lock; no allocation past the
        first publish of a series)."""
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        now = self._clock()
        with self._lock:
            series = self._series.get((name, replica))
            if series is None:
                if len(self._series) >= self._max_series:
                    self._dropped += 1
                    return
                series = _Series(self._window)
                self._series[(name, replica)] = series
            series.add(value, self._alpha, now)

    def publish_many(self, samples: dict[str, float],
                     replica: str = GATEWAY_REPLICA) -> None:
        for name, value in samples.items():
            if value is not None:
                self.publish(name, value, replica)

    # -- consumer side ----------------------------------------------------

    def get(self, name: str, replica: str = GATEWAY_REPLICA
            ) -> dict[str, Any] | None:
        """Aggregate view for one series, or None if never published."""
        now = self._clock()
        with self._lock:
            series = self._series.get((name, replica))
            if series is None:
                return None
            return series.view(now)

    def ewma(self, name: str, replica: str = GATEWAY_REPLICA,
             max_age_s: float | None = None) -> float | None:
        """Just the EWMA, or None when absent/staler than ``max_age_s``
        (the controller's hold-position staleness guard)."""
        now = self._clock()
        with self._lock:
            series = self._series.get((name, replica))
            if series is None or series.ewma is None:
                return None
            if max_age_s is not None and (now - series.ts) > max_age_s:
                return None
            return series.ewma

    def replicas(self, name: str) -> list[str]:
        """Replica keys that have published ``name``."""
        with self._lock:
            return sorted(r for (n, r) in self._series if n == name)

    def snapshot(self, prefix: str = "") -> dict[str, dict[str, Any]]:
        """{``name@replica``: aggregate view} for every series (optionally
        name-prefix filtered) — the audit-ring "signals in" payload and
        the /admin/controller signal table."""
        now = self._clock()
        with self._lock:
            items = [((n, r), s) for (n, r), s in self._series.items()
                     if n.startswith(prefix)]
        return {f"{n}@{r}": s.view(now) for (n, r), s in items}

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"series": len(self._series),
                    "window": self._window,
                    "dropped": self._dropped}
