"""Engine-admission backpressure for the /v1 surface (the single-engine
half of the JAX package's ``gateway/flight_recorder.py``): queue depth,
capacity and saturation, the Retry-After it advises, and the headers that
carry them."""

from __future__ import annotations

import math
from typing import Any


def compute_queue_state(engine: Any) -> dict[str, Any] | None:
    """Depth/capacity/saturation of one engine, or None without one."""
    if engine is None:
        return None
    depth = engine.stats.queue_depth
    capacity = engine.config.max_queue
    # max_queue <= 0 is an unbounded admission queue (queue.Queue maxsize
    # semantics): never full
    saturation = min(1.0, depth / capacity) if capacity > 0 else 0.0
    return {"depth": int(depth), "capacity": int(capacity),
            "saturation": round(saturation, 4)}


def queue_state(app: Any) -> dict[str, Any] | None:
    """The app's engine admission state (``app["tpu_engine"]``); refreshes
    the ``gw_engine_saturation`` gauge when the app carries metrics."""
    state = compute_queue_state(app.get("tpu_engine"))
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
