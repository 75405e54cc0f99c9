"""Engine-admission backpressure for the /v1 surface (the queue-state half
of the JAX package's ``gateway/flight_recorder.py``): queue depth, capacity
and saturation of one engine or of a replica pool, the Retry-After it
advises, and the headers that carry them."""

from __future__ import annotations

import math
from typing import Any


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
    pool, else ``app["tpu_engine"]``); refreshes the
    ``gw_engine_saturation`` gauge when the app carries metrics."""
    state = compute_queue_state(app.get("tpu_engine_pool"), app.get("tpu_engine"))
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
