"""Graceful-degradation ladder: per-component breakers and the overload
shedder (a copy of the JAX package's ``observability/degradation.py``;
stdlib only).

- :class:`CircuitBreaker`: closed -> open after ``failure_threshold``
  consecutive failures, open -> half-open after ``cooldown_s`` (one probe
  allowed through), half-open -> closed on the probe's success, back to
  open on its failure.
- :class:`DegradationManager`: the registry of breakers and manual
  component states, with a bounded transition history and the
  ``degradation_state{component}`` gauge (0 closed, 1 half-open, 2 open)
  when it is given a metrics sink.
- :class:`OverloadShedder`: admission-time 429s on the LLM surface. It
  sheds the LOWEST SLO class first: ``class_order`` lists the sheddable
  classes lowest-first, class i sheds once the engine's saturation (queue
  depth over capacity) crosses an evenly spaced bar between ``shed_at``
  and 1.0, and classes not listed never shed on saturation. A tenant whose
  quota window is spent (``ledger.quota_ratio >= 1``) sheds regardless.
  Each verdict carries a Retry-After scaled by how far past the bar the
  saturation is.

The manager is a process-global singleton, (re)configured at app build.
All breaker mutation is under locks (counter math only, no I/O).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

logger = logging.getLogger(__name__)

# gauge encoding for mcpforge_degradation_state
STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


class CircuitBreaker:
    """One component's (or one peer's) failure ladder. State mutates
    under the owning manager's lock; callers use:

    - ``allow()`` before the guarded operation — False means skip it and
      serve the degraded path (open, cooldown not yet elapsed);
    - ``record_failure()`` / ``record_success()`` after it.
    """

    def __init__(self, component: str, key: str = "",
                 failure_threshold: int = 3, cooldown_s: float = 5.0,
                 on_transition=None) -> None:
        self.component = component
        self.key = key
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.state = "closed"
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.failures = 0
        self.successes = 0
        self._on_transition = on_transition
        self._lock = threading.Lock()

    def _transition(self, state: str) -> None:
        if state == self.state:
            return
        old, self.state = self.state, state
        if self._on_transition is not None:
            self._on_transition(self, old, state)

    def allow(self) -> bool:
        """May the guarded operation run right now? An open breaker
        whose cooldown elapsed moves to half-open and admits ONE probe;
        further calls while the probe is out stay refused."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if time.monotonic() - self.opened_at < self.cooldown_s:
                    return False
                self._transition("half_open")
                return True
            # half_open: the single probe is already out
            return False

    def record_failure(self, reason: str = "") -> None:
        with self._lock:
            self.failures += 1
            self.consecutive_failures += 1
            if self.state == "half_open" or (
                    self.state == "closed"
                    and self.consecutive_failures >= self.failure_threshold):
                self.opened_at = time.monotonic()
                self._transition("open")
                logger.warning(
                    "degradation: breaker %s%s OPEN after %d consecutive "
                    "failure(s)%s", self.component,
                    f"[{self.key}]" if self.key else "",
                    self.consecutive_failures,
                    f" ({reason})" if reason else "")

    def record_success(self) -> None:
        with self._lock:
            self.successes += 1
            self.consecutive_failures = 0
            if self.state != "closed":
                self._transition("closed")
                logger.info("degradation: breaker %s%s CLOSED (recovered)",
                            self.component,
                            f"[{self.key}]" if self.key else "")

    def snapshot(self) -> dict[str, Any]:
        return {"component": self.component, "key": self.key,
                "state": self.state,
                "consecutive_failures": self.consecutive_failures,
                "failures": self.failures, "successes": self.successes,
                "failure_threshold": self.failure_threshold,
                "cooldown_s": self.cooldown_s}


class DegradationManager:
    """Registry + status surface for every breaker and manual state."""

    def __init__(self, metrics: Any = None, failure_threshold: int = 3,
                 cooldown_s: float = 5.0, history_size: int = 64) -> None:
        self.metrics = metrics
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._breakers: dict[tuple[str, str], CircuitBreaker] = {}
        self._manual: dict[str, str] = {}  # component -> state (shedder)
        self._history: list[dict[str, Any]] = []
        self._history_size = max(1, history_size)
        self._lock = threading.Lock()

    def breaker(self, component: str, key: str = "",
                failure_threshold: int | None = None,
                cooldown_s: float | None = None) -> CircuitBreaker:
        """The breaker for (component, key), created on first use.
        ``key`` scopes multi-member components (one breaker per
        federation peer); the exported gauge aggregates per component."""
        with self._lock:
            breaker = self._breakers.get((component, key))
            if breaker is None:
                breaker = CircuitBreaker(
                    component, key,
                    failure_threshold=(failure_threshold
                                       if failure_threshold is not None
                                       else self.failure_threshold),
                    cooldown_s=(cooldown_s if cooldown_s is not None
                                else self.cooldown_s),
                    on_transition=self._record_transition)
                self._breakers[(component, key)] = breaker
        self._export(component)
        return breaker

    def _record_transition(self, breaker: CircuitBreaker, old: str,
                           new: str) -> None:
        # called under the breaker's lock: bounded append only (the
        # manager lock is NOT taken here — lock order stays one-level)
        self._history.append({
            "component": breaker.component, "key": breaker.key,
            "from": old, "to": new, "ts": time.time()})
        del self._history[:-self._history_size]
        self._export(breaker.component)

    def adopt(self, breaker: CircuitBreaker) -> None:
        """Re-register a live breaker after a reconfigure. The manager
        is a process singleton and ``configure_degradation`` clears its
        registry (hermetic app builds); components that outlive a
        rebuild keep their breaker OBJECTS working, but the status/gauge
        surfaces would stop seeing them; a harness that builds several
        apps in one process adopts the surviving breakers back into the
        registry it reports through."""
        with self._lock:
            self._breakers[(breaker.component, breaker.key)] = breaker
        breaker._on_transition = self._record_transition
        self._export(breaker.component)

    def set_state(self, component: str, state: str,
                  ttl_s: float | None = None) -> None:
        """Manual (non-breaker) component state — the overload shedder
        reports open while it is actively shedding. ``ttl_s`` bounds a
        non-closed state's lifetime: the shedder only runs on request
        admission, so without a TTL an overload burst followed by total
        idle would read "open" forever (a page for an overload that
        ended hours ago); past the TTL the state lazily reads — and
        records — closed."""
        if state not in STATE_VALUES:
            raise ValueError(f"unknown state {state!r}")
        old = self._manual_state(component)
        expires = (time.monotonic() + ttl_s) if ttl_s else None
        self._manual[component] = (state, expires)
        if old != state:
            self._history.append({"component": component, "key": "",
                                  "from": old, "to": state,
                                  "ts": time.time()})
            del self._history[:-self._history_size]
        self._export(component)

    def _manual_state(self, component: str) -> str:
        """Current manual state with lazy TTL expiry (the expiry is a
        real transition: history + gauge updated)."""
        entry = self._manual.get(component)
        if entry is None:
            return "closed"
        state, expires = entry
        if state != "closed" and expires is not None \
                and time.monotonic() >= expires:
            self._manual[component] = ("closed", None)
            self._history.append({"component": component, "key": "",
                                  "from": state, "to": "closed",
                                  "ts": time.time(), "expired": True})
            del self._history[:-self._history_size]
            self._export(component)
            return "closed"
        return state

    def component_state(self, component: str) -> str:
        """Worst state across the component's members + manual state."""
        worst = self._manual_state(component)
        for (comp, _key), breaker in list(self._breakers.items()):
            if comp != component:
                continue
            if STATE_VALUES[breaker.state] > STATE_VALUES[worst]:
                worst = breaker.state
        return worst

    def _export(self, component: str) -> None:
        metrics = self.metrics
        if metrics is None:
            return
        try:
            metrics.degradation_state.labels(component=component).set(
                STATE_VALUES[self.component_state(component)])
        except Exception:
            pass  # telemetry must never break the failure path

    def transitions(self, component: str | None = None) -> list[dict[str, Any]]:
        rows = list(self._history)
        if component is not None:
            rows = [r for r in rows if r["component"] == component]
        return rows

    def status(self) -> dict[str, Any]:
        with self._lock:
            breakers = [b.snapshot() for b in self._breakers.values()]
        components = sorted({b["component"] for b in breakers}
                            | set(self._manual))
        return {
            "components": {c: self.component_state(c) for c in components},
            "breakers": sorted(breakers,
                               key=lambda b: (b["component"], b["key"])),
            "manual": {c: self._manual_state(c) for c in self._manual},
            "transitions": list(self._history),
        }


_MANAGER = DegradationManager()


def get_degradation() -> DegradationManager:
    return _MANAGER


def configure_degradation(metrics: Any = None, failure_threshold: int = 3,
                          cooldown_s: float = 5.0) -> DegradationManager:
    """(Re)configure the process manager at app build: swap the metrics
    sink, apply thresholds to future breakers, and drop state from a
    previous app in this process (hermetic tests)."""
    _MANAGER.metrics = metrics
    _MANAGER.failure_threshold = failure_threshold
    _MANAGER.cooldown_s = cooldown_s
    with _MANAGER._lock:
        _MANAGER._breakers.clear()
    _MANAGER._manual.clear()
    _MANAGER._history.clear()
    return _MANAGER


class OverloadShedder:
    """Admission-time 429s on the LLM surface, lowest SLO class first.

    ``class_order`` lists the SHEDDABLE classes lowest-first; class i's
    shed bar is ``shed_at + (1 - shed_at) * i / len(order)``, so the
    head of the list sheds the moment saturation crosses the bar and
    later entries shed only as the queue approaches full. Classes not
    listed (and tenants mapped to them) NEVER shed on saturation — that
    is the "higher classes hold their targets" half of the ladder.

    Independently, a tenant whose quota window is exhausted
    (``quota_ratio >= 1.0`` — the same window behind
    ``mcpforge_gw_tenant_quota_used_ratio``) sheds regardless of
    saturation, enforced per tenant.
    """

    def __init__(self, shed_at: float = 0.95,
                 class_order: list[str] | None = None,
                 tenant_classes: dict[str, str] | None = None,
                 ledger: Any = None, degradation: DegradationManager | None = None,
                 metrics: Any = None, enabled: bool = True,
                 limiter: Any = None) -> None:
        self.enabled = enabled
        self.shed_at = min(max(float(shed_at), 0.0), 1.0)
        self.class_order = list(class_order or [])
        self.tenant_classes = dict(tenant_classes or {})
        self.ledger = ledger
        self.degradation = degradation
        self.metrics = metrics
        # DistributedTenantLimiter (coordination/ratelimit.py): when set,
        # the quota verdict comes from the SHARED cross-worker window
        # instead of this worker's ledger alone (decide_admission)
        self.limiter = limiter
        self.shed_total = 0
        # llm.overload 'open' auto-expires: decide() only runs on
        # admission, so a burst followed by total idle must not read
        # open forever (the TTL is refreshed by every shedding decide)
        self.open_ttl_s = 30.0

    def class_for(self, tenant: str) -> str:
        return self.tenant_classes.get(tenant or "", "default")

    def _bar(self, slo_class: str) -> float | None:
        """Saturation past which this class sheds; None = never."""
        try:
            rank = self.class_order.index(slo_class)
        except ValueError:
            return None
        span = 1.0 - self.shed_at
        return self.shed_at + span * rank / max(1, len(self.class_order))

    async def decide_admission(self, saturation: float, tenant: str = "",
                               est_tokens: float = 1.0
                               ) -> dict[str, Any] | None:
        """Admission-path decide. Order matters: the sync :meth:`decide`
        (saturation shed + the local ledger's own ratio floor — it sees
        this worker's usage BEFORE the reconciliation interval publishes
        it; both only ever under-admit) runs FIRST, so a request the
        saturation ladder refuses never debits the tenant's distributed
        grant — an overloaded hour must not also eat the quota window.
        Only a locally-admitted request consults the SHARED cross-worker
        window; its refusals carry the shared window's retry horizon, so
        N workers enforce one budget, not N."""
        verdict = self.decide(saturation, tenant)
        if verdict is not None:
            return verdict
        if self.enabled and self.limiter is not None \
                and self.limiter.enabled:
            quota = await self.limiter.decide(tenant, est_tokens)
            if quota is not None:
                slo_class = self.class_for(tenant)
                verdict = {"status": 429, "slo_class": slo_class, **quota}
                self.shed_total += 1
                if self.metrics is not None:
                    try:
                        self.metrics.gw_requests_shed.labels(
                            slo_class=slo_class, reason="quota").inc()
                    except Exception:
                        pass
                return verdict
        return None

    def decide(self, saturation: float,
               tenant: str = "") -> dict[str, Any] | None:
        """None = admit; else a shed verdict
        ``{"status": 429, "retry_after_s": N, "reason", "slo_class"}``."""
        if not self.enabled:
            return None
        slo_class = self.class_for(tenant)
        verdict = None
        if self.ledger is not None:
            ratio = self.ledger.quota_ratio(tenant)
            if ratio >= 1.0:
                verdict = {"status": 429,
                           "retry_after_s": min(8, max(1, int(ratio))),
                           "reason": "quota", "slo_class": slo_class,
                           "quota_used_ratio": round(ratio, 3)}
        if verdict is None:
            bar = self._bar(slo_class)
            if bar is not None and saturation >= bar:
                # scale the advisory with depth past the class's own bar
                from ..gateway.flight_recorder import retry_after_s
                verdict = {"status": 429,
                           "retry_after_s": retry_after_s(saturation, bar),
                           "reason": "overload", "slo_class": slo_class,
                           "saturation": round(saturation, 4)}
        shedding = saturation >= self.shed_at and bool(self.class_order)
        if self.degradation is not None:
            if shedding:
                self.degradation.set_state("llm.overload", "open",
                                           ttl_s=self.open_ttl_s)
            else:
                self.degradation.set_state("llm.overload", "closed")
        if verdict is not None:
            self.shed_total += 1
            if self.metrics is not None:
                try:
                    self.metrics.gw_requests_shed.labels(
                        slo_class=slo_class,
                        reason=verdict["reason"]).inc()
                except Exception:
                    pass
        return verdict
