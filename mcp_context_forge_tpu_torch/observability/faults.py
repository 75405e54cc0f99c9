"""Fault-injection plane: named fault points at the serving seams (a copy
of the JAX package's ``observability/faults.py``; stdlib only).

- A seam calls ``fault_point("<name>", scope=...)`` and gets either
  ``None`` (no rule armed: one dict miss, no lock) or a
  :class:`FaultAction` telling it to raise, sleep, or corrupt its payload.
- Rules are deterministic: seeded schedules fire ``once``, ``one_in_n``
  (by call count + seed, no clocks, no RNG state), for a ``window`` of
  seconds after arming, or ``always``.
- The plane is armed only when ``fault_injection_enabled`` is set; with
  it unset (the default) ``arm()`` refuses and the rule table stays
  empty.
- Rules arrive through ``arm`` or the ``fault_rules`` settings JSON
  (boot-time arming, ``configure_fault_plane``).
- Every injected fault counts in ``faults_injected{point,kind}`` when the
  plane has a metrics sink.

:data:`FAULT_POINTS` is the reference's registry of point names, so a rule
validates here as it does there. The port's seam so far is
``engine.dispatch`` (``TorchEngine``'s dispatch loop, scope = replica
id): ``latency`` is a slow replica, ``error`` a dispatch-thread crash
through the engine's real crash path.

Thread model: fault points fire from engine dispatch threads and the
asyncio loop. The rule table is a plain dict read without a lock
(armed and disarmed a whole rule at a time); per-rule counters mutate
under the plane lock so schedules stay exact.

:class:`FaultError` subclasses ``ConnectionError`` so transport- and
disk-error handlers treat an injected fault exactly like a real one.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any

logger = logging.getLogger(__name__)

# THE registry of injectable seams (the reference's names). A seam
# annotates itself by calling fault_point() with one of these literals;
# anything else raises at arm time.
FAULT_POINTS = (
    "coordination.hub.rpc",   # coordination/rpc.py client send (scope =
                              # method; corrupt = partition: frame dropped)
    "db.execute",             # db/core.py: every statement (scope = SQL)
    "engine.dispatch",        # engine.py dispatch loop (scope = replica id)
    "federation.peer.request",  # peer connect/call (scope = peer URL)
    "ledger.rollup.flush",    # metering.py rollup window -> DB write
    "pool.migrate",           # pool.py prefill->decode KV-page transfer
                              # (corrupt = payload fails verify-before-
                              # serve and migration degrades in place)
    "pool.requeue",           # pool.py failover requeue hop
    "tier.disk.read",         # tiers.py T2 spill-file load
    "tier.disk.write",        # tiers.py T2 write-behind persist
    "tier.host.get",          # tiers.py T1 fetch at match time
    "tier.object.get",        # tiers.py T3 object-store fetch (corrupt =
                              # mangled blob -> verify-MISS, never a
                              # served page)
    "tier.object.put",        # tiers.py T3 write-through persist
)

KINDS = ("error", "latency", "corrupt")
MODES = ("always", "once", "one_in_n", "window")


class FaultError(ConnectionError):
    """An injected fault. ConnectionError (⊂ OSError) so transport- and
    disk-error handlers treat it exactly like the real failure."""


@dataclass
class FaultRule:
    """One armed fault: what to inject at a point, and when."""

    point: str
    kind: str = "error"          # error | latency | corrupt
    mode: str = "always"         # always | once | one_in_n | window
    n: int = 2                   # one_in_n period
    window_s: float = 0.0        # window mode: fire this long after arm
    latency_ms: float = 0.0      # latency kind: injected delay
    scope: str = ""              # substring filter on the seam's scope
    seed: int = 0                # one_in_n phase offset
    message: str = ""
    # runtime state (plane-lock guarded)
    calls: int = 0
    fired: int = 0
    armed_at: float = field(default_factory=time.monotonic)

    def validate(self) -> None:
        # type discipline first: a non-string scope would TypeError at
        # EVERY matching seam call (`rule.scope not in scope`) — not a
        # FaultError the degradation handlers catch, but an uncontrolled
        # crash broader than any fault the operator armed
        for name in ("point", "kind", "mode", "scope", "message"):
            if not isinstance(getattr(self, name), str):
                raise ValueError(f"{name} must be a string")
        for name in ("n", "seed"):
            if not isinstance(getattr(self, name), int) \
                    or isinstance(getattr(self, name), bool):
                raise ValueError(f"{name} must be an integer")
        for name in ("window_s", "latency_ms"):
            if not isinstance(getattr(self, name), (int, float)) \
                    or isinstance(getattr(self, name), bool):
                raise ValueError(f"{name} must be a number")
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r} "
                             f"(have {list(FAULT_POINTS)})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}")
        if self.mode == "one_in_n" and self.n < 1:
            raise ValueError("one_in_n needs n >= 1")
        if self.mode == "window" and self.window_s <= 0:
            raise ValueError("window mode needs window_s > 0")
        if self.kind == "latency" and self.latency_ms <= 0:
            raise ValueError("latency kind needs latency_ms > 0")

    def snapshot(self) -> dict[str, Any]:
        return {"point": self.point, "kind": self.kind, "mode": self.mode,
                "n": self.n, "window_s": self.window_s,
                "latency_ms": self.latency_ms, "scope": self.scope,
                "seed": self.seed, "calls": self.calls, "fired": self.fired}


class FaultAction:
    """What an armed rule told the seam to do. The seam interprets it:
    ``apply()`` raises/sleeps on thread seams, ``async_apply()`` on loop
    seams, ``corrupt`` leaves payload mangling to seam-specific code
    (``corrupt_bytes`` is the shared deterministic mangler)."""

    __slots__ = ("point", "kind", "latency_s", "message")

    def __init__(self, point: str, kind: str, latency_s: float = 0.0,
                 message: str = "") -> None:
        self.point = point
        self.kind = kind
        self.latency_s = latency_s
        self.message = message or f"injected fault at {point}"

    def apply(self) -> None:
        """Thread seams: sleep (latency) or raise (error). ``corrupt``
        is a no-op here — the seam mangles its own payload."""
        if self.kind == "latency":
            time.sleep(self.latency_s)
        elif self.kind == "error":
            raise FaultError(self.message)

    async def async_apply(self) -> None:
        """Asyncio seams: same contract without blocking the loop."""
        if self.kind == "latency":
            import asyncio
            await asyncio.sleep(self.latency_s)
        elif self.kind == "error":
            raise FaultError(self.message)

    @staticmethod
    def corrupt_bytes(data: bytes) -> bytes:
        """Deterministic payload mangling: flip every bit of one byte per
        1 KiB stride (and always the first byte), so verification layers
        see content that is the right length but the wrong content."""
        if not data:
            return data
        out = bytearray(data)
        for i in range(0, len(out), 1024):
            out[i] ^= 0xFF
        return bytes(out)


class FaultPlane:
    """The process-wide rule table behind every ``fault_point()`` call."""

    def __init__(self, enabled: bool = False, metrics: Any = None) -> None:
        self.enabled = enabled
        self.metrics = metrics
        self._rules: dict[str, FaultRule] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- management

    def arm(self, rule: FaultRule) -> FaultRule:
        """Install (or replace) the rule for a point. Refuses while the
        plane is disabled — the default-off contract is 'the table CANNOT
        become non-empty', not 'rules exist but are skipped'."""
        if not self.enabled:
            raise RuntimeError(
                "fault injection is disabled "
                "(set MCPFORGE_FAULT_INJECTION_ENABLED=true)")
        rule.validate()
        rule.armed_at = time.monotonic()
        with self._lock:
            self._rules[rule.point] = rule
        logger.warning("fault plane: armed %s", rule.snapshot())
        return rule

    def disarm(self, point: str) -> bool:
        with self._lock:
            rule = self._rules.pop(point, None)
        if rule is not None:
            logger.warning("fault plane: disarmed %s (fired %d/%d calls)",
                           point, rule.fired, rule.calls)
        return rule is not None

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            rules = [r.snapshot() for r in self._rules.values()]
        return {"enabled": self.enabled, "points": list(FAULT_POINTS),
                "rules": sorted(rules, key=lambda r: r["point"])}

    # --------------------------------------------------------------- fire path

    def check(self, point: str, scope: str | None = None) -> FaultAction | None:
        """The fault point itself. Unarmed points (the production
        steady state, and EVERY point when the plane is disabled) cost
        one dict miss and return None — no lock, no branching beyond
        the miss; the zero-overhead contract is pinned in tests."""
        rule = self._rules.get(point)
        if rule is None:
            return None
        return self._decide(rule, scope)

    def _decide(self, rule: FaultRule,
                scope: str | None) -> FaultAction | None:
        if rule.scope and (scope is None or rule.scope not in scope):
            return None
        with self._lock:
            call_index = rule.calls
            rule.calls += 1
            if rule.mode == "once":
                fire = rule.fired == 0
            elif rule.mode == "one_in_n":
                fire = (call_index + rule.seed) % rule.n == 0
            elif rule.mode == "window":
                fire = (time.monotonic() - rule.armed_at) <= rule.window_s
            else:  # always
                fire = True
            if not fire:
                return None
            rule.fired += 1
        metrics = self.metrics
        if metrics is not None:
            try:
                metrics.faults_injected.labels(point=rule.point,
                                               kind=rule.kind).inc()
            except Exception:
                pass  # accounting must never mask the injected fault
        return FaultAction(rule.point, rule.kind,
                           latency_s=rule.latency_ms / 1e3,
                           message=rule.message)


# One process-global plane: fault points fire from dispatch threads, the
# spill writer, and the DB executor without any app handle to thread
# through — the app configures this instance at build time.
_PLANE = FaultPlane()


def fault_point(point: str, scope: str | None = None) -> FaultAction | None:
    """THE seam annotation (see module doc). Returns None (default) or
    the action the armed rule selected."""
    return _PLANE.check(point, scope)


def get_fault_plane() -> FaultPlane:
    return _PLANE


def configure_fault_plane(enabled: bool, metrics: Any = None,
                          rules_json: str = "") -> FaultPlane:
    """(Re)configure the process plane from settings at app build: sets
    the armed flag, swaps the metrics sink, clears stale rules from a
    previous app in this process (hermetic tests), and arms any
    boot-time rules from the ``fault_rules`` env JSON (a list of rule
    objects — the headless bench path)."""
    _PLANE.enabled = bool(enabled)
    _PLANE.metrics = metrics
    _PLANE.clear()
    if rules_json and _PLANE.enabled:
        try:
            raw = json.loads(rules_json)
        except json.JSONDecodeError as exc:
            raise ValueError(f"invalid fault_rules JSON: {exc}") from exc
        if not isinstance(raw, list):
            raise ValueError("fault_rules must be a JSON array of rules")
        for entry in raw:
            _PLANE.arm(FaultRule(**entry))
    return _PLANE
