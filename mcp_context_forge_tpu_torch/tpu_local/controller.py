"""Closed-loop serving controller (a copy of the JAX package's
``tpu_local/controller.py``; stdlib only, so it runs on the card too).

It reads the live :class:`~..observability.signals.SignalBus` and retunes
four knobs inside hard safety rails:

- **Superstep K** (per replica): queue-wait p95 past
  ``queue_wait_high_ms`` steps K DOWN one captured ladder rung; queue-wait
  under ``queue_wait_low_ms`` with the device idle fraction past
  ``idle_frac_high`` steps K UP. Moves land only at the engine's drain
  barriers on graphs captured at build (``TorchEngine.request_knobs``
  refuses other rungs), so greedy streams hold.
- **Batch-width floor** (per replica): the p95 of live occupancy picks
  the smallest captured width the engine may shrink to.
- **Spec decode on/off** (per replica): measured acceptance below
  ``spec_accept_off`` turns drafting off; an acceptance signal stale past
  ``reprobe_after_s`` turns it back on to measure again.
- **Shed bars** (gateway scope): ``slo.burn_rate`` past ``burn_high``
  lowers ``OverloadShedder.shed_at`` toward ``shed_floor``; burn under
  ``burn_low`` raises it back toward the configured bar. Without a fresh
  burn signal the bar holds.

Anti-flap: a per-(replica, knob) cooldown; hysteresis on a reversal (the
trigger must clear its threshold by an extra ``hysteresis`` margin);
staleness guards (a dead replica's last signal is not a signal).

Every decision lands in a bounded audit ring (``RING_SCHEMA``) carrying
the triggering signals and, after ``eval_window_s``, the observed effect;
counts ``controller_decisions{knob,direction}`` and sets
``controller_knob{knob,replica}`` when given metrics; and emits a
parentless ``controller.decision`` span when given a tracer.
``safe_mode`` records every decision it would have made without
actuating.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Callable

from ..observability.signals import GATEWAY_REPLICA, SignalBus

logger = logging.getLogger(__name__)

# ring row schema version (admin surface consumers pin on this)
RING_SCHEMA = 1


class ServingController:
    """Feedback controller over the live signal bus.

    ``engines_fn`` returns the CURRENT list of engine-like objects
    (``.config.replica_id``, ``.request_knobs()``, ``.knob_state()``) —
    a callable so pool reloads/scale-outs are picked up per tick.
    ``tick()`` is synchronous and deterministic given the bus contents
    (tests drive it directly with an injected clock); ``start()`` runs
    it on the gateway loop every ``tick_s``.
    """

    def __init__(self, bus: SignalBus,
                 engines_fn: Callable[[], list[Any]],
                 shedder: Any = None,
                 slo_evaluator: Any = None,
                 metrics: Any = None,
                 tracer: Any = None,
                 *,
                 enabled: bool = True,
                 safe_mode: bool = False,
                 tick_s: float = 1.0,
                 cooldown_s: float = 10.0,
                 eval_window_s: float = 5.0,
                 hysteresis: float = 0.1,
                 ring_size: int = 256,
                 queue_wait_high_ms: float = 500.0,
                 queue_wait_low_ms: float = 50.0,
                 idle_frac_high: float = 0.35,
                 spec_accept_off: float = 0.5,
                 spec_accept_on: float = 1.0,
                 burn_high: float = 1.0,
                 burn_low: float = 0.25,
                 shed_floor: float = 0.5,
                 shed_step: float = 0.05,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.bus = bus
        self.engines_fn = engines_fn
        self.shedder = shedder
        self.slo = slo_evaluator
        self.metrics = metrics
        self.tracer = tracer
        self.enabled = enabled
        self.safe_mode = bool(safe_mode)
        self.tick_s = max(0.05, float(tick_s))
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.eval_window_s = max(self.tick_s, float(eval_window_s))
        self.hysteresis = max(0.0, float(hysteresis))
        self.queue_wait_high_ms = float(queue_wait_high_ms)
        self.queue_wait_low_ms = float(queue_wait_low_ms)
        self.idle_frac_high = float(idle_frac_high)
        self.spec_accept_off = float(spec_accept_off)
        self.spec_accept_on = float(spec_accept_on)
        self.burn_high = float(burn_high)
        self.burn_low = float(burn_low)
        self.shed_floor = min(max(float(shed_floor), 0.0), 1.0)
        self.shed_step = max(0.001, float(shed_step))
        self._clock = clock
        # signals older than this are dead — hold, don't steer on them
        self.stale_after_s = max(3.0 * self.tick_s, self.eval_window_s)
        # spec re-probe: acceptance is unobservable while drafting is
        # off, so a long-stale acceptance signal re-enables to measure
        self.reprobe_after_s = max(3.0 * self.cooldown_s, 30.0)
        # the static shed bar is the RELAXED ceiling the dynamic bar
        # returns to (captured at construction, before we ever move it)
        self._shed_ceiling = (min(max(float(shedder.shed_at), 0.0), 1.0)
                             if shedder is not None else 1.0)
        # audit ring: bounded, newest at the right
        self._ring: deque[dict[str, Any]] = deque(maxlen=max(8, ring_size))
        self._seq = 0
        # decisions awaiting their post-window effect capture
        self._pending_effects: list[dict[str, Any]] = []
        # per-(replica, knob) anti-flap state
        self._last_move_ts: dict[tuple[str, str], float] = {}
        self._last_direction: dict[tuple[str, str], str] = {}
        self._ticks = 0
        self._held = 0  # ticks where at least one knob held position
        self._task: asyncio.Task | None = None

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self._task is not None or not self.enabled:
            return
        self._task = asyncio.get_running_loop().create_task(
            self._run(), name="serving-controller")

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.tick_s)
            try:
                self.tick()
            except Exception:
                # the control loop must never take the gateway down; a
                # broken tick holds every knob where it is
                logger.exception("serving controller tick failed")

    # ---------------------------------------------------------------- tick

    def tick(self) -> list[dict[str, Any]]:
        """One control iteration: publish SLO burn onto the bus, settle
        due effect captures, then evaluate every knob ladder. Returns
        the decision rows emitted this tick (tests assert on them)."""
        now = self._clock()
        self._ticks += 1
        self._publish_burn()
        self._settle_effects(now)
        decisions: list[dict[str, Any]] = []
        for engine in self.engines_fn() or []:
            try:
                decisions.extend(self._tick_engine(engine, now))
            except Exception:
                logger.exception("controller: engine tick failed")
        decisions.extend(self._tick_shed(now))
        self._refresh_knob_gauges()
        return decisions

    # ------------------------------------------------------- signal inputs

    def _view(self, name: str, replica: str) -> dict[str, Any] | None:
        """Fresh aggregate view or None (absent/stale = hold)."""
        view = self.bus.get(name, replica)
        if view is None or view["age_s"] > self.stale_after_s:
            return None
        return view

    def _publish_burn(self) -> None:
        """Evaluate SLOs under the controller's own consumer window and
        push burn onto the bus — overall, plus one slice per tenant
        class (bounded by the class table). A vacuous burn (empty first
        window with no lifetime data, or every objective's target above
        the histogram buckets) publishes NOTHING: downstream ladders
        then hold by the staleness/absence guard, which is exactly the
        required behavior for a controller facing an unmeasurable SLO."""
        if self.slo is None:
            return
        try:
            report = self.slo.evaluate(consumer="controller")
        except Exception:
            logger.exception("controller: SLO evaluation failed")
            return
        burn = self._burn_from(report)
        if burn is not None:
            self.bus.publish("slo.burn_rate", burn, GATEWAY_REPLICA)
        classes = getattr(self.slo, "tenant_classes", None) or {}
        by_class: dict[str, str] = {}
        for tenant in sorted(classes):
            by_class.setdefault(classes[tenant], tenant)
        for slo_class, tenant in sorted(by_class.items()):
            try:
                sliced = self.slo.evaluate(consumer="controller",
                                           tenant=tenant)
            except Exception:
                continue
            class_burn = self._burn_from(sliced)
            if class_burn is not None:
                self.bus.publish(f"slo.burn_rate.{slo_class}", class_burn,
                                 GATEWAY_REPLICA)

    @staticmethod
    def _burn_from(report: dict[str, Any]) -> float | None:
        """Worst actionable burn rate in an evaluator report, or None
        when every objective is vacuous: no samples at all (first-window
        empty AND no lifetime fallback data), or the target sits above
        the top finite bucket (fraction-over is optimistic fiction)."""
        worst = None
        for obj in report.get("objectives", []):
            if obj.get("target_above_buckets"):
                continue
            if not obj.get("window_samples") and not obj.get("total_samples"):
                continue
            rate = obj.get("burn_rate")
            if rate is None:
                continue
            worst = rate if worst is None else max(worst, rate)
        return worst

    # ---------------------------------------------------------- knob logic

    def _tick_engine(self, engine: Any, now: float) -> list[dict[str, Any]]:
        rid = engine.config.replica_id
        state = engine.knob_state()
        out: list[dict[str, Any]] = []
        move = self._decide_superstep(rid, state, now)
        if move is not None:
            out.append(self._actuate(engine, rid, "superstep", move, now))
        move = self._decide_width_floor(rid, state, now)
        if move is not None:
            out.append(self._actuate(engine, rid, "width_floor", move, now))
        move = self._decide_spec(rid, state, now)
        if move is not None:
            out.append(self._actuate(engine, rid, "spec", move, now))
        return out

    def _cooldown_ok(self, rid: str, knob: str, now: float) -> bool:
        last = self._last_move_ts.get((rid, knob))
        return last is None or (now - last) >= self.cooldown_s

    def _reversal_margin(self, rid: str, knob: str, direction: str) -> float:
        """Multiplier a trigger must clear when the proposed move
        REVERSES the previous one (the anti-flap hysteresis): 1.0 for a
        same-direction or first move, 1 + hysteresis for a reversal."""
        prev = self._last_direction.get((rid, knob))
        if prev is not None and prev != direction:
            return 1.0 + self.hysteresis
        return 1.0

    def _decide_superstep(self, rid: str, state: dict[str, Any],
                          now: float) -> dict[str, Any] | None:
        ladder = [k for k in state.get("warmed_k", []) if k >= 1]
        if len(ladder) < 2 or not self._cooldown_ok(rid, "superstep", now):
            return None
        current = state["superstep"]
        if current not in ladder:
            return None
        idx = ladder.index(current)
        qw = self._view("llm.queue_wait_ms", rid)
        idle = self._view("llm.idle_frac", rid)
        # DOWN: admission waits too long between drain barriers
        if qw is not None and idx > 0:
            margin = self._reversal_margin(rid, "superstep", "down")
            if qw["p95"] > self.queue_wait_high_ms * margin:
                return {"direction": "down", "from": current,
                        "to": ladder[idx - 1],
                        "why": {"llm.queue_wait_ms.p95": qw["p95"],
                                "threshold": self.queue_wait_high_ms
                                * margin}}
        # UP: queue calm and the device is host-dispatch-bound
        if idle is not None and idx < len(ladder) - 1:
            calm = qw is None or qw["p95"] < self.queue_wait_low_ms
            margin = self._reversal_margin(rid, "superstep", "up")
            if calm and idle["ewma"] > self.idle_frac_high * margin:
                return {"direction": "up", "from": current,
                        "to": ladder[idx + 1],
                        "why": {"llm.idle_frac.ewma": idle["ewma"],
                                "llm.queue_wait_ms.p95":
                                    qw["p95"] if qw else None,
                                "threshold": self.idle_frac_high * margin}}
        return None

    def _decide_width_floor(self, rid: str, state: dict[str, Any],
                            now: float) -> dict[str, Any] | None:
        widths = sorted(state.get("warmed_widths", []))
        # a single warmed width means fixed-width serving (batch
        # bucketing off): there is no floor ladder to manage, and asking
        # anyway would fill the audit ring with one hold_rejected per
        # tick (a refusal deliberately does not burn the cooldown)
        if len(widths) < 2 or not self._cooldown_ok(rid, "width_floor", now):
            return None
        occ = self._view("llm.occupancy", rid)
        if occ is None:
            return None
        current = state.get("width_floor", 0)
        max_width = widths[-1]
        # the p95 of live occupancy says where bursts keep landing; a
        # floor below that just buys shrink/re-grow pool re-homes
        need = occ["p95"] * max_width
        target = 0
        if occ["p95"] >= 0.25:
            for w in widths:
                if w >= need:
                    target = w
                    break
            else:
                target = max_width
        if target == current:
            return None
        direction = "up" if target > current else "down"
        if self._reversal_margin(rid, "width_floor", direction) > 1.0 \
                and abs(target - current) <= 0:
            return None
        return {"direction": direction, "from": current, "to": target,
                "why": {"llm.occupancy.p95": occ["p95"],
                        "max_width": max_width}}

    def _decide_spec(self, rid: str, state: dict[str, Any],
                     now: float) -> dict[str, Any] | None:
        if not state.get("spec_built"):
            return None
        if not self._cooldown_ok(rid, "spec", now):
            return None
        enabled = state.get("spec_enabled", False)
        accept = self.bus.get("llm.spec_accept", rid)
        if enabled:
            if accept is None or accept["age_s"] > self.stale_after_s:
                return None  # no evidence yet — keep measuring
            margin = self._reversal_margin(rid, "spec", "off")
            if accept["ewma"] < self.spec_accept_off / margin:
                return {"direction": "off", "from": 1, "to": 0,
                        "why": {"llm.spec_accept.ewma": accept["ewma"],
                                "threshold": self.spec_accept_off / margin}}
            return None
        # off: acceptance can't be observed — re-probe once the last
        # measurement has gone stale enough
        if accept is None or accept["age_s"] >= self.reprobe_after_s \
                or accept["ewma"] >= self.spec_accept_on:
            return {"direction": "on", "from": 0, "to": 1,
                    "why": {"llm.spec_accept.age_s":
                                accept["age_s"] if accept else None,
                            "reprobe_after_s": self.reprobe_after_s}}
        return None

    def _tick_shed(self, now: float) -> list[dict[str, Any]]:
        shedder = self.shedder
        if shedder is None or not getattr(shedder, "enabled", False):
            return []
        if not self._cooldown_ok(GATEWAY_REPLICA, "shed_bar", now):
            return []
        burn = self._view("slo.burn_rate", GATEWAY_REPLICA)
        if burn is None:
            return []  # vacuous/stale burn: hold position (satellite 3)
        current = float(shedder.shed_at)
        target = current
        if burn["ewma"] > self.burn_high * self._reversal_margin(
                GATEWAY_REPLICA, "shed_bar", "down"):
            target = max(self.shed_floor, current - self.shed_step)
        elif burn["ewma"] < self.burn_low / self._reversal_margin(
                GATEWAY_REPLICA, "shed_bar", "up"):
            target = min(self._shed_ceiling, current + self.shed_step)
        if abs(target - current) < 1e-9:
            return []
        move = {"direction": "down" if target < current else "up",
                "from": round(current, 4), "to": round(target, 4),
                "why": {"slo.burn_rate.ewma": burn["ewma"],
                        "burn_high": self.burn_high,
                        "burn_low": self.burn_low}}
        row = self._record(GATEWAY_REPLICA, "shed_bar", move, now,
                           accepted=True)
        if not self.safe_mode:
            shedder.shed_at = target
        return [row]

    # ----------------------------------------------------------- actuation

    def _actuate(self, engine: Any, rid: str, knob: str,
                 move: dict[str, Any], now: float) -> dict[str, Any]:
        """Apply one engine-knob move (unless safe_mode) and record it.
        The engine validates against its warmed grid; a refusal is
        recorded as direction=hold_rejected so the audit trail shows
        the controller ASKED and the rail held."""
        accepted = True
        if not self.safe_mode:
            if knob == "superstep":
                result = engine.request_knobs(superstep=move["to"])
                accepted = result.get("superstep", False)
            elif knob == "width_floor":
                result = engine.request_knobs(width_floor=move["to"])
                accepted = result.get("width_floor", False)
            elif knob == "spec":
                result = engine.request_knobs(
                    spec_enabled=bool(move["to"]))
                accepted = result.get("spec_enabled", False)
        return self._record(rid, knob, move, now, accepted=accepted)

    def _record(self, rid: str, knob: str, move: dict[str, Any],
                now: float, accepted: bool) -> dict[str, Any]:
        self._seq += 1
        direction = move["direction"] if accepted else "hold_rejected"
        if accepted:
            self._last_move_ts[(rid, knob)] = now
            self._last_direction[(rid, knob)] = move["direction"]
        wall = time.time()
        row = {
            "schema": RING_SCHEMA,
            "seq": self._seq,
            "ts": wall,
            "replica": rid,
            "knob": knob,
            "direction": direction,
            "from": move["from"],
            "to": move["to"],
            "actuated": accepted and not self.safe_mode,
            "safe_mode": self.safe_mode,
            # the triggering evidence, verbatim — an audit row must
            # stand alone ("signal snapshot in -> knob delta out")
            "signals": dict(move.get("why") or {}),
            # filled after eval_window_s by _settle_effects
            "effect": None,
        }
        self._ring.append(row)
        watch = self._effect_watch(rid)
        self._pending_effects.append({
            "due": now + self.eval_window_s,
            "row": row,
            "before": watch,
        })
        # bound the pending list the same way the ring is bounded
        if len(self._pending_effects) > self._ring.maxlen:
            self._pending_effects = self._pending_effects[-self._ring.maxlen:]
        if self.metrics is not None:
            try:
                self.metrics.controller_decisions.labels(
                    knob=knob, direction=direction).inc()
            except Exception:
                pass
        if self.tracer is not None:
            # parentless decision span:
            # stitched into retained traces by the trace store's
            # controller window so forensics can line a latency shift up
            # against the knob move that caused it
            try:
                self.tracer.emit_span(
                    "controller.decision", wall - 0.001, wall,
                    attributes={
                        "controller.knob": knob,
                        "controller.replica": rid,
                        "controller.direction": direction,
                        "controller.from": str(move["from"]),
                        "controller.to": str(move["to"]),
                        "controller.actuated":
                            bool(accepted and not self.safe_mode),
                    })
            except Exception:
                pass
        return row

    # ------------------------------------------------------ effect capture

    _EFFECT_SIGNALS = ("llm.queue_wait_ms", "llm.ttft_ms",
                       "llm.tokens_per_dispatch", "llm.idle_frac",
                       "llm.step_tokens_per_sec")

    def _effect_watch(self, rid: str) -> dict[str, float]:
        """EWMA snapshot of the outcome signals a decision is judged by."""
        out: dict[str, float] = {}
        scope = (rid,) if rid != GATEWAY_REPLICA else \
            tuple(self.bus.replicas("llm.queue_wait_ms")) or (rid,)
        for name in self._EFFECT_SIGNALS:
            for replica in scope:
                value = self.bus.ewma(name, replica)
                if value is not None:
                    out[f"{name}@{replica}"] = round(value, 4)
        return out

    def _settle_effects(self, now: float) -> None:
        """Fill in the observed post-window effect on due decision rows
        (audit-ring contract: signal snapshot in -> knob delta out ->
        observed effect after the evaluation window)."""
        due = [p for p in self._pending_effects if p["due"] <= now]
        if not due:
            return
        self._pending_effects = [p for p in self._pending_effects
                                 if p["due"] > now]
        for pending in due:
            row = pending["row"]
            after = self._effect_watch(row["replica"])
            effect: dict[str, Any] = {}
            for key, before in pending["before"].items():
                effect[key] = {"before": before,
                               "after": after.get(key)}
            for key, value in after.items():
                if key not in effect:
                    effect[key] = {"before": None, "after": value}
            row["effect"] = effect

    # ------------------------------------------------------- admin surface

    def _refresh_knob_gauges(self) -> None:
        if self.metrics is None:
            return
        try:
            for engine in self.engines_fn() or []:
                rid = engine.config.replica_id
                state = engine.knob_state()
                self.metrics.controller_knob.labels(
                    knob="superstep", replica=rid).set(state["superstep"])
                self.metrics.controller_knob.labels(
                    knob="width_floor", replica=rid).set(
                    state["width_floor"])
                self.metrics.controller_knob.labels(
                    knob="spec", replica=rid).set(
                    1.0 if state["spec_enabled"] else 0.0)
            if self.shedder is not None:
                self.metrics.controller_knob.labels(
                    knob="shed_bar", replica=GATEWAY_REPLICA).set(
                    float(self.shedder.shed_at))
        except Exception:
            pass

    def decisions(self, limit: int = 64) -> list[dict[str, Any]]:
        """Newest-first audit rows (the /admin/controller ring)."""
        rows = list(self._ring)
        rows.reverse()
        return rows[:max(1, limit)]

    def snapshot(self, limit: int = 64) -> dict[str, Any]:
        """Full admin view: posture, ladders, ring, live signal table."""
        knobs: dict[str, Any] = {}
        for engine in self.engines_fn() or []:
            try:
                knobs[engine.config.replica_id] = engine.knob_state()
            except Exception:
                continue
        return {
            "enabled": self.enabled,
            "safe_mode": self.safe_mode,
            "tick_s": self.tick_s,
            "cooldown_s": self.cooldown_s,
            "eval_window_s": self.eval_window_s,
            "hysteresis": self.hysteresis,
            "ticks": self._ticks,
            "shed_bar": (float(self.shedder.shed_at)
                         if self.shedder is not None else None),
            "shed_ceiling": self._shed_ceiling,
            "shed_floor": self.shed_floor,
            "knobs": knobs,
            "decisions": self.decisions(limit),
            "signals": self.bus.snapshot(),
            "bus": self.bus.stats(),
        }
