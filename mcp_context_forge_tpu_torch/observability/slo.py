"""Serving SLO evaluation over the token-level histograms (a copy of the
JAX package's ``observability/slo.py``; stdlib only).

Turns the TTFT, TPOT, queue-wait and HTTP histograms into objective
verdicts at ``GET /admin/slo``: for each objective, the estimated
percentile (since boot and over the window since the consumer's previous
evaluation), the fraction of window samples over target, and a burn rate
against the error budget (fraction over target / budget: 1.0 consumes the
budget exactly as provisioned, above 1 burns it down).

The evaluator is pull-based: it reads the histograms the engine writes
(``collect()``; nothing runs on the dispatch thread) and keeps one snapshot
per consumer and objective, so consecutive calls see window deltas.
Percentiles interpolate linearly across bucket bounds (the
``histogram_quantile`` estimate, good to a bucket width). The serving
controller evaluates under its own consumer and publishes the burn as
``slo.burn_rate``.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class SloObjective:
    """One latency objective: metric_attr names a Histogram attribute on
    PrometheusRegistry; target_ms bounds the given percentile."""

    name: str
    metric_attr: str
    percentile: float
    target_ms: float


@dataclass(frozen=True)
class SloClass:
    """A named bundle of latency targets assignable per tenant
    (``slo_class_<name>_{ttft,tpot,http}_p95_ms`` in docs/config terms).
    ``/admin/slo?tenant=<t>`` evaluates the tenant's assigned class
    against that tenant's metric label slice."""

    name: str
    ttft_p95_ms: float
    tpot_p95_ms: float
    http_p95_ms: float

    def objectives(self) -> list[SloObjective]:
        return [
            SloObjective("ttft_p95", "llm_ttft", 0.95, self.ttft_p95_ms),
            SloObjective("tpot_p95", "llm_tpot", 0.95, self.tpot_p95_ms),
            SloObjective("http_p95", "http_duration", 0.95,
                         self.http_p95_ms),
        ]


def default_objectives(settings: Any) -> list[SloObjective]:
    return [
        SloObjective("ttft_p95", "llm_ttft", 0.95,
                     float(settings.slo_ttft_p95_ms)),
        SloObjective("tpot_p95", "llm_tpot", 0.95,
                     float(settings.slo_tpot_p95_ms)),
        SloObjective("queue_wait_p95", "llm_queue_wait", 0.95,
                     float(settings.slo_queue_wait_p95_ms)),
        # gateway-side: end-to-end HTTP latency across routes — the
        # objective the scenario load harness asserts per phase window
        # (summed over method/path children like every other objective)
        SloObjective("http_p95", "http_duration", 0.95,
                     float(getattr(settings, "slo_http_p95_ms", 1000.0))),
    ]


def parse_slo_classes(settings: Any) -> dict[str, SloClass]:
    """SLO-class bundles from settings: the ``default`` class comes from
    the flat ``slo_*_p95_ms`` targets; ``slo_classes`` (JSON object:
    ``{"premium": {"ttft_p95_ms": 500, ...}}``) adds named bundles whose
    unset fields inherit the defaults. Malformed JSON fails fast at app
    build — a silently-dropped SLO class is a false all-clear."""
    import json

    default = SloClass(
        "default",
        ttft_p95_ms=float(settings.slo_ttft_p95_ms),
        tpot_p95_ms=float(settings.slo_tpot_p95_ms),
        http_p95_ms=float(getattr(settings, "slo_http_p95_ms", 1000.0)))
    classes = {"default": default}
    raw = getattr(settings, "slo_classes", "") or ""
    if raw:
        try:
            parsed = json.loads(raw)
            if not isinstance(parsed, dict):
                raise ValueError("must be a JSON object")
            for name, targets in parsed.items():
                if not isinstance(targets, dict):
                    raise ValueError(f"class {name!r} must map to an object")
                classes[name] = SloClass(
                    name,
                    ttft_p95_ms=float(targets.get("ttft_p95_ms",
                                                  default.ttft_p95_ms)),
                    tpot_p95_ms=float(targets.get("tpot_p95_ms",
                                                  default.tpot_p95_ms)),
                    http_p95_ms=float(targets.get("http_p95_ms",
                                                  default.http_p95_ms)))
        except (json.JSONDecodeError, TypeError, ValueError) as exc:
            raise ValueError(f"invalid slo_classes setting: {exc}") from exc
    return classes


def parse_tenant_classes(settings: Any) -> dict[str, str]:
    """``slo_tenant_classes`` JSON object: tenant id → class name."""
    import json

    raw = getattr(settings, "slo_tenant_classes", "") or ""
    if not raw:
        return {}
    try:
        parsed = json.loads(raw)
        if not isinstance(parsed, dict):
            raise ValueError("must be a JSON object")
        return {str(k): str(v) for k, v in parsed.items()}
    except (json.JSONDecodeError, TypeError, ValueError) as exc:
        raise ValueError(
            f"invalid slo_tenant_classes setting: {exc}") from exc


def _histogram_state(metric: Any, match: dict[str, str] | None = None
                     ) -> tuple[dict[float, float], float]:
    """(cumulative bucket counts summed across label children, total
    count) for a prometheus_client Histogram. ``match`` restricts the
    sum to children whose labels carry every given key=value — the
    tenant-sliced evaluation path."""
    buckets: dict[float, float] = {}
    count = 0.0
    for family in metric.collect():
        for sample in family.samples:
            if match and any(sample.labels.get(k) != v
                             for k, v in match.items()):
                continue
            if sample.name.endswith("_bucket"):
                le_raw = sample.labels.get("le", "+Inf")
                le = math.inf if le_raw == "+Inf" else float(le_raw)
                buckets[le] = buckets.get(le, 0.0) + sample.value
            elif sample.name.endswith("_count"):
                count += sample.value
    return buckets, count


def _delta(cur: dict[float, float], count: float,
           prev: tuple[dict[float, float], float] | None
           ) -> tuple[dict[float, float], float]:
    if prev is None:
        return dict(cur), count
    prev_buckets, prev_count = prev
    window = {le: max(0.0, c - prev_buckets.get(le, 0.0))
              for le, c in cur.items()}
    return window, max(0.0, count - prev_count)


def _percentile_s(buckets: dict[float, float], count: float,
                  q: float) -> float | None:
    """Interpolated q-quantile in seconds; None when the histogram is
    empty. Clamps to the last finite bucket bound when the quantile lands
    in the +Inf bucket (the honest 'at least this' estimate)."""
    if count <= 0.0 or not buckets:
        return None
    target = q * count
    prev_le = 0.0
    prev_cum = 0.0
    last_finite = 0.0
    for le in sorted(buckets):
        cum = buckets[le]
        if le != math.inf:
            last_finite = le
        if cum >= target:
            if le == math.inf:
                return last_finite if last_finite > 0.0 else None
            span = cum - prev_cum
            frac = (target - prev_cum) / span if span > 0.0 else 1.0
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return last_finite if last_finite > 0.0 else None


def _fraction_over(buckets: dict[float, float], count: float,
                   threshold_s: float) -> float:
    """Fraction of observations PROVABLY above threshold_s, interpolating
    within the bucket the threshold falls into. When the threshold sits
    beyond the last finite bucket bound, the +Inf-bucket mass is
    indeterminate (somewhere between the bound and the threshold — the
    histogram cannot tell which side) and must NOT read as a breach: a
    target above the bucket range would otherwise report a permanent
    false 'burning'. Callers surface that case via
    :func:`_target_above_buckets` instead."""
    if count <= 0.0 or not buckets:
        return 0.0
    prev_le = 0.0
    prev_cum = 0.0
    at_threshold = None
    for le in sorted(buckets):
        cum = buckets[le]
        if le >= threshold_s:
            if le == math.inf:
                # threshold > every finite bound: +Inf mass is
                # indeterminate, count nothing as provably over
                at_threshold = cum
            else:
                span = cum - prev_cum
                width = le - prev_le
                frac = (threshold_s - prev_le) / width if width > 0.0 else 1.0
                at_threshold = prev_cum + span * min(1.0, max(0.0, frac))
            break
        prev_le, prev_cum = le, cum
    if at_threshold is None:
        at_threshold = prev_cum
    return max(0.0, min(1.0, (count - at_threshold) / count))


def _target_above_buckets(buckets: dict[float, float],
                          threshold_s: float) -> bool:
    """True when the objective's target exceeds the histogram's top
    finite bucket bound — breaches between the bound and the target are
    unmeasurable, so the verdict is optimistic until the buckets are
    widened (surfaced per objective so operators see it)."""
    finite = [le for le in buckets if le != math.inf]
    return bool(finite) and threshold_s > max(finite)


class SloEvaluator:
    """Stateful evaluator over one PrometheusRegistry. Call pattern is
    pull (the /admin/slo handler); window percentiles/burn rates cover
    the interval since the previous call BY THE SAME CONSUMER: windows
    are keyed by a caller-supplied name, so the admin UI's 5 s poll
    cannot shred the load harness's phase-length deltas (each consumer's
    snapshot advances only on its own calls).

    **Tenant-sliced evaluation**: ``evaluate(tenant=...)`` resolves the
    tenant's assigned :class:`SloClass` (``slo_tenant_classes`` →
    ``slo_classes``, else ``default``) and evaluates its target bundle
    against only the metric label children carrying that tenant's
    (clamped) label. Tenant windows are isolated per (consumer, tenant)
    — polling tenant A never shreds tenant B's deltas.

    **Window freshness**: a consumer's FIRST sight of an objective (a
    genuinely new consumer, or one that staled out of the bounded table
    and re-appeared) records a snapshot and reports an EMPTY window —
    never the whole metric lifetime dressed up as a window. A re-
    appearing tenant window must start fresh, not inherit the stale
    implicit from-boot baseline (burn rate falls back to lifetime data,
    labeled as such by window_samples == 0)."""

    MAX_CONSUMERS = 16  # /admin/slo is auth-gated, but still bound it

    def __init__(self, metrics: Any, objectives: list[SloObjective],
                 error_budget: float = 0.05,
                 slo_classes: dict[str, SloClass] | None = None,
                 tenant_classes: dict[str, str] | None = None,
                 tenant_label: Any = None) -> None:
        self.metrics = metrics
        self.objectives = objectives
        self.error_budget = max(1e-6, float(error_budget))
        # named target bundles + tenant → class assignment (per-tenant
        # evaluation path); tenant_label maps a tenant id to its clamped
        # metric label WITHOUT consuming a clamp admission slot
        self.slo_classes = slo_classes or {}
        self.tenant_classes = tenant_classes or {}
        self.tenant_label = tenant_label or (lambda t: t)
        # consumer -> objective -> (buckets, count); consumer -> last ts
        self._prev: dict[str, dict[str, tuple[dict[float, float], float]]] = {}
        self._prev_ts: dict[str, float] = {}

    def class_for(self, tenant: str) -> SloClass:
        name = self.tenant_classes.get(tenant, "default")
        cls = self.slo_classes.get(name)
        if cls is None:
            cls = self.slo_classes.get("default")
        if cls is None:  # evaluator built without classes: derive one
            targets = {o.name: o.target_ms for o in self.objectives}
            cls = SloClass("default",
                           ttft_p95_ms=targets.get("ttft_p95", 2500.0),
                           tpot_p95_ms=targets.get("tpot_p95", 250.0),
                           http_p95_ms=targets.get("http_p95", 1000.0))
        return cls

    def evaluate(self, consumer: str = "default",
                 tenant: str | None = None) -> dict[str, Any]:
        now = time.time()
        slo_class = None
        match = None
        objectives = self.objectives
        key = consumer
        if tenant is not None:
            slo_class = self.class_for(tenant)
            label = self.tenant_label(tenant)
            match = {"tenant": label}
            objectives = slo_class.objectives()
            # per-(consumer, tenant) window isolation; \x1f cannot occur
            # in either part (consumer is query-string-trimmed)
            key = f"{consumer}\x1ftenant={label}"
        if key not in self._prev and len(
                self._prev) >= self.MAX_CONSUMERS:
            # evict the staled-out consumer rather than grow unbounded
            oldest = min(self._prev_ts, key=self._prev_ts.get)
            self._prev.pop(oldest, None)
            self._prev_ts.pop(oldest, None)
        prev = self._prev.setdefault(key, {})
        prev_ts = self._prev_ts.get(key)
        window_s = (now - prev_ts) if prev_ts is not None else None
        results: list[dict[str, Any]] = []
        overall_ok = True
        for obj in objectives:
            metric = getattr(self.metrics, obj.metric_attr, None)
            if metric is None:
                continue
            buckets, count = _histogram_state(metric, match)
            prior = prev.get(obj.name)
            if prior is None:
                # first sight (fresh consumer OR post-eviction return):
                # snapshot now, report an EMPTY window — the from-boot
                # totals are not this window's data
                win_buckets: dict[float, float] = {}
                win_count = 0.0
            else:
                win_buckets, win_count = _delta(buckets, count, prior)
            prev[obj.name] = (buckets, count)
            threshold_s = obj.target_ms / 1e3
            cum_p = _percentile_s(buckets, count, obj.percentile)
            win_p = _percentile_s(win_buckets, win_count, obj.percentile)
            # burn rate over the freshest data available: the window when
            # it has samples, else lifetime (first call / idle gateway)
            frac_buckets, frac_count = ((win_buckets, win_count)
                                        if win_count > 0 else (buckets, count))
            over = _fraction_over(frac_buckets, frac_count, threshold_s)
            burn_rate = over / self.error_budget
            ok = burn_rate <= 1.0
            overall_ok = overall_ok and ok
            results.append({
                # target beyond the top finite bucket: the fraction-over
                # is optimistic (unmeasurable band) — widen the buckets
                "target_above_buckets": _target_above_buckets(buckets,
                                                              threshold_s),
                "name": obj.name,
                "metric": obj.metric_attr,
                "percentile": obj.percentile,
                "target_ms": obj.target_ms,
                "cumulative_p_ms": (round(cum_p * 1e3, 3)
                                    if cum_p is not None else None),
                "window_p_ms": (round(win_p * 1e3, 3)
                                if win_p is not None else None),
                "window_samples": win_count,
                "total_samples": count,
                "fraction_over_target": round(over, 5),
                "burn_rate": round(burn_rate, 4),
                "ok": ok,
            })
        self._prev_ts[key] = now
        report = {
            "ok": overall_ok,
            "error_budget": self.error_budget,
            "consumer": consumer,
            "window_s": round(window_s, 3) if window_s is not None else None,
            "evaluated_at": now,
            "objectives": results,
        }
        if tenant is not None:
            report["tenant"] = tenant
            report["tenant_label"] = match["tenant"]
            # a clamped tenant's slice is the shared "other" bucket —
            # verdicts cover the overflow POOL, not this tenant alone
            report["tenant_clamped"] = match["tenant"] != tenant
            report["slo_class"] = slo_class.name
        return report
