"""Request forensics: histogram exemplars, a tail-sampled trace store and
the cross-layer waterfall (a copy of the JAX package's
``observability/trace_store.py`` over the port's ``tracing.Span``; stdlib
only).

- ``ExemplarLedger``: per-(metric, labels, bucket) trace-id exemplars of
  the TTFT, TPOT, queue-wait and HTTP histograms, which the registry's
  OpenMetrics render prints on bucket lines. It PINS their trace ids, so
  that the store keeps every trace a rendered exemplar points at.
- ``TraceStore``: a bounded store fed as a tracer sink. Retention is
  decided when a trace's root span finishes, with the whole trace in
  hand: every error trace, every SLO-breaching trace, the slowest N per
  route and per tenant, every exemplar-pinned trace, and a deterministic
  1-in-M sample of the rest; the others are dropped.
- ``span_dict`` and ``stitch_waterfall``: the JSON of one trace for
  ``GET /admin/trace/{trace_id}``: the span tree with containment and
  sum-of-children invariants, the engine step-ring rows each decode span
  overlapped, and the flight recorder's phase vector when there is one.

``sink`` and ``note`` run on whichever thread finished the span (the event
loop, an engine's dispatch thread, the tier spill worker); one lock
serializes the store. Reads copy under the lock and serialize outside it.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import OrderedDict
from typing import Any, Iterable

from .tracing import Span

# ---------------------------------------------------------------------------
# The stitch table: every span name the waterfall knows how to place, and
# the serving layer it belongs to (anything else is layer "other").
# ---------------------------------------------------------------------------

STITCH_SPANS = {
    # gateway data plane
    "http.request": "gateway",
    # provider / request lifecycle
    "llm.request": "provider",
    "llmchat.turn": "services",
    "llm.provider.rewire": "services",
    "tool.invoke": "services",
    "a2a.invoke": "services",
    # engine phases (emitted off-thread via Tracer.emit_span)
    "llm.queue": "engine",
    "llm.prefill": "engine",
    "llm.decode": "engine",
    "llm.xla_compile": "engine",
    # tiered prefix/KV cache IO (spill on evict, restore on match)
    "tier.spill": "kv_tier",
    "tier.restore": "kv_tier",
    # pool failover: the requeue hop joining a killed replica's spans to
    # the successor's in one trace
    "pool.requeue": "pool",
    # disaggregated serving: the prefill->decode KV-page migration hop
    # (docs/disaggregation.md) joining the prefill leg's spans to the
    # decode continuation's in one trace
    "pool.migrate": "pool",
    # serving-controller knob decisions (tpu_local/controller.py):
    # parentless like llm.xla_compile, so a latency shift in a retained
    # trace lines up against the knob move that caused it
    "controller.decision": "controller",
}

# Names that FINALIZE a trace when they finish: the retention decision
# runs with the whole request in hand. (llm.request only roots a trace
# when the engine is driven without a gateway in front — tests, bench.)
ROOT_SPANS = ("http.request", "llm.request")


# ---------------------------------------------------------------------------
# exemplars
# ---------------------------------------------------------------------------

class ExemplarLedger:
    """Per-(metric, labels, bucket) trace-id exemplars.

    ``note()`` is called at the histogram observe site with the value and
    the observing request's trace id; it returns the OpenMetrics exemplar
    dict to pass to ``Histogram.observe(value, exemplar=...)`` and
    records the trace id as the CURRENT exemplar of the bucket the value
    lands in. The trace store consults :meth:`pinned` so every live
    exemplar's trace survives retention — the dashboard click-through
    contract. A bucket's previous exemplar unpins when replaced (its
    trace becomes evictable like any other).

    Bounded: at most ``max_entries`` (metric, labels, bucket) cells,
    FIFO-evicted; the pin set is exactly the live cells' trace ids.
    """

    def __init__(self, max_entries: int = 2048, enabled: bool = True) -> None:
        self.enabled = enabled
        self.max_entries = max(16, int(max_entries))
        self._lock = threading.Lock()
        self._buckets: dict[str, list[float]] = {}   # metric -> sorted les
        # (metric, labels, le) -> trace_id, insertion-ordered for FIFO
        self._cells: OrderedDict[tuple, str] = OrderedDict()
        self._pins: dict[str, int] = {}              # trace_id -> cell count
        self.noted = 0

    def register(self, metric: str, buckets: Iterable[float]) -> None:
        """Declare a histogram's bucket bounds so ``note`` can place
        values without re-deriving prometheus internals."""
        self._buckets[metric] = sorted(float(b) for b in buckets)

    def note(self, metric: str, value: float, trace_id: str | None,
             labels: tuple = ()) -> dict[str, str] | None:
        """Record ``trace_id`` as the current exemplar for the bucket
        ``value`` lands in; returns the exemplar dict for the
        ``observe()`` call (None when disabled / unattributed)."""
        if not self.enabled or not trace_id:
            return None
        les = self._buckets.get(metric)
        if les is None:
            return None
        idx = bisect.bisect_left(les, value)
        le = les[idx] if idx < len(les) else float("inf")
        key = (metric, tuple(labels), le)
        with self._lock:
            old = self._cells.pop(key, None)
            if old is not None:
                self._unpin_locked(old)
            self._cells[key] = trace_id
            self._pins[trace_id] = self._pins.get(trace_id, 0) + 1
            while len(self._cells) > self.max_entries:
                _, evicted = self._cells.popitem(last=False)
                self._unpin_locked(evicted)
            self.noted += 1
        return {"trace_id": trace_id}

    def _unpin_locked(self, trace_id: str) -> None:
        count = self._pins.get(trace_id, 0) - 1
        if count <= 0:
            self._pins.pop(trace_id, None)
        else:
            self._pins[trace_id] = count

    def pinned(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._pins

    def trace_ids(self) -> set[str]:
        with self._lock:
            return set(self._pins)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"enabled": self.enabled, "cells": len(self._cells),
                    "pinned_traces": len(self._pins), "noted": self.noted,
                    "metrics": sorted(self._buckets)}


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class _TraceEntry:
    __slots__ = ("trace_id", "spans", "first_ts", "last_ts", "reasons",
                 "route", "tenant", "duration_ms", "status", "root_name",
                 "breaches", "truncated")

    def __init__(self, trace_id: str) -> None:
        self.trace_id = trace_id
        self.spans: list[Span] = []
        self.first_ts = time.time()
        self.last_ts = self.first_ts
        self.reasons: set[str] = set()
        self.route = ""
        self.tenant = ""
        self.duration_ms: float | None = None
        self.status = "OK"
        self.root_name = ""
        self.breaches: list[str] = []
        self.truncated = False


class TraceStore:
    """Bounded tail-retention trace store (module docstring)."""

    def __init__(self, *, max_traces: int = 512,
                 max_spans_per_trace: int = 256,
                 sample_every: int = 32,
                 slowest_per_key: int = 4,
                 max_keys: int = 64,
                 idle_finalize_s: float = 60.0,
                 slo_targets: dict[str, float] | None = None,
                 exemplars: ExemplarLedger | None = None) -> None:
        self.max_traces = max(1, int(max_traces))
        self.max_spans = max(8, int(max_spans_per_trace))
        self.sample_every = max(0, int(sample_every))
        self.slowest_per_key = max(1, int(slowest_per_key))
        self.max_keys = max(1, int(max_keys))
        self.idle_finalize_s = max(0.0, float(idle_finalize_s))
        # seconds per objective: http (root wall), ttft (queue start ->
        # first token), tpot (decode wall / token), queue_wait
        self.slo_targets = dict(slo_targets or {})
        self.exemplars = exemplars
        self._lock = threading.Lock()
        self._open: OrderedDict[str, _TraceEntry] = OrderedDict()
        self._retained: OrderedDict[str, _TraceEntry] = OrderedDict()
        # key -> [(duration_ms, trace_id)] ascending, len <= slowest_per_key
        self._slowest_route: OrderedDict[str, list] = OrderedDict()
        self._slowest_tenant: OrderedDict[str, list] = OrderedDict()
        self.finalized = 0
        self.refinalized = 0
        self.dropped = 0
        self.evicted = 0
        self.exemplar_released = 0
        self.span_overflow = 0

    # ------------------------------------------------------------------ sink

    def sink(self, span: Span) -> None:
        """Tracer on-finish callback (any thread)."""
        with self._lock:
            entry = self._retained.get(span.trace_id) \
                or self._open.get(span.trace_id)
            if entry is None:
                entry = _TraceEntry(span.trace_id)
                self._open[span.trace_id] = entry
                # bound the open table: a flood of rootless traces must
                # not grow it — classify-or-drop the oldest
                while len(self._open) > self.max_traces:
                    _, stale = self._open.popitem(last=False)
                    self._finalize_locked(stale)
            if len(entry.spans) >= self.max_spans \
                    and span.name not in ROOT_SPANS:
                # root-named spans bypass the cap: the root finishes
                # LAST, so a trace that overflowed on children (e.g.
                # hundreds of tier.restore spans for a long prefix)
                # would otherwise store everything EXCEPT the one span
                # the waterfall re-roots on — bounded, a request has
                # exactly one root
                entry.truncated = True
                self.span_overflow += 1
            else:
                entry.spans.append(span)
            entry.last_ts = time.time()
            # finalize only on the LOCAL root: http.request always is
            # (even on a federation hop with an inbound traceparent),
            # and any parentless span is. A NESTED llm.request (a chat
            # agent turn makes several per http.request) has a parent
            # and must NOT finalize the trace early — the retention
            # decision needs the whole request.
            is_root = (span.name == "http.request"
                       or span.parent_span_id is None)
            if is_root and span.trace_id in self._open:
                self._open.pop(span.trace_id, None)
                self._finalize_locked(entry, root=span)
            elif is_root and span.trace_id in self._retained:
                # the trace was idle-finalized while its (slow!) request
                # was still in flight — the root arriving late means the
                # early decision ran on a partial trace. RE-finalize
                # over the full span list so duration/route/breaches/
                # slowest rankings reflect the whole request instead of
                # a stale prefix (exactly the slow traces this store
                # exists to capture).
                self._retained.pop(span.trace_id, None)
                self._forget_slowest_locked(entry)
                entry.reasons.clear()
                self.refinalized += 1
                self._finalize_locked(entry, root=span)
            else:
                self._finalize_stale_locked()

    def _finalize_stale_locked(self) -> None:
        """Traces that never see a root span (engine driven directly,
        client vanished between spans) finalize on idle instead of
        leaking in the open table forever."""
        if not self._open or self.idle_finalize_s <= 0:
            return
        now = time.time()
        oldest_id = next(iter(self._open))
        oldest = self._open[oldest_id]
        if now - oldest.last_ts > self.idle_finalize_s:
            self._open.pop(oldest_id, None)
            self._finalize_locked(oldest)

    # ------------------------------------------------------------- retention

    def _reap_unpinned_locked(self) -> None:
        """Release entries retained ONLY as live histogram exemplars
        once their bucket cell has been replaced. A request's own
        observes run microseconds before its root span finishes, so at
        finalize time nearly every trace IS its bucket's current
        exemplar — without this sweep the 'exemplar' reason would
        retain everything and tail sampling would degenerate into
        retain-all-then-budget-evict. The click-through contract is
        untouched: a trace still rendered on /metrics stays pinned and
        is never swept."""
        if self.exemplars is None:
            return
        pinned = self.exemplars.trace_ids()
        stale = [tid for tid, e in self._retained.items()
                 if e.reasons == {"exemplar"} and tid not in pinned]
        for tid in stale:
            self._retained.pop(tid, None)
            self.exemplar_released += 1

    def _finalize_locked(self, entry: _TraceEntry,
                         root: Span | None = None) -> None:
        self.finalized += 1
        self._reap_unpinned_locked()
        if root is None:
            root = self._pick_root(entry.spans)
        if root is not None:
            entry.root_name = root.name
            entry.duration_ms = root.duration_ms
            # slowest-per-route keys on the ROUTE TEMPLATE (http.route,
            # stamped by the middleware: resource.canonical, or
            # "unmatched" for 404 scans), never the raw client path —
            # per-path keys would make every scanned URL the trivial
            # "slowest" of its own one-member route and squat the budget
            entry.route = str(root.attributes.get("http.route", "")
                              or root.attributes.get("http.path", "")
                              or root.name)
        entry.status = ("ERROR" if any(s.status == "ERROR"
                                       for s in entry.spans) else "OK")
        for span in entry.spans:
            tenant = span.attributes.get("llm.tenant") \
                or span.attributes.get("gw.tenant")
            if tenant and tenant != "anonymous":
                entry.tenant = str(tenant)
                break
        entry.breaches = self._slo_breaches(entry)
        reasons = entry.reasons
        if entry.status == "ERROR":
            reasons.add("error")
        if entry.breaches:
            reasons.add("slo_breach")
        if self.exemplars is not None \
                and self.exemplars.pinned(entry.trace_id):
            reasons.add("exemplar")
        if entry.duration_ms is not None:
            if self._admit_slowest(self._slowest_route, entry.route, entry):
                reasons.add("slowest_route")
            if entry.tenant and self._admit_slowest(
                    self._slowest_tenant, entry.tenant, entry):
                reasons.add("slowest_tenant")
        if entry.root_name == "controller.decision":
            # serving-controller knob moves are rare, bounded by the
            # controller's own cooldown, and exactly what a forensics
            # session wants next to a latency shift — retain them
            # (UNPROTECTED: the budget eviction below still bounds the
            # store if a misconfigured controller ever floods)
            reasons.add("controller")
        if (not reasons or reasons == {"exemplar"}) \
                and self.sample_every > 0:
            # deterministic 1-in-M: the same trace id always makes the
            # same call, so a re-run reproduces the retained set. Also
            # evaluated for exemplar-only traces: the pin is transient
            # (replaced on the bucket's next observe) and a trace the
            # sample would keep must survive its unpin reap
            try:
                bucket = int(entry.trace_id[:8], 16)
            except ValueError:
                bucket = 1
            if bucket % self.sample_every == 0:
                reasons.add("sampled")
        if not reasons:
            self.dropped += 1
            return
        self._retained[entry.trace_id] = entry
        self._enforce_budget_locked()

    @staticmethod
    def _pick_root(spans: list[Span]) -> Span | None:
        for name in ROOT_SPANS:
            for span in spans:
                if span.name == name:
                    return span
        for span in spans:
            if span.parent_span_id is None:
                return span
        return spans[0] if spans else None

    def _slo_breaches(self, entry: _TraceEntry) -> list[str]:
        targets = self.slo_targets
        if not targets:
            return []
        breaches: list[str] = []
        by_name: dict[str, Span] = {}
        for span in entry.spans:
            by_name.setdefault(span.name, span)
        http = targets.get("http")
        if http and entry.duration_ms is not None \
                and entry.root_name in ROOT_SPANS \
                and entry.duration_ms / 1e3 > http:
            # request roots only: a parentless utility span (e.g. a
            # multi-second llm.xla_compile) finalizes as its own
            # single-span trace, and its wall is not an http latency —
            # a compile storm must not fill the store with protected
            # "http breach" traces (the slowest-N table still keeps
            # the slowest compiles under their own route key)
            breaches.append("http")
        queue = by_name.get("llm.queue")
        qw = targets.get("queue_wait")
        if queue is not None and qw and (queue.duration_ms or 0) / 1e3 > qw:
            breaches.append("queue_wait")
        prefill = by_name.get("llm.prefill")
        ttft = targets.get("ttft")
        if prefill is not None and prefill.end_ts is not None and ttft:
            # TTFT = submit -> first token: queue start (when present)
            # through prefill end
            start = queue.start_ts if queue is not None else prefill.start_ts
            if prefill.end_ts - start > ttft:
                breaches.append("ttft")
        decode = by_name.get("llm.decode")
        tpot = targets.get("tpot")
        if decode is not None and tpot:
            tokens = decode.attributes.get("gen_ai.usage.completion_tokens")
            if isinstance(tokens, int) and tokens > 1 \
                    and (decode.duration_ms or 0) / 1e3 / tokens > tpot:
                breaches.append("tpot")
        return breaches

    def _admit_slowest(self, table: OrderedDict, key: str,
                       entry: _TraceEntry) -> bool:
        """Top-N-by-duration per key. Returns True when the entry joins
        the table; a displaced trace loses its slowest_* claim (and is
        re-examined for eviction)."""
        if key not in table and len(table) >= self.max_keys:
            # bounded key space: forget the least-recently-touched key —
            # and STRIP its members' slowest_* claim (a reason backed by
            # no table would protect the entry from eviction forever);
            # members survive only on their other reasons
            reason = ("slowest_route" if table is self._slowest_route
                      else "slowest_tenant")
            _, evicted_ranking = table.popitem(last=False)
            for _, orphan_id in evicted_ranking:
                orphan = self._retained.get(orphan_id)
                if orphan is None:
                    continue
                orphan.reasons.discard(reason)
                if not orphan.reasons:
                    self._retained.pop(orphan_id, None)
                    self.evicted += 1
        ranking = table.setdefault(key, [])
        table.move_to_end(key)
        item = (entry.duration_ms, entry.trace_id)
        if len(ranking) < self.slowest_per_key:
            bisect.insort(ranking, item)
            return True
        if item[0] <= ranking[0][0]:
            return False
        displaced = ranking[0][1]
        del ranking[0]
        bisect.insort(ranking, item)
        loser = self._retained.get(displaced)
        if loser is not None:
            loser.reasons.discard(
                "slowest_route" if table is self._slowest_route
                else "slowest_tenant")
            if not loser.reasons:
                self._retained.pop(displaced, None)
                self.evicted += 1
        return True

    def _protected_locked(self, entry: _TraceEntry) -> bool:
        if entry.reasons & {"error", "slo_breach", "slowest_route",
                            "slowest_tenant"}:
            return True
        return self.exemplars is not None \
            and self.exemplars.pinned(entry.trace_id)

    def _enforce_budget_locked(self) -> None:
        while len(self._retained) > self.max_traces:
            victim_id = None
            for tid, entry in self._retained.items():  # oldest first
                if not self._protected_locked(entry):
                    victim_id = tid
                    break
            if victim_id is None:
                # every entry is protected: the budget still wins — but
                # prefer a victim that is NOT a live /metrics exemplar
                # (evicting one would dangle the rendered click-through;
                # error/breach/slowest claims have no external pointer).
                # Only when every retained trace is itself a live
                # exemplar does the oldest go regardless: a bounded
                # store is the contract.
                pinned = (self.exemplars.trace_ids()
                          if self.exemplars is not None else set())
                victim_id = next(
                    (tid for tid in self._retained if tid not in pinned),
                    next(iter(self._retained)))
            victim = self._retained.pop(victim_id)
            self._forget_slowest_locked(victim)
            self.evicted += 1

    def _forget_slowest_locked(self, entry: _TraceEntry) -> None:
        for table in (self._slowest_route, self._slowest_tenant):
            for ranking in table.values():
                for i, (_, tid) in enumerate(ranking):
                    if tid == entry.trace_id:
                        del ranking[i]
                        break

    # ------------------------------------------------------------------ read

    def get(self, trace_id: str) -> dict[str, Any] | None:
        """One trace's spans + retention metadata (retained traces and
        still-open ones — a scenario probing its slowest request must
        not race the root span's sink by a scheduler tick)."""
        with self._lock:
            entry = self._retained.get(trace_id) or self._open.get(trace_id)
            if entry is None:
                return None
            spans = list(entry.spans)
            summary = self._summary_locked(entry)
        summary["spans"] = [span_dict(s) for s in spans]
        return summary

    def _summary_locked(self, entry: _TraceEntry) -> dict[str, Any]:
        return {
            "trace_id": entry.trace_id,
            "root": entry.root_name,
            "route": entry.route,
            "tenant": entry.tenant or None,
            "status": entry.status,
            "duration_ms": entry.duration_ms,
            "span_count": len(entry.spans),
            "reasons": sorted(entry.reasons),
            "breaches": entry.breaches,
            "truncated": entry.truncated,
            "ts": entry.first_ts,
        }

    def snapshot(self, limit: int = 64) -> dict[str, Any]:
        """Retention stats + newest-first retained trace summaries (the
        admin-UI list, the support bundle's traces.json)."""
        limit = max(1, int(limit))
        with self._lock:
            entries = list(self._retained.values())
            out = {
                "retained": len(self._retained),
                "open": len(self._open),
                "finalized": self.finalized,
                "refinalized": self.refinalized,
                "dropped": self.dropped,
                "evicted": self.evicted,
                "exemplar_released": self.exemplar_released,
                "span_overflow": self.span_overflow,
                "max_traces": self.max_traces,
                "sample_every": self.sample_every,
                "slowest_per_key": self.slowest_per_key,
                "slo_targets_ms": {k: round(v * 1e3, 1)
                                   for k, v in self.slo_targets.items()},
                "traces": [self._summary_locked(e)
                           for e in reversed(entries[-limit:])],
            }
        if self.exemplars is not None:
            out["exemplars"] = self.exemplars.stats()
        return out

    def export(self, limit: int = 8) -> list[dict[str, Any]]:
        """Full span dumps of the newest retained traces (support
        bundle: summaries alone cannot be stitched offline)."""
        with self._lock:
            entries = list(self._retained.values())[-max(1, int(limit)):]
            picked = [(self._summary_locked(e), list(e.spans))
                      for e in reversed(entries)]
        return [{**summary, "spans": [span_dict(s) for s in spans]}
                for summary, spans in picked]


# ---------------------------------------------------------------------------
# waterfall stitching
# ---------------------------------------------------------------------------

def span_dict(span: Span) -> dict[str, Any]:
    return {
        "name": span.name,
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "parent_span_id": span.parent_span_id,
        "start_ts": span.start_ts,
        "end_ts": span.end_ts,
        "duration_ms": (round(span.duration_ms, 3)
                        if span.duration_ms is not None else None),
        "status": span.status,
        "layer": STITCH_SPANS.get(span.name, "other"),
        "attributes": {k: (v if isinstance(v, (str, int, float, bool))
                           or v is None else str(v))
                       for k, v in span.attributes.items()},
        "events": [{"ts": ts, "name": name,
                    "attributes": {k: (v if isinstance(
                        v, (str, int, float, bool)) or v is None else str(v))
                        for k, v in attrs.items()}}
                   for ts, name, attrs in span.events],
    }


def _interval_cover_ms(intervals: list[tuple[float, float]]) -> float:
    """Union length of [start, end] intervals — the overlap-tolerant
    'time covered by children' measure (a requeued request's two
    attempts overlap on the wall clock; a plain sum would double-count
    the overlap and spuriously exceed the parent)."""
    total = 0.0
    last_end = None
    for start, end in sorted(intervals):
        if last_end is None or start > last_end:
            total += max(0.0, end - start)
            last_end = end
        elif end > last_end:
            total += end - last_end
            last_end = end
    return total * 1e3


def stitch_waterfall(spans: list[dict[str, Any]], *,
                     gateway_row: dict[str, Any] | None = None,
                     engines: dict[str, Any] | None = None,
                     tolerance_ms: float = 10.0,
                     max_steps_per_span: int = 64) -> dict[str, Any]:
    """Assemble the cross-layer waterfall for one trace.

    ``spans`` are :func:`span_dict` rows; ``gateway_row`` is the flight
    recorder's row for the trace (phase vector, status, tenant);
    ``engines`` maps replica_id -> engine, used to join each decode /
    prefill span against the step-ring rows its window overlapped.

    Invariants computed per parent node and aggregated:

    - ``children_within_parent`` — every child's [start, end] fits inside
      its parent's window (± tolerance);
    - ``child_sum_le_wall`` — the plain sum of child walls stays within
      the parent wall (breaks legitimately when a requeue's two attempts
      overlap — see ``child_cover_le_wall``);
    - ``child_cover_le_wall`` — the UNION of child windows fits in the
      parent wall; holds even across failover hops.
    """
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots: list[dict[str, Any]] = []
    for node in by_id.values():
        parent = by_id.get(node["parent_span_id"] or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    for node in by_id.values():
        node["children"].sort(key=lambda n: n["start_ts"] or 0.0)

    tol_s = tolerance_ms / 1e3
    within = sum_ok = cover_ok = True
    for node in by_id.values():
        children = node["children"]
        if not children or node["end_ts"] is None:
            continue
        p_start, p_end = node["start_ts"], node["end_ts"]
        intervals = []
        child_sum = 0.0
        for child in children:
            c_start = child["start_ts"]
            c_end = child["end_ts"] if child["end_ts"] is not None else c_start
            intervals.append((c_start, c_end))
            child_sum += max(0.0, c_end - c_start) * 1e3
            if c_start < p_start - tol_s or c_end > p_end + tol_s:
                within = False
                child["outside_parent"] = True
        node["child_sum_ms"] = round(child_sum, 3)
        node["child_cover_ms"] = round(_interval_cover_ms(intervals), 3)
        wall = (p_end - p_start) * 1e3
        if child_sum > wall + tolerance_ms:
            sum_ok = False
        if node["child_cover_ms"] > wall + tolerance_ms:
            cover_ok = False

    # engine step-ring join: rows whose [ts - duration, ts] window
    # overlaps a decode/prefill span's window, tagged onto the span
    engines = engines or {}
    steps_joined = 0
    for node in by_id.values():
        if node["name"] not in ("llm.decode", "llm.prefill"):
            continue
        rid = str(node["attributes"].get("llm.replica_id", ""))
        engine = engines.get(rid)
        if engine is None or node["end_ts"] is None:
            continue
        try:
            rows = engine.recent_steps()
        except Exception:
            continue
        joined = []
        for row in rows:
            row_end = row.get("ts") or 0.0
            row_start = row_end - (row.get("duration_ms") or 0.0) / 1e3
            if row_end < node["start_ts"] or row_start > node["end_ts"]:
                continue
            joined.append({k: row.get(k) for k in (
                "seq", "kind", "batch", "duration_ms", "tokens",
                "superstep", "frozen", "gap_ms", "phases", "mfu",
                "hbm_frac")})
        if joined:
            node["engine_steps"] = joined[-max_steps_per_span:]
            steps_joined += len(node["engine_steps"])

    # cross-layer summary: replica hops (a requeued request shows >1),
    # tenants (must be conserved end-to-end), tier IO, requeue spans
    hops: list[str] = []
    tenants: set[str] = set()
    for span in sorted(spans, key=lambda s: s["start_ts"] or 0.0):
        rid = span["attributes"].get("llm.replica_id")
        if rid is not None and str(rid) not in hops:
            hops.append(str(rid))
        tenant = span["attributes"].get("llm.tenant") \
            or span["attributes"].get("gw.tenant")
        if tenant and tenant != "anonymous":
            tenants.add(str(tenant))
    layers: dict[str, int] = {}
    for span in spans:
        layer = STITCH_SPANS.get(span["name"], "other")
        layers[layer] = layers.get(layer, 0) + 1

    gateway = None
    if gateway_row is not None:
        phases = gateway_row.get("phases_ms") or {}
        gateway = dict(gateway_row)
        gateway["phase_sum_ms"] = round(sum(phases.values()), 3)

    root = next((r for r in sorted(roots,
                                   key=lambda n: n["start_ts"] or 0.0)
                 if r["name"] in ROOT_SPANS), None) \
        or (roots[0] if roots else None)
    return {
        "trace_id": spans[0]["trace_id"] if spans else None,
        "root": ({"name": root["name"], "span_id": root["span_id"],
                  "duration_ms": root["duration_ms"],
                  "status": root["status"]} if root else None),
        "span_count": len(spans),
        "layers": layers,
        "replica_hops": hops,
        "tenants": sorted(tenants),
        "requeues": [s for s in spans if s["name"] == "pool.requeue"],
        "tier_io": [s for s in spans if s["name"].startswith("tier.")],
        "engine_steps_joined": steps_joined,
        "gateway": gateway,
        "invariants": {
            "children_within_parent": within,
            "child_sum_le_wall": sum_ok,
            "child_cover_le_wall": cover_ok,
            "tolerance_ms": tolerance_ms,
        },
        "complete": bool(root is not None and within and cover_ok),
        "tree": roots,
    }
