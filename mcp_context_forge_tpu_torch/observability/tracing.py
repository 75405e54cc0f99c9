"""In-tree tracer with OTel semantics (a copy of the JAX package's
``observability/tracing.py``; stdlib only).

Spans carry name, attributes, status and timing, parentage via
contextvars, and W3C ``traceparent`` extraction and injection. Exporters:
``memory`` (a bounded list, ``Tracer.finished``), ``console`` and
``none``; extra sinks register with ``add_sink``.
"""

from __future__ import annotations

import contextvars
import random
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "mcpforge_current_span", default=None
)


def _rand_hex(nbytes: int) -> str:
    return "".join(f"{random.getrandbits(8):02x}" for _ in range(nbytes))


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_span_id: str | None = None
    start_ts: float = field(default_factory=time.time)
    end_ts: float | None = None
    status: str = "OK"
    attributes: dict[str, Any] = field(default_factory=dict)
    events: list[tuple[float, str, dict[str, Any]]] = field(default_factory=list)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, attributes: dict[str, Any] | None = None) -> None:
        self.events.append((time.time(), name, attributes or {}))

    def record_exception(self, exc: BaseException) -> None:
        self.status = "ERROR"
        self.attributes["exception.type"] = type(exc).__name__
        self.attributes["exception.message"] = str(exc)

    @property
    def duration_ms(self) -> float | None:
        if self.end_ts is None:
            return None
        return (self.end_ts - self.start_ts) * 1000.0

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def context(self) -> tuple[str, str]:
        """(trace_id, span_id) — hand this across threads so work running
        off the contextvar chain (engine dispatch) can parent to it."""
        return self.trace_id, self.span_id


class Tracer:
    def __init__(self, service_name: str = "mcpforge", exporter: str = "memory",
                 max_memory_spans: int = 4096) -> None:
        self.service_name = service_name
        self.exporter = exporter
        self.finished: list[Span] = []  # memory exporter ring
        self._max_memory = max_memory_spans
        self._sinks: list[Callable[[Span], None]] = []

    def add_sink(self, sink: Callable[[Span], None]) -> None:
        """Register an extra on-finish callback (e.g. the DB trace store)."""
        self._sinks.append(sink)

    @contextmanager
    def span(self, name: str, attributes: dict[str, Any] | None = None,
             traceparent: str | None = None) -> Iterator[Span]:
        parent = _current_span.get()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif traceparent is not None and (ctx := parse_traceparent(traceparent)):
            trace_id, parent_id = ctx
        else:
            trace_id, parent_id = _rand_hex(16), None
        span = Span(name=name, trace_id=trace_id, span_id=_rand_hex(8),
                    parent_span_id=parent_id, attributes=dict(attributes or {}))
        token = _current_span.set(span)
        try:
            yield span
        except BaseException as exc:
            span.record_exception(exc)
            raise
        finally:
            span.end_ts = time.time()
            try:
                _current_span.reset(token)
            except ValueError:
                # the span was opened inside an (async) generator that a
                # different context is now closing (GC-driven aclose):
                # the token belongs to a foreign Context, whose own spans
                # must not be touched — the original context never sees
                # this span again anyway, so leave everything alone
                pass
            self._finish(span)

    def emit_span(self, name: str, start_ts: float, end_ts: float,
                  trace_ctx: tuple[str, str] | None = None,
                  attributes: dict[str, Any] | None = None,
                  status: str = "OK",
                  events: list[tuple[float, str, dict[str, Any]]] | None = None
                  ) -> Span:
        """Record an already-completed span with explicit timing and
        parentage. For producers that cannot wrap their work in the
        ``span()`` context manager — the engine dispatch thread measures
        phases for many interleaved requests at once, then reports each
        one here with the (trace_id, span_id) its submitter captured.
        ``events`` are pre-timestamped (ts, name, attributes) span events
        (the engine's sampled decode-step phase rows ride here)."""
        if trace_ctx is not None:
            trace_id, parent_id = trace_ctx
        else:
            trace_id, parent_id = _rand_hex(16), None
        span = Span(name=name, trace_id=trace_id, span_id=_rand_hex(8),
                    parent_span_id=parent_id, start_ts=start_ts,
                    attributes=dict(attributes or {}), status=status)
        if events:
            span.events = [(ts, ev_name, dict(attrs))
                           for ts, ev_name, attrs in events]
        span.end_ts = end_ts
        self._finish(span)
        return span

    def _finish(self, span: Span) -> None:
        if self.exporter == "memory":
            self.finished.append(span)
            if len(self.finished) > self._max_memory:
                del self.finished[: len(self.finished) // 2]
        elif self.exporter == "console":
            print(f"[span] {span.name} {span.duration_ms:.2f}ms status={span.status} "
                  f"trace={span.trace_id[:8]} attrs={span.attributes}")
        for sink in self._sinks:
            try:
                sink(span)
            except Exception:
                pass


def parse_traceparent(header: str) -> tuple[str, str] | None:
    """Extract (trace_id, parent_span_id) from a W3C traceparent header.
    Strictly lowercase-hex per spec — these ids are client-controlled and
    flow into admin surfaces, so non-hex must never be adopted."""
    parts = header.strip().split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    hexdigits = set("0123456789abcdef")
    if not (set(parts[1]) <= hexdigits and set(parts[2]) <= hexdigits):
        return None
    return parts[1], parts[2]


def current_span() -> Span | None:
    return _current_span.get()


_tracer: Tracer = Tracer(exporter="none")


def init_tracer(service_name: str, exporter: str) -> Tracer:
    global _tracer
    _tracer = Tracer(service_name=service_name, exporter=exporter)
    return _tracer


def get_tracer() -> Tracer:
    return _tracer
