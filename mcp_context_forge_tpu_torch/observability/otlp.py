"""OTLP/HTTP export of the port's tracer (a copy of the JAX package's
``observability/otlp.py``; stdlib only).

``encode_spans`` builds an OTLP-JSON ExportTraceServiceRequest from
finished ``tracing.Span``s; ``OTLPExporter`` is a tracer sink that buffers
them and an async flusher that POSTs them in batches to
``{endpoint}/v1/traces``. The HTTP client is the caller's: ``post(url,
payload, headers)`` is an async callable returning ``(status, text)``, so
this module imports no HTTP library (``aiohttp_post`` builds one on
aiohttp, imported when it is first called).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Any, Awaitable, Callable

from .tracing import Span

logger = logging.getLogger(__name__)

Post = Callable[[str, dict, dict], Awaitable[tuple[int, str]]]


def _attr(key: str, value: Any) -> dict[str, Any]:
    if isinstance(value, bool):
        typed: dict[str, Any] = {"boolValue": value}
    elif isinstance(value, int):
        typed = {"intValue": str(value)}
    elif isinstance(value, float):
        typed = {"doubleValue": value}
    else:
        typed = {"stringValue": str(value)}
    return {"key": key, "value": typed}


def encode_spans(spans: list[Span], service_name: str) -> dict[str, Any]:
    """OTLP-JSON ExportTraceServiceRequest: one resource (``service.name``),
    one scope, the spans with their attributes, events and status."""
    def nanos(ts: float | None) -> str:
        return str(int((ts or 0.0) * 1e9))

    return {"resourceSpans": [{
        "resource": {"attributes": [_attr("service.name", service_name)]},
        "scopeSpans": [{
            "scope": {"name": "mcpforge"},
            "spans": [{
                "traceId": span.trace_id,
                "spanId": span.span_id,
                **({"parentSpanId": span.parent_span_id} if span.parent_span_id else {}),
                "name": span.name,
                "kind": 1,  # SPAN_KIND_INTERNAL
                "startTimeUnixNano": nanos(span.start_ts),
                "endTimeUnixNano": nanos(span.end_ts),
                "attributes": [_attr(k, v) for k, v in span.attributes.items()],
                "events": [{"timeUnixNano": nanos(ts), "name": name,
                            "attributes": [_attr(k, v) for k, v in attrs.items()]}
                           for ts, name, attrs in span.events],
                "status": {"code": 2 if span.status == "ERROR" else 1},
            } for span in spans],
        }],
    }]}


def aiohttp_post(timeout_s: float = 10.0) -> tuple[Post, Callable[[], Awaitable[None]]]:
    """(post, close): a ``Post`` over one aiohttp session, made on the
    running loop at the first call, and the coroutine that closes it."""
    session: list = []

    async def post(url: str, payload: dict, headers: dict) -> tuple[int, str]:
        import aiohttp

        if not session:
            session.append(aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=timeout_s)))
        async with session[0].post(url, json=payload, headers=headers) as resp:
            return resp.status, await resp.text()

    async def close() -> None:
        if session:
            await session.pop().close()

    return post, close


class OTLPExporter:
    """Buffers spans from the (sync) tracer sink; an async flusher POSTs
    them in batches. A transient failure (a transport error, a 5xx) retries
    the batch with exponential backoff up to ``max_retries`` times before it
    drops; a 4xx (the collector refused the payload: retrying cannot help)
    drops at once, and so does a span that finds the bounded buffer full.
    Every span's fate is counted in ``exported``/``dropped`` and, with a
    registry, ``otel_spans_exported`` / ``otel_spans_dropped{reason}``."""

    def __init__(self, post: Post, endpoint: str, service_name: str,
                 headers: dict[str, str] | None = None, metrics: Any = None,
                 flush_interval: float = 2.0, max_buffer: int = 8192,
                 max_batch: int = 512, max_retries: int = 3,
                 backoff_base_s: float = 0.5):
        self.post = post
        self.metrics = metrics
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.headers = {"content-type": "application/json", **(headers or {})}
        self.flush_interval = flush_interval
        self.max_buffer = max_buffer
        self.max_batch = max_batch
        self.max_retries = max(0, int(max_retries))
        self.backoff_base_s = max(0.01, float(backoff_base_s))
        self._buffer: list[Span] = []
        self._lock = threading.Lock()
        self._task: asyncio.Task | None = None
        # in-flight retry state (flusher only): the failed batch, its
        # attempt count, and the earliest monotonic time to retry
        self._retry_batch: list[Span] | None = None
        self._retry_attempts = 0
        self._retry_at = 0.0
        self.exported = 0
        self.dropped = 0
        self.retries = 0

    def _count_exported(self, n: int) -> None:
        self.exported += n
        if self.metrics is not None:
            self.metrics.otel_spans_exported.inc(n)

    def _count_dropped(self, n: int, reason: str) -> None:
        self.dropped += n
        if self.metrics is not None:
            self.metrics.otel_spans_dropped.labels(reason=reason).inc(n)

    def sink(self, span: Span) -> None:
        with self._lock:
            if len(self._buffer) >= self.max_buffer:
                self._count_dropped(1, "buffer_full")
                return
            self._buffer.append(span)

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # final flush: a pending retry gets its last attempt now
        self._retry_at = 0.0
        await self.flush()
        # what the final attempt could not deliver is lost with the process
        if self._retry_batch is not None:
            self._count_dropped(len(self._retry_batch), "shutdown")
            self._retry_batch = None
            self._retry_attempts = 0
        with self._lock:
            leftover = len(self._buffer)
            self._buffer.clear()
        if leftover:
            self._count_dropped(leftover, "shutdown")

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.flush_interval)
            try:
                await self.flush()
            except Exception:
                logger.debug("otlp flush failed", exc_info=True)

    async def flush(self) -> None:
        # the retried batch goes first (span order roughly kept, and a
        # collector still down is found before new batches are risked);
        # not yet due: wait for the next tick
        while True:
            if self._retry_batch is not None:
                if time.monotonic() < self._retry_at:
                    return
                batch = self._retry_batch
                retrying = True
            else:
                with self._lock:
                    batch = self._buffer[: self.max_batch]
                    del self._buffer[: self.max_batch]
                retrying = False
            if not batch:
                return
            payload = encode_spans(batch, self.service_name)
            try:
                status, text = await self.post(f"{self.endpoint}/v1/traces", payload,
                                               self.headers)
                if 400 <= status < 500:
                    # the collector refused the payload: the same bytes
                    # cannot succeed, so drop, loudly
                    logger.warning("otlp export rejected: %s %s", status, text[:200])
                    self._count_dropped(len(batch), "rejected")
                elif status >= 500:
                    self._defer(batch, f"http_{status}")
                    return
                else:
                    self._count_exported(len(batch))
            except Exception as exc:
                # collector down or a network blip: transient
                self._defer(batch, f"{type(exc).__name__}: {exc}")
                return
            if retrying:
                self._retry_batch = None
                self._retry_attempts = 0

    def _defer(self, batch: list[Span], cause: str) -> None:
        """Schedule a failed batch for a retry with exponential backoff,
        dropping it only after ``max_retries`` attempts."""
        attempts = self._retry_attempts + 1 if self._retry_batch is batch else 1
        if attempts > self.max_retries:
            logger.warning("otlp export dropped %d span(s) after %d attempt(s): %s",
                           len(batch), attempts, cause)
            self._count_dropped(len(batch), "retry_exhausted")
            self._retry_batch = None
            self._retry_attempts = 0
            return
        self.retries += 1
        self._retry_batch = batch
        self._retry_attempts = attempts
        backoff = self.backoff_base_s * (2 ** (attempts - 1))
        self._retry_at = time.monotonic() + backoff
        logger.warning("otlp export failed (attempt %d/%d, retrying in %.1fs): %s",
                       attempts, self.max_retries, backoff, cause)
