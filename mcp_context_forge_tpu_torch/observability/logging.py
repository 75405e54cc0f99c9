"""Structured logging of the port (a copy of the JAX package's
``observability/logging.py``; stdlib only): ``trace_extra`` for producers
off the contextvar chain, the JSON formatter that stamps each line with its
trace and span ids, the ring buffer behind ``/admin/logs``, and
``init_logging``, which installs them on the root logger with an optional
rotating file sink."""

from __future__ import annotations

import collections
import json
import logging
import os
from typing import Any


def trace_extra(trace_ctx: "tuple[str, str] | None") -> dict[str, Any]:
    """``extra=`` kwargs that stamp a log record with an explicit
    (trace_id, span_id), for producers off the contextvar chain (the
    engine's dispatch thread) whose records must still join the trace of
    the request they concern."""
    if not trace_ctx:
        return {}
    return {"ctx": {"trace_id": trace_ctx[0], "span_id": trace_ctx[1]}}


def _trace_fields(record: logging.LogRecord) -> tuple[str | None, str | None]:
    """(trace_id, span_id) for a record: an explicit ``ctx`` extra wins
    (cross-thread producers), else the contextvar-current span (request
    handlers), else nothing."""
    ctx = getattr(record, "ctx", None)
    if isinstance(ctx, dict) and ctx.get("trace_id"):
        return ctx.get("trace_id"), ctx.get("span_id")
    try:  # lazy: logging must work before and without the tracer
        from .tracing import current_span
        span = current_span()
    except Exception:
        span = None
    if span is not None:
        return span.trace_id, span.span_id
    return None, None


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        trace_id, span_id = _trace_fields(record)
        if trace_id:
            payload["trace_id"] = trace_id
            if span_id:
                payload["span_id"] = span_id
        extra = getattr(record, "ctx", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload, separators=(",", ":"), default=str)


class RingBufferHandler(logging.Handler):
    """Keeps the last N records in memory for /admin/logs search."""

    def __init__(self, capacity: int = 5000) -> None:
        super().__init__()
        self.records: collections.deque[dict[str, Any]] = collections.deque(maxlen=capacity)

    def emit(self, record: logging.LogRecord) -> None:
        entry = {
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        trace_id, span_id = _trace_fields(record)
        if trace_id:
            entry["trace_id"] = trace_id
            if span_id:
                entry["span_id"] = span_id
        self.records.append(entry)

    def search(self, query: str = "", level: str | None = None,
               limit: int = 200) -> list[dict[str, Any]]:
        """Newest first: records at ``level`` whose message holds ``query``
        (case-insensitive), at most ``limit``."""
        out = []
        for rec in reversed(self.records):
            if level and rec["level"] != level.upper():
                continue
            if query and query.lower() not in rec["message"].lower():
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out


ring_buffer = RingBufferHandler()

# the one file sink this module manages (see init_logging)
_file_handler: logging.FileHandler | None = None


def init_logging(level: str = "INFO", as_json: bool = False,
                 buffer_capacity: int | None = None,
                 file_path: str | None = None,
                 rotation: bool = False, max_mb: float = 1.0,
                 backup_count: int = 5) -> None:
    """Root logging: the ring buffer (``/admin/logs``), a stream and, when
    ``file_path`` is set, a file sink, size-rotated with ``rotation``."""
    root = logging.getLogger()
    root.setLevel(level.upper())
    if buffer_capacity and buffer_capacity != ring_buffer.records.maxlen:
        ring_buffer.records = collections.deque(ring_buffer.records, maxlen=buffer_capacity)
    if not any(isinstance(h, RingBufferHandler) for h in root.handlers):
        root.addHandler(ring_buffer)
    stream = next((h for h in root.handlers if isinstance(h, logging.StreamHandler)
                   and not isinstance(h, RingBufferHandler)), None)
    if stream is None:
        stream = logging.StreamHandler()
        root.addHandler(stream)
    formatter: logging.Formatter = (JsonFormatter() if as_json else logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s"))
    stream.setFormatter(formatter)
    # the file sink is re-created on every init: the root logger is
    # process-global, so an app built without a file must drop the sink a
    # previous init attached
    global _file_handler
    if _file_handler is not None:
        root.removeHandler(_file_handler)
        _file_handler.close()
        _file_handler = None
    if file_path:
        os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
        if rotation:
            from logging.handlers import RotatingFileHandler
            _file_handler = RotatingFileHandler(
                file_path, maxBytes=int(max_mb * 1024 * 1024), backupCount=backup_count)
        else:
            _file_handler = logging.FileHandler(file_path)
        _file_handler.setFormatter(formatter)
        root.addHandler(_file_handler)
