"""Request-scoped tenant identity and trace-correlated log records.

The port's own copy of what the engine and the provider need from the
JAX package's ``observability/tenant.py`` (the ``current_tenant``
contextvar) and ``observability/logging.py`` (``trace_extra``). The
contextvar is the port's own: whatever resolves a request's tenant sets
it with ``set_current_tenant`` around the provider call.
"""

from __future__ import annotations

import contextvars
from typing import Any

_current_tenant: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("mcpforge_torch_tenant", default=None)


def current_tenant() -> str | None:
    """The request's resolved tenant, or None outside an attributed
    request (callers account such work as unattributed)."""
    return _current_tenant.get()


def set_current_tenant(tenant: str | None) -> contextvars.Token:
    return _current_tenant.set(tenant)


def reset_current_tenant(token: contextvars.Token) -> None:
    try:
        _current_tenant.reset(token)
    except ValueError:  # a token of another context (generator teardown)
        pass


def trace_extra(trace_ctx: "tuple[str, str] | None") -> dict[str, Any]:
    """``extra=`` kwargs that stamp a log record with an explicit
    (trace_id, span_id), for producers off the contextvar chain (the
    engine's dispatch thread) whose records must still join the trace of
    the request they concern."""
    if not trace_ctx:
        return {}
    return {"ctx": {"trace_id": trace_ctx[0], "span_id": trace_ctx[1]}}
