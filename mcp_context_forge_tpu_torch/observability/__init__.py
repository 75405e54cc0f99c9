"""Observability of the port: request-scoped tenant identity and
trace-correlated log records here; the phase clock (``phases``), the
tracer (``tracing``), the degradation ladder and overload shedder
(``degradation``), the signal bus (``signals``) and the fault plane
(``faults``) in their modules. All of it is stdlib only.

This module is the port's own copy of what the engine, the provider and
the auth middleware need from the JAX package's ``observability/tenant.py``
(``resolve_tenant`` and the ``current_tenant`` contextvar) and
``observability/logging.py`` (``trace_extra``). The contextvar is the
port's own: the auth middleware sets it around each request.
"""

from __future__ import annotations

import contextvars
from typing import Any

# unauthenticated surfaces (public paths, auth_required off)
ANONYMOUS = "anonymous"

_current_tenant: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("mcpforge_torch_tenant", default=None)


def resolve_tenant(auth: Any) -> str:
    """A resolved principal's billing tenant: its first team (the
    lexicographically smallest id, so that the pick does not depend on
    row order), else its API-key jti, else the user itself; no principal,
    or an anonymous one, is ``anonymous``. Prefixed (``team:``, ``key:``,
    ``user:``) so the namespaces never collide."""
    if auth is None or getattr(auth, "via", "anonymous") == "anonymous":
        return ANONYMOUS
    teams = getattr(auth, "teams", None)
    if teams:
        return f"team:{min(teams)}"
    jti = getattr(auth, "token_jti", None)
    if jti:
        return f"key:{jti}"
    return f"user:{getattr(auth, 'user', '') or ANONYMOUS}"


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
