"""Observability of the port, all of it stdlib only: request-scoped tenant
identity and its label clamp (``tenant``, re-exported here), the phase
clock (``phases``), the tracer (``tracing``), the metrics registry
(``metrics``), exemplars and the tail-sampled trace store
(``trace_store``), the SLO evaluator (``slo``), the tenant ledger
(``metering``), the fleet view (``fleet``), the degradation ladder and
overload shedder (``degradation``), the signal bus (``signals``) and the
fault plane (``faults``).

``trace_extra`` is the port's copy of what the engine needs of the JAX
package's ``observability/logging.py``.
"""

from __future__ import annotations

from typing import Any

from .tenant import (ANONYMOUS, OTHER, UNATTRIBUTED, TenantClamp, current_tenant,
                     reset_current_tenant, resolve_tenant, set_current_tenant)

__all__ = ["ANONYMOUS", "OTHER", "UNATTRIBUTED", "TenantClamp", "current_tenant",
           "reset_current_tenant", "resolve_tenant", "set_current_tenant", "trace_extra"]


def trace_extra(trace_ctx: "tuple[str, str] | None") -> dict[str, Any]:
    """``extra=`` kwargs that stamp a log record with an explicit
    (trace_id, span_id), for producers off the contextvar chain (the
    engine's dispatch thread) whose records must still join the trace of
    the request they concern."""
    if not trace_ctx:
        return {}
    return {"ctx": {"trace_id": trace_ctx[0], "span_id": trace_ctx[1]}}
