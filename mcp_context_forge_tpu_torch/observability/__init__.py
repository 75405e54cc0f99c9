"""Observability of the port, all of it stdlib only: request-scoped tenant
identity and its label clamp (``tenant``, re-exported here), the phase
clock (``phases``), the tracer (``tracing``), the metrics registry
(``metrics``), exemplars and the tail-sampled trace store
(``trace_store``), the SLO evaluator (``slo``), the tenant ledger
(``metering``), the fleet view (``fleet``), the degradation ladder and
overload shedder (``degradation``), the signal bus (``signals``), the
fault plane (``faults``), structured logging (``logging``: ``trace_extra``,
re-exported here, the JSON formatter and the log ring) and the OTLP exporter
(``otlp``).
"""

from __future__ import annotations

from .logging import trace_extra
from .tenant import (ANONYMOUS, OTHER, UNATTRIBUTED, TenantClamp, current_tenant,
                     reset_current_tenant, resolve_tenant, set_current_tenant)

__all__ = ["ANONYMOUS", "OTHER", "UNATTRIBUTED", "TenantClamp", "current_tenant",
           "reset_current_tenant", "resolve_tenant", "set_current_tenant", "trace_extra"]

