"""Tenant identity and its bounded metric label (a copy of the JAX
package's ``observability/tenant.py``; stdlib only).

- ``resolve_tenant``: a resolved principal's billing tenant, in one order:
  team, then API key, then user, with ``anonymous`` for unauthenticated
  surfaces. Prefixes (``team:``, ``key:``, ``user:``) keep the namespaces
  apart.
- a contextvar that carries the tenant through a request's async call
  tree, so that the provider stamps it on the engine's ``GenRequest``
  without a tenant field in the OpenAI wire shapes. The auth middleware
  sets it around each request; work submitted outside a request has none
  and is accounted as ``UNATTRIBUTED``.
- ``TenantClamp``: the first ``max_tenants`` distinct tenants get a label
  of their own, every later one maps to ``"other"``, so a tenant label
  never has more than ``max_tenants + 1`` children. The ledger
  (``metering.py``) keeps exact rows whatever the clamp says.
"""

from __future__ import annotations

import contextvars
import threading
from typing import Any

# engine work with no resolved tenant (direct submissions, warm-up)
UNATTRIBUTED = "unattributed"
# the clamp's overflow label: the N+1'th distinct tenant and every later one
OTHER = "other"
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


class TenantClamp:
    """First-N-observed tenant -> metric label.

    ``label()`` admits a tenant while fewer than ``max_tenants`` are
    tracked and returns ``OTHER`` for everyone after; an admitted tenant's
    label never changes (a running top-N would rename label children as
    rankings shift). ``peek()`` is the read-only twin for query paths: a
    probe of an unknown tenant must not take an admission slot.

    Thread-safe: the engine's dispatch thread labels at retire while the
    event loop labels HTTP observations."""

    def __init__(self, max_tenants: int = 8) -> None:
        self.max_tenants = max(1, int(max_tenants))
        self._admitted: set[str] = set()
        self._lock = threading.Lock()

    def label(self, tenant: str) -> str:
        tenant = tenant or UNATTRIBUTED
        with self._lock:
            if tenant in self._admitted:
                return tenant
            if len(self._admitted) < self.max_tenants:
                self._admitted.add(tenant)
                return tenant
        return OTHER

    def peek(self, tenant: str) -> str:
        """``label()`` without admission: an unknown tenant reads as
        ``OTHER``."""
        tenant = tenant or UNATTRIBUTED
        with self._lock:
            return tenant if tenant in self._admitted else OTHER

    def admitted(self) -> list[str]:
        with self._lock:
            return sorted(self._admitted)

    def snapshot(self) -> dict[str, Any]:
        return {"max_tenants": self.max_tenants, "admitted": self.admitted()}
