"""CSRF protection primitives: HMAC-signed double-submit tokens + the
browser-origin heuristics the middleware enforces.

A copy of the JAX package's ``services/csrf_service.py`` (the reference's
`middleware/csrf_middleware.py` and `services/csrf_service.py`). The attack surface here is the admin page:
browsers re-attach Basic credentials (and cookies) to CROSS-SITE form
posts, so a state-changing request that rides ambient credentials must
prove same-origin intent. Two complementary mechanisms:

- **fetch-metadata / Origin check** (`browser_cross_site`): a browser-
  originated cross-site request declares itself via ``Sec-Fetch-Site``
  or a mismatched ``Origin`` header; non-browser clients (curl, SDKs,
  tests) send neither and are not CSRF-able (they attach credentials
  explicitly per request).
- **double-submit token** (`mint`/`validate`): the admin page receives a
  ``csrf_token`` cookie; its JS echoes the value in ``X-CSRF-Token`` on
  every mutating fetch. A cross-site attacker can make the browser SEND
  the cookie but cannot READ it, so the echo proves same-origin JS ran.
  Tokens are HMAC(user|expiry) under the JWT secret — stateless, no DB.

Residual gap, stated honestly: a legacy browser that re-attaches Basic
credentials to a cross-site form POST while sending NEITHER
``Sec-Fetch-Site`` nor ``Origin`` passes the origin check, and — because
the cookie is SameSite=Strict — the double-submit branch has no cookie
to demand. Every browser since ~2011 sends ``Origin`` on cross-origin
POSTs (and all evergreen ones send fetch metadata), so the exposure is
pre-2011 user agents only; closing it fully would mean requiring the
token pair on EVERY non-Bearer mutation, breaking curl/SDK basic-auth
clients. The reference accepts the same trade (its Bearer-exempt,
cookie-bound validation never fires for ambient-Basic non-browser
clients either).
"""

from __future__ import annotations

import hashlib
import hmac
import time

SAFE_METHODS = frozenset({"GET", "HEAD", "OPTIONS", "TRACE"})
COOKIE_NAME = "csrf_token"
HEADER_NAME = "X-CSRF-Token"


def mint(user: str, secret: str, ttl_s: float = 8 * 3600,
         _now: float | None = None) -> str:
    """``<expiry>.<hex hmac(user|expiry)>`` — verifiable statelessly."""
    expiry = int((_now if _now is not None else time.time()) + ttl_s)
    mac = hmac.new(secret.encode(), f"{user}|{expiry}".encode(),
                   hashlib.sha256).hexdigest()
    return f"{expiry}.{mac}"


def validate(token: str, user: str, secret: str,
             _now: float | None = None) -> bool:
    try:
        expiry_raw, mac = token.split(".", 1)
        expiry = int(expiry_raw)
    except ValueError:
        return False
    if expiry < (_now if _now is not None else time.time()):
        return False
    expected = hmac.new(secret.encode(), f"{user}|{expiry}".encode(),
                        hashlib.sha256).hexdigest()
    return hmac.compare_digest(mac, expected)


def browser_cross_site(headers, host: str,
                       trusted_origins: tuple[str, ...] = ()) -> bool:
    """True when the request declares browser CROSS-SITE provenance.

    ``Sec-Fetch-Site`` is attacker-unforgeable from a browser (forbidden
    header); an ``Origin`` whose authority differs from the request host
    (and isn't explicitly trusted) is the pre-fetch-metadata signal.
    Absence of both means a non-browser client: not a CSRF vector."""
    site = headers.get("sec-fetch-site", "").lower()
    if site == "cross-site":
        return True
    origin = headers.get("origin", "")
    if origin and origin.lower() not in ("null",):
        if origin in trusted_origins:
            return False
        authority = origin.split("://", 1)[-1]
        if authority.lower() != host.lower():
            return True
    elif origin.lower() == "null":
        return True  # sandboxed/opaque origin: never a legitimate admin UI
    return False
