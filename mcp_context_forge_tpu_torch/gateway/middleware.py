"""The aiohttp middlewares of the port's app: the JAX package's
``gateway/middleware.py`` chain in its order (``MIDDLEWARES``, outermost
first):

- ``observability_middleware``: a correlation id and the ``http.request``
  span, through the app's tracer (``app["tracer"]``); with a registry in
  ``app["metrics"]``, ``http_requests`` counted and ``http_duration``
  observed under the clamped tenant label, with the trace's exemplar;
- ``flight_recorder_middleware``: a ``PhaseClock`` per request, whose
  vector (the ``handler`` or ``error`` residue included) sums to the
  request's wall and lands as a ``gw.phases`` event on the span and, with
  ``app["flight_recorder"]``, as a row of the recorder's rings;
  X-Queue-Depth and Retry-After on the unary /v1 responses;
- ``client_disconnect_middleware``: a ``CancelledError`` out of the handler
  counts ``client_disconnects`` and marks the request. aiohttp cancels a
  handler whose peer went away only when the server runs with
  ``handler_cancellation=True``, which neither package sets: a client that
  closes mid-stream shows as a failed write instead, and this counter does
  not move, in either package;
- ``forwarded_middleware``: ``request["client_ip"]``, the rightmost
  X-Forwarded-For entry with ``trust_proxy_headers``, else the peer;
- ``host_validation_middleware``: 421 for a Host outside ``allowed_hosts``;
- ``cors_middleware``: with ``cors_allowed_origins``, a 204 preflight and
  the allow-origin headers on the answer;
- ``compression_middleware``: a unary body of ``compression_min_bytes`` or
  more compressed as Accept-Encoding allows; event streams and streamed
  answers untouched;
- ``security_headers_middleware``: nosniff, DENY, no-referrer, no-store,
  each unless the handler set it (a streamed answer has sent its headers
  before this layer runs);
- ``deprecation_middleware``: Deprecation, X-Deprecated-Endpoint and Sunset
  on the ``deprecated_path_prefixes``;
- ``header_size_middleware``: 431 past ``max_header_bytes``,
  ``max_header_count`` or ``max_header_field_bytes``;
- ``token_usage_middleware``: with ``token_usage_logging_enabled``, a
  ``token_usage_logs`` row for every request made with an API token (a
  jti-bearing JWT), 401/403/429 marked ``blocked``; a refused token's jti
  is read from its unverified payload and kept only when the catalog has
  it. The row is written off the answer's path, as a task in
  ``app["_token_usage_tasks"]``, which the app drains before its database
  closes. It sits outside ``error_middleware`` to see final statuses;
- ``error_middleware``: ``NotFoundError`` -> 404, ``ConflictError`` -> 409,
  ``ValidationFailure`` and ``ValueError`` -> 422, ``AuthError`` -> 401 with
  ``www-authenticate: Bearer``, ``PermissionDenied`` -> 403, anything else
  -> 500 without a trace;
- ``protocol_version_middleware``: 400 for an ``MCP-Protocol-Version``
  outside ``supported_protocol_versions`` on ``/mcp``, ``/servers`` and
  ``/rpc``;
- ``rate_limit_middleware``: 429 (``retry-after: 1``) when
  ``app["rate_limiter"]`` (a ``RateLimiter``, per client ip) refuses;
- ``auth_middleware``: ``request["auth"]`` from the plugins'
  ``http_auth_resolve_user`` hooks when ``app["plugin_manager"]`` is set,
  else from the Authorization header through ``app["auth_service"]``
  (``services/auth_service.py``: Bearer, Basic, an anonymous admin when
  ``auth_required`` is off), then the plugins' ``http_pre_request`` hooks;
  public paths (``/auth/sso/*``, ``/.well-known/*`` and a server's
  ``/.well-known/mcp`` among them) and OPTIONS pass as anonymous; the rest
  of the chain runs under the principal's tenant (``request["tenant"]``
  and the port's ``set_current_tenant``);
- ``csrf_middleware``: with ``csrf_enabled``, an unsafe method riding
  ambient credentials (Basic, not Bearer) answers 403 ``CSRF_CROSS_SITE``
  when the browser declares cross-site provenance, ``CSRF_NO_PROVENANCE``
  under ``csrf_check_referer`` when it declares none, and
  ``CSRF_TOKEN_INVALID`` when the ``csrf_token`` cookie is not echoed in
  ``X-CSRF-Token`` (``services/csrf_service.py``);
- ``password_change_middleware``: with
  ``password_change_enforcement_enabled``, an interactive identity flagged
  ``password_change_required`` answers 403 ``PASSWORD_CHANGE_REQUIRED``
  anywhere but ``/auth/password`` (API tokens are exempt);
- ``request_logging_middleware``: at DEBUG, each request's body masked by
  ``utils/masking.py`` and each status; with ``app["audit_service"]``, an
  ``audit_trail`` row for each successful POST, PUT or DELETE outside the
  MCP, /v1 and /llmchat surfaces;
- ``db_query_logging_middleware``: with ``db_query_logging``, the handler's
  statements (``db/core.py`` ``query_log_capture``) as X-DB-Query-Count and
  X-DB-Query-Time-MS, a warning per slow statement and per repeated shape.

``request.app["settings"]`` is duck-typed as the gateway's settings.
"""

from __future__ import annotations

import asyncio
import base64
import binascii
import hmac
import logging
import time
import uuid
from typing import Awaitable, Callable

from aiohttp import web

from ..observability import (ANONYMOUS, reset_current_tenant, resolve_tenant,
                             set_current_tenant)
from ..observability import phases as request_phases
from ..observability.tracing import current_span
from ..services.base import ConflictError, NotFoundError, ValidationFailure
from .auth import AuthContext, AuthError, PermissionDenied
from .flight_recorder import backpressure_headers, queue_state

Handler = Callable[[web.Request], Awaitable[web.StreamResponse]]

PUBLIC_PATHS = {"/health", "/ready", "/version", "/auth/login", "/robots.txt",
                # the reset flow is pre-auth by nature; its handlers are
                # rate limited and answer alike for unknown accounts
                "/auth/password/reset-request", "/auth/password/reset"}


@web.middleware
async def observability_middleware(request: web.Request,
                                   handler: Handler) -> web.StreamResponse:
    """Correlation id, the ``http.request`` span and, with a registry, the
    HTTP metrics of each request."""
    settings = request.app["settings"]
    metrics = request.app.get("metrics")
    inbound = (request.headers.get(settings.correlation_id_header, "")
               if settings.correlation_id_preserve else "")
    correlation_id = inbound or uuid.uuid4().hex[:16]
    request["correlation_id"] = correlation_id
    started = time.monotonic()
    route = request.match_info.route.resource
    # the route template (bounded); unmatched paths are client-controlled and
    # collapse to one label, so a scan of 404s adds no series
    path_label = route.canonical if route is not None else "unmatched"
    attrs = {"http.method": request.method, "http.path": request.path,
             "correlation_id": correlation_id}
    with request.app["tracer"].span(
            "http.request", attrs,
            traceparent=request.headers.get("traceparent")) as span:
        span.set_attribute("http.route", path_label)
        response = await handler(request)
        span.set_attribute("http.status_code", response.status)
        tenant = request.get("tenant") or ANONYMOUS
        span.set_attribute("gw.tenant", tenant)
        if metrics is not None:
            elapsed = time.monotonic() - started
            metrics.http_requests.labels(request.method, path_label,
                                         str(response.status)).inc()
            # the tenant label is clamped; the observe carries the trace as
            # its exemplar (the http_p95 objective reads this histogram)
            label = metrics.tenant_clamp.label(tenant)
            metrics.http_duration.labels(request.method, path_label, label).observe(
                elapsed, exemplar=metrics.exemplar("http_duration", elapsed, span.trace_id,
                                                   (request.method, path_label, label)))
        response.headers[settings.correlation_id_response_header] = correlation_id
        return response


@web.middleware
async def flight_recorder_middleware(request: web.Request,
                                     handler: Handler) -> web.StreamResponse:
    """A ``PhaseClock`` for the request: the layers below charge auth,
    routing, engine and serialize time to it; the residue is ``handler``,
    or ``error`` when an exception passed through. With a recorder in
    ``app["flight_recorder"]``, the request is registered in flight while it
    runs and then recorded (phase vector, status, route, trace ids, tenant;
    499 for a client that went away, 500 for an exception), as the JAX
    middleware does."""
    recorder = request.app.get("flight_recorder")
    clock = request_phases.PhaseClock()
    token = request_phases.set_phase_clock(clock)
    span = current_span()
    trace = span.context() if span is not None else None
    rid = recorder.start_request(request.path, trace) if recorder is not None else None
    started = time.perf_counter()
    response: web.StreamResponse | None = None
    error: str | None = None
    disconnected = False
    try:
        response = await handler(request)
        return response
    except web.HTTPException as exc:
        response = exc  # an HTTPException is its response
        raise
    except asyncio.CancelledError:
        error, disconnected = "CancelledError", True
        raise
    except Exception as exc:
        error = type(exc).__name__
        raise
    finally:
        request_phases.reset_phase_clock(token)
        wall = time.perf_counter() - started
        clock.add("error" if error else "handler", max(0.0, wall - clock.total()))
        if recorder is not None:
            recorder.finish_request(rid)
            status = (response.status if response is not None
                      else 499 if disconnected else 500)
            route = request.match_info.route.resource
            if error is None and status >= 500:
                # the handler's exception was mapped to a 5xx below us
                error = f"http_{status}"
            recorder.record(
                method=request.method, path=request.path,
                route=route.canonical if route is not None else "unmatched",
                status=status, duration_s=wall, phases_ms=clock.vector_ms(),
                trace_id=trace[0] if trace else None, span_id=trace[1] if trace else None,
                correlation_id=request.get("correlation_id"), tenant=request.get("tenant"),
                error=error, client_disconnected=(
                    disconnected or bool(request.get("client_disconnected"))))
        if span is not None:
            span.add_event("gw.phases", {"duration_ms": round(wall * 1e3, 3),
                                         **clock.vector_ms()})
        if response is not None:
            _apply_backpressure(request, response, request.app["settings"])


def _apply_backpressure(request: web.Request, response: web.StreamResponse,
                        settings) -> None:
    """X-Queue-Depth / Retry-After on the unary /v1 responses (the SSE path
    sets them before it prepares the stream)."""
    if (not settings.gw_backpressure_headers or response.prepared
            or not request.path.startswith(settings.llm_api_prefix + "/")):
        return
    response.headers.update(backpressure_headers(queue_state(request.app), settings))


@web.middleware
async def client_disconnect_middleware(request: web.Request,
                                       handler: Handler) -> web.StreamResponse:
    """Count a cancelled handler (a client that went away, when the server
    cancels handlers) and mark the request, instead of logging a naked
    ``CancelledError``."""
    try:
        return await handler(request)
    except asyncio.CancelledError:
        metrics = request.app.get("metrics")
        if metrics is not None:
            metrics.client_disconnects.inc()
        request["client_disconnected"] = True
        raise


@web.middleware
async def forwarded_middleware(request: web.Request, handler: Handler) -> web.StreamResponse:
    """The client's address: X-Forwarded-For only from a trusted edge
    (``trust_proxy_headers``); a client-supplied header would otherwise mint
    a fresh rate-limit identity per request."""
    client_ip = request.remote or "unknown"
    if request.app["settings"].trust_proxy_headers:
        forwarded = request.headers.get("x-forwarded-for", "")
        if forwarded:
            # the rightmost entry is the one the trusted edge appended
            client_ip = forwarded.split(",")[-1].strip() or client_ip
    request["client_ip"] = client_ip
    return await handler(request)


@web.middleware
async def host_validation_middleware(request: web.Request,
                                     handler: Handler) -> web.StreamResponse:
    """421 for a Host header outside ``allowed_hosts`` ("" allows any)."""
    allowed = request.app["settings"].allowed_host_set
    if allowed:
        host = (request.host or "").split(":", 1)[0].lower()
        if host not in allowed:
            return web.json_response({"detail": f"Host {host!r} not allowed"}, status=421)
    return await handler(request)


@web.middleware
async def cors_middleware(request: web.Request, handler: Handler) -> web.StreamResponse:
    """CORS for browser-based MCP clients, on with ``cors_allowed_origins``
    ("*" allows any origin)."""
    settings = request.app["settings"]
    allowed = settings.cors_origins
    origin = request.headers.get("origin", "")
    grant = origin if (allowed and origin and ("*" in allowed or origin in allowed)) else ""
    if request.method == "OPTIONS" and grant:
        headers = {
            "access-control-allow-origin": grant,
            "access-control-allow-methods": settings.cors_allowed_methods,
            "access-control-allow-headers": settings.cors_allowed_headers,
            "access-control-max-age": str(settings.cors_max_age_s),
            "vary": "origin",
        }
        if settings.cors_allow_credentials:
            headers["access-control-allow-credentials"] = "true"
        return web.Response(status=204, headers=headers)
    response = await handler(request)
    if grant:
        response.headers["access-control-allow-origin"] = grant
        response.headers.setdefault("vary", "origin")
        response.headers["access-control-expose-headers"] = "mcp-session-id, x-correlation-id"
        if settings.cors_allow_credentials:
            response.headers["access-control-allow-credentials"] = "true"
    return response


@web.middleware
async def compression_middleware(request: web.Request,
                                 handler: Handler) -> web.StreamResponse:
    """Negotiated compression of unary bodies; an event stream, a streamed
    answer and a small body are left as they are (compressing an SSE
    answer would buffer it)."""
    response = await handler(request)
    settings = request.app["settings"]
    if not settings.compression_enabled:
        return response
    if not isinstance(response, web.Response) or response.body is None:
        return response
    if response.content_type == "text/event-stream":
        return response
    if "content-encoding" in response.headers:
        return response
    if len(response.body) < settings.compression_min_bytes:
        return response
    response.enable_compression()  # negotiates via Accept-Encoding
    return response


@web.middleware
async def security_headers_middleware(request: web.Request,
                                      handler: Handler) -> web.StreamResponse:
    response = await handler(request)
    response.headers.setdefault("x-content-type-options", "nosniff")
    response.headers.setdefault("x-frame-options", "DENY")
    response.headers.setdefault("referrer-policy", "no-referrer")
    response.headers.setdefault("cache-control", "no-store")
    return response


@web.middleware
async def deprecation_middleware(request: web.Request, handler: Handler) -> web.StreamResponse:
    """RFC 8594 Deprecation and Sunset headers on the configured legacy path
    prefixes."""
    response = await handler(request)
    settings = request.app["settings"]
    prefixes = settings.deprecated_path_prefixes
    if prefixes and any(request.path.startswith(p) for p in prefixes):
        response.headers["Deprecation"] = "true"
        response.headers["X-Deprecated-Endpoint"] = request.path
        if settings.legacy_api_sunset_date:
            response.headers["Sunset"] = settings.legacy_api_sunset_date
    return response


@web.middleware
async def header_size_middleware(request: web.Request, handler: Handler) -> web.StreamResponse:
    """431 for an oversized header block, before any work below."""
    settings = request.app["settings"]
    limit = settings.max_header_bytes
    if limit:
        total = sum(len(k) + len(v) for k, v in request.raw_headers)
        if total > limit:
            return web.json_response({"detail": f"Request headers exceed {limit} bytes"},
                                     status=431)
    if settings.max_header_count and len(request.raw_headers) > settings.max_header_count:
        return web.json_response(
            {"detail": f"More than {settings.max_header_count} header fields"}, status=431)
    if settings.max_header_field_bytes:
        for key, value in request.raw_headers:
            if len(key) + len(value) > settings.max_header_field_bytes:
                return web.json_response(
                    {"detail": f"Header field exceeds {settings.max_header_field_bytes} bytes"},
                    status=431)
    return await handler(request)


@web.middleware
async def error_middleware(request: web.Request, handler: Handler) -> web.StreamResponse:
    """Map errors to HTTP codes; never leak stack traces."""
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except NotFoundError as exc:
        return web.json_response({"detail": str(exc)}, status=404)
    except ConflictError as exc:
        return web.json_response({"detail": str(exc)}, status=409)
    except (ValidationFailure, ValueError) as exc:
        return web.json_response({"detail": str(exc)}, status=422)
    except AuthError as exc:
        return web.json_response({"detail": str(exc)}, status=401,
                                 headers={"www-authenticate": "Bearer"})
    except PermissionDenied as exc:
        return web.json_response({"detail": str(exc)}, status=403)
    except Exception as exc:
        request.app.logger.exception("Unhandled error on %s", request.path)
        return web.json_response({"detail": f"Internal error: {type(exc).__name__}"},
                                 status=500)


@web.middleware
async def protocol_version_middleware(request: web.Request,
                                      handler: Handler) -> web.StreamResponse:
    """400 for an ``MCP-Protocol-Version`` the gateway does not speak, on the
    MCP surfaces, instead of undefined behaviour deeper in."""
    version = request.headers.get("mcp-protocol-version")
    if version and request.path.startswith(("/mcp", "/servers", "/rpc")):
        supported = request.app["settings"].supported_protocol_versions
        if version not in supported:
            return web.json_response(
                {"detail": f"Unsupported MCP protocol version {version!r};"
                           f" supported: {sorted(supported)}"}, status=400)
    return await handler(request)


class RateLimiter:
    """A token bucket per client. The bucket dict is kept in recency order
    (``allow`` re-inserts the key), so overflow eviction pops from the front
    in O(evictions)."""

    # a bucket that would refill to full is the same as a fresh one, so it
    # can be pruned without loss: address churn cannot grow the dict
    _SWEEP_INTERVAL = 60.0

    def __init__(self, rps: int, burst: int, max_buckets: int = 100_000) -> None:
        self.rps = rps
        self.burst = burst
        self.max_buckets = max_buckets
        self._buckets: dict[str, tuple[float, float]] = {}  # key -> (tokens, last)
        self._next_sweep = time.monotonic() + self._SWEEP_INTERVAL

    def _sweep(self, now: float) -> None:
        self._buckets = {
            k: (tokens, last) for k, (tokens, last) in self._buckets.items()
            if tokens + (now - last) * self.rps < self.burst}
        self._next_sweep = now + self._SWEEP_INTERVAL

    def allow(self, key: str) -> bool:
        if self.rps <= 0:
            return True
        now = time.monotonic()
        if now >= self._next_sweep:
            self._sweep(now)
        entry = self._buckets.pop(key, None)  # re-insert: recency order
        tokens, last = entry if entry is not None else (float(self.burst), now)
        tokens = min(self.burst, tokens + (now - last) * self.rps)
        allowed = tokens >= 1.0
        self._buckets[key] = (tokens - 1.0 if allowed else tokens, now)
        while len(self._buckets) > self.max_buckets:
            # oldest first: iteration order is recency order here
            del self._buckets[next(iter(self._buckets))]
        return allowed


@web.middleware
async def rate_limit_middleware(request: web.Request, handler: Handler) -> web.StreamResponse:
    limiter: RateLimiter = request.app["rate_limiter"]
    key = request.get("client_ip") or request.remote or "unknown"
    if not limiter.allow(key):
        return web.json_response({"detail": "Rate limit exceeded"}, status=429,
                                 headers={"retry-after": "1"})
    return await handler(request)


async def _handle_as_tenant(request: web.Request, handler: Handler) -> web.StreamResponse:
    """The rest of the chain under the principal's resolved tenant."""
    tenant = resolve_tenant(request.get("auth"))
    request["tenant"] = tenant
    token = set_current_tenant(tenant)
    try:
        return await handler(request)
    finally:
        reset_current_tenant(token)


@web.middleware
async def auth_middleware(request: web.Request, handler: Handler) -> web.StreamResponse:
    """``request["auth"]`` from the plugins' ``http_auth_resolve_user``
    hooks, else a Bearer JWT or Basic credentials through
    ``app["auth_service"]``; an anonymous admin when ``auth_required`` is
    off; else ``AuthError``. The plugins' ``http_pre_request`` hooks run
    after it."""
    if (request.method == "OPTIONS" or request.path in PUBLIC_PATHS
            or request.path.startswith("/auth/sso/")
            # well-known files are public discovery surface, the gateway's
            # and each virtual server's
            or request.path.startswith("/.well-known/")
            or (request.path.startswith("/servers/")
                and request.path.endswith("/.well-known/mcp"))):
        request["auth"] = AuthContext(user="anonymous", via="anonymous")
        return await _handle_as_tenant(request, handler)
    settings = request.app["settings"]
    auth_service = request.app["auth_service"]
    pm = request.app.get("plugin_manager")
    # header parsing and the database-backed lookups charge "auth"; the
    # plugin hooks inside charge "plugins" (self time)
    with request_phases.phase("auth"):
        header = request.headers.get(settings.auth_header_name, "")
        auth = (await pm.http_auth_resolve_user(dict(request.headers))
                if pm is not None else None)
        if auth is None:
            if header.lower().startswith("bearer "):
                auth = await auth_service.resolve_bearer(header[7:].strip())
            elif header.lower().startswith("basic "):
                try:
                    decoded = base64.b64decode(header[6:].strip()).decode()
                except (binascii.Error, ValueError) as exc:
                    raise AuthError("Malformed basic credentials") from exc
                username, _, password = decoded.partition(":")
                auth = await auth_service.resolve_basic(username, password)
            elif not settings.auth_required:
                auth = AuthContext(user="anonymous", is_admin=True, via="anonymous")
            else:
                raise AuthError("Authentication required")
        request["auth"] = auth
    if pm is not None:
        await pm.http_pre_request(request.method, request.path, dict(request.headers),
                                  user=auth.user)
    return await _handle_as_tenant(request, handler)


@web.middleware
async def csrf_middleware(request: web.Request, handler: Handler) -> web.StreamResponse:
    """CSRF protection of the ambient-credential surface; runs after auth.
    A Bearer request is exempt (a cross-site page cannot attach a token it
    does not hold); Basic and cookie credentials ride along with any
    browser request, so an unsafe method must prove same-origin provenance:
    a declared cross-site browser request (``Sec-Fetch-Site``, a foreign
    ``Origin``) is a 403, and with the ``csrf_token`` cookie present the
    ``X-CSRF-Token`` header must echo it and verify (double submit)."""
    from ..services import csrf_service

    settings = request.app["settings"]
    if (not settings.csrf_enabled or request.method in csrf_service.SAFE_METHODS
            or request.path in PUBLIC_PATHS):
        return await handler(request)
    for exempt in settings.csrf_exempt_paths:
        if request.path == exempt or request.path.startswith(exempt.rstrip("/") + "/"):
            return await handler(request)
    auth = request.get("auth")
    header = request.headers.get(settings.auth_header_name, "")
    if header.lower().startswith("bearer ") or auth is None or auth.via == "anonymous":
        return await handler(request)
    host = request.headers.get("host", "")
    if csrf_service.browser_cross_site(request.headers, host, settings.csrf_trusted_origins):
        return web.json_response(
            {"detail": "CSRF validation failed", "code": "CSRF_CROSS_SITE"}, status=403)
    if settings.csrf_check_referer and not (
            request.headers.get("origin") or request.headers.get("referer")
            or request.headers.get("sec-fetch-site")):
        # fail closed: ambient-credential mutations must declare provenance
        return web.json_response(
            {"detail": "CSRF validation failed", "code": "CSRF_NO_PROVENANCE"}, status=403)
    cookie = request.cookies.get(settings.csrf_cookie_name)
    if cookie:
        echoed = request.headers.get(settings.csrf_header_name, "")
        if not echoed or not hmac.compare_digest(echoed, cookie) \
                or not csrf_service.validate(echoed, auth.user, settings.jwt_secret_key):
            return web.json_response(
                {"detail": "CSRF validation failed", "code": "CSRF_TOKEN_INVALID"}, status=403)
    return await handler(request)


@web.middleware
async def password_change_middleware(request: web.Request,
                                     handler: Handler) -> web.StreamResponse:
    """Forced password rotation: an interactive identity whose
    ``password_change_required`` flag is set reaches only ``/auth/password``
    until it rotates. API tokens are exempt. The flag rides ``AuthContext``
    (read in resolve_*'s users row), so this layer runs no query."""
    settings = request.app["settings"]
    if not settings.password_change_enforcement_enabled:
        return await handler(request)
    auth = request.get("auth")
    if (auth is None or auth.via == "anonymous" or auth.token_jti or auth.scoped
            or request.path in PUBLIC_PATHS or request.path == "/auth/password"):
        return await handler(request)
    if auth.password_change_required:
        return web.json_response(
            {"detail": "Password change required before further access",
             "code": "PASSWORD_CHANGE_REQUIRED", "change_url": "/auth/password"}, status=403)
    return await handler(request)


@web.middleware
async def token_usage_middleware(request: web.Request, handler: Handler) -> web.StreamResponse:
    """A ``token_usage_logs`` row for each request made with an API token:
    endpoint, status, latency, client; 401/403/429 marked blocked. A
    refused token's jti is read from its unverified payload and confirmed
    against the catalog, so a forged token cannot write rows."""
    settings = request.app["settings"]
    if not settings.token_usage_logging_enabled:
        return await handler(request)
    started = time.monotonic()
    response = await handler(request)
    auth = request.get("auth")
    jti = auth.token_jti if auth is not None else None
    user_email = auth.user if auth is not None else None
    if jti is None and response.status in (401, 403):
        # refused before an identity existed: identify (not trust) the token
        header = request.headers.get(settings.auth_header_name, "")
        if header.lower().startswith("bearer "):
            from ..utils import jwt as jwt_utils
            payload = jwt_utils.decode_unverified(header[7:].strip())
            candidate = (payload or {}).get("jti")
            if candidate:
                row = await request.app["ctx"].db.fetchone(
                    "SELECT jti, user_email FROM api_tokens WHERE jti=?", (candidate,))
                if row:
                    # the catalog's owner: the unverified sub is the caller's
                    jti = row["jti"]
                    user_email = row["user_email"]
    if jti is not None:
        # "blocked" is a security denial; routine 404s and 400s are traffic
        blocked = response.status in (401, 403, 429)
        row_values = (
            jti, user_email, time.time(), request.method, request.path, response.status,
            round((time.monotonic() - started) * 1000, 2),
            request.get("client_ip", request.remote),
            request.headers.get("user-agent", "")[:256],
            1 if blocked else 0, f"http_{response.status}" if blocked else None)

        async def _record() -> None:
            try:
                await request.app["ctx"].db.execute(
                    "INSERT INTO token_usage_logs (token_jti, user_email,"
                    " ts, method, path, status, response_ms, client_ip,"
                    " user_agent, blocked, block_reason)"
                    " VALUES (?,?,?,?,?,?,?,?,?,?,?)", row_values)
            except Exception:  # accounting never breaks serving
                request.app.logger.debug("token usage write failed", exc_info=True)

        # off the answer's path; the set (made before the app froze) holds
        # the tasks and is drained before the database closes
        tasks: set = request.app["_token_usage_tasks"]
        task = asyncio.ensure_future(_record())
        tasks.add(task)
        task.add_done_callback(tasks.discard)
    return response


@web.middleware
async def request_logging_middleware(request: web.Request,
                                     handler: Handler) -> web.StreamResponse:
    """At DEBUG, each request's body with its sensitive values masked, and
    each answer's status; an audit row for each successful mutation."""
    logger = request.app.logger
    if logger.isEnabledFor(logging.DEBUG):
        from ..utils.masking import mask_text
        body = await request.text() if request.can_read_body else ""
        logger.debug("req %s %s %s", request.method, request.path,
                     mask_text(body[:4096]) if body else "")
    response = await handler(request)
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug("resp %s %s -> %s", request.method, request.path, response.status)
    # the audit trail: successful mutations of the REST surface
    audit = request.app.get("audit_service")
    if (audit is not None and request.method in ("POST", "PUT", "DELETE")
            and 200 <= response.status < 300
            and not request.path.startswith(("/rpc", "/mcp", "/messages", "/v1/", "/llmchat"))):
        auth = request.get("auth")
        await audit.record(auth.user if auth else None, f"{request.method} {request.path}",
                           details={"status": response.status})
    return response


@web.middleware
async def db_query_logging_middleware(request: web.Request,
                                      handler: Handler) -> web.StreamResponse:
    """With ``db_query_logging``, the statements the handler ran (innermost:
    the layers above are not counted): X-DB-Query-Count and
    X-DB-Query-Time-MS, a warning per statement slower than
    ``db_query_logging_slow_ms`` and one for each statement shape repeated
    ``db_query_n1_threshold`` times or more (a possible N+1)."""
    settings = request.app["settings"]
    if not settings.db_query_logging:
        return await handler(request)
    from ..db.core import query_log_capture
    with query_log_capture() as queries:
        response = await handler(request)
    if not queries:
        return response
    logger = request.app.logger
    total_ms = sum(ms for _, ms in queries)
    response.headers["X-DB-Query-Count"] = str(len(queries))
    response.headers["X-DB-Query-Time-MS"] = f"{total_ms:.2f}"
    for sql, ms in queries:
        if ms >= settings.db_query_logging_slow_ms:
            logger.warning("slow query (%.1f ms) on %s %s: %s",
                           ms, request.method, request.path, sql[:300])
    shapes: dict[str, int] = {}
    for sql, _ in queries:
        shapes[sql] = shapes.get(sql, 0) + 1
    suspects = {sql: n for sql, n in shapes.items() if n >= settings.db_query_n1_threshold}
    if suspects:
        logger.warning("possible N+1 on %s %s: %s", request.method, request.path,
                       "; ".join(f"{n}x {sql[:160]}" for sql, n in suspects.items()))
    else:
        logger.debug("%s %s ran %d queries in %.2f ms", request.method,
                     request.path, len(queries), total_ms)
    return response


# outermost first: observability sees every response (errors included); the
# recorder sits just inside it, so a disconnect's CancelledError, re-raised
# one layer down, still gets a row; token_usage sits outside error
# translation, so a refused token shows as a status; error_middleware sits
# outside the rate limit and auth, so AuthError maps to a status; csrf and
# password_change need the resolved identity; db_query_logging is
# innermost, so it counts the handler's statements only
MIDDLEWARES = [
    observability_middleware,
    flight_recorder_middleware,
    client_disconnect_middleware,
    forwarded_middleware,
    host_validation_middleware,
    cors_middleware,
    compression_middleware,
    security_headers_middleware,
    deprecation_middleware,
    header_size_middleware,
    token_usage_middleware,
    error_middleware,
    protocol_version_middleware,
    rate_limit_middleware,
    auth_middleware,
    csrf_middleware,
    password_change_middleware,
    request_logging_middleware,
    db_query_logging_middleware,
]
