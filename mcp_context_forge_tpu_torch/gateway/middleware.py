"""The aiohttp middlewares of the port's app: the part of the JAX
package's ``gateway/middleware.py`` chain that the /v1 surface needs, in
the reference's order (``MIDDLEWARES``, outermost first):

- ``observability_middleware``: a correlation id and the ``http.request``
  span, through the app's tracer (``app["tracer"]``); with a registry in
  ``app["metrics"]``, ``http_requests`` counted and ``http_duration``
  observed under the clamped tenant label, with the trace's exemplar;
- ``flight_recorder_middleware``: a ``PhaseClock`` per request, whose
  vector (the ``handler`` or ``error`` residue included) sums to the
  request's wall and lands as a ``gw.phases`` event on the span and, with
  ``app["flight_recorder"]``, as a row of the recorder's rings;
  X-Queue-Depth and Retry-After on the unary /v1 responses;
- ``error_middleware``: ``NotFoundError`` -> 404, ``ConflictError`` -> 409,
  ``ValidationFailure`` and ``ValueError`` -> 422, ``AuthError`` -> 401 with
  ``www-authenticate: Bearer``, ``PermissionDenied`` -> 403, anything else
  -> 500 without a trace;
- ``auth_middleware``: ``request["auth"]`` from the plugins'
  ``http_auth_resolve_user`` hooks when ``app["plugin_manager"]`` is set,
  else from the Authorization header (``gateway/auth.py``), then the
  plugins' ``http_pre_request`` hooks; public paths (``/.well-known/*``
  and a server's ``/.well-known/mcp`` among them) and OPTIONS pass as
  anonymous; the rest of the chain runs under the principal's tenant
  (``request["tenant"]`` and the port's ``set_current_tenant``).

``request.app["settings"]`` is duck-typed as the gateway's settings.
"""

from __future__ import annotations

import asyncio
import time
import uuid
from typing import Awaitable, Callable

from aiohttp import web

from ..observability import (ANONYMOUS, reset_current_tenant, resolve_tenant,
                             set_current_tenant)
from ..observability import phases as request_phases
from ..observability.tracing import current_span
from ..services.base import ConflictError, NotFoundError, ValidationFailure
from .auth import AuthContext, AuthError, PermissionDenied, resolve_header
from .flight_recorder import backpressure_headers, queue_state

Handler = Callable[[web.Request], Awaitable[web.StreamResponse]]

PUBLIC_PATHS = {"/health", "/ready", "/version", "/auth/login", "/robots.txt",
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
                error=error, client_disconnected=disconnected)
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
    hooks, else a Bearer JWT or Basic credentials; an anonymous admin when
    ``auth_required`` is off; else ``AuthError``. The plugins'
    ``http_pre_request`` hooks run after it."""
    if (request.method == "OPTIONS" or request.path in PUBLIC_PATHS
            # well-known files are public discovery surface, the gateway's
            # and each virtual server's
            or request.path.startswith("/.well-known/")
            or (request.path.startswith("/servers/")
                and request.path.endswith("/.well-known/mcp"))):
        request["auth"] = AuthContext(user="anonymous", via="anonymous")
        return await _handle_as_tenant(request, handler)
    settings = request.app["settings"]
    pm = request.app.get("plugin_manager")
    # the plugin hooks inside charge "plugins" (self time), the rest "auth"
    with request_phases.phase("auth"):
        auth = (await pm.http_auth_resolve_user(dict(request.headers))
                if pm is not None else None)
        if auth is None:
            auth = resolve_header(settings, request.headers.get(settings.auth_header_name, ""))
        request["auth"] = auth
    if pm is not None:
        await pm.http_pre_request(request.method, request.path, dict(request.headers),
                                  user=auth.user)
    return await _handle_as_tenant(request, handler)


# outermost first: observability sees every response (errors included),
# and error_middleware sits outside auth so AuthError maps to a status
MIDDLEWARES = [
    observability_middleware,
    flight_recorder_middleware,
    error_middleware,
    auth_middleware,
]
