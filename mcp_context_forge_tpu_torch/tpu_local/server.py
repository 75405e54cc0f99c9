"""The OpenAI-compatible /v1 surface over the port's engine (a standalone
copy of the JAX package's ``tpu_local/server.py`` routes, and of the
single-engine branch of its gateway app).

``setup_llm_routes`` binds ``POST /chat/completions`` (unary and SSE),
``POST /embeddings``, ``GET /models`` and ``POST /moderations`` under a
prefix. The routes consult the gateway's pieces when the app carries
them: ``request["auth"]`` (``require("llm.chat")``),
``app["overload_shedder"]``, ``app["phase_clock"]`` (``.phase(name)``
context managers) and ``app["current_span"]`` (a callable returning the
request's span or None).

``build_llm_app`` builds an aiohttp app that serves them from a
``TorchEngine`` configured by the gateway's settings, or from an
``EnginePool`` of such engines when ``tpu_local_replicas`` > 1, as the JAX
gateway does (with the pool, ``setup_pool_routes`` adds its admin card and
actions): the observability plane (the metrics registry, the tenant clamp
and ledger, the distributed tenant limiter, the SLO evaluator and its fleet
twin, exemplars and the trace store; ``setup_observability_routes``), the
middlewares of ``gateway/middleware.py`` (the ``http.request``
span, the phase clock, error mapping, authentication, so that
``request["auth"]`` is always set), the overload shedder, the signal
bus, the fault plane and, with ``controller_enabled``, the serving
controller. ``tpu_local_mesh_shape`` (with ``tpu_local_sp_impl`` and
``tpu_local_sp_threshold``) reaches the engine through
``EngineConfig.from_settings``: "1xN" serves on N GPUs, one process each
(``ranks.py``), also as the shared plane's owner. Each app is a worker of the coordination layer (a bus RPC seam
and a heartbeat lease): with ``tpu_local_pool_shared`` its engine is the
shared engine plane's (one owner elected among the workers builds it, the
others forward), and ``setup_fabric_routes`` serves the prefix-cache
fabric's ``/admin/fabric/adverts`` exchange.

``setup_operator_routes`` serves the JAX gateway's operator routes
(health, readiness, version, the log ring, the engine's stats and steps,
the flight recorder's rings and the profiler capture). ``setup_mcp_routes``
serves the MCP tools/call path: ``POST /rpc``, the streamable-HTTP ``/mcp``
and ``/servers/{server_id}/mcp`` (with sampling and completion) and the
elicit route, beside the catalog routes of ``gateway/routers.py``, the
``/llmchat`` agent of ``gateway/routers_chat.py`` and the ``/a2a`` and
``/toolops`` routes of ``gateway/routers_extra.py``. ``run`` serves the app
on a port (``cli.py serve``).

aiohttp is imported here, by the gateway's routers, middlewares and
transport, by ``translate.py`` (and, when they post, by the OTLP exporter's
``aiohttp_post``, the fabric publisher's peer client and the REST tools'
shared session), nowhere else in the port.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import logging
import math
import os
import tempfile
from typing import Any

from aiohttp import web

from ..gateway.flight_recorder import (backpressure_headers, queue_state,
                                       retry_after_s)
from ..gateway.serialize import SSE_DONE, sse_event
from ..observability.trace_store import stitch_waterfall
from ..services.base import NotFoundError
from .provider import LLMError, LLMProviderRegistry, LLMUnavailable


def _phase(request: web.Request, name: str):
    clock = request.app.get("phase_clock")
    return clock.phase(name) if clock is not None else contextlib.nullcontext()


def _require(request: web.Request, permission: str) -> None:
    auth = request.get("auth")
    if auth is not None:
        auth.require(permission)


def _queue_state(request: web.Request) -> dict[str, Any] | None:
    """Engine admission state for the backpressure headers, when the
    settings enable them."""
    if not request.app["settings"].gw_backpressure_headers:
        return None
    return queue_state(request.app)


def _estimate_tokens(body: dict) -> float:
    """Admission-time token estimate for the shedder's quota debit: ~4
    characters per prompt token, the chat template's per-message overhead
    (erring high) and the completion budget."""
    try:
        messages = [m for m in body.get("messages", []) if isinstance(m, dict)]
        prompt_chars = sum(len(str(m.get("content", ""))) for m in messages)
        overhead = 8.0 + 6.0 * len(messages)
        return prompt_chars / 4.0 + overhead + float(body.get("max_tokens") or 16)
    except (TypeError, ValueError):
        return 1.0


def setup_llm_routes(app: web.Application, registry: LLMProviderRegistry,
                     prefix: str = "/v1") -> None:
    routes = web.RouteTableDef()

    def _count_error(request: web.Request) -> None:
        """Resolution and validation failures never reach the provider's
        counters. The model label is fixed: the name is client-supplied."""
        metrics = request.app.get("metrics")
        if metrics is not None:
            metrics.llm_requests.labels(model="unresolved", status="error").inc()

    def _unavailable_response(request: web.Request,
                              exc: LLMUnavailable) -> web.Response:
        """503 + Retry-After, scaled with live saturation when the queue
        state is readable, floored at the exception's own advisory."""
        state = queue_state(request.app)
        retry_in = exc.retry_after_s
        headers = {}
        if state is not None:
            headers["X-Queue-Depth"] = str(state["depth"])
            retry_in = max(retry_in, retry_after_s(state["saturation"]))
        headers["Retry-After"] = str(retry_in)
        _count_error(request)
        return web.json_response(
            {"error": {"message": str(exc), "type": "overloaded_error",
                       "code": 503, "retry_after_s": retry_in}},
            status=503, headers=headers)

    async def _shed_response(request: web.Request,
                             body: dict) -> web.Response | None:
        """The overload shedder's admission verdict (429 + Retry-After),
        when the app carries one."""
        shedder = request.app.get("overload_shedder")
        if shedder is None:
            return None
        state = queue_state(request.app)
        verdict = await shedder.decide_admission(
            (state or {}).get("saturation", 0.0), request.get("tenant") or "",
            est_tokens=_estimate_tokens(body))
        if verdict is None:
            return None
        headers = {"Retry-After": str(verdict["retry_after_s"])}
        if state is not None:
            headers["X-Queue-Depth"] = str(state["depth"])
        _count_error(request)
        return web.json_response(
            {"error": {"message": "request shed under overload "
                       f"({verdict['reason']}); retry after "
                       f"{verdict['retry_after_s']}s",
                       "type": "overloaded_error", "code": 429,
                       "reason": verdict["reason"],
                       "slo_class": verdict["slo_class"],
                       "retry_after_s": verdict["retry_after_s"]}},
            status=429, headers=headers)

    async def _stream(request: web.Request, body: dict) -> web.StreamResponse:
        with _phase(request, "routing"):
            registry.resolve(body.get("model"))  # fail before the stream starts
        # the first chunk is awaited before prepare(), for a bounded window:
        # a refusal (LLMUnavailable) gets a clean 503 + Retry-After, while a
        # long time to first token does not hold back the headers
        chunks = registry.chat_stream(body).__aiter__()
        first_task = asyncio.ensure_future(chunks.__anext__())
        try:
            first = None
            first_pending = True
            wait_s = request.app["settings"].gw_stream_first_chunk_wait_s
            if wait_s > 0:
                with _phase(request, "engine"):
                    done, _ = await asyncio.wait({first_task}, timeout=wait_s)
                if done:
                    first_pending = False
                    try:
                        first = first_task.result()  # LLMUnavailable -> 503
                    except StopAsyncIteration:
                        first = None
            headers = {"content-type": "text/event-stream",
                       "cache-control": "no-store"}
            # a streamed response's headers are fixed once sent
            headers.update(backpressure_headers(_queue_state(request),
                                                request.app["settings"]))
            resp = web.StreamResponse(headers=headers)
            await resp.prepare(request)
            try:
                chunk = first
                if first_pending:
                    # headers are out: a refusal now lands as an error event
                    with _phase(request, "engine"):
                        try:
                            chunk = await first_task
                        except StopAsyncIteration:
                            chunk = None
                while chunk is not None:
                    with _phase(request, "serialize"):
                        await resp.write(sse_event(chunk))
                    with _phase(request, "engine"):
                        try:
                            chunk = await chunks.__anext__()
                        except StopAsyncIteration:
                            chunk = None
                await resp.write(SSE_DONE)
            except Exception as exc:
                # a second response cannot start once prepare() has run
                await resp.write(sse_event(
                    {"error": {"message": f"{type(exc).__name__}: {exc}"}}))
            await resp.write_eof()
            return resp
        finally:
            # the prefetch must never leak a generation: cancel it, mark any
            # exception retrieved, and close the provider stream so the
            # engine stops generating for a client that is gone
            if not first_task.done():
                first_task.cancel()
            elif not first_task.cancelled():
                first_task.exception()
            try:
                await chunks.aclose()
            except Exception:
                pass

    @routes.post(f"{prefix}/chat/completions")
    async def chat_completions(request: web.Request) -> web.StreamResponse:
        _require(request, "llm.chat")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": {"message": "invalid JSON"}}, status=400)
        if not isinstance(body.get("messages"), list) or not body["messages"]:
            return web.json_response(
                {"error": {"message": "messages must be a non-empty list"}}, status=422)
        shed = await _shed_response(request, body)
        if shed is not None:
            return shed
        current_span = request.app.get("current_span")
        span = current_span() if current_span is not None else None
        if span is not None:
            span.set_attribute("gen_ai.operation.name", "chat")
            span.set_attribute("gen_ai.request.model", body.get("model") or "")
            span.set_attribute("llm.stream", bool(body.get("stream")))
        try:
            if body.get("stream"):
                return await _stream(request, body)
            with _phase(request, "engine"):
                result = await registry.chat(body)
            with _phase(request, "serialize"):
                return web.json_response(result)
        except LLMUnavailable as exc:
            return _unavailable_response(request, exc)
        except LLMError as exc:
            _count_error(request)
            return web.json_response({"error": {"message": str(exc),
                                                "type": "invalid_request_error"}},
                                     status=404)

    @routes.post(f"{prefix}/embeddings")
    async def embeddings(request: web.Request) -> web.Response:
        _require(request, "llm.chat")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": {"message": "invalid JSON"}}, status=400)
        texts = body.get("input", [])
        if isinstance(texts, str):
            texts = [texts]
        if not texts or not all(isinstance(t, str) for t in texts):
            return web.json_response(
                {"error": {"message": "input must be a string or list of strings"}},
                status=422)
        try:
            vectors = await registry.embed(texts, model=body.get("model"))
        except LLMError as exc:
            return web.json_response({"error": {"message": str(exc)}}, status=404)
        return web.json_response({
            "object": "list",
            "data": [{"object": "embedding", "index": i, "embedding": vec}
                     for i, vec in enumerate(vectors)],
            "model": body.get("model") or "tpu_local-encoder",
            "usage": {"prompt_tokens": sum(len(t.split()) for t in texts),
                      "total_tokens": sum(len(t.split()) for t in texts)},
        })

    @routes.get(f"{prefix}/models")
    async def models(request: web.Request) -> web.Response:
        return web.json_response({"object": "list", "data": registry.list_models()})

    @routes.post(f"{prefix}/moderations")
    async def moderations(request: web.Request) -> web.Response:
        """OpenAI-compatible moderation backed by the classifier head."""
        _require(request, "llm.chat")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return web.json_response({"error": {"message": "invalid JSON"}}, status=400)
        texts = body.get("input", [])
        if isinstance(texts, str):
            texts = [texts]
        try:
            scores = await registry.classify(texts)
        except LLMError as exc:
            return web.json_response({"error": {"message": str(exc)}}, status=404)
        return web.json_response({
            "id": "modr-tpu",
            "model": "tpu_local-moderation",
            "results": [{
                "flagged": score >= 0.5,
                "category_scores": {"harmful": score},
                "categories": {"harmful": score >= 0.5},
            } for score in scores],
        })

    app.add_routes(routes)


def _shed_class_order(settings) -> list[str]:
    """``gw_shed_class_order`` (a JSON array of class names, lowest first)."""
    if not settings.gw_shed_class_order:
        return []
    try:
        order = json.loads(settings.gw_shed_class_order)
    except json.JSONDecodeError as exc:
        raise ValueError(f"invalid gw_shed_class_order JSON: {exc}") from exc
    if not isinstance(order, list):
        raise ValueError("gw_shed_class_order must be a JSON array of class "
                         "names, lowest first")
    return order


def setup_pool_routes(app: web.Application) -> None:
    """``GET /admin/engine/pool`` (the pool's status card; needs
    ``observability.read``) and ``POST /admin/engine/pool/{replica}/{action}``
    (``drain``, ``undrain``, ``reload`` with an optional body
    ``{"timeout_s": n}``, ``role`` with ``{"role": "prefill|decode|any"}``;
    needs ``admin.all``, since a reload rebuilds the weights). Without a pool
    (``app["tpu_engine_pool"]`` None) both answer 404; an unknown replica is
    a 404, a bad action or body a 422."""
    routes = web.RouteTableDef()

    def _no_pool() -> web.Response:
        return web.json_response(
            {"detail": "engine replica pool is not enabled "
                       "(set MCPFORGE_TPU_LOCAL_REPLICAS > 1)"}, status=404)

    def _invalid(message: str) -> web.Response:
        return web.json_response({"detail": message}, status=422)

    @routes.get("/admin/engine/pool")
    async def engine_pool_status(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        pool = request.app.get("tpu_engine_pool")
        if pool is None:
            return _no_pool()
        return web.json_response(pool.status())

    @routes.post("/admin/engine/pool/{replica}/{action}")
    async def engine_pool_action(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        pool = request.app.get("tpu_engine_pool")
        if pool is None:
            return _no_pool()
        action = request.match_info["action"]
        rid = request.match_info["replica"]
        body = {}
        if request.can_read_body:
            try:
                body = await request.json()
            except json.JSONDecodeError:
                return _invalid("body must be JSON")
        if not isinstance(body, dict):   # valid JSON but e.g. [30] or "60"
            return _invalid("body must be a JSON object")
        try:
            timeout_s = float(body.get("timeout_s", 60.0))
        except (TypeError, ValueError):
            return _invalid("timeout_s must be a number")
        try:
            if action == "drain":
                result = await pool.drain(rid, timeout_s=timeout_s)
            elif action == "undrain":
                result = await pool.undrain(rid)
            elif action == "reload":
                result = await pool.reload(rid, timeout_s=timeout_s)
            elif action == "role":
                role = body.get("role")
                if not isinstance(role, str) or not role:
                    return _invalid('role action needs a body {"role": '
                                    '"prefill|decode|any"}')
                result = pool.set_role(rid, role)
            else:
                return _invalid(f"action must be drain|undrain|reload|role, "
                                f"got {action!r}")
        except KeyError as exc:
            return web.json_response({"detail": str(exc)}, status=404)
        except ValueError as exc:
            return _invalid(str(exc))
        return web.json_response(result)

    app.add_routes(routes)


def _detail(message: str, status: int) -> web.Response:
    return web.json_response({"detail": message}, status=status)


def _query_limit(request: web.Request, default: str) -> int | None:
    """``?limit=`` clamped to 1..1024; None when it is not an integer."""
    try:
        return max(1, min(int(request.query.get("limit", default)), 1024))
    except ValueError:
        return None


def setup_fabric_routes(app: web.Application) -> None:
    """The prefix-cache fabric's HTTP peer exchange (the JAX gateway's
    ``routers_extra.py`` routes) over ``app["fabric_publisher"]``:
    ``POST /admin/fabric/adverts`` (needs ``admin.all``) merges a peer's
    advert batch and answers with this host's adverts, 404 without an
    object tier, 422 for a body that is not an advert batch;
    ``GET /admin/fabric/adverts`` (needs ``observability.read``) answers
    the publisher's counters and the tier store's stats."""
    routes = web.RouteTableDef()

    @routes.post("/admin/fabric/adverts")
    async def fabric_adverts_exchange(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        publisher = request.app.get("fabric_publisher")
        if publisher is None or publisher.store is None \
                or getattr(publisher.store, "object_store", None) is None:
            return _detail("prefix-cache fabric is not enabled "
                           "(set MCPFORGE_TPU_LOCAL_TIER_OBJECT_URL)", 404)
        try:
            body = await request.json()
        except json.JSONDecodeError as exc:
            return _detail(f"invalid JSON: {exc}", 422)
        if not isinstance(body, dict):
            return _detail("body must be an advert batch object", 422)
        try:
            reply = await publisher.handle_advert(body)
        except ValueError as exc:
            return _detail(str(exc), 422)
        return web.json_response(reply)

    @routes.get("/admin/fabric/adverts")
    async def fabric_adverts_status(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        publisher = request.app.get("fabric_publisher")
        if publisher is None:
            return _detail("prefix-cache fabric is not wired", 404)
        payload = publisher.stats()
        store = publisher.store
        payload["store"] = store.stats() if store is not None else None
        return web.json_response(payload)

    app.add_routes(routes)


def setup_observability_routes(app: web.Application) -> None:
    """The observability plane's routes (the JAX gateway's), each answering
    ``{"detail": ...}`` with 404 where its piece is not wired:

    - ``GET /metrics/prometheus``: ``app["metrics"]``'s exposition, OpenMetrics
      when ``Accept`` names ``application/openmetrics-text``; ``?scope=fleet``
      the merged exposition of every worker (``app["fleet_metrics"]``);
    - ``GET /admin/slo`` (``observability.read``): the SLO evaluator's report
      under the consumer window ``?window=`` (default "default"), for
      ``?tenant=`` the tenant's class on its label slice, ``?scope=fleet``
      over the fleet's summed histograms;
    - ``GET /admin/tenants/usage`` (``observability.read``): the live
      ``TenantLedger`` (``?limit=``, 422 when not an integer), the newest
      ``tenant_usage`` rows of the rollup (``rollups``) and its interval;
    - ``GET /admin/trace/{trace_id}`` (``observability.read``): the stitched
      waterfall of a trace the trace store kept, with its retention reasons."""
    routes = web.RouteTableDef()

    @routes.get("/metrics/prometheus")
    async def prometheus(request: web.Request) -> web.Response:
        if request.query.get("scope") == "fleet":
            fleet = request.app.get("fleet_metrics")
            if fleet is None:
                return _detail("fleet metrics aggregation is not enabled "
                               "(set MCPFORGE_GW_FLEET_METRICS=true)", 404)
            body, content_type = fleet.render_fleet()
        else:
            body, content_type = request.app["metrics"].render(
                accept=request.headers.get("accept", ""))
        return web.Response(body=body, headers={"Content-Type": content_type})

    @routes.get("/admin/slo")
    async def slo_status(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        fleet = request.query.get("scope") == "fleet"
        evaluator = request.app.get("slo_evaluator_fleet" if fleet else "slo_evaluator")
        if evaluator is None:
            return _detail("fleet SLO evaluation needs MCPFORGE_GW_FLEET_METRICS" if fleet
                           else "SLO evaluation is not enabled", 404)
        consumer = request.query.get("window", "default")[:64] or "default"
        tenant = request.query.get("tenant") or None
        report = evaluator.evaluate(consumer=consumer, tenant=tenant[:128] if tenant else None)
        if fleet:
            report["scope"] = "fleet"
        return web.json_response(report)

    @routes.get("/admin/tenants/usage")
    async def tenant_usage(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        ledger = request.app.get("tenant_ledger")
        if ledger is None:
            return _detail("tenant metering is disabled "
                           "(set MCPFORGE_TENANT_METERING_ENABLED=true)", 404)
        try:
            limit = int(request.query.get("limit", "64"))
        except ValueError:
            return _detail("limit must be an integer", 422)
        payload = ledger.snapshot(limit=max(1, min(limit, 1024)))
        rollup = request.app.get("tenant_usage_rollup")
        payload["rollups"] = (await rollup.recent(limit=min(limit * 2, 200))
                              if rollup is not None else [])
        payload["rollup_interval_s"] = rollup.interval_s if rollup is not None else None
        return web.json_response(payload)

    @routes.get("/admin/trace/{trace_id}")
    async def trace_waterfall(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        store = request.app.get("trace_store")
        if store is None:
            return _detail("request forensics trace store is disabled "
                           "(set MCPFORGE_TRACE_STORE_ENABLED=true)", 404)
        trace_id = request.match_info["trace_id"]
        entry = store.get(trace_id)
        if entry is None:
            return _detail(
                f"trace {trace_id} is not retained (tail sampling keeps errors, SLO "
                f"breaches, slowest-N, exemplars, and a 1-in-{store.sample_every} sample)", 404)
        pool = request.app.get("tpu_engine_pool")
        engine = request.app.get("tpu_engine")
        if pool is not None:
            engines = {r.id: r.engine for r in pool.replicas}
        else:
            engines = {engine.config.replica_id: engine} if engine is not None else {}
        waterfall = stitch_waterfall(entry["spans"], engines=engines)
        waterfall["retention"] = {k: entry[k] for k in ("reasons", "breaches", "route",
                                                        "tenant", "status", "truncated")}
        return web.json_response(waterfall)

    app.add_routes(routes)


def _profiler_or_404(request: web.Request):
    """The gate of every profiling route: ``torch_profile_enabled`` first,
    then the app's capture (made only beside a local engine)."""
    if not getattr(request.app["settings"], "torch_profile_enabled", False):
        raise NotFoundError("profiler capture is disabled "
                            "(set MCPFORGE_TORCH_PROFILE_ENABLED=true)")
    profiler = request.app.get("torch_profiler")
    if profiler is None:
        raise NotFoundError("tpu_local engine is not enabled")
    return profiler


async def _serving_ready(app: web.Application) -> tuple[bool, bool, str]:
    """(ready, leader, detail) of the engine: a local engine whose
    dispatch thread runs, a pool with a ready replica, or a shared plane
    with an elected owner. ``leader`` is whether this worker owns
    the engine it serves (the plane's owner; always, for a local engine)."""
    plane = app.get("engine_plane")
    if plane is not None:
        owner = await plane.owner()
        return owner is not None, plane.is_owner, "no engine-pool owner is elected"
    pool = app.get("tpu_engine_pool")
    if pool is not None:
        ready = any(r.state == "ready" and r.engine.dispatch_alive() for r in pool.replicas)
        return ready, True, "no replica of the pool is serving"
    engine = app.get("tpu_engine")
    return (engine is not None and engine.dispatch_alive(), True,
            "the engine's dispatch thread is not running")


def setup_operator_routes(app: web.Application) -> None:
    """The JAX gateway's operator routes, each with its permission, query
    clamps and 404 texts (``{"detail": ...}``):

    - ``GET /health``, ``GET /ready`` and ``GET /version`` (the port's
      ``__version__``), public. ``/ready`` runs ``SELECT 1`` on the app's
      database first, as the JAX gateway does, then asks the engine
      (``_serving_ready``): either failing answers 503
      ``{"status": "not ready", "detail"}``;
    - ``GET /admin/logs`` (``observability.read``): the log ring's
      ``search`` under ``?q=``, ``?level=``, ``?limit=`` (default 200);
    - ``GET /admin/engine/stats`` and ``GET /admin/engine/steps``
      (``observability.read``; ``?limit=`` 1..1024, default 64): the live
      engine's counters and ``engine_introspection``; 404 without an engine;
    - ``GET /admin/gateway/requests`` (``observability.read``; ``?limit=``
      1..1024, default 32, ``?tenant=``): the flight recorder's rings, the
      loop sampler's snapshot, the backpressure state, the degradation
      ladder's components and the shedder's total; 404 without a recorder;
    - ``POST /admin/engine/profile`` (``admin.all``; body ``{"duration_ms":
      n}``, at most 30 s): a timed capture that stops only itself;
      ``GET /admin/engine/profile/status`` (``observability.read``),
      ``POST /admin/engine/profile/start`` and ``/stop`` (``admin.all``):
      all 404 unless ``torch_profile_enabled``, 409 on a transition the
      capture refuses; start and stop run in ``asyncio.to_thread``.

    A malformed ``limit`` answers 422."""
    from .. import __version__
    from ..gateway.flight_recorder import queue_state
    from ..observability.degradation import get_degradation
    from ..observability.logging import ring_buffer
    from ..services.base import ConflictError
    from ..services.diagnostics_service import engine_introspection, live_tpu_engine
    from .parallel.mesh import mesh_shape_from_string

    routes = web.RouteTableDef()

    def _engine(request: web.Request):
        engine = live_tpu_engine(request.app)
        if engine is None:
            raise NotFoundError("tpu_local engine is not enabled")
        return engine

    @routes.get("/health")
    async def health(request: web.Request) -> web.Response:
        return web.json_response({"status": "healthy"})

    @routes.get("/ready")
    async def ready(request: web.Request) -> web.Response:
        try:
            await request.app["ctx"].db.execute("SELECT 1")
        except Exception as exc:
            return web.json_response({"status": "not ready", "detail": str(exc)}, status=503)
        serving, leader, detail = await _serving_ready(request.app)
        if not serving:
            return web.json_response({"status": "not ready", "detail": detail}, status=503)
        return web.json_response({"status": "ready", "worker_id": request.app["worker_id"],
                                  "leader": leader})

    @routes.get("/version")
    async def version(request: web.Request) -> web.Response:
        return web.json_response({"version": __version__})

    @routes.get("/admin/logs")
    async def admin_logs(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        return web.json_response(ring_buffer.search(
            query=request.query.get("q", ""), level=request.query.get("level"),
            limit=int(request.query.get("limit", "200"))))

    @routes.get("/admin/engine/stats")
    async def engine_stats(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        engine = _engine(request)
        stats, alloc = engine.stats, engine.allocator
        data, model = mesh_shape_from_string(engine.config.mesh_shape, len(engine.devices))
        return web.json_response({
            "model": engine.config.model,
            "mesh": {"data": data, "model": model},
            "requests": stats.requests,
            "prompt_tokens": stats.prompt_tokens,
            "completion_tokens": stats.completion_tokens,
            "decode_steps": stats.decode_steps,
            "decode_dispatches": stats.decode_dispatches,
            "superstep": engine.config.fused_steps,
            "prefill_batches": stats.prefill_batches,
            "prefill_requests": stats.prefill_requests,
            "queue_depth": stats.queue_depth,
            "kv_pages_in_use": alloc.pages_in_use,
            "kv_pages_free": alloc.free_pages,
            "kv_quant": engine.config.kv_quant or "off",
            "kv_bytes_in_use": engine.kv_bytes_in_use(),
            "prefill_ms_total": round(stats.prefill_ms_total, 1),
            "decode_ms_total": round(stats.decode_ms_total, 1),
            "engine_restarts": stats.engine_restarts,
            "chunking": stats.chunking,
            "prefix_cache": {
                "enabled": engine.config.prefix_cache,
                "cached_pages": alloc.cached_pages,
                "hits": alloc.prefix_hits,
                "hit_tokens": alloc.prefix_hit_tokens,
                "tiers": engine.tier_stats(),
            },
            "tier_hits_host": alloc.tier_hits["host"],
            "tier_hits_disk": alloc.tier_hits["disk"],
            "tier_hits_object": alloc.tier_hits.get("object", 0),
            "tier_hit_tokens_spilled": (alloc.tier_hit_tokens["host"]
                                        + alloc.tier_hit_tokens["disk"]
                                        + alloc.tier_hit_tokens.get("object", 0)),
            "spec_decode": {"enabled": engine.config.spec_decode,
                            "steps": stats.spec_steps, "extra_tokens": stats.spec_tokens},
        })

    @routes.get("/admin/engine/steps")
    async def engine_steps(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        engine = _engine(request)
        limit = _query_limit(request, "64")
        if limit is None:
            return _detail("limit must be an integer", 422)
        return web.json_response(engine_introspection(engine, limit=limit))

    @routes.get("/admin/gateway/requests")
    async def gateway_requests(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        recorder = request.app.get("flight_recorder")
        if recorder is None:
            raise NotFoundError("gateway flight recorder is disabled "
                                "(set MCPFORGE_GW_FLIGHT_RECORDER_ENABLED=true)")
        limit = _query_limit(request, "32")
        if limit is None:
            return _detail("limit must be an integer", 422)
        snapshot = recorder.snapshot(limit=limit, tenant=request.query.get("tenant"))
        sampler = request.app.get("loop_lag_sampler")
        snapshot["loop"] = sampler.snapshot() if sampler is not None else None
        snapshot["backpressure"] = queue_state(request.app)
        snapshot["degradation"] = get_degradation().status()["components"]
        shedder = request.app.get("overload_shedder")
        snapshot["shed_total"] = shedder.shed_total if shedder is not None else None
        return web.json_response(snapshot)

    @routes.post("/admin/engine/profile")
    async def engine_profile(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        profiler = _profiler_or_404(request)
        engine = _engine(request)
        body = await request.json() if request.can_read_body else {}
        duration_ms = min(float(body.get("duration_ms", 1000.0)), 30_000.0)
        started = (await asyncio.to_thread(profiler.start))["started_at"]
        try:
            await asyncio.sleep(duration_ms / 1000.0)
        finally:
            try:
                # stop this capture only: one an operator stopped and
                # restarted in the window is theirs
                result = await asyncio.to_thread(profiler.stop, expect_started_at=started)
            except ConflictError:
                result = {"active": profiler.active, "trace_dir": profiler.trace_dir,
                          "detail": "capture was stopped externally"}
        result.update({"duration_ms": duration_ms,
                       "decode_steps": engine.stats.decode_steps,
                       "prefill_batches": engine.stats.prefill_batches})
        return web.json_response(result)

    @routes.get("/admin/engine/profile/status")
    async def profile_status(request: web.Request) -> web.Response:
        request["auth"].require("observability.read")
        return web.json_response(_profiler_or_404(request).status())

    @routes.post("/admin/engine/profile/start")
    async def profile_start(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        profiler = _profiler_or_404(request)
        return web.json_response(await asyncio.to_thread(profiler.start))

    @routes.post("/admin/engine/profile/stop")
    async def profile_stop(request: web.Request) -> web.Response:
        request["auth"].require("admin.all")
        profiler = _profiler_or_404(request)
        return web.json_response(await asyncio.to_thread(profiler.stop))

    app.add_routes(routes)


def setup_mcp_routes(app: web.Application) -> None:
    """The MCP surface over ``app["dispatcher"]`` and
    ``app["streamable_transport"]``, as the JAX gateway mounts it:
    ``POST /rpc`` (one JSON-RPC request, at most ``max_request_size_bytes``;
    a refusal is a JSON-RPC error with status 200, a notification 202),
    ``POST``/``GET``/``DELETE /mcp`` and ``POST``/``GET
    /servers/{server_id}/mcp`` (the transport, mounted directly: the JAX
    gateway's swappable ingress is not ported), and ``POST
    /sessions/{session_id}/elicit`` (``tools.invoke``; ``{"message",
    "requestedSchema", "timeout"}`` over ``app["elicitation_service"]``: the
    client's answer, ``{"action": "cancel", "reason": "timeout"}`` after
    ``timeout`` seconds, 422 for a timeout that is not a finite number, 404
    for a session with no stream here, and 409 for a session that another
    worker owns, as the JAX gateway answers when its handoff to the owner
    is off). Every path is behind the auth middleware."""
    from ..jsonrpc import JSONRPCError, RPCRequest, parse_body

    transport = app["streamable_transport"]
    max_size = app["settings"].max_request_size_bytes

    async def handle_rpc(request: web.Request) -> web.Response:
        raw = await request.read()
        headers = {k.lower(): v for k, v in request.headers.items()}
        payload: object = None
        try:
            payload = parse_body(raw, max_size)
            rpc_request = RPCRequest.parse(payload)
            body = await request.app["dispatcher"].dispatch_bytes(
                rpc_request, request["auth"], headers=headers)
        except JSONRPCError as exc:
            rid = payload.get("id") if isinstance(payload, dict) else None
            return web.json_response(exc.to_dict(rid))
        if body is None:
            return web.Response(status=202)
        return web.Response(body=body, content_type="application/json")

    async def elicit(request: web.Request) -> web.Response:
        # the JAX route's local case: the cross-worker handoff is not
        # ported, so a session another worker owns is refused with its 409
        request["auth"].require("tools.invoke")
        body = await request.json()
        session_id = request.match_info["session_id"]
        try:
            timeout = float(body.get("timeout", 120.0))
        except (TypeError, ValueError):
            return web.json_response({"detail": "timeout must be a number"}, status=422)
        if not math.isfinite(timeout):
            return web.json_response({"detail": "timeout must be finite"}, status=422)
        ctx = request.app["ctx"]
        if transport.sessions.get(session_id) is None and \
                (await ctx.leases.holder(f"session-owner:{session_id}")) not in (
                    None, ctx.worker_id):
            return web.json_response(
                {"detail": "Session is owned by another worker; "
                           "elicit on the owning worker"}, status=409)
        result = await request.app["elicitation_service"].elicit(
            session_id, body.get("message", ""),
            requested_schema=body.get("requestedSchema"), timeout=timeout)
        return web.json_response(result)

    app.router.add_post("/rpc", handle_rpc)
    app.router.add_post("/sessions/{session_id}/elicit", elicit)
    app.router.add_post("/mcp", transport.handle_post)
    app.router.add_get("/mcp", transport.handle_get)
    app.router.add_delete("/mcp", transport.handle_delete)
    app.router.add_post("/servers/{server_id}/mcp", transport.handle_post)
    app.router.add_get("/servers/{server_id}/mcp", transport.handle_get)


def build_pool(settings, config, tracer=None, signals=None, engine_factory=None,
               metrics=None, ledger=None):
    """An ``EnginePool`` of ``settings.tpu_local_replicas`` engines of
    ``config``, with the gateway's ``tpu_local_pool_*`` settings (the JAX
    gateway's wiring); ``engine_factory`` as ``EnginePool`` takes it."""
    from .pool import EnginePool

    return EnginePool(
        config, replicas=settings.tpu_local_replicas, tracer=tracer, metrics=metrics,
        ledger=ledger, signals=signals, engine_factory=engine_factory,
        affinity_routing=getattr(settings, "tpu_local_pool_affinity_routing", True),
        health_interval_s=getattr(settings, "tpu_local_pool_health_interval_s", 0.5),
        heartbeat_timeout_s=getattr(settings, "tpu_local_pool_heartbeat_timeout_s", 10.0),
        requeue_max=getattr(settings, "tpu_local_pool_requeue_max", 2),
        roles=getattr(settings, "tpu_local_pool_roles", ""),
        disagg_prompt_tokens=getattr(settings, "tpu_local_disagg_prompt_tokens", 64),
        role_penalty_tokens=getattr(settings, "tpu_local_pool_role_penalty_tokens", 256))


def coordination_from_settings(settings) -> tuple[Any, Any, Any, Any]:
    """The bus and leases of ``settings.bus_backend`` (the JAX gateway's
    wiring): ``memory`` (one process), ``file`` (a directory,
    ``bus_dir``, shared by the workers of one host) or ``tcp`` (a hub at
    ``bus_tcp_host``:``bus_tcp_port``, which this process hosts with
    ``bus_tcp_serve``, authenticated by ``bus_tcp_secret`` or else the JWT
    secret). Returns (bus, leases, hub or None, hub client or None);
    nothing is started."""
    from ..coordination import make_bus, make_lease_manager

    backend = getattr(settings, "bus_backend", "memory")
    if backend != "tcp":
        directory = getattr(settings, "bus_dir", None)
        return make_bus(backend, directory), make_lease_manager(backend, directory), None, None
    from ..coordination.hub import CoordinationHub, HubClient, TcpEventBus, TcpLeaseManager

    secret = settings.bus_tcp_secret or settings.jwt_secret_key
    hub = None
    if settings.bus_tcp_serve:
        hub = CoordinationHub(settings.bus_tcp_host, settings.bus_tcp_port, secret=secret)
    client = HubClient(settings.bus_tcp_host, settings.bus_tcp_port, secret=secret)
    return TcpEventBus(client), TcpLeaseManager(client), hub, client


def build_llm_app(settings, engine=None, pool=None, bus=None, leases=None,
                  worker_id: str | None = None, device: str | None = None) -> web.Application:
    """An app serving the /v1 surface under ``settings.llm_api_prefix`` from
    one engine or a replica pool: ``pool``, or ``engine``, or, with
    ``tpu_local_replicas`` > 1, a pool (``build_pool``) and else one
    ``TorchEngine``, built from ``EngineConfig.from_settings(settings)``
    (weights from ``tpu_local_checkpoint``). The app's tracer, signal bus,
    metrics registry and tenant ledger go to the engines (given ones keep
    handles they already have), the registry also to the provider, the
    pool, the shedder, the degradation manager, the fault plane and the
    controller, which evaluates SLO burn with ``app["slo_evaluator"]``. With
    a pool, ``app["tpu_engine_pool"]`` is set, ``app["tpu_engine"]`` is
    replica 0's engine at build time, the provider speaks to the pool, the
    controller steers every replica's current engine, and the pool's admin
    routes are added. The engine or pool, and then the controller, start
    with the app; at its cleanup the controller stops first, then the
    provider and the engines. ``settings`` is duck-typed as the gateway's.

    Coordination: the app is worker ``worker_id`` (a fresh id by default)
    on ``bus`` and ``leases`` (by default those of the settings' backend,
    ``coordination_from_settings``, which the app then starts and stops).
    It runs a ``BusRpc`` (``app["bus_rpc"]``) and the worker's heartbeat
    lease, and registers the fabric publisher's ``fabric.advert`` method
    (``app["fabric_publisher"]``; its gossip loop runs when
    ``tpu_local_tier_object_url`` is set). With ``tpu_local_pool_shared``
    the engine is not built with the app: a ``SharedEnginePlane``
    (``app["engine_plane"]``) elects one owner among the workers, whose
    factory builds the engine or pool (or starts the given one), and the
    registry's provider is a ``SharedPoolProvider`` that forwards to the
    owner; ``app["tpu_engine"]`` and ``app["tpu_engine_pool"]`` stay None,
    and the backpressure headers read the owner's queue through the plane.

    Observability (the JAX gateway's settings and defaults, duck-typed):
    ``app["metrics"]`` (a ``PrometheusRegistry`` whose tenant labels clamp
    at ``tenant_label_clamp``, exemplars per ``metrics_exemplars``),
    ``app["tenant_ledger"]`` (``tenant_metering_enabled``) and
    ``app["tenant_usage_rollup"]``, which drains its window into the
    ``tenant_usage`` table every ``tenant_usage_rollup_interval_s``,
    ``app["tenant_limiter"]`` (``gw_distributed_limiter`` with a
    ``tenant_quota_tokens_per_window``, over the bus backend's shared
    counter), ``app["slo_evaluator"]`` (always), ``app["fleet_metrics"]``
    and ``app["slo_evaluator_fleet"]`` (``gw_fleet_metrics``) and
    ``app["trace_store"]`` (``trace_store_enabled``, a tracer sink).

    The operator plane: the root logger gets the log ring and the settings'
    format and file sink (``init_logging``); insecure settings refuse to
    build (``validate_security``); with ``otel_otlp_endpoint`` an
    ``OTLPExporter`` is a tracer sink (``app["otlp_exporter"]``); with
    ``gw_flight_recorder_enabled`` a ``FlightRecorder`` and a
    ``LoopLagSampler`` on the signal bus (``app["flight_recorder"]``,
    ``app["loop_lag_sampler"]``); beside a local engine a
    ``TorchProfilerCapture`` into ``torch_profile_dir``
    (``app["torch_profiler"]``); ``setup_operator_routes`` serves them.
    ``device`` (e.g. "cpu") replaces the engine config's device for the
    engines the app builds.

    The gateway's database and what reads it, as the JAX gateway wires them:
    ``make_database(database_url)`` (connected and migrated when the app
    starts, closed last at its cleanup; tier-1 sets ``:memory:``, and
    anything else names its own file), an ``AppContext`` in ``app["ctx"]``
    (its ``llm_registry`` the app's registry), with ``plugins_enabled`` a
    ``PluginManager`` (``app["plugin_manager"]``, also ``ctx.plugin_manager``;
    loaded at startup, then its ``plugin_bindings``), and
    ``app["llm_provider_service"]``, whose ``rewire`` wires the
    ``llm_providers`` rows into the registry at startup;
    ``gateway/routers_extra.py`` serves the provider and plugin routes.

    The MCP tools/call path, under the JAX gateway's keys in ``app`` and
    ``ctx.extras``: ``upstream_sessions`` (its sweeper runs from startup),
    ``cancellation_service``, ``tool_service`` (whose ``invoke_tool`` fires
    the plugins' tool hooks), ``gateway_service`` (its health loop runs from
    startup, gated by the ``gateway-leader`` lease of
    ``ctx.extras["leader_elector"]``), ``server_service``, ``dispatcher``
    (``RPCDispatcher``) and ``streamable_transport``, to whose stateful
    sessions each ``tools.changed`` on the bus broadcasts
    ``notifications/tools/list_changed``; ``gateway/routers.py`` and
    ``setup_mcp_routes`` serve them. ``ctx.http_client`` is built at startup
    in a worker thread; at cleanup the loops stop and the upstream sessions
    close first.

    The services that call the engine, as the JAX gateway wires them:
    ``a2a_service`` (also ``ctx.extras``: the A2A tools' route), the
    dispatcher's ``SamplingHandler`` and ``CompletionService``,
    ``chat_service`` over ``app["kv_store"]`` (a ``TcpKVStore`` on the hub
    for a tcp bus, else ``make_kv`` of the bus backend; its expired entries
    are purged every 600 s), ``toolops_service`` and
    ``elicitation_service`` (also ``ctx.extras`` and the transport's
    ``elicitation``).

    The rest of the MCP catalog and the HTTP edge, as the JAX gateway wires
    them: ``resource_service`` and ``prompt_service`` (also the
    dispatcher's), whose ``resources.changed`` and ``prompts.changed`` on
    the bus broadcast ``notifications/resources/list_changed`` and
    ``notifications/prompts/list_changed`` to the stateful sessions; with
    ``registry_cache_enabled`` a ``RegistryCache`` (``app["registry_cache"]``,
    also ``ctx.extras``) that the ``<entity>.changed`` topics flush;
    ``app["rate_limiter"]``, a ``RateLimiter`` at ``rate_limit_rps`` and
    ``rate_limit_burst`` (0 rps admits everything) for ``MIDDLEWARES``; and
    at startup, in a worker thread, the native log-masking library's build
    (``utils/masking.py``).

    Auth backed by the database, as the JAX gateway wires it:
    ``app["auth_service"]`` (``AuthService``, whose ``invalidate_user`` is
    ``ctx.extras["auth_invalidate"]`` for the team writes), ``role_service``,
    ``team_service``, ``email_service`` (also ``ctx.extras``: lockout and
    invitation mails), ``compliance_service``, with ``audit_enabled``
    ``audit_service`` (the request log's audit rows; its SIEM export runs
    from startup with ``siem_export_url``), ``sso_service`` (the providers of
    ``sso_providers``), ``dcr_service`` (also ``ctx.extras``) and
    ``ctx.extras["oauth_manager"]`` (the client-credentials Bearer of an
    ``oauth`` tool or gateway). At startup, after the migrations, the
    platform admin's users row (``bootstrap_admin``: one argon2 hash in a
    worker thread) and the system roles are seeded. ``app["_token_usage_tasks"]``
    holds the token-usage and mail tasks, drained at cleanup before the
    database closes. ``gateway/routers_rbac.py`` serves the RBAC,
    compliance, SSO, DCR, token-exchange and audit routes."""
    from ..coordination.heartbeat import WorkerHeartbeat
    from ..coordination.ratelimit import DistributedTenantLimiter, make_rate_counter
    from ..coordination.rpc import BusRpc
    from ..gateway.middleware import MIDDLEWARES, RateLimiter
    from ..gateway.registry_cache import RegistryCache
    from ..observability import phases
    from ..observability.degradation import OverloadShedder, configure_degradation
    from ..observability.faults import configure_fault_plane
    from ..config import validate_security
    from ..db import MIGRATIONS
    from ..db.pg import make_database
    from ..gateway import routers_extra
    from ..gateway.flight_recorder import FlightRecorder, LoopLagSampler
    from ..observability.fleet import FleetMetrics, FleetMetricsView
    from ..observability.logging import init_logging
    from ..observability.metering import TenantLedger, TenantUsageRollup
    from ..observability.metrics import PrometheusRegistry
    from ..observability.signals import SignalBus
    from ..observability.slo import (SloEvaluator, default_objectives, parse_slo_classes,
                                     parse_tenant_classes)
    from ..observability.tenant import TenantClamp
    from ..observability.otlp import OTLPExporter, aiohttp_post
    from ..observability.trace_store import ExemplarLedger, TraceStore
    from ..observability.tracing import Tracer, current_span
    from ..coordination.leases import LeaderElector
    from ..coordination.hub import TcpEventBus
    from ..coordination.kv import TcpKVStore, make_kv
    from ..gateway import routers, routers_chat
    from ..gateway.rpc import RPCDispatcher
    from ..gateway.transports.streamable_http import StreamableHTTPTransport
    from ..plugins.framework import PluginManager
    from ..services.base import AppContext
    from ..services.a2a_service import A2AService
    from ..services.cancellation_service import CancellationService
    from ..services.chat_service import ChatService
    from ..services.elicitation_service import ElicitationService
    from ..services.gateway_service import GatewayService
    from ..services.sampling_service import CompletionService, SamplingHandler
    from ..services.server_service import ServerService
    from ..services.tool_service import ToolService
    from ..services.toolops_service import ToolOpsService
    from ..services.upstream_sessions import UpstreamSessionRegistry
    from ..services.diagnostics_service import TorchProfilerCapture
    from ..gateway.routers_rbac import (setup_compliance_routes, setup_identity_routes,
                                        setup_rbac_routes)
    from ..services.audit_service import AuditService
    from ..services.auth_service import AuthService
    from ..services.compliance_service import ComplianceService
    from ..services.email_service import EmailNotificationService
    from ..services.oauth_service import DCRService, OAuthManager, SSOService
    from ..services.role_service import RoleService
    from ..services.team_service import TeamService
    from ..services.llm_provider_service import LLMProviderService
    from ..services.prompt_service import PromptService
    from ..services.resource_service import ResourceService
    from ..utils import new_id
    from ..utils.masking import native_available
    from .controller import ServingController
    from .engine import EngineConfig, TorchEngine
    from .kv.fabric.publisher import ADVERT_METHOD, FabricIndexPublisher
    from .pool_rpc import SharedEnginePlane, SharedPoolProvider
    from .tpu_provider import TorchLocalProvider

    init_logging(getattr(settings, "log_level", "INFO"), getattr(settings, "log_json", False),
                 buffer_capacity=getattr(settings, "log_buffer_capacity", 5000),
                 file_path=(os.path.join(getattr(settings, "log_folder", "logs"),
                                         getattr(settings, "log_file", "mcpforge.log"))
                            if getattr(settings, "log_to_file", False) else None),
                 rotation=getattr(settings, "log_rotation_enabled", False),
                 max_mb=getattr(settings, "log_max_size_mb", 1.0),
                 backup_count=getattr(settings, "log_backup_count", 5))
    problems = validate_security(settings)
    if problems:
        raise RuntimeError(f"Refusing to start with insecure configuration: {problems}")
    # one tenant clamp for the registry and the ledger: bounded tenant label
    # cardinality, the same admission on both sides
    tenant_clamp = TenantClamp(getattr(settings, "tenant_label_clamp", 8))
    metrics = PrometheusRegistry(
        tenant_clamp=tenant_clamp,
        exemplars=ExemplarLedger(enabled=getattr(settings, "metrics_exemplars", True)))
    # the process's fault plane stays a no-op unless fault_injection_enabled
    # is set (then faults.get_fault_plane().arm(...) arms a rule)
    configure_fault_plane(settings.fault_injection_enabled, metrics=metrics,
                          rules_json=settings.fault_rules)
    degradation = configure_degradation(
        metrics=metrics, failure_threshold=settings.degradation_failure_threshold,
        cooldown_s=settings.degradation_cooldown_s)
    tracer = Tracer(service_name=settings.otel_service_name,
                    exporter=settings.otel_exporter if settings.otel_enable else "none")
    trace_store = None
    if getattr(settings, "trace_store_enabled", True):
        # tail retention: errors, SLO breaches, slowest-N per route and
        # tenant, exemplar-pinned traces and a 1-in-M sample
        trace_store = TraceStore(
            max_traces=getattr(settings, "trace_store_max_traces", 512),
            max_spans_per_trace=getattr(settings, "trace_store_max_spans", 256),
            sample_every=getattr(settings, "trace_store_sample_every", 32),
            slowest_per_key=getattr(settings, "trace_store_slowest_per_key", 4),
            idle_finalize_s=getattr(settings, "trace_store_idle_finalize_s", 30.0),
            slo_targets={"http": getattr(settings, "slo_http_p95_ms", 1000.0) / 1e3,
                         "ttft": settings.slo_ttft_p95_ms / 1e3,
                         "tpot": settings.slo_tpot_p95_ms / 1e3,
                         "queue_wait": settings.slo_queue_wait_p95_ms / 1e3},
            exemplars=metrics.exemplars)
        tracer.add_sink(trace_store.sink)
    otlp = otlp_close = None
    if settings.otel_enable and getattr(settings, "otel_otlp_endpoint", ""):
        # OTLP/HTTP export beside the memory sink and the trace store
        headers = (json.loads(settings.otel_otlp_headers)
                   if getattr(settings, "otel_otlp_headers", "") else None)
        post, otlp_close = aiohttp_post()
        otlp = OTLPExporter(post, settings.otel_otlp_endpoint, settings.otel_service_name,
                            headers, metrics=metrics,
                            max_retries=getattr(settings, "otel_otlp_retry_max", 3))
        tracer.add_sink(otlp.sink)
    # the gateway's database: statements run on its own threads, the
    # connection and the migrations at startup
    db = make_database(settings.database_url, settings.db_pool_size,
                       busy_timeout_ms=settings.db_sqlite_busy_timeout_ms,
                       max_retries=settings.db_max_retries,
                       retry_interval_ms=settings.db_retry_interval_ms)
    quota = getattr(settings, "tenant_quota_tokens_per_window", 0)
    ledger = rollup = None
    if getattr(settings, "tenant_metering_enabled", True):
        ledger = TenantLedger(clamp=tenant_clamp, metrics=metrics,
                              max_tenants=getattr(settings, "tenant_ledger_max_tenants", 512),
                              quota_tokens_per_window=quota)
        # each rollup interval closes the ledger's quota window (a tenant
        # over one window's quota is admitted again) and writes its rows
        rollup = TenantUsageRollup(
            db, ledger, interval_s=getattr(settings, "tenant_usage_rollup_interval_s", 60.0),
            pending_max=settings.tenant_rollup_pending_max)
    signal_bus = SignalBus(window=settings.signal_window,
                           ewma_alpha=settings.signal_ewma_alpha)
    hub = hub_client = None
    owns_bus = bus is None
    if owns_bus:
        bus, leases, hub, hub_client = coordination_from_settings(settings)
    worker_id = worker_id or new_id()[:12]
    # tenant quotas against ONE shared window counter: N workers admit the
    # quota and one burst, never N quotas
    limiter = None
    if getattr(settings, "gw_distributed_limiter", True) and ledger is not None and quota > 0:
        limiter = DistributedTenantLimiter(
            make_rate_counter(getattr(settings, "bus_backend", "memory"),
                              getattr(settings, "bus_dir", None), hub_client=hub_client),
            ledger, quota_tokens=quota,
            window_s=(getattr(settings, "tenant_quota_window_s", 0.0)
                      or getattr(settings, "tenant_usage_rollup_interval_s", 60.0)),
            burst_tokens=getattr(settings, "tenant_quota_burst_tokens", 2048),
            sync_interval_s=getattr(settings, "tenant_limiter_sync_interval_s", 0.25))
    fleet = None
    if getattr(settings, "gw_fleet_metrics", False):
        fleet = FleetMetrics(bus, worker_id, metrics,
                             interval_s=getattr(settings, "gw_fleet_metrics_interval_s", 2.0))

    def evaluator(source) -> SloEvaluator:
        # SLO classes map tenants to target bundles, evaluated per tenant
        # label slice (clamp peek: a probe never takes a slot)
        return SloEvaluator(source, default_objectives(settings),
                            error_budget=getattr(settings, "slo_error_budget", 0.05),
                            slo_classes=parse_slo_classes(settings),
                            tenant_classes=parse_tenant_classes(settings),
                            tenant_label=tenant_clamp.peek)

    recorder = sampler = None
    if getattr(settings, "gw_flight_recorder_enabled", True):
        # per-request phase rows behind /admin/gateway/requests, and the
        # loop's lag, pushed onto the signal bus as gw.loop_lag_ms
        recorder = FlightRecorder(
            metrics, ring_size=getattr(settings, "gw_flight_ring_size", 256),
            slowest_size=getattr(settings, "gw_flight_slowest_size", 32),
            slow_request_s=settings.gw_slow_request_s, worker=worker_id)
        sampler = LoopLagSampler(
            metrics, interval_s=getattr(settings, "gw_loop_lag_interval_s", 0.25),
            warn_s=getattr(settings, "gw_loop_lag_warn_ms", 250.0) / 1e3, recorder=recorder)
        sampler.signals = signal_bus
    bus_rpc = BusRpc(bus, worker_id, leases=leases,
                     default_timeout_s=getattr(settings, "gw_rpc_timeout_s", 30.0),
                     idle_timeout_s=getattr(settings, "gw_stream_idle_timeout_s", 15.0))
    heartbeat = WorkerHeartbeat(leases, worker_id)
    # the engines that serve on this worker (none on a plane's non-owner)
    live = {"engine": None, "pool": None}

    def engine_config() -> EngineConfig:
        config = EngineConfig.from_settings(settings)
        return dataclasses.replace(config, device=device) if device else config

    def make_provider(engine, pool):
        """The engines' provider, building the pool or the engine first when
        none is given."""
        if pool is None and engine is None and getattr(settings, "tpu_local_replicas", 1) > 1:
            pool = build_pool(settings, engine_config(),
                              tracer=tracer, signals=signal_bus, metrics=metrics,
                              ledger=ledger)
        handles = dict(tracer=tracer, signals=signal_bus, metrics=metrics, ledger=ledger)
        if pool is not None:
            for name, handle in handles.items():
                if getattr(pool, name) is None:
                    setattr(pool, name, handle)
            engines = [r.engine for r in pool.replicas]
        else:
            if engine is None:
                engine = TorchEngine(engine_config(), **handles)
            engines = [engine]
        for served in engines:
            for name, handle in handles.items():
                if getattr(served, name) is None:
                    setattr(served, name, handle)
        live.update(engine=engines[0], pool=pool)
        provider = TorchLocalProvider(
            "tpu_local", pool if pool is not None else engines[0], tracer=tracer,
            metrics=metrics,
            embedding_model=settings.tpu_local_embedding_model,
            encoder_max_batch=settings.tpu_local_encoder_max_batch,
            encoder_max_wait_ms=settings.tpu_local_encoder_max_wait_ms,
            encoder_min_seq=settings.tpu_local_encoder_min_seq)
        provider.classify_window = settings.tpu_local_classify_window
        provider.classify_coverage = settings.tpu_local_classify_coverage
        provider.classify_max_windows = settings.tpu_local_classify_max_windows
        provider.classify_cache_size = settings.tpu_local_classify_cache_size
        return provider

    registry = LLMProviderRegistry()
    plane = None
    provider = None
    if getattr(settings, "tpu_local_pool_shared", False):

        async def build_owner_provider():
            provider = await asyncio.to_thread(make_provider, engine, pool)
            await (live["pool"] or live["engine"]).start()
            return provider

        plane = SharedEnginePlane(
            bus_rpc, leases, worker_id, build_owner_provider,
            lease_ttl=getattr(settings, "leader_lease_ttl", 15.0),
            rpc_timeout_s=getattr(settings, "gw_rpc_timeout_s", 30.0),
            stream_idle_timeout_s=getattr(settings, "gw_stream_idle_timeout_s", 15.0))
        registry.register(SharedPoolProvider("tpu_local", plane),
                          [settings.tpu_local_model, "tpu_local"],
                          default_chat=True, default_embed=True)
    else:
        provider = make_provider(engine, pool)
        registry.register(provider, [settings.tpu_local_model, "tpu_local"],
                          default_chat=True, default_embed=True)
    ctx = AppContext(settings=settings, db=db, bus=bus, leases=leases, tracer=tracer,
                     metrics=metrics, llm_registry=registry, worker_id=worker_id)
    llm_provider_service = LLMProviderService(ctx)
    ctx.extras.update(tpu_engine=live["engine"], tpu_engine_pool=live["pool"],
                      engine_plane=plane)
    # the MCP tools/call path, under the JAX gateway's keys
    upstream_sessions = UpstreamSessionRegistry(
        ctx, max_sessions=settings.upstream_max_sessions, idle_ttl=settings.upstream_idle_ttl)
    tool_service, server_service = ToolService(ctx), ServerService(ctx)
    resource_service, prompt_service = ResourceService(ctx), PromptService(ctx)
    gateway_service = GatewayService(ctx)
    dispatcher = RPCDispatcher(ctx, tool_service, resource_service, prompt_service,
                               server_service, completion_service=CompletionService(ctx),
                               sampling_handler=SamplingHandler(ctx))
    transport = StreamableHTTPTransport(dispatcher, settings)
    transport.sessions.metrics = metrics   # the mcpforge_sessions_active gauge
    elicitation_service = ElicitationService(ctx, transport.sessions)
    transport.elicitation = elicitation_service
    mcp_services = {
        "upstream_sessions": upstream_sessions, "cancellation_service": CancellationService(ctx),
        "tool_service": tool_service, "gateway_service": gateway_service,
        "resource_service": resource_service, "prompt_service": prompt_service,
        "server_service": server_service, "dispatcher": dispatcher,
        "streamable_transport": transport, "a2a_service": A2AService(ctx),
        "elicitation_service": elicitation_service}
    ctx.extras.update(mcp_services)
    # chat sessions in the coordination KV store: any worker continues one
    if hub_client is not None or isinstance(bus, TcpEventBus):
        kv_store = TcpKVStore(hub_client or bus._client)
    else:
        kv_store = make_kv(getattr(settings, "bus_backend", "memory"),
                           getattr(settings, "bus_dir", None))

    def notify(method: str):
        # catalog changes fan out to every stateful /mcp session
        async def handler(topic, message):
            await transport.sessions.broadcast({"jsonrpc": "2.0", "method": method})
        return handler

    for entity in ("tools", "resources", "prompts"):
        bus.subscribe(f"{entity}.changed", notify(f"notifications/{entity}/list_changed"))
    elector = LeaderElector(leases, "gateway-leader", worker_id,
                            ttl=getattr(settings, "leader_lease_ttl", 15.0))
    ctx.extras["leader_elector"] = elector   # gates the gateway health loop
    app = web.Application(middlewares=MIDDLEWARES)
    for key, service in mcp_services.items():
        app[key] = service
    app["kv_store"] = kv_store
    app["rate_limiter"] = RateLimiter(settings.rate_limit_rps, settings.rate_limit_burst)
    if settings.registry_cache_enabled:
        registry_cache = RegistryCache(ctx)
        registry_cache.wire()   # flushed by the <entity>.changed topics
        app["registry_cache"] = ctx.extras["registry_cache"] = registry_cache
    app["chat_service"] = ChatService(ctx, tool_service, server_service, kv=kv_store,
                                      session_ttl=settings.session_ttl)
    # auth backed by the database, under the JAX gateway's keys
    auth_service = AuthService(ctx)
    app["auth_service"] = auth_service
    # membership and role writers bust the auth resolution cache through
    # this hook (services do not import each other for it)
    ctx.extras["auth_invalidate"] = auth_service.invalidate_user
    app["role_service"] = RoleService(ctx)
    app["team_service"] = TeamService(ctx)
    app["email_service"] = ctx.extras["email_service"] = EmailNotificationService(ctx)
    app["compliance_service"] = ComplianceService(ctx)
    audit_service = AuditService(ctx, siem_url=settings.siem_export_url)
    if settings.audit_enabled:
        app["audit_service"] = audit_service
    ctx.extras["oauth_manager"] = OAuthManager(ctx)
    sso_service = SSOService(ctx, auth_service)
    app["sso_service"] = sso_service
    for entry in (json.loads(settings.sso_providers) if settings.sso_providers else []):
        sso_service.register_provider(
            entry["name"], entry["issuer"], entry["client_id"], entry.get("client_secret", ""),
            authorization_endpoint=entry.get("authorization_endpoint", ""),
            token_endpoint=entry.get("token_endpoint", ""),
            dialect=entry.get("dialect", "oidc"),
            userinfo_endpoint=entry.get("userinfo_endpoint", ""),
            metadata=entry.get("metadata"))
    dcr_service = DCRService(ctx)
    app["dcr_service"] = ctx.extras["dcr_service"] = dcr_service
    # made before the app freezes: a handler may not add keys to it
    app["_token_usage_tasks"] = set()
    app["toolops_service"] = ToolOpsService(ctx, tool_service)
    app["settings"] = settings
    app["ctx"] = ctx
    app["plugin_manager"] = None   # set at startup with plugins_enabled
    app["llm_provider_service"] = llm_provider_service
    app["llm_registry"] = registry
    app["tpu_engine"] = live["engine"]
    app["tpu_engine_pool"] = live["pool"]
    app["tpu_provider"] = provider
    app["engine_plane"] = plane
    app["bus_rpc"] = bus_rpc
    app["coordination_hub"] = hub
    app["worker_id"] = worker_id
    app["tracer"] = tracer
    app["current_span"] = current_span
    app["phase_clock"] = phases   # phases.phase(name) charges the request's clock
    app["signal_bus"] = signal_bus
    app["metrics"] = metrics
    app["tenant_ledger"] = ledger
    app["tenant_usage_rollup"] = rollup
    app["tenant_limiter"] = limiter
    app["trace_store"] = trace_store
    app["fleet_metrics"] = fleet
    app["otlp_exporter"] = otlp
    app["flight_recorder"] = recorder
    app["loop_lag_sampler"] = sampler
    served = live["engine"]
    app["torch_profiler"] = (
        TorchProfilerCapture(getattr(settings, "torch_profile_dir", os.path.join(
            tempfile.gettempdir(), "mcpforge-torchprof")), device=served.device)
        if served is not None else None)
    app["slo_evaluator"] = evaluator(metrics)
    app["slo_evaluator_fleet"] = (evaluator(FleetMetricsView(metrics, fleet))
                                  if fleet is not None else None)
    if settings.gw_shed_enabled:
        app["overload_shedder"] = OverloadShedder(
            shed_at=settings.gw_shed_saturation_at,
            class_order=_shed_class_order(settings),
            tenant_classes=parse_tenant_classes(settings), ledger=ledger,
            degradation=degradation, metrics=metrics, limiter=limiter)

    def live_engines() -> list:
        # a pool's reload swaps engine objects: read the current ones
        if live["pool"] is not None:
            return [r.engine for r in live["pool"].replicas]
        return [live["engine"]] if live["engine"] is not None else []

    controller = None
    if settings.controller_enabled:
        controller = ServingController(
            signal_bus, live_engines, shedder=app.get("overload_shedder"),
            slo_evaluator=app["slo_evaluator"], metrics=metrics, tracer=tracer, enabled=True,
            safe_mode=settings.controller_safe_mode,
            tick_s=settings.controller_tick_s,
            cooldown_s=settings.controller_cooldown_s,
            eval_window_s=settings.controller_eval_window_s,
            hysteresis=settings.controller_hysteresis,
            ring_size=settings.controller_ring_size,
            queue_wait_high_ms=settings.controller_queue_wait_high_ms,
            queue_wait_low_ms=settings.controller_queue_wait_low_ms,
            idle_frac_high=settings.controller_idle_frac_high,
            spec_accept_off=settings.controller_spec_accept_off,
            spec_accept_on=settings.controller_spec_accept_on,
            burn_high=settings.controller_burn_high,
            burn_low=settings.controller_burn_low,
            shed_floor=settings.controller_shed_floor,
            shed_step=settings.controller_shed_step)
    app["serving_controller"] = controller

    def fabric_store():
        # resolved at each tick: a plane's store exists once its owner built
        if live["pool"] is not None:
            return live["pool"].tier_store
        client = getattr(live["engine"], "_tier_client", None)
        return client.store if client is not None else None

    fabric_http: list = []   # one ClientSession, made on the loop at first use

    async def fabric_post_json(url: str, payload: dict) -> dict | None:
        # a peer URL may carry Basic credentials ("http://admin:pw@host:4444");
        # aiohttp refuses userinfo in the request URL itself
        import aiohttp
        from yarl import URL

        if not fabric_http:
            fabric_http.append(aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=5.0)))
        u = URL(url)
        auth = aiohttp.BasicAuth(u.user, u.password or "") if u.user else None
        async with fabric_http[0].post(u.with_user(None), json=payload, auth=auth) as resp:
            resp.raise_for_status()
            return await resp.json()

    fabric_publisher = FabricIndexPublisher(
        fabric_store, worker_id, rpc=bus_rpc,
        http_peers=[u.strip() for u in getattr(settings, "tpu_local_fabric_peers", "").split(",")
                    if u.strip()],
        post_json=fabric_post_json,
        interval_s=getattr(settings, "tpu_local_fabric_advert_interval_s", 2.0),
        ttl_s=getattr(settings, "tpu_local_fabric_advert_ttl_s", 300.0),
        rpc_timeout_s=getattr(settings, "gw_rpc_timeout_s", 30.0))
    app["fabric_publisher"] = fabric_publisher
    bus_rpc.register(ADVERT_METHOD, fabric_publisher.handle_advert)

    async def start(app: web.Application) -> None:
        await db.connect()
        await db.migrate(MIGRATIONS)
        await auth_service.bootstrap_admin()
        await app["role_service"].bootstrap_system_roles()
        if settings.plugins_enabled:
            ctx.plugin_manager = app["plugin_manager"] = await PluginManager.load(ctx)
        if sampler is not None:
            await sampler.start()
        if otlp is not None:
            await otlp.start()
        if hub is not None:
            await hub.start()
            hub_client.port = hub.bound_port   # a hub on port 0 took a free one
        if owns_bus:
            await bus.start()
        await bus_rpc.start()
        await heartbeat.start()
        if plane is not None:
            await plane.start()
        else:
            await (live["pool"] or live["engine"]).start()
        if controller is not None:
            await controller.start()
        await llm_provider_service.rewire()   # external providers from the table
        if ctx.plugin_manager is not None:
            await ctx.plugin_manager.load_bindings()
        if rollup is not None:
            await rollup.start()
        if limiter is not None:
            await limiter.start()   # ledger -> the shared quota counter
        if fleet is not None:
            await fleet.start()
        if settings.tpu_local_tier_object_url:
            await fabric_publisher.start()
        # the shared outbound pool, built off the loop: httpx's import and
        # the CA bundle's load would stall it for most of a second
        await asyncio.to_thread(lambda: ctx.http_client)
        await asyncio.to_thread(native_available)   # g++ off the loop
        await transport.sessions.start_sweeper()
        await upstream_sessions.start()
        await elector.start()
        await gateway_service.start_health_loop()
        kv_sweeper.append(asyncio.create_task(purge_kv()))
        await audit_service.start()

    kv_sweeper: list = []

    async def purge_kv() -> None:
        # chat sessions expire by the KV ttl; the purge drops the entries of
        # abandoned ones, which no get() reaches again
        while True:
            await asyncio.sleep(600)
            try:
                await kv_store.purge_expired()
            except Exception:
                logging.getLogger(__name__).exception("kv purge failed")

    async def stop(app: web.Application) -> None:
        # the last requests' token-usage rows (blocked denials among them,
        # which compliance reports count) and mails land before the db closes
        pending = app["_token_usage_tasks"]
        if pending:
            await asyncio.gather(*list(pending), return_exceptions=True)
        await audit_service.stop()
        for task in kv_sweeper:
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
        await gateway_service.stop_health_loop()
        await elector.stop()
        await transport.sessions.stop_sweeper()
        await upstream_sessions.stop()
        await fabric_publisher.stop()
        if fleet is not None:
            await fleet.stop()
        if limiter is not None:
            await limiter.stop()
        if fabric_http:
            await fabric_http[0].close()
        if controller is not None:
            # before the engine stops: no knob request may land on a
            # stopping dispatch loop
            await controller.stop()
        await registry.shutdown()
        if rollup is not None:
            # after the engines (their last retires are in the ledger), before
            # the database closes: the last window's rows are written
            await rollup.stop()
        await heartbeat.stop()
        await bus_rpc.stop()
        if owns_bus:
            await bus.stop()
        if hub is not None:
            await hub.stop()
        if otlp is not None:
            await otlp.stop()   # after the engines: their last spans go out
            await otlp_close()
        if sampler is not None:
            await sampler.stop()
        await ctx.close_http_client()
        await db.close()

    app.on_startup.append(start)
    app.on_cleanup.append(stop)
    setup_llm_routes(app, registry, prefix=settings.llm_api_prefix)
    setup_pool_routes(app)
    setup_fabric_routes(app)
    setup_observability_routes(app)
    setup_operator_routes(app)
    routers_extra.setup_routes(app)
    routers.setup_routes(app)
    routers_chat.setup_routes(app)
    setup_rbac_routes(app)
    setup_compliance_routes(app)
    setup_identity_routes(app, sso_service, dcr_service, audit_service)
    setup_mcp_routes(app)
    return app


def install_event_loop(policy_name: str) -> str:
    """Install the ``gw_event_loop`` policy; returns the loop installed:
    ``uvloop`` only when asked for and importable, else asyncio's, with a
    warning when uvloop was asked for (the knob is never a boot error)."""
    if policy_name != "uvloop":
        return "asyncio"
    try:
        import uvloop  # type: ignore[import-not-found]
    except ImportError:
        logging.getLogger(__name__).warning(
            "gw_event_loop=uvloop but uvloop is not installed; falling back to asyncio")
        return "asyncio"
    asyncio.set_event_loop_policy(uvloop.EventLoopPolicy())
    return "uvloop"


def run(settings=None, device: str | None = None) -> None:
    """Serve ``build_llm_app(settings, device=device)`` on ``settings.host``
    and ``settings.port`` until SIGINT or SIGTERM (the port's settings from
    the environment by default): TLS with ``ssl_enabled``, one shared
    SO_REUSEPORT socket with ``gw_reuse_port``, ``gw_listen_backlog``. The
    engine is built before the port binds; a build that fails (no card for a
    ``cuda`` device) raises out of here."""
    from ..config import get_settings
    from ..utils.sslctx import serving_ssl

    settings = settings or get_settings()
    install_event_loop(getattr(settings, "gw_event_loop", ""))

    async def factory() -> web.Application:
        return build_llm_app(settings, device=device)

    web.run_app(factory(), host=settings.host, port=settings.port,
                reuse_port=getattr(settings, "gw_reuse_port", False) or None,
                backlog=getattr(settings, "gw_listen_backlog", 1024),
                ssl_context=serving_ssl(settings))
