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
actions): the middlewares of ``gateway/middleware.py`` (the ``http.request``
span, the phase clock, error mapping, authentication, so that
``request["auth"]`` is always set), the overload shedder, the signal
bus, the fault plane and, with ``controller_enabled``, the serving
controller. ``tpu_local_mesh_shape`` (with ``tpu_local_sp_impl`` and
``tpu_local_sp_threshold``) reaches the engine through
``EngineConfig.from_settings``: "1xN" serves on N GPUs, one process each
(``ranks.py``); a multi-rank owner of the shared plane is refused. Each app is a worker of the coordination layer (a bus RPC seam
and a heartbeat lease): with ``tpu_local_pool_shared`` its engine is the
shared engine plane's (one owner elected among the workers builds it, the
others forward), and ``setup_fabric_routes`` serves the prefix-cache
fabric's ``/admin/fabric/adverts`` exchange.

aiohttp is imported here and in ``gateway/middleware.py``, nowhere else in
the port.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
from typing import Any

from aiohttp import web

from ..gateway.flight_recorder import (backpressure_headers, queue_state,
                                       retry_after_s)
from ..gateway.serialize import SSE_DONE, sse_event
from .parallel.mesh import parse_mesh_shape
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


def _tenant_classes(settings) -> dict[str, str]:
    """``slo_tenant_classes`` (a JSON object: tenant id -> SLO class)."""
    raw = getattr(settings, "slo_tenant_classes", "") or ""
    if not raw:
        return {}
    try:
        parsed = json.loads(raw)
        if not isinstance(parsed, dict):
            raise ValueError("must be a JSON object")
        return {str(k): str(v) for k, v in parsed.items()}
    except (json.JSONDecodeError, TypeError, ValueError) as exc:
        raise ValueError(f"invalid slo_tenant_classes setting: {exc}") from exc


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


def setup_fabric_routes(app: web.Application) -> None:
    """The prefix-cache fabric's HTTP peer exchange (the JAX gateway's
    ``routers_extra.py`` routes) over ``app["fabric_publisher"]``:
    ``POST /admin/fabric/adverts`` (needs ``admin.all``) merges a peer's
    advert batch and answers with this host's adverts, 404 without an
    object tier, 422 for a body that is not an advert batch;
    ``GET /admin/fabric/adverts`` (needs ``observability.read``) answers
    the publisher's counters and the tier store's stats."""
    routes = web.RouteTableDef()

    def _detail(message: str, status: int) -> web.Response:
        return web.json_response({"detail": message}, status=status)

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


def _refuse_multi_rank_owner(mesh_shape: str) -> None:
    """The shared engine plane (``pool_rpc.py``) does not carry a
    multi-rank owner yet: raise for a mesh of more than one device."""
    if mesh_shape:
        data, model = parse_mesh_shape(mesh_shape)
        if data * model > 1:
            raise NotImplementedError(
                f"a multi-rank engine (mesh {mesh_shape}) as the shared engine plane's "
                "owner (tpu_local_pool_shared) is not carried yet")


def build_pool(settings, config, tracer=None, signals=None, engine_factory=None):
    """An ``EnginePool`` of ``settings.tpu_local_replicas`` engines of
    ``config``, with the gateway's ``tpu_local_pool_*`` settings (the JAX
    gateway's wiring); ``engine_factory`` as ``EnginePool`` takes it."""
    from .pool import EnginePool

    return EnginePool(
        config, replicas=settings.tpu_local_replicas, tracer=tracer, signals=signals,
        engine_factory=engine_factory,
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
                  worker_id: str | None = None) -> web.Application:
    """An app serving the /v1 surface under ``settings.llm_api_prefix`` from
    one engine or a replica pool: ``pool``, or ``engine``, or, with
    ``tpu_local_replicas`` > 1, a pool (``build_pool``) and else one
    ``TorchEngine``, built from ``EngineConfig.from_settings(settings)``
    (weights from ``tpu_local_checkpoint``). The app's tracer and signal
    bus go to the engines (given ones keep handles they already have). With
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
    and the backpressure headers read the owner's queue through the plane."""
    from ..coordination.heartbeat import WorkerHeartbeat
    from ..coordination.rpc import BusRpc
    from ..gateway.middleware import MIDDLEWARES
    from ..observability import phases
    from ..observability.degradation import OverloadShedder, configure_degradation
    from ..observability.faults import configure_fault_plane
    from ..observability.signals import SignalBus
    from ..observability.tracing import Tracer, current_span
    from ..utils import new_id
    from .controller import ServingController
    from .engine import EngineConfig, TorchEngine
    from .kv.fabric.publisher import ADVERT_METHOD, FabricIndexPublisher
    from .pool_rpc import SharedEnginePlane, SharedPoolProvider
    from .tpu_provider import TorchLocalProvider

    # the process's fault plane stays a no-op unless fault_injection_enabled
    # is set (then faults.get_fault_plane().arm(...) arms a rule)
    configure_fault_plane(settings.fault_injection_enabled, rules_json=settings.fault_rules)
    degradation = configure_degradation(
        failure_threshold=settings.degradation_failure_threshold,
        cooldown_s=settings.degradation_cooldown_s)
    tracer = Tracer(service_name=settings.otel_service_name,
                    exporter=settings.otel_exporter if settings.otel_enable else "none")
    signal_bus = SignalBus(window=settings.signal_window,
                           ewma_alpha=settings.signal_ewma_alpha)
    hub = hub_client = None
    owns_bus = bus is None
    if owns_bus:
        bus, leases, hub, hub_client = coordination_from_settings(settings)
    worker_id = worker_id or new_id()[:12]
    bus_rpc = BusRpc(bus, worker_id, leases=leases,
                     default_timeout_s=getattr(settings, "gw_rpc_timeout_s", 30.0),
                     idle_timeout_s=getattr(settings, "gw_stream_idle_timeout_s", 15.0))
    heartbeat = WorkerHeartbeat(leases, worker_id)
    # the engines that serve on this worker (none on a plane's non-owner)
    live = {"engine": None, "pool": None}

    def make_provider(engine, pool):
        """The engines' provider, building the pool or the engine first when
        none is given."""
        if pool is None and engine is None and getattr(settings, "tpu_local_replicas", 1) > 1:
            pool = build_pool(settings, EngineConfig.from_settings(settings),
                              tracer=tracer, signals=signal_bus)
        if pool is not None:
            if pool.tracer is None:
                pool.tracer = tracer
            if pool.signals is None:
                pool.signals = signal_bus
            engines = [r.engine for r in pool.replicas]
        else:
            if engine is None:
                engine = TorchEngine(EngineConfig.from_settings(settings), tracer=tracer,
                                     signals=signal_bus)
            engines = [engine]
        for served in engines:
            if served.tracer is None:
                served.tracer = tracer
            if served.signals is None:
                served.signals = signal_bus
        live.update(engine=engines[0], pool=pool)
        provider = TorchLocalProvider(
            "tpu_local", pool if pool is not None else engines[0], tracer=tracer,
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
        _refuse_multi_rank_owner(getattr(settings, "tpu_local_mesh_shape", ""))

        async def build_owner_provider():
            provider = await asyncio.to_thread(make_provider, engine, pool)
            for served in ([r.engine for r in live["pool"].replicas] if live["pool"]
                           else [live["engine"]]):
                if served.world > 1:
                    await (live["pool"] or live["engine"]).stop()
                    _refuse_multi_rank_owner(f"1x{served.world}")
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
    app = web.Application(middlewares=MIDDLEWARES)
    app["settings"] = settings
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
    if settings.gw_shed_enabled:
        app["overload_shedder"] = OverloadShedder(
            shed_at=settings.gw_shed_saturation_at,
            class_order=_shed_class_order(settings),
            tenant_classes=_tenant_classes(settings), degradation=degradation)

    def live_engines() -> list:
        # a pool's reload swaps engine objects: read the current ones
        if live["pool"] is not None:
            return [r.engine for r in live["pool"].replicas]
        return [live["engine"]] if live["engine"] is not None else []

    controller = None
    if settings.controller_enabled:
        controller = ServingController(
            signal_bus, live_engines, shedder=app.get("overload_shedder"),
            tracer=tracer, enabled=True,
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
        if settings.tpu_local_tier_object_url:
            await fabric_publisher.start()

    async def stop(app: web.Application) -> None:
        await fabric_publisher.stop()
        if fabric_http:
            await fabric_http[0].close()
        if controller is not None:
            # before the engine stops: no knob request may land on a
            # stopping dispatch loop
            await controller.stop()
        await registry.shutdown()
        await heartbeat.stop()
        await bus_rpc.stop()
        if owns_bus:
            await bus.stop()
        if hub is not None:
            await hub.stop()

    app.on_startup.append(start)
    app.on_cleanup.append(stop)
    setup_llm_routes(app, registry, prefix=settings.llm_api_prefix)
    setup_pool_routes(app)
    setup_fabric_routes(app)
    return app
