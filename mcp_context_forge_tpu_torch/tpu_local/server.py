"""The OpenAI-compatible /v1 surface over the port's engine (a standalone
copy of the JAX package's ``tpu_local/server.py`` routes, and of the
single-engine branch of its gateway app).

``setup_llm_routes`` binds ``POST /chat/completions`` (unary and SSE),
``POST /embeddings``, ``GET /models`` and ``POST /moderations`` under a
prefix; ``build_llm_app`` builds an aiohttp app that serves them from a
``TorchEngine`` configured by the gateway's settings. The gateway's own
pieces (authentication, overload shedding, the request phase clock, the
tracing span) are consulted only when the app carries them:
``request["auth"]``, ``app["overload_shedder"]``, ``app["phase_clock"]``
(``.phase(name)`` context managers) and ``app["current_span"]`` (a
callable returning the request's span or None).

aiohttp is imported here and nowhere else in the port.
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


def build_llm_app(settings, engine=None) -> web.Application:
    """An app serving the /v1 surface under ``settings.llm_api_prefix`` from
    one engine: ``engine``, or a ``TorchEngine`` built from
    ``EngineConfig.from_settings(settings)`` (weights from
    ``tpu_local_checkpoint``). The engine starts with the app and stops,
    with the provider, at its cleanup. ``settings`` is duck-typed as the
    gateway's."""
    from .engine import EngineConfig, TorchEngine
    from .tpu_provider import TorchLocalProvider

    if engine is None:
        engine = TorchEngine(EngineConfig.from_settings(settings))
    provider = TorchLocalProvider(
        "tpu_local", engine,
        embedding_model=settings.tpu_local_embedding_model,
        encoder_max_batch=settings.tpu_local_encoder_max_batch,
        encoder_max_wait_ms=settings.tpu_local_encoder_max_wait_ms,
        encoder_min_seq=settings.tpu_local_encoder_min_seq)
    provider.classify_window = settings.tpu_local_classify_window
    provider.classify_coverage = settings.tpu_local_classify_coverage
    provider.classify_max_windows = settings.tpu_local_classify_max_windows
    provider.classify_cache_size = settings.tpu_local_classify_cache_size
    registry = LLMProviderRegistry()
    registry.register(provider, [settings.tpu_local_model, "tpu_local"],
                      default_chat=True, default_embed=True)
    app = web.Application()
    app["settings"] = settings
    app["llm_registry"] = registry
    app["tpu_engine"] = engine
    app["tpu_provider"] = provider

    async def start(app: web.Application) -> None:
        await engine.start()

    async def stop(app: web.Application) -> None:
        await registry.shutdown()

    app.on_startup.append(start)
    app.on_cleanup.append(stop)
    setup_llm_routes(app, registry, prefix=settings.llm_api_prefix)
    return app
