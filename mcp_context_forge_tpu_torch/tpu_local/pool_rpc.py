"""Shared engine plane: one pool owner, N serving workers (a copy of the JAX
package's ``tpu_local/pool_rpc.py``).

A multi-worker gateway runs N processes, but an engine (or an
``EnginePool``) owns the card's memory, and N of them would hold N copies
of the weights and split the KV budget. This module keeps ONE:

- every worker runs :class:`SharedEnginePlane`; they all contend for the
  ``engine-pool-owner`` lease through the coordination layer
  (``coordination/leases.py``, or the hub's ``TcpLeaseManager``);
- the winner builds the real engine or pool and its provider through
  ``provider_factory`` and serves the ``pool.*`` RPC methods over the bus
  RPC seam (``coordination/rpc.py``);
- the others register :class:`SharedPoolProvider` in their LLM registry:
  ``chat``/``chat_stream``/``embed``/``classify`` forward to the current
  owner, carrying the ORIGINATING tenant so that the owner's ledger bills
  the right principal;
- owner death: the lease expires, a survivor wins the next acquire and
  builds a fresh engine; requests that raced the failover surface
  :class:`~.provider.LLMUnavailable` (503 + Retry-After) and the client
  retries onto the re-elected owner. A whole-process death is that
  503-and-retry path; a replica's death inside the owner's pool is the
  pool's own requeue.

Each worker that serves these methods must also hold its ``worker:<id>``
heartbeat lease (``coordination/heartbeat.py``): a caller waiting on a
silent owner reads that lease to tell a long prefill from a dead owner.

Wire shapes (all JSON over the bus):
  pool.chat        {"body", "tenant"} -> {"ok", "result"} |
                   {"ok": false, "error_type", "message", "retry_after_s"}
  pool.chat_stream same params; chunks are chat.completion.chunk dicts;
                   refusals ride the stream-end error ("LLMUnavailable:…")
  pool.embed       {"texts", "model", "tenant"} -> {"ok", "result"}
  pool.classify    {"texts", "tenant"} -> {"ok", "result"}
  pool.status      {} -> owner stats (worker id, provider wired, models)
  pool.set_role    {"replica", "role"} -> {"ok", "result": replica status}
                   — any worker can retarget the owner pool's
                   prefill/decode/any split live
  pool.queue_state {} -> {"ok", "result": depth/capacity/saturation|null}
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, AsyncIterator, Awaitable, Callable

from .. import observability as tenant_ctx
from .provider import LLMError, LLMProvider, LLMUnavailable

logger = logging.getLogger(__name__)

LEASE_NAME = "engine-pool-owner"


class SharedEnginePlane:
    """Leader-elected pool ownership + the RPC serving seam."""

    def __init__(self, rpc: Any, leases: Any, worker_id: str,
                 provider_factory: Callable[[], Awaitable[LLMProvider]],
                 lease_ttl: float = 15.0,
                 rpc_timeout_s: float = 120.0,
                 stream_idle_timeout_s: float = 15.0) -> None:
        self.rpc = rpc
        self.leases = leases
        self.worker_id = worker_id
        self.provider_factory = provider_factory
        self.lease_ttl = max(1.0, float(lease_ttl))
        self.rpc_timeout_s = rpc_timeout_s
        self.stream_idle_timeout_s = stream_idle_timeout_s
        self.local_provider: LLMProvider | None = None
        self.is_owner = False
        self.elections_won = 0
        self.build_failures = 0
        self._task: asyncio.Task | None = None
        self._build_task: asyncio.Task | None = None
        self._building = False
        # non-owner backpressure: short-TTL cache of the OWNER's queue
        # state, refreshed over bus RPC (see queue_state_sync)
        self.queue_cache_ttl_s = 1.0
        self._queue_cache: dict[str, Any] | None = None
        self._queue_cache_at = 0.0
        self._queue_refresh: asyncio.Task | None = None

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self.rpc.register("pool.chat", self._serve_chat)
        self.rpc.register("pool.embed", self._serve_embed)
        self.rpc.register("pool.classify", self._serve_classify)
        self.rpc.register("pool.status", self._serve_status)
        self.rpc.register("pool.set_role", self._serve_set_role)
        self.rpc.register("pool.queue_state", self._serve_queue_state)
        self.rpc.register_stream("pool.chat_stream", self._serve_chat_stream)
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._elector(), name="engine-pool-elector")

    async def stop(self) -> None:
        refresh, self._queue_refresh = self._queue_refresh, None
        if refresh is not None and not refresh.done():
            refresh.cancel()
        for task in (self._task, self._build_task):
            if task is not None:
                task.cancel()
                try:
                    await task
                except asyncio.CancelledError:
                    pass
        self._task = self._build_task = None
        if self.is_owner:
            try:
                await self.leases.release(LEASE_NAME, self.worker_id)
            except Exception:
                pass
        self.is_owner = False
        provider, self.local_provider = self.local_provider, None
        if provider is not None:
            try:
                await provider.shutdown()
            except Exception:
                logger.exception("shared pool provider shutdown failed")

    async def _elector(self) -> None:
        """Contend for pool ownership forever. Winning builds the pool
        (once); holding renews the lease at TTL/3 — the same cadence the
        worker heartbeat uses, so a dead owner's lease expires within
        one TTL and a survivor takes over. The build runs as a task of
        its own, so that the renewals go on while it runs: a build longer
        than the TTL keeps the lease (the reference awaits the build in
        this loop, and such a build loses the lease to a peer, which then
        builds a second pool)."""
        while True:
            try:
                got = await self.leases.acquire(LEASE_NAME, self.worker_id,
                                                self.lease_ttl)
                if got:
                    if not self.is_owner:
                        logger.info("shared engine plane: worker %s won "
                                    "pool ownership", self.worker_id)
                        self.elections_won += 1
                    self.is_owner = True
                    if self.local_provider is None and not self._building:
                        self._building = True
                        self._build_task = asyncio.get_running_loop(
                        ).create_task(self._build(),
                                      name="engine-pool-build")
                else:
                    self.is_owner = False
            except Exception:
                logger.exception("pool elector iteration failed")
            await asyncio.sleep(self.lease_ttl / 3)

    async def _build(self) -> None:
        self._building = True
        try:
            provider = await self.provider_factory()
            if not self.is_owner:
                # the lease went to a peer while this pool was built: the
                # peer's is the one that serves
                logger.warning("shared engine plane: worker %s lost the "
                               "lease during its build", self.worker_id)
                await provider.shutdown()
                return
            self.local_provider = provider
            logger.info("shared engine plane: pool built on worker %s",
                        self.worker_id)
        except Exception:
            self.build_failures += 1
            logger.exception("shared engine plane: pool build FAILED; "
                             "releasing ownership")
            try:
                await self.leases.release(LEASE_NAME, self.worker_id)
            except Exception:
                pass
            self.is_owner = False
        finally:
            self._building = False

    @property
    def ready_local(self) -> bool:
        return self.is_owner and self.local_provider is not None

    async def owner(self) -> str | None:
        try:
            return await self.leases.holder(LEASE_NAME)
        except Exception:
            return None

    async def _remote_owner(self) -> str:
        """The serving owner, waiting one election interval for a
        failover to settle; no owner => LLMUnavailable (503 + retry)."""
        deadline = time.monotonic() + self.lease_ttl
        while time.monotonic() < deadline:
            owner = await self.owner()
            if owner is not None and owner != self.worker_id:
                return owner
            if owner == self.worker_id:
                # we hold the lease but the pool is still building
                if self.ready_local:
                    return self.worker_id
            await asyncio.sleep(min(0.25, self.lease_ttl / 10))
        raise LLMUnavailable(
            "no engine-pool owner elected (failover in progress)",
            retry_after_s=max(1, int(self.lease_ttl / 3)))

    # ----------------------------------------------------------- server side

    def _local(self) -> LLMProvider:
        if self.local_provider is None:
            raise LLMUnavailable("pool not built on this worker yet",
                                 retry_after_s=2)
        return self.local_provider

    @staticmethod
    def _fail(exc: Exception) -> dict[str, Any]:
        out = {"ok": False, "error_type": type(exc).__name__,
               "message": str(exc)}
        if isinstance(exc, LLMUnavailable):
            out["retry_after_s"] = exc.retry_after_s
        return out

    async def _serve_chat(self, params: dict[str, Any]) -> dict[str, Any]:
        token = tenant_ctx.set_current_tenant(params.get("tenant") or "")
        try:
            return {"ok": True,
                    "result": await self._local().chat(
                        params.get("body") or {})}
        except LLMError as exc:
            return self._fail(exc)
        finally:
            tenant_ctx.reset_current_tenant(token)

    async def _serve_chat_stream(self, params: dict[str, Any]
                                 ) -> AsyncIterator[dict[str, Any]]:
        token = tenant_ctx.set_current_tenant(params.get("tenant") or "")
        try:
            async for chunk in self._local().chat_stream(
                    params.get("body") or {}):
                yield chunk
        finally:
            tenant_ctx.reset_current_tenant(token)

    async def _serve_embed(self, params: dict[str, Any]) -> dict[str, Any]:
        token = tenant_ctx.set_current_tenant(params.get("tenant") or "")
        try:
            return {"ok": True,
                    "result": await self._local().embed(
                        list(params.get("texts") or []),
                        model=params.get("model"))}
        except LLMError as exc:
            return self._fail(exc)
        finally:
            tenant_ctx.reset_current_tenant(token)

    async def _serve_classify(self, params: dict[str, Any]) -> dict[str, Any]:
        token = tenant_ctx.set_current_tenant(params.get("tenant") or "")
        try:
            classify = getattr(self._local(), "classify", None)
            if classify is None:
                raise LLMError("owner provider has no classifier head")
            return {"ok": True,
                    "result": await classify(list(params.get("texts") or []))}
        except LLMError as exc:
            return self._fail(exc)
        finally:
            tenant_ctx.reset_current_tenant(token)

    async def _serve_set_role(self, params: dict[str, Any]
                              ) -> dict[str, Any]:
        """Live role reassignment on the owner pool (``EnginePool.set_role``):
        routing-only state, no drain needed."""
        try:
            pool = getattr(self._local(), "engine", None)
            set_role = getattr(pool, "set_role", None)
            if set_role is None:
                raise LLMError("owner provider is not pool-backed "
                               "(roles need an EnginePool)")
            return {"ok": True,
                    "result": set_role(str(params.get("replica", "")),
                                       str(params.get("role", "")))}
        except (LLMError, KeyError, ValueError) as exc:
            return self._fail(exc)

    async def _serve_status(self, params: dict[str, Any]) -> dict[str, Any]:
        provider = self.local_provider
        return {"worker_id": self.worker_id, "is_owner": self.is_owner,
                "provider_ready": provider is not None,
                "models": (await provider.models()) if provider else []}

    def _local_queue_state(self) -> dict[str, Any] | None:
        """Admission state of the locally-built pool (owner only)."""
        from ..gateway.flight_recorder import compute_queue_state
        backend = getattr(self.local_provider, "engine", None)
        if backend is None:
            return None
        if hasattr(backend, "replicas"):
            return compute_queue_state(backend, None)
        return compute_queue_state(None, backend)

    async def _serve_queue_state(self, params: dict[str, Any]
                                 ) -> dict[str, Any]:
        """The owner's queue depth/capacity/saturation — what every
        non-owner worker's X-Queue-Depth / Retry-After / shed decision must
        reflect (a worker-local zero here would be wrong: the worker has no
        engine, the owner does)."""
        return {"ok": True, "result": self._local_queue_state()}

    # ----------------------------------------------------------- client side

    def queue_state_sync(self) -> dict[str, Any] | None:
        """Backpressure state for THIS worker, synchronously: the local
        pool on the owner; elsewhere the owner's state via a short-TTL
        bus-RPC cache (refreshed in the background — the per-request
        path must not block on a hub round-trip). Returns None until the
        first refresh lands / when no owner is reachable: "no signal",
        which callers render as no backpressure headers — never a fake
        zero depth."""
        if self.ready_local:
            return self._local_queue_state()
        now = time.monotonic()
        if (self._queue_cache_at and
                now - self._queue_cache_at <= self.queue_cache_ttl_s):
            return self._queue_cache
        if self._queue_refresh is None or self._queue_refresh.done():
            try:
                self._queue_refresh = asyncio.get_running_loop(
                ).create_task(self._refresh_queue_cache())
            except RuntimeError:
                return self._queue_cache  # no loop (sync test context)
        return self._queue_cache

    async def _refresh_queue_cache(self) -> None:
        try:
            owner = await self.owner()
            if owner is None or owner == self.worker_id:
                # no elected owner (failover window) or we ARE the owner
                # but the pool is still building: no signal
                self._queue_cache = None
            else:
                resp = await self.rpc.call(
                    owner, "pool.queue_state", {},
                    timeout_s=min(5.0, self.rpc_timeout_s), batch=True)
                self._queue_cache = (resp.get("result")
                                     if resp.get("ok") else None)
        except Exception:
            self._queue_cache = None  # unreachable owner: no signal
        self._queue_cache_at = time.monotonic()

    @staticmethod
    def _raise_remote(resp: dict[str, Any]) -> Any:
        if resp.get("ok"):
            return resp.get("result")
        etype = resp.get("error_type", "LLMError")
        message = resp.get("message", "remote pool error")
        if etype == "LLMUnavailable":
            raise LLMUnavailable(message,
                                 retry_after_s=resp.get("retry_after_s", 1))
        raise LLMError(message)

    async def _call(self, method: str, params: dict[str, Any]) -> Any:
        from ..coordination.rpc import RpcError
        params["tenant"] = tenant_ctx.current_tenant()
        if self.ready_local:
            handler = {"pool.chat": self._serve_chat,
                       "pool.embed": self._serve_embed,
                       "pool.classify": self._serve_classify,
                       "pool.set_role": self._serve_set_role}[method]
            return self._raise_remote(await handler(params))
        owner = await self._remote_owner()
        try:
            return self._raise_remote(
                await self.rpc.call(owner, method, params,
                                    timeout_s=self.rpc_timeout_s))
        except RpcError as exc:
            # owner died mid-call / partition: 503 + Retry-After — the
            # next attempt lands on the re-elected owner
            raise LLMUnavailable(
                f"pool owner unreachable: {exc}",
                retry_after_s=max(1, int(self.lease_ttl / 3))) from exc

    async def chat(self, request: dict[str, Any]) -> dict[str, Any]:
        return await self._call("pool.chat", {"body": request})

    async def chat_stream(self, request: dict[str, Any]
                          ) -> AsyncIterator[dict[str, Any]]:
        from ..coordination.rpc import RpcAppError, RpcError
        tenant = tenant_ctx.current_tenant()
        if self.ready_local:
            async for chunk in self._serve_chat_stream(
                    {"body": request, "tenant": tenant}):
                yield chunk
            return
        owner = await self._remote_owner()
        try:
            async for chunk in self.rpc.call_stream(
                    owner, "pool.chat_stream",
                    {"body": request, "tenant": tenant},
                    idle_timeout_s=self.stream_idle_timeout_s):
                yield chunk
        except RpcAppError as exc:
            message = str(exc)
            if message.startswith("LLMUnavailable"):
                raise LLMUnavailable(message.split(":", 1)[-1].strip() or
                                     message) from exc
            raise LLMError(message) from exc
        except RpcError as exc:
            raise LLMUnavailable(
                f"pool owner lost mid-stream: {exc}",
                retry_after_s=max(1, int(self.lease_ttl / 3))) from exc

    async def embed(self, texts: list[str],
                    model: str | None = None) -> list[list[float]]:
        return await self._call("pool.embed", {"texts": texts,
                                               "model": model})

    async def classify(self, texts: list[str]) -> list[float]:
        return await self._call("pool.classify", {"texts": texts})

    async def set_role(self, replica: str, role: str) -> dict[str, Any]:
        """Retarget one owner-pool replica's role from ANY worker."""
        return await self._call("pool.set_role",
                                {"replica": replica, "role": role})

    def stats(self) -> dict[str, Any]:
        return {"worker_id": self.worker_id, "is_owner": self.is_owner,
                "provider_ready": self.local_provider is not None,
                "elections_won": self.elections_won,
                "build_failures": self.build_failures}


class SharedPoolProvider(LLMProvider):
    """LLM registry provider backed by the shared plane: local calls on
    the owning worker, RPC forwarding elsewhere — every worker serves
    LLM traffic, one copy of HBM state."""

    provider_type = "tpu_local_shared"

    def __init__(self, name: str, plane: SharedEnginePlane) -> None:
        self.name = name
        self.plane = plane

    async def chat(self, request: dict[str, Any]) -> dict[str, Any]:
        return await self.plane.chat(request)

    async def chat_stream(self, request: dict[str, Any]
                          ) -> AsyncIterator[dict[str, Any]]:
        async for chunk in self.plane.chat_stream(request):
            yield chunk

    async def embed(self, texts: list[str],
                    model: str | None = None) -> list[list[float]]:
        return await self.plane.embed(texts, model=model)

    async def classify(self, texts: list[str]) -> list[float]:
        return await self.plane.classify(texts)

    async def shutdown(self) -> None:
        await self.plane.stop()
