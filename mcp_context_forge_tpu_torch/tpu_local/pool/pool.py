"""EnginePool: an affinity-routed serving tier of several engine replicas
(a copy of the JAX package's ``tpu_local/pool/pool.py``).

One ``TorchEngine`` is one device, one dispatch thread, one failure
domain. The pool owns N of them behind the submit/generate surface the
provider already speaks, and adds what one replica cannot have:

- **routing** (``router.py``): prefix-cache affinity first, then least
  outstanding decode tokens; priorities ride through to each replica's own
  scheduler;
- **failover** (``health.py``): a crashed or wedged replica's in-flight
  requests REQUEUE onto healthy replicas as continuations: the new prompt
  is the original prompt plus the tokens already emitted, so consumers see
  every token exactly once. Requeued shadows carry ``queue_observed`` and
  ``ttft_observed`` so that a logical request's queue wait and TTFT are
  observed once;
- **drain/reload**: a rolling rebuild of one replica (drain, rebuild the
  engine from ``config``, readmit) while the rest of the pool serves, with
  its resident prefix pages spilled to the shared tiers first;
- **disaggregated prefill/decode**: replicas carry ROLES (``prefill``,
  ``decode``, ``any``) and the router classes each admission by prompt
  length (or ``GenRequest.route_class``). A prefill-classed request lands
  on a prefill replica capped at ONE token; its prompt's KV chain is
  exported into the pool-shared spill tiers, verified page by page against
  its token content (the gate admission restores go through), and the
  request continues on a decode replica as a pool-shadow continuation, the
  mechanism failover uses. Any failed step decodes in place on the prefill
  replica; a migration never loses a stream.

Requests never reach an engine directly: the pool submits a *shadow*
request and pumps its stream into the client's, which is where failover
intercepts an engine's "error" terminal.

All pool state lives on the asyncio loop; the engines' dispatch threads
are reached only through their thread-safe submit, cancel, export, kill
and liveness calls.

Where the port differs from the reference:

- ``partition_devices`` hands each replica its device subset (every
  replica shares the whole list when there are fewer devices than
  replicas, as on one card). An explicit ``mesh_shape`` sized for the
  whole machine falls back to the automatic mesh per replica, with the
  reference's warning. One process holds one multi-rank engine
  (``ranks.py``), so only a pool of one replica serves on its whole
  subset as a multi-rank engine (``EngineReplica.status()`` reports its
  world as ``mesh_devices``); each replica of a larger pool serves on its
  subset's first device, and a larger pool whose replicas would each take
  the rank path (a ``mesh_shape`` that fits, an ``sp_impl``) refuses to
  build;
- replicas that share one card share its CUDA context: a sticky device
  error (an illegal address) poisons every replica of the process, so on
  one card failover covers host-side failures only (a dispatch-thread
  exception, an ``engine.dispatch`` fault, a wedge);
- ``warmed`` is true from construction (the decode graphs are captured
  then), so the wedge arm of the health monitor is live at once;
- a reload collects the replaced engine at once (its device memory is
  freed only by the cycle collector), so that a later reload does not
  build beside an engine already dropped.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import logging
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Sequence

from ...observability import trace_extra
from ...utils import new_id
from ..engine import EngineConfig, EngineStats, GenRequest, TorchEngine, probe_devices
from ..parallel.mesh import mesh_shape_from_string
from .health import HealthMonitor
from .router import ReplicaRouter

logger = logging.getLogger(__name__)

#: the legal replica roles: "prefill"/"decode" split the phases, "any" is
#: the generalist every pool starts with (a plain string, so that fleet
#: classes can ride the same router narrowing)
REPLICA_ROLES = ("prefill", "decode", "any")


def partition_devices(devices: list, n: int) -> list[list]:
    """Split the device list among n replicas.

    With at least n devices each replica gets an equal contiguous slice
    (the remainder idles, with a warning). With fewer devices than
    replicas (the CPU, one card) every replica gets the whole list: the
    same answers, the throughput shared."""
    if n <= 1:
        return [list(devices)]
    if len(devices) >= n:
        per = len(devices) // n
        dropped = len(devices) - per * n
        if dropped:
            logger.warning("engine pool: %d device(s) idle (%d devices / %d replicas)",
                           dropped, len(devices), n)
        return [list(devices[i * per:(i + 1) * per]) for i in range(n)]
    logger.info("engine pool: %d replicas sharing %d device(s)", n, len(devices))
    return [list(devices) for _ in range(n)]


@dataclass
class PoolRecord:
    """One logical client request as the pool tracks it: the client-facing
    GenRequest (never submitted to an engine) and the engine-facing shadow
    serving it now."""
    request: GenRequest
    shadow: GenRequest
    replica: "EngineReplica"
    attempts: int = 1            # dispatches so far (1 = never requeued)
    pump: asyncio.Task | None = None
    done: bool = False
    # this shadow is the one-token PREFILL leg of a migration: its "length"
    # terminal means "hand off to a decode replica", not "budget spent"
    migrate_leg: bool = False


class EngineReplica:
    """One engine and the pool's view of it."""

    STATES = ("ready", "draining", "reloading", "dead")

    def __init__(self, rid: str, index: int, engine: TorchEngine,
                 role: str = "any") -> None:
        self.id = rid
        self.index = index
        self.engine = engine
        self.state = "ready"
        self.role = role
        self.outstanding: dict[str, PoolRecord] = {}
        self.routed = 0
        self.requeued_off = 0
        self.reloads = 0
        self.failures = 0
        self.last_failure = ""
        self.migrations_out = 0   # prefill legs this replica handed off
        self.migrations_in = 0    # decode continuations it received

    def outstanding_tokens(self) -> int:
        """Budgeted work still owed: the router's least-loaded signal."""
        return sum(max(0, rec.request.max_tokens - len(rec.request.generated))
                   for rec in self.outstanding.values())

    def status(self) -> dict[str, Any]:
        engine = self.engine
        stats = engine.stats
        return {
            "id": self.id,
            "state": self.state,
            "role": self.role,
            "model": engine.config.model,
            "device": str(engine.device),
            "mesh_devices": engine.world,
            "dispatch_alive": engine.dispatch_alive(),
            "heartbeat_age_s": round(engine.heartbeat_age(), 3),
            # occupancy: slots carrying work now against capacity
            "occupancy": len(engine._running) + len(engine._chunking),
            "max_batch": engine.config.max_batch,
            "outstanding": len(self.outstanding),
            "outstanding_tokens": self.outstanding_tokens(),
            "kv_pages_in_use": engine.allocator.pages_in_use,
            "queue_depth": stats.queue_depth,
            "requests": stats.requests,
            "completion_tokens": stats.completion_tokens,
            "decode_steps": stats.decode_steps,
            "engine_restarts": stats.engine_restarts,
            "routed": self.routed,
            "requeued_off": self.requeued_off,
            "migrations_out": self.migrations_out,
            "migrations_in": self.migrations_in,
            "reloads": self.reloads,
            "failures": self.failures,
            "last_failure": self.last_failure,
            # kernel builds and graph captures by stage: a serving-stage
            # event on a warmed replica stalls traffic, and the health
            # monitor's wedge bar assumes there is none
            "xla_compiles": engine.compile_stats(),
            "roofline": engine.roofline_snapshot(),
            # the per-tier hit split and spill/restore counts (None when
            # neither tiers nor an index are wired)
            "prefix_tiers": engine.tier_stats(),
        }


class EnginePool:
    """N TorchEngine replicas behind the single-engine serving surface."""

    def __init__(self, config: EngineConfig, replicas: int = 2,
                 tracer=None, metrics=None,
                 affinity_routing: bool = True,
                 health_interval_s: float = 0.5,
                 heartbeat_timeout_s: float = 10.0,
                 requeue_max: int = 2,
                 devices: list | None = None,
                 engine_factory: Callable[..., TorchEngine] | None = None,
                 ledger=None, signals=None,
                 roles: str | Sequence[str] | None = None,
                 disagg_prompt_tokens: int = 64,
                 role_penalty_tokens: int = 256):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.config = config
        self.tracer = tracer
        self.metrics = metrics
        # one signal bus and one tenant ledger for every replica, rebuilt
        # engines included: per-replica aggregates and per-tenant counts
        # survive failover and reloads
        self.signals = signals
        self.ledger = ledger
        if devices is None:
            devices = probe_devices(config.init_timeout_s, config.device)
        self._device_sets = partition_devices(devices, replicas)
        # an explicit mesh_shape is sized for the WHOLE machine; replicas
        # get a device subset, so the spec would fail every replica's mesh
        # (e.g. "1x8" on a 2-replica pool of 8 cards, where each replica
        # holds 4). Fall back to the auto mesh rather than refusing to
        # boot: one device per replica, since one process holds one
        # multi-rank engine.
        self._mesh_shape = config.mesh_shape
        per = len(self._device_sets[0])
        if self._mesh_shape and replicas > 1:
            try:
                mesh_shape_from_string(self._mesh_shape, per)
            except ValueError:
                logger.warning(
                    "engine pool: mesh shape %r does not fit the %d "
                    "device(s) each of %d replicas receives — using the "
                    "auto mesh per replica (one device each)",
                    self._mesh_shape, per, replicas)
                self._mesh_shape = ""
        if replicas > 1 and (self._mesh_shape or config.sp_impl != "none"):
            raise NotImplementedError(
                f"several multi-rank replicas in one pool are not carried yet "
                f"(mesh_shape {self._mesh_shape!r}, sp_impl {config.sp_impl!r} on "
                f"{replicas} replicas): one process holds one multi-rank engine")
        if replicas > 1 and per > 1:
            logger.warning("engine pool: each of %d replicas serves on the first of "
                           "its %d devices (one process holds one multi-rank engine)",
                           replicas, per)
        # the pool-wide prefix plane: ONE index maps chain hashes to
        # (replica | tier) locations, which the router scores as affinity,
        # and with prefix_tiers ONE spill store serves every replica, so a
        # prefix prefilled (then evicted) on any replica restores into the
        # admitting replica's pool. Both outlive rebuilt engines.
        self.prefix_index = None
        self.tier_store = None
        if config.prefix_cache:
            from ..kv.prefix_index import PrefixIndex
            self.prefix_index = PrefixIndex()
            if config.prefix_tiers:
                from ..kv.fabric.object_store import object_store_or_none
                from ..kv.tiers import TieredPageStore
                self.tier_store = TieredPageStore(
                    host_bytes=config.tier_host_bytes,
                    disk_bytes=config.tier_disk_bytes,
                    disk_dir=config.tier_disk_dir,
                    index=self.prefix_index, metrics=metrics,
                    device=self._device_sets[0][0],
                    io_retry_max=config.tier_io_retry_max,
                    io_retry_backoff_ms=config.tier_io_retry_backoff_ms,
                    object_store=object_store_or_none(config.tier_object_url),
                    object_namespace=config.fabric_namespace)
        self.requeue_max = max(0, requeue_max)
        self._factory = engine_factory or (
            lambda cfg, tracer, metrics, ledger=None, tier_store=None,
            prefix_index=None, devices=None: TorchEngine(
                cfg, tracer=tracer, metrics=metrics, ledger=ledger,
                tier_store=tier_store, prefix_index=prefix_index, devices=devices))
        # roles: static here (a comma string or a sequence), live through
        # set_role and the admin surface. Short lists pad with "any"; an
        # unknown role refuses to build rather than route everything
        role_list: list[str] = []
        if roles:
            parts = roles.split(",") if isinstance(roles, str) else list(roles)
            role_list = [str(p).strip().lower() for p in parts if str(p).strip()]
            for role in role_list:
                if role not in REPLICA_ROLES:
                    raise ValueError(f"unknown replica role {role!r} "
                                     f"(roles are {list(REPLICA_ROLES)})")
        self.disagg_prompt_tokens = max(1, int(disagg_prompt_tokens))
        self.replicas: list[EngineReplica] = []
        for i in range(replicas):
            self.replicas.append(EngineReplica(
                str(i), i, self._build_engine(i),
                role=role_list[i] if i < len(role_list) else "any"))
        self.router = ReplicaRouter(affinity=affinity_routing, index=self.prefix_index,
                                    page_size=config.page_size,
                                    role_penalty_tokens=role_penalty_tokens)
        self.health = HealthMonitor(self, interval_s=health_interval_s,
                                    heartbeat_timeout_s=heartbeat_timeout_s)
        self.tokenizer = self.replicas[0].engine.tokenizer
        # where the provider places what it runs beside the engines
        self.device = self.replicas[0].engine.device
        self.requeues = 0
        # migration accounting; conservation: pages spilled == pages
        # restored + pages degraded in place
        self.migrations = {"ok": 0, "degraded": 0}
        self.migration_pages = {"spilled": 0, "restored": 0, "degraded": 0}
        self.migration_bytes = 0
        self._started = False
        self._stopping = False
        self._set_up_gauges()

    def _build_engine(self, index: int) -> TorchEngine:
        subset = self._device_sets[index]
        cfg = dataclasses.replace(self.config, replica_id=str(index),
                                  device=str(subset[0]), mesh_shape=self._mesh_shape)
        # a pool of one replica serves on its whole subset (a multi-rank
        # engine when it holds several devices); a larger pool's replica on
        # its subset's first device, as cfg.device names it
        extra = ({"devices": list(subset)}
                 if len(self._device_sets) == 1 and len(subset) > 1 else {})
        engine = self._factory(cfg, self.tracer, self.metrics, ledger=self.ledger,
                               tier_store=self.tier_store,
                               prefix_index=self.prefix_index, **extra)
        if self.signals is not None:
            engine.signals = self.signals
        return engine

    # --------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._stopping = False
        for replica in self.replicas:
            if replica.state == "ready":
                await replica.engine.start()
        await self.health.start()

    async def stop(self) -> None:
        self._stopping = True
        self._started = False
        await self.health.stop()
        for replica in self.replicas:
            try:
                await replica.engine.stop()
            except Exception:
                logger.exception("engine pool: replica %s stop failed", replica.id)
        # the shared spill store outlives every replica's engine (reloads
        # rebuild engines on it); it closes with the pool
        if self.tier_store is not None:
            self.tier_store.close()

    def warmup(self, mode: str | None = None) -> None:
        """Every replica's ``warmup`` (captured at construction already)."""
        for replica in self.replicas:
            replica.engine.warmup(mode)

    # -------------------------------------------------------------- submission

    async def submit(self, request: GenRequest) -> GenRequest:
        """Route and dispatch one request; the contract of
        ``TorchEngine.submit`` (tokens arrive on ``request.stream``,
        None-terminated, ``finish_reason`` filled)."""
        await self._dispatch(request, attempts=1)
        return request

    async def generate(self, prompt_ids: list[int], **kwargs) -> AsyncIterator[int]:
        request = GenRequest(request_id=new_id(), prompt_ids=prompt_ids, **kwargs)
        await self.submit(request)
        while True:
            token = await request.stream.get()
            if token is None:
                break
            yield token

    def cancel(self, request_id: str) -> bool:
        """Cancel a logical request wherever it runs. The record is keyed
        by the client-facing id; the engine is told the shadow's (``~rN``
        after a requeue), so a request stays cancellable by its own id
        after failover. The engine's ``cancelled`` terminal reaches the
        client through the pump."""
        for replica in self.replicas:
            record = replica.outstanding.get(request_id)
            if record is not None:
                return replica.engine.request_cancel(record.shadow.request_id)
        return False

    def _routable(self) -> list[EngineReplica]:
        return [r for r in self.replicas if r.state == "ready"]

    # ------------------------------------------------------------------- roles

    @property
    def roles_active(self) -> bool:
        """True once any replica holds a role other than "any": the gate of
        classification and migration (a uniform pool routes as if roles
        did not exist)."""
        return any(r.role != "any" for r in self.replicas)

    def set_role(self, rid: str, role: str) -> dict[str, Any]:
        """Reassign one replica's role live. Routing-only state: in-flight
        work finishes where it runs; only later admissions see it."""
        replica = self._replica(rid)
        role = str(role).strip().lower()
        if role not in REPLICA_ROLES:
            raise ValueError(f"role must be one of {list(REPLICA_ROLES)}, got {role!r}")
        if replica.role != role:
            logger.info("engine pool: replica %s role %s -> %s", rid, replica.role, role)
            replica.role = role
        return replica.status()

    def _classify(self, request: GenRequest) -> str:
        """The admission's route class: an explicit ``route_class`` wins;
        else long prompts are prefill-heavy, short ones decode-heavy."""
        if not self.roles_active:
            return ""
        if request.route_class:
            return request.route_class
        return ("prefill" if len(request.prompt_ids) >= self.disagg_prompt_tokens
                else "decode")

    def _migration_eligible(self, request: GenRequest, attempts: int,
                            replica: EngineReplica) -> bool:
        """Whether this dispatch runs as a one-token prefill leg handed off
        to a decode replica: only a first dispatch (a continuation already
        carries tokens), only on a prefill replica, only with the shared
        tiers to carry the pages, at least one full page to carry, more
        than one token owed, and a decode-capable replica to land on."""
        return (attempts == 1 and not request.generated
                and replica.role == "prefill"
                and self.tier_store is not None
                and request.max_tokens > 1
                and len(request.prompt_ids) >= self.config.page_size
                and any(r is not replica and r.state == "ready"
                        and r.role in ("decode", "any") for r in self.replicas))

    # ---------------------------------------------------------------- dispatch

    async def _dispatch(self, request: GenRequest, attempts: int,
                        pin: EngineReplica | None = None) -> EngineReplica | None:
        """Pick a replica, submit the shadow, start the pump; a submit that
        fails (racing a crash) moves on to the next replica. Returns the
        replica the request landed on (None: no capacity, the stream ended
        "unavailable"). A ``pin`` (the migration's decode target, or its
        decode-in-place fallback) is tried first and is never reclassified
        or migrated again; a pin that refuses falls back to routing."""
        last_error: Exception | None = None
        route_class = "" if pin is not None else self._classify(request)
        for _ in range(len(self.replicas) + (1 if pin is not None else 0)):
            if pin is not None and pin.state == "ready":
                replica, affinity_hit = pin, False
            else:
                routable = self._routable()
                if not routable:
                    break
                replica, affinity_hit = self.router.route(
                    routable, request.prompt_ids, route_class)
            migrate_leg = (pin is None and route_class == "prefill"
                           and self._migration_eligible(request, attempts, replica))
            shadow = self._make_shadow(request, attempts, cap=1 if migrate_leg else 0)
            record = PoolRecord(request=request, shadow=shadow, replica=replica,
                                attempts=attempts, migrate_leg=migrate_leg)
            try:
                await replica.engine.submit(shadow)
            except RuntimeError as exc:
                # the dispatch thread died between the health sweep and
                # now: mark it so the router stops offering it
                last_error = exc
                self.fail_replica(replica, reason=f"submit refused: {exc}")
                if replica is pin:
                    pin = None
                continue
            if replica.state == "dead":
                # the sweep failed the replica while submit awaited queue
                # room and already swept its records: a record registered
                # now would sit on a replica no sweep revisits
                last_error = RuntimeError(f"replica {replica.id} died during submit")
                if replica is pin:
                    pin = None
                continue
            replica.routed += 1
            replica.outstanding[request.request_id] = record
            record.pump = asyncio.get_running_loop().create_task(
                self._pump(record), name=f"pool-pump-{request.request_id}")
            m = self.metrics
            if m is not None:
                m.llm_pool_routed.labels(
                    replica=replica.id, affinity="hit" if affinity_hit else "miss").inc()
                m.llm_pool_outstanding.labels(replica=replica.id).set(
                    len(replica.outstanding))
            return replica
        # no replica could take it: capacity loss, not a broken request.
        # The "unavailable" terminal maps to a 503 + Retry-After
        logger.error("engine pool: no routable replica for %s (%s)",
                     request.request_id, last_error, extra=trace_extra(request.trace_ctx))
        if request.finish_reason is None:
            request.finish_reason = "unavailable"
        request.stream.put_nowait(None)
        return None

    def _make_shadow(self, request: GenRequest, attempts: int, cap: int = 0) -> GenRequest:
        """The engine-facing request. On a requeue the prompt is the
        continuation (the original prompt and every token delivered), so
        the survivor resumes where the failed replica stopped and nothing
        is emitted twice; the once-only guards keep the queue wait and the
        TTFT observed once. A non-zero ``cap`` bounds the budget below the
        remainder: a migration's prefill leg runs with cap 1."""
        suffix = "" if attempts == 1 else f"~r{attempts - 1}"
        budget = max(1, request.max_tokens - len(request.generated))
        if cap:
            budget = min(budget, cap)
        return GenRequest(
            request_id=f"{request.request_id}{suffix}",
            prompt_ids=list(request.prompt_ids) + list(request.generated),
            max_tokens=budget,
            temperature=request.temperature,
            top_k=request.top_k,
            top_p=request.top_p,
            stop_ids=request.stop_ids,
            priority=request.priority,
            created=request.created,
            # billing identity rides every shadow, continuations included
            tenant=request.tenant,
            trace_ctx=request.trace_ctx,
            queue_observed=attempts > 1,
            # a first token already delivered means the TTFT was observed
            ttft_observed=len(request.generated) > 0,
        )

    async def _pump(self, record: PoolRecord) -> None:
        """Forward the shadow's tokens to the client's stream; at the
        terminal, finish the client or hand the record to failover.
        Cancelled (without side effects) when a takeover claims it."""
        shadow = record.shadow
        request = record.request
        while True:
            token = await shadow.stream.get()
            if token is None:
                break
            request.generated.append(token)
            request.stream.put_nowait(token)
        await self._on_shadow_done(record)

    async def _on_shadow_done(self, record: PoolRecord) -> None:
        replica = record.replica
        request = record.request
        replica.outstanding.pop(request.request_id, None)
        if self.metrics is not None:
            self.metrics.llm_pool_outstanding.labels(replica=replica.id).set(
                len(replica.outstanding))
        reason = record.shadow.finish_reason or "stop"
        if reason == "error" and not self._stopping:
            # an engine posts "error" only from its crash paths: replica
            # evidence, then finish the request elsewhere
            if not replica.engine.dispatch_alive():
                self.fail_replica(replica, reason="stream error + dead dispatch")
            await self._requeue(record)
            return
        if (record.migrate_leg and reason == "length" and not self._stopping
                and request.finish_reason is None
                and len(request.generated) < request.max_tokens):
            # the prefill leg spent its cap, not the request's budget: hand
            # the chain to a decode replica ("stop" here means the first
            # token finished the request, a plain terminal)
            await self._migrate(record)
            return
        record.done = True
        if request.finish_reason is None:
            request.finish_reason = reason
        request.stream.put_nowait(None)

    # --------------------------------------------------------------- migration

    async def _migrate(self, record: PoolRecord) -> None:
        """The prefill -> decode hop: export the prompt's KV chain into the
        shared tiers at the source engine's drain barrier, verify every
        page against its token content (a corrupt payload is a miss, never
        a wrong page), then continue on a decode replica as a pool-shadow
        continuation. Any failed step decodes in place on the prefill
        replica instead. Conservation: every spilled page counts restored
        (the hop landed) or degraded (anything else)."""
        from ...observability.faults import fault_point
        from ..kv.prefix_index import chain_pages
        request = record.request
        src = record.replica
        started = time.time()
        page_size = self.config.page_size
        expected = len(request.prompt_ids) // page_size
        spilled = 0
        moved_bytes = 0
        corrupt = False
        target: EngineReplica | None = None
        failure = ""
        try:
            # fault point pool.migrate: an error fails the hop (decode in
            # place), a latency stretches it, corrupt mangles the chain's
            # identity below so that the verify rejects the payload
            act = fault_point("pool.migrate", scope=request.request_id)
            if act is not None:
                if act.kind == "corrupt":
                    corrupt = True
                else:
                    await act.async_apply()
            # 1) export: a COPY of the resident chain pages into the shared
            # store at the source's drain barrier; on a later failure they
            # are still resident for decode in place
            spilled = await asyncio.wait_for(
                asyncio.wrap_future(src.engine.request_chain_export(request.prompt_ids)),
                timeout=30.0)
            if spilled < expected:
                raise RuntimeError(f"chain export covered {spilled}/{expected} pages")
            # 2) verify before serving, on the pool's side, with the token
            # content the decode replica will ask for. An injected corrupt
            # changes the first page's expected chunk, so the store's check
            # fails as a real collision would: the entry drops
            steps = chain_pages(request.prompt_ids, page_size)
            if corrupt and steps:
                key_hash, parent, chunk = steps[0]
                steps[0] = (key_hash, parent, (chunk[0] + 1,) + tuple(chunk[1:]))
            verified, moved_bytes = self.tier_store.verify_chain(steps)
            if verified < expected:
                raise RuntimeError(f"verify before serving passed {verified}/{expected} pages")
            # 3) the decode target: role-aware routing over the decode-
            # capable survivors (never the source), scored on the
            # continuation prompt so tier affinity counts
            candidates = [r for r in self._routable()
                          if r is not src and r.role in ("decode", "any")]
            if not candidates:
                raise RuntimeError("no decode-capable target replica")
            target, _ = self.router.route(
                candidates, list(request.prompt_ids) + list(request.generated),
                route_class="decode")
        except Exception as exc:  # FaultError included: degrade, never die
            failure = str(exc)
            target = None
        if target is None:
            logger.warning("engine pool: migration of %s decoding in place on "
                           "replica %s (%s)", request.request_id, src.id,
                           failure or "no target", extra=trace_extra(request.trace_ctx))
        # 4) continue as a pool-shadow continuation, pinned to the target
        # (or to the source, in place); a pin that refuses falls back to
        # routing, so only total capacity loss ends the stream
        landed = await self._dispatch(request, attempts=record.attempts + 1,
                                      pin=target if target is not None else src)
        outcome = "ok" if target is not None and landed is target else "degraded"
        self.migrations[outcome] += 1
        self.migration_pages["spilled"] += spilled
        self.migration_pages["restored" if outcome == "ok" else "degraded"] += spilled
        self.migration_bytes += moved_bytes
        if outcome == "ok":
            src.migrations_out += 1
            landed.migrations_in += 1
        to_id = landed.id if landed is not None else src.id
        m = self.metrics
        if m is not None:
            m.llm_pool_migrations.labels(src.id, to_id, outcome).inc()
            m.llm_pool_migration_seconds.observe(time.time() - started)
            if spilled:
                m.llm_pool_migration_pages.labels("spilled").inc(spilled)
                m.llm_pool_migration_pages.labels(
                    "restored" if outcome == "ok" else "degraded").inc(spilled)
            if moved_bytes:
                m.llm_pool_migration_bytes.inc(moved_bytes)
        if self.tracer is not None and request.trace_ctx is not None:
            # the hop as a span, joining the two replicas' llm.* spans in
            # one trace
            try:
                attrs = {"llm.from_replica": src.id, "llm.to_replica": to_id,
                         "llm.pages": spilled, "llm.outcome": outcome}
                if failure:
                    attrs["llm.failure"] = failure[:200]
                if request.tenant:
                    attrs["llm.tenant"] = request.tenant
                self.tracer.emit_span("pool.migrate", started, time.time(),
                                      trace_ctx=request.trace_ctx, attributes=attrs)
            except Exception:
                pass  # telemetry must never break the hop

    # ---------------------------------------------------------------- failover

    def fail_replica(self, replica: EngineReplica, reason: str = "") -> None:
        """Take a replica out of rotation and requeue its in-flight
        requests. Idempotent; called by the health monitor and by the
        submit and pump paths."""
        if replica.state == "dead":
            return
        replica.state = "dead"
        replica.failures += 1
        replica.last_failure = reason or "failed"
        logger.error("engine pool: replica %s marked dead (%s)",
                     replica.id, replica.last_failure)
        if self.metrics is not None:
            self.metrics.llm_pool_replica_up.labels(replica=replica.id).set(0)
        # signal, never join: a wedged dispatch thread must not delay the
        # requeue, and a zombie that revives exits at its next loop check
        # (its late emissions land in abandoned shadow streams)
        replica.engine.kill()
        client = getattr(replica.engine, "_tier_client", None)
        if client is not None:
            # the dead engine's pool pages are unreachable: forget its
            # index entries (pages already spilled keep serving everyone)
            client.drop_replica()
        survivors = self._take_over_records(replica)
        if survivors:
            asyncio.get_running_loop().create_task(
                self._requeue_batch(survivors), name=f"pool-requeue-{replica.id}")

    def _take_over_records(self, replica: EngineReplica) -> list[PoolRecord]:
        """Detach a replica's in-flight records: cancel the pumps, forward
        what each shadow stream already holds (tokens the consumer must
        neither lose nor see twice), deliver a terminal that raced the
        takeover, and return the records that still need a home. Used by
        failover and by a reload whose drain timed out."""
        records = list(replica.outstanding.values())
        replica.outstanding.clear()
        if self.metrics is not None:
            self.metrics.llm_pool_outstanding.labels(replica=replica.id).set(0)
        survivors: list[PoolRecord] = []
        for record in records:
            if record.pump is not None:
                record.pump.cancel()
            finished = self._drain_shadow(record)
            if finished and (record.shadow.finish_reason or "stop") != "error":
                # the shadow completed (its terminal raced the takeover)
                record.done = True
                if record.request.finish_reason is None:
                    record.request.finish_reason = record.shadow.finish_reason or "stop"
                record.request.stream.put_nowait(None)
                continue
            survivors.append(record)
        return survivors

    def _drain_shadow(self, record: PoolRecord) -> bool:
        """Forward what the failed replica already put in the shadow's
        stream; True if the terminal None was there."""
        while True:
            try:
                token = record.shadow.stream.get_nowait()
            except asyncio.QueueEmpty:
                return False
            if token is None:
                return True
            record.request.generated.append(token)
            record.request.stream.put_nowait(token)

    async def _requeue_batch(self, records: list[PoolRecord]) -> None:
        for record in records:
            await self._requeue(record)

    async def _requeue(self, record: PoolRecord) -> None:
        from ...observability.faults import FaultError, fault_point
        request = record.request
        if record.done or request.finish_reason is not None:
            return
        old = record.replica
        if len(request.generated) >= request.max_tokens:
            # the failed replica had emitted the whole budget
            record.done = True
            request.finish_reason = "length"
            request.stream.put_nowait(None)
            return
        if (self._stopping or record.attempts - 1 >= self.requeue_max
                or not self._routable()):
            # the requeue budget is spent or nowhere is left: the stream
            # ends "unavailable" (LLMUnavailable, a 503 + Retry-After)
            record.done = True
            request.finish_reason = "unavailable"
            request.stream.put_nowait(None)
            return
        # fault point pool.requeue: an error fails this hop as a spent
        # budget does; a latency delays the continuation
        act = fault_point("pool.requeue", scope=request.request_id)
        if act is not None:
            try:
                await act.async_apply()
            except FaultError:
                record.done = True
                request.finish_reason = "unavailable"
                request.stream.put_nowait(None)
                return
        self.requeues += 1
        # counted here, whichever path triggered the requeue, so the
        # status card's requeued_off and the requeue counter agree
        old.requeued_off += 1
        if self.metrics is not None:
            self.metrics.llm_pool_requeues.labels(replica=old.id).inc()
        logger.warning("engine pool: requeueing %s off replica %s (%d tokens "
                       "already delivered)", request.request_id, old.id,
                       len(request.generated), extra=trace_extra(request.trace_ctx))
        requeued_at = time.time()
        await self._dispatch(request, attempts=record.attempts + 1)
        if self.tracer is not None and request.trace_ctx is not None:
            # the failover hop as a span, joining the killed replica's
            # llm.* spans to the successor's in one trace
            try:
                attrs = {"llm.from_replica": old.id,
                         "llm.attempt": record.attempts + 1,
                         "llm.tokens_delivered": len(request.generated)}
                if request.tenant:
                    attrs["llm.tenant"] = request.tenant
                self.tracer.emit_span("pool.requeue", requeued_at, time.time(),
                                      trace_ctx=request.trace_ctx, attributes=attrs)
            except Exception:
                pass  # telemetry must never break failover

    # ------------------------------------------------------------ drain/reload

    def _replica(self, rid: str) -> EngineReplica:
        for replica in self.replicas:
            if replica.id == rid:
                return replica
        raise KeyError(f"no replica {rid!r} (have {[r.id for r in self.replicas]})")

    async def drain(self, rid: str, timeout_s: float = 60.0) -> dict[str, Any]:
        """Stop routing new work to the replica and wait for its in-flight
        requests to finish on it. Idempotent; ``undrain`` reverses it."""
        replica = self._replica(rid)
        if replica.state == "ready":
            replica.state = "draining"
            if self.metrics is not None:
                self.metrics.llm_pool_replica_up.labels(replica=replica.id).set(0)
        deadline = time.monotonic() + max(0.0, timeout_s)
        while replica.outstanding and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        status = replica.status()
        status["drained"] = not replica.outstanding
        return status

    async def undrain(self, rid: str) -> dict[str, Any]:
        """Readmit a drained (or draining) replica to the router."""
        replica = self._replica(rid)
        if replica.state != "draining":
            raise ValueError(f"replica {rid} is {replica.state}, not draining")
        replica.state = "ready"
        if self.metrics is not None:
            self.metrics.llm_pool_replica_up.labels(replica=replica.id).set(1)
        return replica.status()

    async def reload(self, rid: str, timeout_s: float = 60.0) -> dict[str, Any]:
        """Rolling rebuild: drain, rebuild the engine (weights read anew
        from ``config.checkpoint``, or drawn from the seed), readmit. The
        rest of the pool serves throughout; a dead replica can be reloaded
        too (its recovery)."""
        replica = self._replica(rid)
        if replica.state == "reloading":
            raise ValueError(f"replica {rid} is already reloading")
        was_dead = replica.state == "dead"
        if not was_dead:
            await self.drain(rid, timeout_s=timeout_s)
            if replica.outstanding:
                # the drain timed out with generations running: stopping
                # the engine would cut them ("cancelled"), while the rest
                # of the pool can finish them as failover does
                stragglers = self._take_over_records(replica)
                if stragglers:
                    logger.warning("engine pool: reload of replica %s requeueing %d "
                                   "request(s) the drain window did not cover",
                                   rid, len(stragglers))
                    await self._requeue_batch(stragglers)
        replica.state = "reloading"
        try:
            await replica.engine.stop()
        except Exception:
            logger.exception("engine pool: replica %s stop during reload failed "
                             "(rebuilding anyway)", rid)
        # a kill()ed engine was never joined (stop() returns at once when
        # it is not started) and its zombie thread pins the old weights
        # and pool: give it a bounded window to exit before a second
        # footprint is committed to the device
        thread = getattr(replica.engine, "_thread", None)
        if thread is not None and thread.is_alive():
            await asyncio.to_thread(thread.join, min(max(timeout_s, 0.0), 30.0))
            if thread.is_alive():
                logger.warning("engine pool: replica %s dispatch thread is still "
                               "wedged; rebuilding anyway (device memory may be "
                               "committed twice until it exits)", rid)
        # spill on drain: with the dispatch thread quiesced and the old
        # engine's device state intact, copy its ref == 0 resident prefix
        # pages into the shared store, so the rebuilt engine (and every
        # sibling) restores the prefix corpus on a miss. A dead or wedged
        # engine is skipped: its device state is suspect
        thread_quiesced = thread is None or not thread.is_alive()
        if not was_dead and thread_quiesced and self.tier_store is not None:
            try:
                spilled = await asyncio.to_thread(replica.engine.spill_prefix_pages)
                if spilled:
                    logger.info("engine pool: reload of replica %s spilled %d "
                                "resident prefix page(s)", rid, spilled)
            except Exception:
                logger.exception("engine pool: spill on drain failed for replica %s "
                                 "(rebuilding anyway)", rid)
        try:
            # construction loads weights and captures graphs: off the loop
            engine = await asyncio.to_thread(self._build_engine, replica.index)
        except Exception:
            replica.state = "dead"
            if self.metrics is not None:
                self.metrics.llm_pool_replica_up.labels(replica=replica.id).set(0)
            raise
        old, replica.engine = replica.engine, engine
        del old
        # a TorchEngine holds reference cycles (bound methods in its graphs
        # and its compile tracker), so its weights, pool and graphs return
        # to the device only when the cycle collector runs: run it now,
        # off the loop, not at some later collection with a second engine
        # already built on top
        await asyncio.to_thread(gc.collect)
        if self._started:
            await engine.start()
        replica.state = "ready"
        replica.reloads += 1
        if self.metrics is not None:
            self.metrics.llm_pool_reloads.labels(replica=replica.id).inc()
            self.metrics.llm_pool_replica_up.labels(replica=replica.id).set(1)
        logger.info("engine pool: replica %s reloaded%s", rid,
                    " (was dead)" if was_dead else "")
        return replica.status()

    # ------------------------------------------------------------- aggregation

    @property
    def stats(self) -> EngineStats:
        """Scheduler counters summed over the replicas (recomputed per
        read)."""
        total = EngineStats()
        for replica in self.replicas:
            for name, value in vars(replica.engine.stats).items():
                setattr(total, name, getattr(total, name) + value)
        return total

    def kv_pages_in_use(self) -> int:
        return sum(r.engine.allocator.pages_in_use for r in self.replicas)

    def kv_bytes_in_use(self) -> int:
        return sum(r.engine.kv_bytes_in_use() for r in self.replicas)

    def device_idle_fraction(self) -> float:
        fracs = [r.engine.device_idle_fraction() for r in self.replicas]
        return sum(fracs) / len(fracs) if fracs else 0.0

    def status(self) -> dict[str, Any]:
        """The /admin/engine/pool payload: per-replica health, occupancy,
        and the routing, failover and migration counters."""
        return {
            "replicas": [r.status() for r in self.replicas],
            "router": {**self.router.counters(),
                       "affinity_routing": self.router.affinity_routing},
            "prefix_tiers": {
                "enabled": self.tier_store is not None,
                "store": self.tier_store.stats() if self.tier_store is not None else None,
                "index": (self.prefix_index.stats()
                          if self.prefix_index is not None else None),
            },
            "roles": {
                "active": self.roles_active,
                "assignment": {r.id: r.role for r in self.replicas},
                "disagg_prompt_tokens": self.disagg_prompt_tokens,
            },
            "migrations": {**self.migrations, "pages": dict(self.migration_pages),
                           "bytes": self.migration_bytes},
            "requeues": self.requeues,
            "requeue_max": self.requeue_max,
            "health": {
                "sweeps": self.health.sweeps,
                "failures": self.health.failures,
                "interval_s": self.health.interval_s,
                "heartbeat_timeout_s": self.health.heartbeat_timeout_s,
            },
        }

    def _set_up_gauges(self) -> None:
        if self.metrics is None:
            return
        for replica in self.replicas:
            self.metrics.llm_pool_replica_up.labels(replica=replica.id).set(1)
            self.metrics.llm_pool_outstanding.labels(replica=replica.id).set(0)
