"""Cross-worker RPC over the event bus (a copy of the JAX package's
``coordination/rpc.py``; stdlib only). Every cross-worker call rides this
one seam; the port's caller is the shared engine plane
(``tpu_local/pool_rpc.py``) and the fabric publisher's ``fabric.advert``.

- :class:`BusRpc` — register named methods, ``call()`` a peer worker
  (unary), or ``call_stream()`` it (server pushes ordered chunks). Peers
  are addressed by worker id; requests ride topic ``rpc.req`` and
  responses ``rpc.res.<worker>`` (each worker subscribes only to its own
  response topic, so stream fan-out never wakes uninvolved workers).
- Streaming is ordered by explicit ``seq`` and terminated by an ``end``
  frame (optionally carrying an error); a client that sees no chunk for
  ``idle_timeout_s`` checks the server's worker heartbeat lease
  (``worker:<id>``, held by ``heartbeat.WorkerHeartbeat``) and terminates
  CLEANLY when the owner is dead — a worker dying mid-stream must never
  hang its consumers.
- The ``coordination.hub.rpc`` fault point (observability/faults.py)
  fires on the CLIENT send path, scoped by method name: ``error`` raises
  a transport-shaped failure, ``latency`` delays the send, and
  ``corrupt`` models a PARTITION — the request frame is silently dropped
  so the caller walks the timeout/liveness path, exactly like a split
  bus.

- Same-tick call batching (``call(..., batch=True)``): small unary
  calls made within one event-loop tick to the same peer coalesce into
  ONE request frame, and the server answers with ONE response frame —
  amortizing the per-frame bus round-trip that serializes under burst
  (the limiter/ledger class of calls). Ordering is preserved: the
  server runs a batch's handlers sequentially in submission order. The
  failure contract is unchanged — each caller keeps its own future,
  timeout, and heartbeat-liveness check, so a peer dying mid-batch fails
  exactly that batch's callers and nobody else.

Wire frames (bus messages):
  rpc.req          {"to", "from", "corr", "method", "params", "stream"}
  rpc.req          {"to", "from", "batch": [{"corr","method","params"}]}
  rpc.res.<worker> {"corr", "result"|"error"}                    unary
                   {"batch": [{"corr", "result"|"error"}, ...]}  batched
                   {"corr", "seq", "chunk"}                      stream
                   {"corr", "end": true, "error": str|null}      stream end
  rpc.req          {"cancel": corr, "to": server}                client gone
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, Awaitable, Callable

from ..observability.faults import fault_point
from ..utils import new_id

logger = logging.getLogger(__name__)

REQ_TOPIC = "rpc.req"
RES_PREFIX = "rpc.res."

# server-side cap on concurrently-open streams per BusRpc (a runaway
# client must not grow relay tasks without bound)
MAX_OPEN_STREAMS = 1024


class RpcError(ConnectionError):
    """Transport-level RPC failure (timeout, dead peer, injected fault).
    ConnectionError so callers' existing transport handlers apply."""


class RpcPeerLost(RpcError):
    """The serving worker died mid-call (heartbeat lease gone)."""


class RpcAppError(RuntimeError):
    """The remote handler raised: re-raised on the caller with the
    remote type name in the message (never a transport retry case)."""


Handler = Callable[[dict[str, Any]], Awaitable[Any]]
StreamHandler = Callable[[dict[str, Any]], AsyncIterator[Any]]


class BusRpc:
    """Request/response + streaming over an EventBus, worker-addressed."""

    def __init__(self, bus: Any, worker_id: str, leases: Any = None,
                 default_timeout_s: float = 30.0,
                 idle_timeout_s: float = 15.0) -> None:
        self.bus = bus
        self.worker_id = worker_id
        self.leases = leases
        self.default_timeout_s = default_timeout_s
        self.idle_timeout_s = idle_timeout_s
        self._handlers: dict[str, Handler] = {}
        self._stream_handlers: dict[str, StreamHandler] = {}
        # client side: corr -> future (unary) | asyncio.Queue (stream)
        self._pending: dict[str, asyncio.Future] = {}
        self._streams: dict[str, asyncio.Queue] = {}
        # server side: corr -> relay task (cancel on client-gone frames)
        self._serving: dict[str, asyncio.Task] = {}
        self._unsubs: list = []
        self._tasks: set[asyncio.Task] = set()  # strong refs (GC safety)
        # client side: per-peer same-tick batch buffers (call(batch=True))
        self._batch_buf: dict[str, list[dict[str, Any]]] = {}
        self._batch_scheduled: set[str] = set()
        self.calls_served = 0
        self.streams_served = 0
        self.batches_sent = 0
        self.batched_calls = 0

    # ------------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self._unsubs.append(self.bus.subscribe(REQ_TOPIC, self._on_request))
        self._unsubs.append(self.bus.subscribe(
            RES_PREFIX + self.worker_id, self._on_response))

    async def stop(self) -> None:
        for unsub in self._unsubs:
            unsub()
        self._unsubs.clear()
        for task in list(self._serving.values()) + list(self._tasks):
            task.cancel()
        for task in list(self._serving.values()) + list(self._tasks):
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._serving.clear()
        for future in self._pending.values():
            if not future.done():
                future.set_exception(RpcError("rpc stopped"))
        self._pending.clear()
        for queue in self._streams.values():
            queue.put_nowait({"end": True, "error": "rpc stopped"})
        self._streams.clear()

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    def register_stream(self, method: str, handler: StreamHandler) -> None:
        self._stream_handlers[method] = handler

    # ------------------------------------------------------------ client side

    async def _send_request(self, frame: dict[str, Any]) -> None:
        """Publish a request frame through the fault seam. ``corrupt``
        models a partition: the frame is DROPPED (the caller times out /
        walks the liveness check) — the same observable failure as a
        split coordination plane."""
        scope = (frame.get("method")
                 or (frame.get("batch") or [{}])[0].get("method"))
        act = fault_point("coordination.hub.rpc", scope=scope)
        if act is not None:
            if act.kind == "corrupt":
                return  # partition: request never leaves this worker
            await act.async_apply()  # latency sleeps, error raises
        await self.bus.publish(REQ_TOPIC, frame)

    async def _peer_alive(self, worker: str) -> bool:
        """Is the peer's heartbeat lease still held? Unknown leases read
        as dead — a caller blocked on a silent peer must terminate."""
        if self.leases is None:
            return True
        try:
            return await self.leases.holder(f"worker:{worker}") == worker
        except Exception:
            return False

    def _enqueue_batch(self, to: str, item: dict[str, Any]) -> None:
        """Buffer one call for ``to``; the first call in a tick schedules
        a flush at the end of the tick (call_soon), so every batched call
        made before the loop turns rides the same request frame."""
        self._batch_buf.setdefault(to, []).append(item)
        if to not in self._batch_scheduled:
            self._batch_scheduled.add(to)
            loop = asyncio.get_running_loop()
            loop.call_soon(lambda: loop.create_task(self._flush_batch(to)))

    async def _flush_batch(self, to: str) -> None:
        self._batch_scheduled.discard(to)
        items = self._batch_buf.pop(to, [])
        if not items:
            return
        self.batches_sent += 1
        self.batched_calls += len(items)
        try:
            if len(items) == 1:
                # a lone call keeps the plain unary wire shape
                frame = dict(items[0])
                frame.update({"to": to, "from": self.worker_id})
                await self._send_request(frame)
            else:
                await self._send_request({"to": to, "from": self.worker_id,
                                          "batch": items})
        except Exception as exc:
            # the send failed for the WHOLE flush: fail exactly these
            # callers' futures (peers/other batches are untouched)
            for item in items:
                future = self._pending.get(item["corr"])
                if future is not None and not future.done():
                    future.set_exception(RpcError(str(exc)))

    async def call(self, to: str, method: str, params: dict[str, Any],
                   timeout_s: float | None = None,
                   batch: bool = False) -> Any:
        """Unary call; raises RpcAppError (remote handler raised),
        RpcPeerLost (peer died), or RpcError (timeout/transport).
        ``batch=True`` coalesces with other same-tick batched calls to
        the same peer — only for SHORT handlers (limiter/ledger/status
        class): a batch executes sequentially on the server, so a slow
        call would head-of-line-block its batchmates."""
        corr = new_id()
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[corr] = future
        deadline = (timeout_s if timeout_s is not None
                    else self.default_timeout_s)
        try:
            if batch:
                self._enqueue_batch(to, {"corr": corr, "method": method,
                                         "params": params})
            else:
                await self._send_request({"to": to, "from": self.worker_id,
                                          "corr": corr, "method": method,
                                          "params": params})
            try:
                return await asyncio.wait_for(future, deadline)
            except asyncio.TimeoutError:
                if not await self._peer_alive(to):
                    raise RpcPeerLost(
                        f"worker {to} died serving {method}") from None
                raise RpcError(
                    f"rpc {method} to {to} timed out after {deadline}s"
                ) from None
        finally:
            self._pending.pop(corr, None)

    async def call_stream(self, to: str, method: str,
                          params: dict[str, Any],
                          idle_timeout_s: float | None = None
                          ) -> AsyncIterator[Any]:
        """Streaming call: yields the server's chunks in ``seq`` order.
        No chunk within the idle bar triggers a peer liveness check —
        dead peer => RpcPeerLost (clean termination, counted by callers),
        live peer => keep waiting (long TTFT is legitimate)."""
        corr = new_id()
        queue: asyncio.Queue = asyncio.Queue()
        self._streams[corr] = queue
        idle = (idle_timeout_s if idle_timeout_s is not None
                else self.idle_timeout_s)
        next_seq = 0
        held: dict[int, Any] = {}  # out-of-order chunks parked by seq
        try:
            await self._send_request({"to": to, "from": self.worker_id,
                                      "corr": corr, "method": method,
                                      "params": params, "stream": True})
            while True:
                try:
                    frame = await asyncio.wait_for(queue.get(), idle)
                except asyncio.TimeoutError:
                    if not await self._peer_alive(to):
                        raise RpcPeerLost(
                            f"worker {to} died mid-stream ({method})"
                        ) from None
                    continue
                if frame.get("end"):
                    error = frame.get("error")
                    if error:
                        raise RpcAppError(error)
                    return
                held[int(frame.get("seq", next_seq))] = frame.get("chunk")
                while next_seq in held:
                    yield held.pop(next_seq)
                    next_seq += 1
        finally:
            self._streams.pop(corr, None)
            try:
                # tell the server the consumer is gone (idempotent)
                await self.bus.publish(REQ_TOPIC, {"to": to,
                                                   "cancel": corr})
            except Exception:
                pass

    # ------------------------------------------------------------ server side

    async def _on_request(self, topic: str, frame: dict[str, Any]) -> None:
        if frame.get("to") != self.worker_id:
            return
        cancel = frame.get("cancel")
        if cancel:
            task = self._serving.pop(cancel, None)
            if task is not None:
                task.cancel()
            return
        corr = frame.get("corr")
        method = frame.get("method", "")
        reply_topic = RES_PREFIX + str(frame.get("from", ""))
        batch = frame.get("batch")
        if batch:
            # batched unary calls: run handlers SEQUENTIALLY in list
            # order (the ordering contract), answer with ONE frame
            async def _run_batch() -> None:
                payloads: list[dict[str, Any]] = []
                for item in batch:
                    icorr = item.get("corr")
                    handler = self._handlers.get(item.get("method", ""))
                    if handler is None:
                        payloads.append({
                            "corr": icorr,
                            "error": f"unknown rpc method "
                                     f"{item.get('method')!r}"})
                        continue
                    try:
                        result = await handler(item.get("params") or {})
                        payloads.append({"corr": icorr, "result": result})
                        self.calls_served += 1
                    except Exception as exc:
                        payloads.append({
                            "corr": icorr,
                            "error": f"{type(exc).__name__}: {exc}"})
                await self.bus.publish(reply_topic, {"batch": payloads})

            task = asyncio.get_running_loop().create_task(_run_batch())
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
            return
        if frame.get("stream"):
            handler = self._stream_handlers.get(method)
            if handler is None:
                await self.bus.publish(reply_topic, {
                    "corr": corr, "end": True,
                    "error": f"unknown stream method {method!r}"})
                return
            if len(self._serving) >= MAX_OPEN_STREAMS:
                await self.bus.publish(reply_topic, {
                    "corr": corr, "end": True,
                    "error": "stream capacity exhausted"})
                return
            task = asyncio.get_running_loop().create_task(
                self._serve_stream(reply_topic, corr, handler,
                                   frame.get("params") or {}))
            self._serving[corr] = task
            task.add_done_callback(
                lambda _t, c=corr: self._serving.pop(c, None))
            return
        handler2 = self._handlers.get(method)

        async def _run() -> None:
            if handler2 is None:
                payload = {"corr": corr,
                           "error": f"unknown rpc method {method!r}"}
            else:
                try:
                    result = await handler2(frame.get("params") or {})
                    payload = {"corr": corr, "result": result}
                    self.calls_served += 1
                except Exception as exc:
                    payload = {"corr": corr,
                               "error": f"{type(exc).__name__}: {exc}"}
            await self.bus.publish(reply_topic, payload)

        task = asyncio.get_running_loop().create_task(_run())
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def _serve_stream(self, reply_topic: str, corr: str,
                            handler: StreamHandler,
                            params: dict[str, Any]) -> None:
        seq = 0
        error: str | None = None
        iterator = None
        try:
            iterator = handler(params)
            async for chunk in iterator:
                await self.bus.publish(reply_topic, {
                    "corr": corr, "seq": seq, "chunk": chunk})
                seq += 1
            self.streams_served += 1
        except asyncio.CancelledError:
            # consumer went away: close the producer, no end frame needed
            error = "cancelled"
            raise
        except Exception as exc:
            error = f"{type(exc).__name__}: {exc}"
        finally:
            if iterator is not None and hasattr(iterator, "aclose"):
                try:
                    await iterator.aclose()
                except Exception:
                    pass
            if error != "cancelled":
                try:
                    await self.bus.publish(reply_topic, {
                        "corr": corr, "end": True, "error": error})
                except Exception:
                    pass

    # ------------------------------------------------------------- client side

    async def _on_response(self, topic: str, frame: dict[str, Any]) -> None:
        for item in frame.get("batch") or ():
            self._resolve_unary(item)
        if "batch" in frame:
            return
        corr = frame.get("corr", "")
        queue = self._streams.get(corr)
        if queue is not None:
            queue.put_nowait(frame)
            return
        self._resolve_unary(frame)

    def _resolve_unary(self, frame: dict[str, Any]) -> None:
        future = self._pending.get(frame.get("corr", ""))
        if future is None or future.done():
            return
        if "error" in frame and frame["error"] is not None:
            future.set_exception(RpcAppError(frame["error"]))
        else:
            future.set_result(frame.get("result"))

    def stats(self) -> dict[str, Any]:
        return {"worker_id": self.worker_id,
                "methods": sorted(self._handlers),
                "stream_methods": sorted(self._stream_handlers),
                "open_streams": len(self._serving),
                "pending_calls": len(self._pending),
                "calls_served": self.calls_served,
                "streams_served": self.streams_served,
                "batches_sent": self.batches_sent,
                "batched_calls": self.batched_calls}
