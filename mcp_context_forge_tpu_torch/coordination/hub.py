"""TCP coordination hub and client, the cross-host Redis analog (a copy of
the JAX package's ``coordination/hub.py``; stdlib only). Its frames are
byte for byte the reference's, so a client of either package talks to a hub
of either.

- ``CoordinationHub``: an asyncio TCP server speaking newline-delimited
  JSON frames; fans published messages out to every other connection and
  serves lease CAS ops (acquire = SET NX EX, renew = compare-and-extend),
  the shared KV and rate-limit windows from one in-process table, so
  ordering is total per hub.
- ``HubClient``: one connection multiplexing pub/sub and requests, with
  exponential-backoff reconnect and resubscribe.
- ``TcpEventBus`` / ``TcpLeaseManager``: the EventBus/LeaseManager
  implementations over a ``HubClient``.

Wire frames (one JSON object per line):
  client→hub: {"op":"hello","secret":S}                 first frame
              {"op":"pub","topic":T,"msg":{}}           broadcast
              {"op":"sub","topic":T} / {"op":"unsub"}   topic filter
              {"op":"acquire"/"renew"/"release"/"holder",
               "id":N, "name":..., "owner":..., "ttl":...}
              {"op":"kv_set","id":N,"key":K,"value":{},"ttl":S}
              {"op":"kv_get"/"kv_del","id":N,"key":K}
              {"op":"rl_take","id":N,"key":K,"cost":C,"limit":L,
               "window_s":W,"force":bool}
              {"op":"batch","ops":[...]}                same-tick ops
  hub→client: {"op":"hello_ok"}
              {"op":"msg","topic":T,"msg":{}}
              {"op":"resp","id":N, "ok":bool, "holder":str|null,
               "value":{}|null}
              {"op":"batch_resp","results":[...]}

Run standalone: ``python -m mcp_context_forge_tpu_torch.coordination.hub
--port 7077 [--secret S]`` (the secret defaults to
``MCPFORGE_BUS_TCP_SECRET``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Any, Callable

from .bus import EventBus, Handler
from .leases import LeaseManager

logger = logging.getLogger(__name__)

MAX_FRAME = 4 * 1024 * 1024


class CoordinationHub:
    """TCP server: pub/sub fan-out + lease table.

    With ``secret`` set, every connection must open with a matching
    ``{"op": "hello", "secret": ...}`` frame before any other op is
    honored — bus payloads are trusted by workers (affinity forwards carry
    auth context), so an unauthenticated network hub would be a
    privilege-escalation path. Empty secret = loopback/dev only.
    """

    # a wedged worker that stops reading must not grow our buffers forever
    MAX_WRITE_BUFFER = 8 * 1024 * 1024

    def __init__(self, host: str = "127.0.0.1", port: int = 7077,
                 secret: str = ""):
        self.host = host
        self.port = port
        self.secret = secret
        self._server: asyncio.base_events.Server | None = None
        # conn id -> (writer, subscribed topics; "*" = all)
        self._conns: dict[int, tuple[asyncio.StreamWriter, set[str]]] = {}
        self._next_conn = 0
        self._leases: dict[str, tuple[str, float]] = {}  # name -> (owner, expires)
        # shared KV (chat sessions, small cross-worker state); value JSON,
        # expires 0.0 = never. The Redis-keys analog next to pub/sub+leases.
        self._kv: dict[str, tuple[Any, float]] = {}
        self._kv_next_sweep = time.monotonic() + 60.0
        # rate-limit windows: key -> (consumed, window_started, window_s)
        self._rl: dict[str, tuple[float, float, float]] = {}
        self._rl_next_sweep = time.monotonic() + 60.0

    @property
    def bound_port(self) -> int:
        if self._server and self._server.sockets:
            return self._server.sockets[0].getsockname()[1]
        return self.port

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve_conn, self.host, self.port, limit=MAX_FRAME)
        logger.info("coordination hub listening on %s:%s", self.host,
                    self.bound_port)

    async def stop(self) -> None:
        # close live connections first: wait_closed() blocks until every
        # connection handler returns (py3.12 semantics)
        for writer, _ in list(self._conns.values()):
            writer.close()
        self._conns.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # ---------------------------------------------------------------- serving

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        import hmac

        if self.secret:
            try:
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                hello = json.loads(line)
            except (asyncio.TimeoutError, json.JSONDecodeError, ValueError):
                writer.close()
                return
            if hello.get("op") != "hello" or not hmac.compare_digest(
                    str(hello.get("secret", "")), self.secret):
                logger.warning("hub: rejected connection with bad secret")
                writer.close()
                return
            self._send(writer, {"op": "hello_ok"})
        conn_id = self._next_conn
        self._next_conn += 1
        self._conns[conn_id] = (writer, set())
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    frame = json.loads(line)
                except json.JSONDecodeError:
                    continue
                await self._handle(conn_id, writer, frame)
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.pop(conn_id, None)
            writer.close()

    async def _handle(self, conn_id: int, writer: asyncio.StreamWriter,
                      frame: dict[str, Any]) -> None:
        op = frame.get("op")
        conn = self._conns.get(conn_id)
        if conn is None:  # hub stopping: buffered frames race _conns.clear()
            return
        if op == "pub":
            await self._broadcast(conn_id, frame.get("topic", ""),
                                  frame.get("msg") or {})
        elif op == "hello":  # secretless hub still acks so clients confirm
            self._send(writer, {"op": "hello_ok"})
        elif op == "sub":
            conn[1].add(frame.get("topic", "*"))
        elif op == "unsub":
            conn[1].discard(frame.get("topic", "*"))
        elif op in ("acquire", "renew", "release", "holder"):
            self._send(writer, self._lease_op(op, frame))
        elif op in ("kv_set", "kv_get", "kv_del"):
            self._send(writer, self._kv_op(op, frame))
        elif op == "rl_take":
            self._send(writer, self._rl_op(frame))
        elif op == "batch":
            # same-tick client coalescing (HubClient): N scalar ops ride
            # ONE request frame and get ONE response frame back. Sub-ops
            # execute sequentially in list order, so the total per-hub
            # ordering the limiter's CAS depends on is preserved
            self._send(writer, {"op": "batch_resp",
                                "results": self._batch_op(frame)})

    def _batch_op(self, frame: dict[str, Any]) -> list[dict[str, Any]]:
        results: list[dict[str, Any]] = []
        for sub in frame.get("ops") or []:
            sop = sub.get("op")
            if sop in ("acquire", "renew", "release", "holder"):
                results.append(self._lease_op(sop, sub))
            elif sop in ("kv_set", "kv_get", "kv_del"):
                results.append(self._kv_op(sop, sub))
            elif sop == "rl_take":
                results.append(self._rl_op(sub))
            else:
                # pub/sub cannot batch (no resp frame to correlate)
                results.append({"op": "resp", "id": sub.get("id"),
                                "ok": False,
                                "error": f"unbatchable op {sop!r}"})
        return results

    async def _broadcast(self, sender: int, topic: str,
                         message: dict[str, Any]) -> None:
        frame = {"op": "msg", "topic": topic, "msg": message}
        for conn_id, (writer, topics) in list(self._conns.items()):
            if conn_id == sender:
                continue  # publisher delivers locally itself
            if topics and ("*" in topics or topic in topics):
                transport = writer.transport
                if (transport is not None and
                        transport.get_write_buffer_size() > self.MAX_WRITE_BUFFER):
                    # slow consumer: evict rather than buffer without bound
                    logger.warning("hub: dropping slow consumer conn %s", conn_id)
                    self._conns.pop(conn_id, None)
                    writer.close()
                    continue
                self._send(writer, frame)

    def _send(self, writer: asyncio.StreamWriter, frame: dict[str, Any]) -> None:
        try:
            writer.write(json.dumps(frame, separators=(",", ":")).encode() + b"\n")
        except (ConnectionResetError, RuntimeError):
            pass

    # ----------------------------------------------------------------- leases

    def _lease_op(self, op: str, frame: dict[str, Any]) -> dict[str, Any]:
        name = frame.get("name", "")
        owner = frame.get("owner", "")
        ttl = float(frame.get("ttl") or 0.0)
        resp: dict[str, Any] = {"op": "resp", "id": frame.get("id")}
        now = time.monotonic()
        current = self._leases.get(name)
        expired = current is None or current[1] <= now
        if op == "acquire":
            if expired or current[0] == owner:
                self._leases[name] = (owner, now + ttl)
                resp["ok"] = True
            else:
                resp["ok"] = False
        elif op == "renew":
            if not expired and current[0] == owner:
                self._leases[name] = (owner, now + ttl)
                resp["ok"] = True
            else:
                resp["ok"] = False
        elif op == "release":
            if current is not None and current[0] == owner:
                del self._leases[name]
            resp["ok"] = True
        elif op == "holder":
            resp["ok"] = True
            resp["holder"] = None if expired else current[0]
        return resp


    # --------------------------------------------------------------- kv store

    def _kv_op(self, op: str, frame: dict[str, Any]) -> dict[str, Any]:
        key = str(frame.get("key", ""))
        resp: dict[str, Any] = {"op": "resp", "id": frame.get("id"), "ok": True}
        now = time.monotonic()
        if now >= self._kv_next_sweep:
            self._kv = {k: (v, exp) for k, (v, exp) in self._kv.items()
                        if exp == 0.0 or exp > now}
            self._kv_next_sweep = now + 60.0
        if op == "kv_set":
            ttl = float(frame.get("ttl") or 0.0)
            self._kv[key] = (frame.get("value"), now + ttl if ttl else 0.0)
        elif op == "kv_get":
            entry = self._kv.get(key)
            if entry is None or (entry[1] and entry[1] <= now):
                self._kv.pop(key, None)
                resp["value"] = None
            else:
                resp["value"] = entry[0]
        elif op == "kv_del":
            self._kv.pop(key, None)
        return resp


    # ---------------------------------------------------------- rate limiting

    def _rl_op(self, frame: dict[str, Any]) -> dict[str, Any]:
        """Shared token-budget window: the distributed tenant limiter's
        CAS (the JAX package's ``coordination/ratelimit.py``, which the
        port has not taken over). One counter per key, reset each
        ``window_s``; ``take`` succeeds while consumed < limit (grants
        overshoot by at most one cost — the bounded over-admission),
        ``force`` charges unconditionally (ledger reconciliation).
        Ordering is total per hub, so N workers' grants serialize here."""
        key = str(frame.get("key", ""))
        cost = float(frame.get("cost") or 0.0)
        limit = float(frame.get("limit") or 0.0)
        window_s = max(0.001, float(frame.get("window_s") or 60.0))
        force = bool(frame.get("force"))
        now = time.monotonic()
        if now >= self._rl_next_sweep:
            # an expired window is state-free (the next take resets it
            # identically), so pruning is lossless — churned tenant keys
            # must not grow the table forever (same discipline as _kv)
            self._rl = {k: entry for k, entry in self._rl.items()
                        if now - entry[1] < entry[2]}
            self._rl_next_sweep = now + 60.0
        consumed, started, _w = self._rl.get(key, (0.0, now, window_s))
        if now - started >= window_s:
            consumed, started = 0.0, now
        ok = force or limit <= 0 or consumed < limit
        if ok:
            consumed += cost
        self._rl[key] = (consumed, started, window_s)
        remaining = max(0.0, window_s - (now - started))
        return {"op": "resp", "id": frame.get("id"), "ok": ok,
                "consumed": consumed,
                "retry_after": round(remaining, 3)}


class HubClient:
    """One multiplexed connection to the hub, shared by bus + leases."""

    def __init__(self, host: str, port: int, secret: str = "",
                 reconnect_max: float = 5.0):
        self.host = host
        self.port = port
        self.secret = secret
        self.reconnect_max = reconnect_max
        self._writer: asyncio.StreamWriter | None = None
        self._reader_task: asyncio.Task | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._topics: set[str] = set()
        self._on_message: Callable[[str, dict[str, Any]], Any] | None = None
        self._connected = asyncio.Event()
        self._stopping = False
        # same-tick op coalescing (see _enqueue_batch)
        self._batch_buf: list[dict[str, Any]] = []
        self._batch_scheduled = False
        self.batches_sent = 0
        self.batched_ops = 0

    async def start(self) -> None:
        self._stopping = False
        if self._reader_task is None:
            self._reader_task = asyncio.create_task(self._run())
        await asyncio.wait_for(self._connected.wait(), timeout=10.0)

    async def stop(self) -> None:
        self._stopping = True
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except asyncio.CancelledError:
                pass
            self._reader_task = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        for future in self._pending.values():
            if not future.done():
                future.cancel()
        self._pending.clear()

    def on_message(self, callback: Callable[[str, dict[str, Any]], Any]) -> None:
        self._on_message = callback

    async def _run(self) -> None:
        backoff = 0.1
        while not self._stopping:
            try:
                reader, writer = await asyncio.open_connection(
                    self.host, self.port, limit=MAX_FRAME)
                self._writer = writer
                self._send({"op": "hello", "secret": self.secret})
                # _connected only after the hub acks the secret — otherwise a
                # typo'd secret looks like a healthy start with a dead bus
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if not line or json.loads(line).get("op") != "hello_ok":
                    raise ConnectionError("hub rejected handshake (bad secret?)")
                for topic in self._topics:  # resubscribe after reconnect
                    self._send({"op": "sub", "topic": topic})
                self._connected.set()
                backoff = 0.1
                while True:
                    line = await reader.readline()
                    if not line:
                        break
                    try:
                        frame = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    await self._dispatch(frame)
            except (ConnectionError, OSError, asyncio.TimeoutError,
                    json.JSONDecodeError) as exc:
                if backoff >= self.reconnect_max:
                    logger.warning("hub connection failing (%s:%s): %s",
                                   self.host, self.port, exc)
            finally:
                self._connected.clear()
                self._writer = None
                # in-flight requests cannot complete across a reconnect
                for future in self._pending.values():
                    if not future.done():
                        future.set_exception(ConnectionError("hub connection lost"))
                self._pending.clear()
            if self._stopping:
                return
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, self.reconnect_max)

    async def _dispatch(self, frame: dict[str, Any]) -> None:
        op = frame.get("op")
        if op == "msg":
            if self._on_message is not None:
                try:
                    result = self._on_message(frame.get("topic", ""),
                                              frame.get("msg") or {})
                    if asyncio.iscoroutine(result):
                        await result
                except Exception:
                    logger.exception("bus message handler failed")
        elif op == "resp":
            future = self._pending.pop(frame.get("id"), None)
            if future is not None and not future.done():
                future.set_result(frame)
        elif op == "batch_resp":
            for result in frame.get("results") or []:
                future = self._pending.pop(result.get("id"), None)
                if future is not None and not future.done():
                    future.set_result(result)

    def _send(self, frame: dict[str, Any]) -> None:
        if self._writer is None:
            raise ConnectionError("hub not connected")
        self._writer.write(json.dumps(frame, separators=(",", ":")).encode() + b"\n")

    def publish(self, topic: str, message: dict[str, Any]) -> None:
        self._send({"op": "pub", "topic": topic, "msg": message})

    def subscribe(self, topic: str) -> None:
        self._topics.add(topic)
        if self._writer is not None:
            self._send({"op": "sub", "topic": topic})

    def unsubscribe(self, topic: str) -> None:
        self._topics.discard(topic)
        if self._writer is not None:
            try:
                self._send({"op": "unsub", "topic": topic})
            except ConnectionError:
                pass  # next reconnect simply won't resubscribe

    async def kv_set(self, key: str, value: Any, ttl: float = 0.0) -> None:
        await self.request({"op": "kv_set", "key": key, "value": value,
                            "ttl": ttl})

    async def kv_get(self, key: str) -> Any:
        return (await self.request({"op": "kv_get", "key": key})).get("value")

    async def kv_del(self, key: str) -> None:
        await self.request({"op": "kv_del", "key": key})

    async def rl_take(self, key: str, cost: float, limit: float,
                      window_s: float, force: bool = False
                      ) -> dict[str, Any]:
        """Shared rate-limit window op (see CoordinationHub._rl_op).

        Batched: under burst every admitted request costs one limiter
        round-trip, and those serialize in hub frame handling — same-tick
        takes (N concurrent admissions, the ledger's force-charges) now
        coalesce into one wire frame each way."""
        return await self.request({"op": "rl_take", "key": key,
                                   "cost": cost, "limit": limit,
                                   "window_s": window_s, "force": force},
                                  batch=True)

    async def request(self, frame: dict[str, Any], timeout: float = 5.0,
                      batch: bool = False) -> dict[str, Any]:
        self._next_id += 1
        frame["id"] = self._next_id
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[frame["id"]] = future
        if batch:
            self._enqueue_batch(frame)
        else:
            self._send(frame)
        try:
            return await asyncio.wait_for(future, timeout)
        finally:
            self._pending.pop(frame["id"], None)

    # -------------------------------------------------- same-tick op batching

    def _enqueue_batch(self, frame: dict[str, Any]) -> None:
        """Queue a scalar op; everything queued within the same event-loop
        tick flushes as ONE ``batch`` frame (a single op stays a plain
        frame, so the unbatched wire shape is unchanged)."""
        self._batch_buf.append(frame)
        if not self._batch_scheduled:
            self._batch_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush_batch)

    def _flush_batch(self) -> None:
        self._batch_scheduled = False
        frames, self._batch_buf = self._batch_buf, []
        if not frames:
            return
        self.batches_sent += 1
        self.batched_ops += len(frames)
        try:
            if len(frames) == 1:
                self._send(frames[0])
            else:
                self._send({"op": "batch", "ops": frames})
        except ConnectionError as exc:
            # the send failed for every op in this flush: fail exactly
            # those callers (their futures), nobody else
            for sub in frames:
                future = self._pending.pop(sub.get("id"), None)
                if future is not None and not future.done():
                    future.set_exception(ConnectionError(str(exc)))


class TcpEventBus(EventBus):
    """Network bus: publishes through the hub; local delivery is immediate
    (same contract as MemoryEventBus/FileEventBus)."""

    def __init__(self, client: HubClient):
        self._client = client
        self._subs: dict[str, list[Handler]] = {}
        client.on_message(self._deliver)

    async def start(self) -> None:
        await self._client.start()

    async def stop(self) -> None:
        await self._client.stop()

    async def publish(self, topic: str, message: dict[str, Any]) -> None:
        try:
            self._client.publish(topic, message)
        except ConnectionError:
            logger.warning("bus publish while hub disconnected: %s", topic)
        await self._deliver(topic, message)

    def subscribe(self, topic: str, handler: Handler) -> Callable[[], None]:
        self._subs.setdefault(topic, []).append(handler)
        self._client.subscribe(topic)

        def _unsub() -> None:
            try:
                self._subs.get(topic, []).remove(handler)
            except ValueError:
                return
            if not self._subs.get(topic):  # last handler: stop hub fan-out
                self._subs.pop(topic, None)
                self._client.unsubscribe(topic)

        return _unsub

    async def _deliver(self, topic: str, message: dict[str, Any]) -> None:
        for handler in list(self._subs.get(topic, ())):
            try:
                await handler(topic, message)
            except Exception:  # subscriber errors must not break publishers
                pass


class TcpLeaseManager(LeaseManager):
    """Lease CAS served by the hub (cross-host SET NX EX)."""

    def __init__(self, client: HubClient):
        self._client = client

    async def acquire(self, name: str, owner: str, ttl: float) -> bool:
        return await self._op("acquire", name, owner, ttl)

    async def renew(self, name: str, owner: str, ttl: float) -> bool:
        return await self._op("renew", name, owner, ttl)

    async def release(self, name: str, owner: str) -> None:
        await self._op("release", name, owner, 0.0)

    async def holder(self, name: str) -> str | None:
        try:
            resp = await self._client.request({"op": "holder", "name": name})
            return resp.get("holder")
        except (ConnectionError, asyncio.TimeoutError):
            return None

    async def _op(self, op: str, name: str, owner: str, ttl: float) -> bool:
        try:
            resp = await self._client.request(
                {"op": op, "name": name, "owner": owner, "ttl": ttl})
            return bool(resp.get("ok"))
        except (ConnectionError, asyncio.TimeoutError):
            return False  # unreachable hub = cannot hold leadership


def main() -> None:  # pragma: no cover - manual entry point
    import argparse

    import os

    parser = argparse.ArgumentParser(description="mcpforge coordination hub")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7077)
    parser.add_argument("--secret",
                        default=os.environ.get("MCPFORGE_BUS_TCP_SECRET", ""))
    args = parser.parse_args()

    async def run() -> None:
        hub = CoordinationHub(args.host, args.port, secret=args.secret)
        await hub.start()
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":  # pragma: no cover
    main()
