"""The port's bus RPC (``coordination/rpc.py``) on the cases of the JAX
package's ``tests/unit/test_bus_rpc.py``: a unary call and its remote
errors, ordered streams with an end error, a dead peer's stream and call
that end (never hang), the ``coordination.hub.rpc`` fault point (error,
latency, partition, scope), a cancel, and same-tick batching. Then the
wire: the frames both packages publish for the same calls are equal once
correlation ids are normalised, a port caller and a JAX server talk to
each other, and the calls run over the file bus and the TCP hub, where
every frame is encoded as JSON."""

import asyncio
import time

import pytest

from mcp_context_forge_tpu.coordination import rpc as jax_rpc
from mcp_context_forge_tpu.coordination.bus import MemoryEventBus as JaxMemoryBus
from mcp_context_forge_tpu.observability import faults as jax_faults
from mcp_context_forge_tpu_torch.coordination.bus import FileEventBus, MemoryEventBus
from mcp_context_forge_tpu_torch.coordination.hub import (CoordinationHub, HubClient,
                                                          TcpEventBus, TcpLeaseManager)
from mcp_context_forge_tpu_torch.coordination.leases import MemoryLeaseManager
from mcp_context_forge_tpu_torch.coordination.rpc import (BusRpc, RpcAppError, RpcError,
                                                          RpcPeerLost)
from mcp_context_forge_tpu_torch.observability.faults import FaultRule, configure_fault_plane


class _Leases:
    """Lease stub: name -> holder."""

    def __init__(self):
        self.holders = {}

    async def holder(self, name):
        return self.holders.get(name)


async def _pair(leases=None, bus=None):
    bus = bus or MemoryEventBus()
    a = BusRpc(bus, "worker-a", leases=leases, default_timeout_s=2.0, idle_timeout_s=0.3)
    b = BusRpc(bus, "worker-b", leases=leases, default_timeout_s=2.0, idle_timeout_s=0.3)
    await a.start()
    await b.start()
    return a, b


async def _echo(params):
    return {"got": params.get("x", "ok")} if "x" in params else "ok"


async def _boom(params):
    raise ValueError("kaboom")


async def _counter(params):
    for i in range(int(params["n"])):
        yield {"i": i}


async def _broken(params):
    yield {"i": 0}
    raise RuntimeError("mid-stream failure")


async def test_unary_call_roundtrip_and_app_error():
    a, b = await _pair()
    b.register("echo", _echo)
    b.register("boom", _boom)
    assert await a.call("worker-b", "echo", {"x": 41}) == {"got": 41}
    with pytest.raises(RpcAppError, match="ValueError: kaboom"):
        await a.call("worker-b", "boom", {})
    with pytest.raises(RpcAppError, match="unknown rpc method"):
        await a.call("worker-b", "nope", {})
    assert b.calls_served == 1
    await a.stop()
    await b.stop()


async def test_stream_ordered_chunks_and_end_error():
    a, b = await _pair()
    b.register_stream("count", _counter)
    b.register_stream("broken", _broken)
    got = [c["i"] async for c in a.call_stream("worker-b", "count", {"n": 5})]
    assert got == [0, 1, 2, 3, 4]
    with pytest.raises(RpcAppError, match="mid-stream failure"):
        async for _chunk in a.call_stream("worker-b", "broken", {}):
            pass
    with pytest.raises(RpcAppError, match="unknown stream method"):
        async for _chunk in a.call_stream("worker-b", "nope", {}):
            pass
    assert b.streams_served == 1
    await a.stop()
    await b.stop()


async def test_out_of_order_chunks_are_yielded_in_seq_order():
    """Chunks are parked by ``seq`` until the gap before them fills."""
    bus = MemoryEventBus()
    a = BusRpc(bus, "worker-a", default_timeout_s=2.0, idle_timeout_s=0.3)
    await a.start()

    async def serve(topic, frame):
        if frame.get("stream"):
            reply = "rpc.res.worker-a"
            for seq in (2, 0, 1):
                await bus.publish(reply, {"corr": frame["corr"], "seq": seq, "chunk": seq})
            await bus.publish(reply, {"corr": frame["corr"], "end": True, "error": None})

    bus.subscribe("rpc.req", serve)
    assert [c async for c in a.call_stream("worker-b", "any", {})] == [0, 1, 2]
    await a.stop()


async def test_dead_peer_stream_terminates_cleanly_not_hangs():
    """A stream whose serving worker dies ends with RpcPeerLost inside the
    liveness bound, never hangs."""
    leases = _Leases()
    leases.holders["worker:worker-b"] = "worker-b"
    a, b = await _pair(leases)

    async def stall(params):
        yield {"i": 0}
        await asyncio.sleep(60)  # worker "dies" while the client waits
        yield {"i": 1}

    b.register_stream("stall", stall)
    chunks = a.call_stream("worker-b", "stall", {})
    assert (await chunks.__anext__())["i"] == 0
    leases.holders.pop("worker:worker-b")  # heartbeat lease expires
    with pytest.raises(RpcPeerLost):
        await asyncio.wait_for(chunks.__anext__(), timeout=5.0)
    await a.stop()
    await b.stop()


async def test_live_peer_slow_stream_keeps_waiting():
    """A live peer that sends nothing for several idle bars is waited for."""
    leases = _Leases()
    leases.holders["worker:worker-b"] = "worker-b"
    a, b = await _pair(leases)

    async def slow(params):
        await asyncio.sleep(1.0)         # past three idle bars of 0.3 s
        yield {"i": 0}

    b.register_stream("slow", slow)
    assert [c async for c in a.call_stream("worker-b", "slow", {})] == [{"i": 0}]
    await a.stop()
    await b.stop()


async def test_dead_peer_unary_raises_peer_lost():
    leases = _Leases()  # worker-b never heartbeats
    a = BusRpc(MemoryEventBus(), "worker-a", leases=leases, default_timeout_s=0.2)
    await a.start()
    with pytest.raises(RpcPeerLost):
        await a.call("worker-b", "echo", {})
    await a.stop()


async def test_fault_point_error_latency_and_partition():
    """coordination.hub.rpc: error raises a transport-shaped failure,
    latency delays the send, corrupt models a PARTITION: the request frame
    is dropped and the caller walks the timeout path."""
    plane = configure_fault_plane(True)
    try:
        leases = _Leases()
        leases.holders["worker:worker-b"] = "worker-b"
        a, b = await _pair(leases)
        b.register("echo", _echo)
        plane.arm(FaultRule(point="coordination.hub.rpc", kind="error"))
        with pytest.raises(ConnectionError):
            await a.call("worker-b", "echo", {})
        plane.arm(FaultRule(point="coordination.hub.rpc", kind="latency", latency_ms=50.0))
        started = time.monotonic()
        assert await a.call("worker-b", "echo", {}) == "ok"
        assert time.monotonic() - started >= 0.05
        # partition: the frame never leaves this worker; the peer is
        # alive, so the caller times out with RpcError (not PeerLost)
        plane.arm(FaultRule(point="coordination.hub.rpc", kind="corrupt"))
        with pytest.raises(RpcError) as excinfo:
            await a.call("worker-b", "echo", {}, timeout_s=0.2)
        assert not isinstance(excinfo.value, RpcPeerLost)
        # a partitioned stream from a live peer waits; once the peer's
        # lease lapses it ends with RpcPeerLost
        stream = a.call_stream("worker-b", "echo", {})
        waiter = asyncio.ensure_future(stream.__anext__())
        await asyncio.sleep(0.5)
        assert not waiter.done()
        leases.holders.pop("worker:worker-b")
        with pytest.raises(RpcPeerLost):
            await asyncio.wait_for(waiter, 5.0)
        leases.holders["worker:worker-b"] = "worker-b"
        plane.disarm("coordination.hub.rpc")
        assert await a.call("worker-b", "echo", {}) == "ok"
        await a.stop()
        await b.stop()
    finally:
        configure_fault_plane(False)


async def test_fault_scope_filters_by_method():
    plane = configure_fault_plane(True)
    try:
        a, b = await _pair()
        b.register("safe", _echo)
        b.register("hit", _echo)
        plane.arm(FaultRule(point="coordination.hub.rpc", kind="error", scope="hit"))
        assert await a.call("worker-b", "safe", {}) == "ok"
        with pytest.raises(ConnectionError):
            await a.call("worker-b", "hit", {})
        await a.stop()
        await b.stop()
    finally:
        configure_fault_plane(False)


async def test_stream_cancel_stops_server_task():
    a, b = await _pair()
    cancelled = asyncio.Event()

    async def endless(params):
        try:
            i = 0
            while True:
                yield {"i": i}
                i += 1
                await asyncio.sleep(0)
        except asyncio.CancelledError:
            cancelled.set()
            raise

    b.register_stream("endless", endless)
    chunks = a.call_stream("worker-b", "endless", {})
    assert (await chunks.__anext__())["i"] == 0
    await chunks.aclose()  # consumer walks away -> cancel frame
    await asyncio.wait_for(cancelled.wait(), timeout=2.0)
    assert not b._serving  # relay task reaped
    await a.stop()
    await b.stop()


async def test_stop_ends_pending_calls_and_streams():
    """``stop()`` fails the caller's pending calls and ends its streams."""
    leases = _Leases()
    leases.holders["worker:worker-b"] = "worker-b"
    a, b = await _pair(leases)

    async def never(params):
        await asyncio.sleep(60)

    async def stall(params):
        yield {"i": 0}
        await asyncio.sleep(60)

    b.register("never", never)
    b.register_stream("stall", stall)
    call = asyncio.ensure_future(a.call("worker-b", "never", {}))
    stream = a.call_stream("worker-b", "stall", {})
    assert (await stream.__anext__())["i"] == 0
    nxt = asyncio.ensure_future(stream.__anext__())
    await asyncio.sleep(0.05)
    await a.stop()
    with pytest.raises(RpcError, match="rpc stopped"):
        await asyncio.wait_for(call, 2)
    with pytest.raises(RpcAppError, match="rpc stopped"):
        await asyncio.wait_for(nxt, 2)
    await b.stop()


async def test_batched_calls_coalesce_into_one_frame():
    a, b = await _pair()
    b.register("echo", _echo)
    sent_before = a.batches_sent
    results = await asyncio.gather(
        a.call("worker-b", "echo", {"x": 1}, batch=True),
        a.call("worker-b", "echo", {"x": 2}, batch=True),
        a.call("worker-b", "echo", {"x": 3}, batch=True))
    assert results == [{"got": 1}, {"got": 2}, {"got": 3}]
    assert a.batches_sent == sent_before + 1
    assert a.batched_calls >= 3
    assert a.stats()["batches_sent"] == a.batches_sent
    await a.stop()
    await b.stop()


async def test_batch_server_runs_handlers_in_submission_order():
    a, b = await _pair()
    order: list[int] = []

    async def record(params):
        order.append(params["i"])
        return params["i"]

    b.register("record", record)
    results = await asyncio.gather(*[a.call("worker-b", "record", {"i": i}, batch=True)
                                     for i in range(6)])
    assert results == [0, 1, 2, 3, 4, 5]
    assert order == [0, 1, 2, 3, 4, 5]
    await a.stop()
    await b.stop()


async def test_batch_app_error_fails_only_its_caller():
    a, b = await _pair()
    b.register("echo", _echo)
    b.register("boom", _boom)
    ok1, err, ok2 = await asyncio.gather(
        a.call("worker-b", "echo", {"x": 1}, batch=True),
        a.call("worker-b", "boom", {}, batch=True),
        a.call("worker-b", "echo", {"x": 2}, batch=True),
        return_exceptions=True)
    assert ok1 == {"got": 1} and ok2 == {"got": 2}
    assert isinstance(err, RpcAppError)
    await a.stop()
    await b.stop()


async def test_batch_dead_peer_fails_only_that_batch():
    leases = _Leases()
    bus = MemoryEventBus()
    a = BusRpc(bus, "worker-a", leases=leases, default_timeout_s=0.3)
    c = BusRpc(bus, "worker-c", leases=leases, default_timeout_s=2.0)
    await a.start()
    await c.start()
    leases.holders["worker:worker-c"] = "worker-c"
    c.register("echo", _echo)
    dead1, dead2, live = await asyncio.gather(
        a.call("worker-b", "echo", {"x": 1}, batch=True),
        a.call("worker-b", "echo", {"x": 2}, batch=True),
        a.call("worker-c", "echo", {"x": 3}, batch=True),
        return_exceptions=True)
    assert isinstance(dead1, RpcPeerLost)
    assert isinstance(dead2, RpcPeerLost)
    assert live == {"got": 3}
    await a.stop()
    await c.stop()


# ----------------------------------------------------------------- the wire

async def _wire_run(rpc_mod, bus_cls, fault_mod) -> list:
    """The same calls through one package's BusRpc pair; every frame
    published, with correlation ids numbered in order of appearance."""
    bus = bus_cls()
    frames = []
    publish = bus.publish

    async def spy(topic, frame):
        frames.append((topic, frame))
        await publish(topic, frame)

    bus.publish = spy
    a = rpc_mod.BusRpc(bus, "worker-a", default_timeout_s=2.0, idle_timeout_s=0.3)
    b = rpc_mod.BusRpc(bus, "worker-b", default_timeout_s=2.0, idle_timeout_s=0.3)
    await a.start()
    await b.start()
    b.register("echo", _echo)
    b.register("boom", _boom)
    b.register_stream("count", _counter)
    b.register_stream("broken", _broken)
    await a.call("worker-b", "echo", {"x": [1, {"y": 2}]})
    with pytest.raises(rpc_mod.RpcAppError):
        await a.call("worker-b", "boom", {})
    with pytest.raises(rpc_mod.RpcAppError):
        await a.call("worker-b", "nope", {})
    assert [c async for c in a.call_stream("worker-b", "count", {"n": 3})] == \
        [{"i": 0}, {"i": 1}, {"i": 2}]
    with pytest.raises(rpc_mod.RpcAppError):
        async for _chunk in a.call_stream("worker-b", "broken", {}):
            pass
    await asyncio.gather(a.call("worker-b", "echo", {"x": 1}, batch=True),
                         a.call("worker-b", "boom", {}, batch=True), return_exceptions=True)
    await a.call("worker-b", "echo", {"x": 9}, batch=True)
    plane = fault_mod.configure_fault_plane(True)
    try:
        plane.arm(fault_mod.FaultRule(point="coordination.hub.rpc", kind="corrupt",
                                      scope="echo"))
        with pytest.raises(rpc_mod.RpcError):
            await a.call("worker-b", "echo", {}, timeout_s=0.1)
    finally:
        fault_mod.configure_fault_plane(False)
    await asyncio.sleep(0.05)
    stats = (a.stats(), b.stats())
    await a.stop()
    await b.stop()
    ids: dict = {}

    def norm(value):
        if isinstance(value, dict):
            return {k: (ids.setdefault(v, f"corr{len(ids)}")
                        if k in ("corr", "cancel") else norm(v)) for k, v in value.items()}
        if isinstance(value, list):
            return [norm(v) for v in value]
        return value

    return [(topic, norm(frame)) for topic, frame in frames] + [stats]


def test_wire_frames_equal_the_reference():
    port = asyncio.run(_wire_run(__import__(
        "mcp_context_forge_tpu_torch.coordination.rpc", fromlist=["rpc"]), MemoryEventBus,
        __import__("mcp_context_forge_tpu_torch.observability.faults", fromlist=["faults"])))
    ref = asyncio.run(_wire_run(jax_rpc, JaxMemoryBus, jax_faults))
    assert port == ref
    topics = [t for t, _ in port[:-1]]
    # three unary calls, two streams (a request and a cancel each), two batch
    # flushes; the partitioned call sent nothing
    assert topics.count("rpc.req") == 9 and "rpc.res.worker-a" in topics
    # the partitioned call's frame never reached the bus
    assert not any(f.get("method") == "echo" and f.get("params") == {} for _, f in port[:-1])


async def test_port_caller_and_jax_server_on_one_bus():
    """Both packages' BusRpc speak the same frames on one bus: a port
    caller to a JAX server and back, unary and streamed."""
    bus = MemoryEventBus()
    ours = BusRpc(bus, "port", default_timeout_s=2.0)
    theirs = jax_rpc.BusRpc(bus, "jax", default_timeout_s=2.0)
    await ours.start()
    await theirs.start()
    for server in (ours, theirs):
        server.register("echo", _echo)
        server.register_stream("count", _counter)
    try:
        assert await ours.call("jax", "echo", {"x": "to jax"}) == {"got": "to jax"}
        assert await theirs.call("port", "echo", {"x": "to port"}) == {"got": "to port"}
        assert [c["i"] async for c in ours.call_stream("jax", "count", {"n": 3})] == [0, 1, 2]
        assert [c["i"] async for c in theirs.call_stream("port", "count", {"n": 2})] == [0, 1]
        assert await asyncio.gather(ours.call("jax", "echo", {"x": 1}, batch=True),
                                    ours.call("jax", "echo", {"x": 2}, batch=True)) == \
            [{"got": 1}, {"got": 2}]
    finally:
        await ours.stop()
        await theirs.stop()


async def _json_wire_calls(bus_a, bus_b, leases) -> list:
    a = BusRpc(bus_a, "worker-a", leases=leases, default_timeout_s=10.0, idle_timeout_s=1.0)
    b = BusRpc(bus_b, "worker-b", leases=leases, default_timeout_s=10.0, idle_timeout_s=1.0)
    await a.start()
    await b.start()
    b.register("echo", _echo)
    b.register_stream("count", _counter)
    try:
        await leases.acquire("worker:worker-b", "worker-b", 30.0)
        out = [await a.call("worker-b", "echo", {"x": {"nested": [1.5, None, "s"]}}),
               [c async for c in a.call_stream("worker-b", "count", {"n": 4})],
               await asyncio.gather(a.call("worker-b", "echo", {"x": 1}, batch=True),
                                    a.call("worker-b", "echo", {"x": 2}, batch=True))]

        async def unencodable(params):
            return {"value": object()}

        b.register("bad", unencodable)
        # the server's reply cannot be encoded: the caller times out on a
        # live peer (the failure stays on the server's side of the wire)
        with pytest.raises(RpcError):
            await a.call("worker-b", "bad", {}, timeout_s=0.5)
        out.append(b.calls_served)
        return out
    finally:
        await a.stop()
        await b.stop()


WANT = [{"got": {"nested": [1.5, None, "s"]}}, [{"i": i} for i in range(4)],
        [{"got": 1}, {"got": 2}], 4]


def test_calls_over_the_tcp_hub():
    async def main():
        hub = CoordinationHub("127.0.0.1", 0, secret="s")
        await hub.start()
        clients = [HubClient("127.0.0.1", hub.bound_port, secret="s") for _ in range(2)]
        buses = [TcpEventBus(c) for c in clients]
        for bus in buses:
            await bus.start()
        try:
            return await _json_wire_calls(buses[0], buses[1], TcpLeaseManager(clients[0]))
        finally:
            for bus in buses:
                await bus.stop()
            await hub.stop()

    assert asyncio.run(main()) == WANT


def test_calls_over_the_file_bus(tmp_path):
    async def main():
        buses = [FileEventBus(str(tmp_path)) for _ in range(2)]
        for bus in buses:
            await bus.start()
        try:
            return await _json_wire_calls(buses[0], buses[1], MemoryLeaseManager())
        finally:
            for bus in buses:
                await bus.stop()

    assert asyncio.run(main()) == WANT
