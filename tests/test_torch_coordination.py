"""The port's coordination layer (``mcp_context_forge_tpu_torch/coordination``)
against the JAX package's: the same operations on the buses, leases, KV
stores and leader electors of both packages (memory and file backends, on
``tmp_path``) give the same results, a file backend of one package shares
its directory with the other's, and the TCP hub's frames are byte for byte
the reference's: a client of either package talks to a hub of either, the
secret handshake included, and a bad secret is refused by both hubs.

Lease expiry is shown by states, never by a window of time: a lease of
0.05 s is read after a sleep of 0.2 s, and a lease that must hold has a
TTL of 30 s."""

import asyncio
import json

import pytest

from mcp_context_forge_tpu.coordination import bus as jax_bus
from mcp_context_forge_tpu.coordination import hub as jax_hub
from mcp_context_forge_tpu.coordination import kv as jax_kv
from mcp_context_forge_tpu.coordination import leases as jax_leases
from mcp_context_forge_tpu_torch.coordination import bus as port_bus
from mcp_context_forge_tpu_torch.coordination import hub as port_hub
from mcp_context_forge_tpu_torch.coordination import kv as port_kv
from mcp_context_forge_tpu_torch.coordination import leases as port_leases

PACKAGES = {"jax": (jax_bus, jax_leases, jax_kv, jax_hub),
            "port": (port_bus, port_leases, port_kv, port_hub)}
BACKENDS = ("memory", "file")


async def until(predicate, timeout_s: float = 10.0) -> None:
    """Wait for a state (a file bus delivers after its poll)."""
    deadline = asyncio.get_running_loop().time() + timeout_s
    while not predicate():
        assert asyncio.get_running_loop().time() < deadline, "state never reached"
        await asyncio.sleep(0.01)


# ------------------------------------------------------------------ bus

async def bus_script(bus_mod, backend: str, directory: str) -> list:
    """Two buses of one backend (one shared directory): subscribers on
    both, publishes from the first, an unsubscribe, a failing handler."""
    a = bus_mod.make_bus(backend, directory)
    b = a if backend == "memory" else bus_mod.make_bus(backend, directory)
    got: list = []

    async def record(who):
        async def handler(topic, message):
            got.append((who, topic, message))
        return handler

    async def failing(topic, message):
        raise RuntimeError("a subscriber's error must not reach the publisher")

    await a.start()
    await b.start()
    try:
        a.subscribe("t1", await record("a"))
        unsub = b.subscribe("t1", await record("b"))
        b.subscribe("t2", failing)
        b.subscribe("t2", await record("b"))
        await a.publish("t1", {"n": 1, "nested": {"x": [1, 2]}})
        await a.publish("t2", {"n": 2})
        await until(lambda: len(got) == 3)
        unsub()
        await a.publish("t1", {"n": 3})
        await until(lambda: len(got) == 4)
        await asyncio.sleep(3 * getattr(b, "POLL_INTERVAL", 0.0))  # nothing else arrives
    finally:
        await a.stop()
        await b.stop()
    return sorted(got, key=json.dumps)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bus_same_deliveries(tmp_path, backend):
    results = {name: asyncio.run(bus_script(mods[0], backend, str(tmp_path / name)))
               for name, mods in PACKAGES.items()}
    assert results["port"] == results["jax"]
    assert len(results["port"]) == 4


def test_file_bus_shared_across_packages(tmp_path):
    """A port worker and a JAX worker on one bus directory hear each other."""
    async def main():
        ours, theirs = port_bus.FileEventBus(str(tmp_path)), jax_bus.FileEventBus(str(tmp_path))
        got = {"port": [], "jax": []}

        def handler(name):
            async def on(topic, message):
                got[name].append(message)
            return on

        ours.subscribe("x", handler("port"))
        theirs.subscribe("x", handler("jax"))
        await ours.start()
        await theirs.start()
        try:
            await ours.publish("x", {"from": "port"})
            await theirs.publish("x", {"from": "jax"})
            await until(lambda: len(got["port"]) == 2 and len(got["jax"]) == 2)
        finally:
            await ours.stop()
            await theirs.stop()
        return {k: sorted(m["from"] for m in v) for k, v in got.items()}

    assert asyncio.run(main()) == {"port": ["jax", "port"], "jax": ["jax", "port"]}


# --------------------------------------------------------------- leases

async def lease_script(leases_mod, backend: str, directory: str) -> list:
    m = leases_mod.make_lease_manager(backend, directory)
    out = [await m.acquire("L", "a", 30.0), await m.acquire("L", "b", 30.0),
           await m.holder("L"), await m.renew("L", "a", 30.0), await m.renew("L", "b", 30.0),
           await m.acquire("L", "a", 30.0)]
    await m.release("L", "b")                        # not the holder: no-op
    out.append(await m.holder("L"))
    await m.release("L", "a")
    out += [await m.holder("L"), await m.renew("L", "a", 30.0)]
    out.append(await m.acquire("S", "a", 0.05))
    await asyncio.sleep(0.2)                         # S has lapsed
    out += [await m.holder("S"), await m.renew("S", "a", 30.0),
            await m.acquire("S", "b", 30.0), await m.holder("S")]
    await m.force_release("S")
    out.append(await m.holder("S"))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_leases_same_answers(tmp_path, backend):
    results = {name: asyncio.run(lease_script(mods[1], backend, str(tmp_path / name)))
               for name, mods in PACKAGES.items()}
    assert results["port"] == results["jax"]
    assert results["port"] == [True, False, "a", True, False, True, "a", None, False,
                               True, None, False, True, "b", None]


def test_file_leases_shared_across_packages(tmp_path):
    async def main():
        ours = port_leases.FileLeaseManager(str(tmp_path))
        theirs = jax_leases.FileLeaseManager(str(tmp_path))
        return [await ours.acquire("L", "port", 30.0), await theirs.acquire("L", "jax", 30.0),
                await theirs.holder("L"), await theirs.renew("L", "port", 30.0)]

    assert asyncio.run(main()) == [True, False, "port", True]


async def elector_script(leases_mod, backend: str, directory: str) -> list:
    """Two electors on one lease: the first elected, the second not while
    the first holds; the first stops (releasing) and the second takes over."""
    m = leases_mod.make_lease_manager(backend, directory)
    events: list = []

    def elector(owner):
        async def elected():
            events.append(("elected", owner))

        async def lost():
            events.append(("lost", owner))
        return leases_mod.LeaderElector(m, "leader", owner, ttl=1.5,
                                        on_elected=elected, on_lost=lost)

    first, second = elector("a"), elector("b")
    await first.start()
    await until(lambda: first.is_leader)
    await second.start()
    await asyncio.sleep(0.1)           # the second's first attempt (at once)
    states = [first.is_leader, second.is_leader, await m.holder("leader")]
    await first.stop()
    await until(lambda: second.is_leader)
    states += [first.is_leader, await m.holder("leader")]
    await second.stop()
    return states + events + [await m.holder("leader")]


@pytest.mark.parametrize("backend", BACKENDS)
def test_leader_elector_same_transitions(tmp_path, backend):
    results = {name: asyncio.run(elector_script(mods[1], backend, str(tmp_path / name)))
               for name, mods in PACKAGES.items()}
    assert results["port"] == results["jax"]
    assert results["port"] == [True, False, "a", False, "b", ("elected", "a"),
                               ("elected", "b"), None]


# ------------------------------------------------------------------- kv

async def kv_script(kv_mod, backend: str, directory: str) -> list:
    s = kv_mod.make_kv(backend, directory)
    await s.set("plain", {"v": [1, "two"]})
    await s.set("odd key/with:chars", 7)
    await s.set("short", "gone", ttl=0.05)
    await s.set("long", "kept", ttl=30.0)
    out = [await s.get("plain"), await s.get("odd key/with:chars"), await s.get("missing")]
    await asyncio.sleep(0.2)
    out += [await s.get("short"), await s.get("long")]
    await s.set("short2", 1, ttl=0.05)
    await asyncio.sleep(0.2)
    out.append(await s.purge_expired())
    await s.delete("plain")
    out += [await s.get("plain"), await s.get("long")]
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_kv_same_answers(tmp_path, backend):
    results = {name: asyncio.run(kv_script(mods[2], backend, str(tmp_path / name)))
               for name, mods in PACKAGES.items()}
    assert results["port"] == results["jax"]
    assert results["port"] == [{"v": [1, "two"]}, 7, None, None, "kept", 1, None, "kept"]


def test_file_kv_shared_across_packages(tmp_path):
    async def main():
        ours, theirs = port_kv.FileKVStore(str(tmp_path)), jax_kv.FileKVStore(str(tmp_path))
        await ours.set("chat:1", {"from": "port"})
        await theirs.set("chat:2", {"from": "jax"})
        return [await theirs.get("chat:1"), await ours.get("chat:2")]

    assert asyncio.run(main()) == [{"from": "port"}, {"from": "jax"}]


# ------------------------------------------------------------------ hub

SECRET = "hub-secret-0123"
# raw frames on one connection: what every hub must answer, byte for byte
RAW_FRAMES = [
    {"op": "hello", "secret": SECRET},
    {"op": "acquire", "id": 1, "name": "L", "owner": "a", "ttl": 30.0},
    {"op": "acquire", "id": 2, "name": "L", "owner": "b", "ttl": 30.0},
    {"op": "holder", "id": 3, "name": "L"},
    {"op": "renew", "id": 4, "name": "L", "owner": "b", "ttl": 30.0},
    {"op": "release", "id": 5, "name": "L", "owner": "a"},
    {"op": "holder", "id": 6, "name": "L"},
    {"op": "kv_set", "id": 7, "key": "k", "value": {"x": [1, 2]}, "ttl": 0},
    {"op": "kv_get", "id": 8, "key": "k"},
    {"op": "kv_del", "id": 9, "key": "k"},
    {"op": "kv_get", "id": 10, "key": "k"},
    {"op": "rl_take", "id": 11, "key": "t", "cost": 5, "limit": 8, "window_s": 3600},
    {"op": "batch", "ops": [
        {"op": "rl_take", "id": 12, "key": "t", "cost": 5, "limit": 8, "window_s": 3600},
        {"op": "rl_take", "id": 13, "key": "t", "cost": 5, "limit": 8, "window_s": 3600},
        {"op": "pub", "id": 14, "topic": "x", "msg": {}}]},
    {"op": "sub", "topic": "news"},
]


def _rl_free(frame: dict) -> dict:
    """A rate-limit answer's retry_after counts down the window's seconds
    left (a clock reading): dropped before comparing."""
    if frame.get("op") == "batch_resp":
        return {**frame, "results": [_rl_free(r) for r in frame["results"]]}
    return {k: v for k, v in frame.items() if k != "retry_after"}


async def raw_exchange(hub_mod) -> tuple[list, list]:
    """RAW_FRAMES against a hub of ``hub_mod``; a second connection
    publishes on ``news``. Returns (the answer lines as bytes, parsed)."""
    hub = hub_mod.CoordinationHub("127.0.0.1", 0, secret=SECRET)
    await hub.start()
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", hub.bound_port)
        lines = []
        for frame in RAW_FRAMES:
            writer.write(json.dumps(frame, separators=(",", ":")).encode() + b"\n")
            if frame["op"] not in ("sub",):
                lines.append(await asyncio.wait_for(reader.readline(), 5))
        r2, w2 = await asyncio.open_connection("127.0.0.1", hub.bound_port)
        w2.write(b'{"op":"hello","secret":"' + SECRET.encode() + b'"}\n')
        await asyncio.wait_for(r2.readline(), 5)
        w2.write(b'{"op":"pub","topic":"news","msg":{"headline":1}}\n')
        w2.write(b'{"op":"pub","topic":"other","msg":{"headline":2}}\n')
        lines.append(await asyncio.wait_for(reader.readline(), 5))
        writer.close()
        w2.close()
    finally:
        await hub.stop()
    return lines, [_rl_free(json.loads(line)) for line in lines]


def test_hub_answers_raw_frames_like_the_reference():
    (port_lines, port_frames), (jax_lines, jax_frames) = (
        asyncio.run(raw_exchange(port_hub)), asyncio.run(raw_exchange(jax_hub)))
    assert port_frames == jax_frames
    # byte for byte, once the clock-dependent retry_after is set aside
    strip = [json.dumps(f, separators=(",", ":")).encode() + b"\n" for f in port_frames]
    assert strip == [json.dumps(f, separators=(",", ":")).encode() + b"\n" for f in jax_frames]
    assert port_lines[0] == jax_lines[0] == b'{"op":"hello_ok"}\n'
    assert port_lines[-1] == jax_lines[-1] == \
        b'{"op":"msg","topic":"news","msg":{"headline":1}}\n'
    assert [f.get("ok") for f in port_frames[1:7]] == [True, False, True, False, True, True]
    assert port_frames[3]["holder"] == "a" and port_frames[6]["holder"] is None
    assert port_frames[12]["results"][0]["ok"] is True
    assert port_frames[12]["results"][1]["ok"] is False
    assert port_frames[12]["results"][2]["error"] == "unbatchable op 'pub'"


async def client_frames(hub_mod) -> list[bytes]:
    """The bytes a ``HubClient`` of ``hub_mod`` sends for one fixed series
    of calls, read by a plain server that answers every request."""
    seen: list[bytes] = []

    async def serve(reader, writer):
        while line := await reader.readline():
            seen.append(line)
            frame = json.loads(line)
            if frame["op"] == "hello":
                writer.write(b'{"op":"hello_ok"}\n')
            elif frame["op"] == "batch":
                writer.write(json.dumps({"op": "batch_resp", "results": [
                    {"op": "resp", "id": f["id"], "ok": True} for f in frame["ops"]]}).encode()
                    + b"\n")
            elif "id" in frame:
                writer.write(json.dumps({"op": "resp", "id": frame["id"], "ok": True,
                                         "holder": "a", "value": 3}).encode() + b"\n")
        writer.close()

    server = await asyncio.start_server(serve, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    client = hub_mod.HubClient("127.0.0.1", port, secret=SECRET)
    bus, leases = hub_mod.TcpEventBus(client), hub_mod.TcpLeaseManager(client)
    await bus.start()
    try:
        async def nothing(topic, message):
            pass

        unsub = bus.subscribe("news", nothing)
        await bus.publish("news", {"n": 1})
        await leases.acquire("L", "a", 30.0)
        await leases.renew("L", "a", 30.0)
        await leases.holder("L")
        await leases.release("L", "a")
        await client.kv_set("k", {"v": 1}, ttl=5.0)
        await client.kv_get("k")
        await client.kv_del("k")
        await asyncio.gather(client.rl_take("t", 1.0, 10.0, 60.0),
                             client.rl_take("t", 2.0, 10.0, 60.0, force=True))
        unsub()
        await asyncio.sleep(0.05)
    finally:
        await bus.stop()
        server.close()
        await server.wait_closed()
    return seen


def test_client_sends_the_reference_frames():
    port, ref = asyncio.run(client_frames(port_hub)), asyncio.run(client_frames(jax_hub))
    assert port == ref
    assert port[0] == b'{"op":"hello","secret":"' + SECRET.encode() + b'"}\n'
    assert port[-1] == b'{"op":"unsub","topic":"news"}\n'


async def cross_package_run(hub_mod, client_mods) -> list:
    """A hub of ``hub_mod`` and two workers, one per module of
    ``client_mods``: pub/sub both ways, a lease contended across, the
    shared KV, and a client with a bad secret that never connects."""
    hub = hub_mod.CoordinationHub("127.0.0.1", 0, secret=SECRET)
    await hub.start()
    clients = [m.HubClient("127.0.0.1", hub.bound_port, secret=SECRET) for m in client_mods]
    buses = [m.TcpEventBus(c) for m, c in zip(client_mods, clients)]
    leases = [m.TcpLeaseManager(c) for m, c in zip(client_mods, clients)]
    got: list = [[], []]
    out: list = []
    try:
        for k, bus in enumerate(buses):
            await bus.start()

            async def on(topic, message, k=k):
                got[k].append(message)
            bus.subscribe("news", on)
        await asyncio.sleep(0.05)       # the sub frames reach the hub
        await buses[0].publish("news", {"from": 0})
        await buses[1].publish("news", {"from": 1})
        await until(lambda: len(got[0]) == 2 and len(got[1]) == 2)
        out.append([sorted(m["from"] for m in g) for g in got])
        out += [await leases[0].acquire("L", "w0", 30.0), await leases[1].acquire("L", "w1", 30.0),
                await leases[1].holder("L"), await leases[1].renew("L", "w0", 30.0)]
        await clients[1].kv_set("k", {"v": "from w1"})
        out.append(await clients[0].kv_get("k"))
        bad = client_mods[0].HubClient("127.0.0.1", hub.bound_port, secret="wrong")
        try:
            await asyncio.wait_for(bad.start(), 1.0)
            out.append("bad secret accepted")
        except asyncio.TimeoutError:
            out.append("bad secret refused")
        finally:
            await bad.stop()
    finally:
        for bus in buses:
            await bus.stop()
        await hub.stop()
    return out


@pytest.mark.parametrize("hub_side", ["jax", "port"])
def test_clients_of_both_packages_on_one_hub(hub_side):
    """A port client and a JAX client on a hub of either package."""
    out = asyncio.run(cross_package_run(PACKAGES[hub_side][3], (port_hub, jax_hub)))
    # the lease answers by owner, whichever connection asks
    assert out == [[[0, 1], [0, 1]], True, False, "w0", True, {"v": "from w1"},
                   "bad secret refused"]


@pytest.mark.parametrize("hub_side", ["jax", "port"])
def test_bad_secret_closed_without_an_answer(hub_side):
    async def main():
        hub = PACKAGES[hub_side][3].CoordinationHub("127.0.0.1", 0, secret=SECRET)
        await hub.start()
        try:
            answers = []
            for hello in (b'{"op":"hello","secret":"wrong"}\n', b'{"op":"holder","id":1}\n',
                          b"not json\n"):
                reader, writer = await asyncio.open_connection("127.0.0.1", hub.bound_port)
                writer.write(hello)
                answers.append(await asyncio.wait_for(reader.read(), 5))
                writer.close()
            return answers
        finally:
            await hub.stop()

    assert asyncio.run(main()) == [b"", b"", b""]


def test_hub_module_entry_serves():
    """``python -m mcp_context_forge_tpu_torch.coordination.hub`` serves a
    JAX client, with the secret from the environment."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "MCPFORGE_BUS_TCP_SECRET": SECRET}
    proc = subprocess.Popen([sys.executable, "-m", "mcp_context_forge_tpu_torch.coordination.hub",
                             "--port", str(port)], cwd=Path(__file__).resolve().parents[1],
                            env=env)
    try:
        async def main():
            client = jax_hub.HubClient("127.0.0.1", port, secret=SECRET, reconnect_max=0.2)
            leases = jax_hub.TcpLeaseManager(client)
            await client.start()
            try:
                return [await leases.acquire("L", "x", 30.0), await leases.holder("L")]
            finally:
                await client.stop()

        assert asyncio.run(main()) == [True, "x"]
    finally:
        proc.terminate()
        proc.wait(10)
