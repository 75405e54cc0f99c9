"""The port's fault plane against the JAX package's, on the CPU: each mode
(``always``, ``once``, ``one_in_n`` seeded, ``window``) fires on the same
calls, scope filters pass the same calls, each action does the same
(``error`` raises a ``ConnectionError``, ``latency`` sleeps,
``corrupt_bytes`` gives the same bytes), the same rules are refused, an
unarmed point takes no lock, and a disabled plane refuses to arm. Then the
``engine.dispatch`` point: an error fault armed once, under
``auto_restart``, gives the same outcome on a ``TorchEngine`` and a
``TPUEngine`` on the same weights (the victim ends "error", the request
queued behind it completes with the tokens served before, one restart,
the same tokens after, no page in use); a latency fault delays a stream
without changing it."""

import asyncio
import threading
import time

import pytest

from mcp_context_forge_tpu.observability import faults as jax_faults
from mcp_context_forge_tpu.tpu_local.engine import GenRequest as JaxRequest
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.observability import faults as port_faults
from mcp_context_forge_tpu_torch.tpu_local.engine import GenRequest
from torch_engine_pair import make_pair
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

PLANES = {"jax": jax_faults, "port": port_faults}


@pytest.fixture(autouse=True)
def disarmed():
    """Both process planes end every test disabled and empty."""
    yield
    for module in PLANES.values():
        module.configure_fault_plane(False)


def _fires(module, rule: dict, calls: list, sleep_after: int | None = None) -> list:
    plane = module.configure_fault_plane(True)
    plane.arm(module.FaultRule(**rule))
    out = []
    for i, scope in enumerate(calls):
        action = plane.check(rule["point"], scope=scope)
        out.append(None if action is None else (action.point, action.kind,
                                                action.latency_s, action.message))
        if sleep_after == i:
            time.sleep(0.08)
    return out + [plane.snapshot()]


SCHEDULES = {
    "always": (dict(point="db.execute"), [None] * 3),
    "once": (dict(point="engine.dispatch", mode="once", kind="error", message="boom"),
             ["0"] * 5),
    "one_in_n": (dict(point="tier.disk.read", mode="one_in_n", n=3), [None] * 7),
    "one_in_n_seeded": (dict(point="tier.disk.read", mode="one_in_n", n=3, seed=1),
                        [None] * 7),
    "scoped": (dict(point="engine.dispatch", scope="1", kind="latency", latency_ms=5.0),
               ["0", "1", None, "replica-1", "2"]),
    "corrupt": (dict(point="tier.object.get", kind="corrupt"), ["x"]),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedules_fire_alike(case):
    rule, calls = SCHEDULES[case]
    got = {name: _fires(module, rule, calls) for name, module in PLANES.items()}
    assert got["port"] == got["jax"]
    assert any(f is not None for f in got["port"][:-1])


def test_window_expires_alike():
    rule = dict(point="db.execute", mode="window", window_s=0.05)
    got = {name: _fires(module, rule, [None, None], sleep_after=0)
           for name, module in PLANES.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] is not None and got["port"][1] is None


@pytest.mark.parametrize("rule", [
    dict(point="no.such.point"), dict(point="db.execute", kind="explode"),
    dict(point="db.execute", mode="sometimes"), dict(point="db.execute", mode="one_in_n", n=0),
    dict(point="db.execute", mode="window"), dict(point="db.execute", kind="latency"),
    dict(point="db.execute", scope=3), dict(point="db.execute", n=True),
], ids=str)
def test_bad_rules_refused_alike(rule):
    messages = []
    for module in PLANES.values():
        plane = module.configure_fault_plane(True)
        with pytest.raises(ValueError) as info:
            plane.arm(module.FaultRule(**rule))
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_disabled_plane_refuses_to_arm():
    for module in PLANES.values():
        plane = module.configure_fault_plane(False, rules_json=(
            '[{"point": "engine.dispatch", "kind": "error"}]'))
        assert plane.snapshot()["rules"] == []
        with pytest.raises(RuntimeError, match="fault injection is disabled"):
            plane.arm(module.FaultRule(point="engine.dispatch"))
        assert module.fault_point("engine.dispatch", scope="0") is None


def test_rules_json_and_snapshot_alike():
    rules = ('[{"point": "engine.dispatch", "kind": "latency", "latency_ms": 5, "scope": "0"},'
             ' {"point": "pool.requeue", "mode": "once"}]')
    snaps = []
    for module in PLANES.values():
        plane = module.configure_fault_plane(True, rules_json=rules)
        assert plane.check("engine.dispatch", scope="1") is None
        assert plane.check("engine.dispatch", scope="0").kind == "latency"
        assert plane.disarm("pool.requeue") and not plane.disarm("pool.requeue")
        snaps.append(plane.snapshot())
        with pytest.raises(ValueError):
            module.configure_fault_plane(True, rules_json="{not json")
    assert snaps[0] == snaps[1]
    assert port_faults.FAULT_POINTS == jax_faults.FAULT_POINTS


class _ExplodingLock:
    def __enter__(self):
        raise AssertionError("an unarmed fault point must not lock")

    def __exit__(self, *args):
        return False


def test_unarmed_point_is_one_dict_miss_no_lock():
    plane = port_faults.configure_fault_plane(True)
    plane._lock = _ExplodingLock()
    for point in port_faults.FAULT_POINTS:
        assert plane.check(point) is None
    plane._lock = threading.Lock()
    plane.arm(port_faults.FaultRule(point="db.execute"))
    plane._lock = _ExplodingLock()
    assert plane.check("engine.dispatch", scope="0") is None
    plane._lock = threading.Lock()


@pytest.mark.parametrize("data", [b"", b"\x00", bytes(range(256)) * 9])
def test_actions_alike(data):
    assert port_faults.FaultAction.corrupt_bytes(data) == \
        jax_faults.FaultAction.corrupt_bytes(data)
    error = port_faults.FaultAction("engine.dispatch", "error")
    with pytest.raises(ConnectionError, match="injected fault at engine.dispatch"):
        error.apply()
    with pytest.raises(port_faults.FaultError):
        asyncio.run(error.async_apply())
    started = time.monotonic()
    port_faults.FaultAction("engine.dispatch", "latency", latency_s=0.02).apply()
    assert time.monotonic() - started >= 0.015
    port_faults.FaultAction("engine.dispatch", "corrupt").apply()   # the seam mangles


@pytest.fixture(scope="module")
def pair():
    return make_pair(max_batch=1, auto_restart=True, auto_restart_max=2)


def _dispatch_fault(engine, module, rule: dict):
    """Serve a prompt; then, while a victim request decodes, arm ``rule``
    on ``module``'s plane and queue a second request behind it; then the
    prompt again. Returns what a caller sees."""
    cls = JaxRequest if isinstance(engine, TPUEngine) else GenRequest

    async def drain(request):
        tokens = []
        while (t := await asyncio.wait_for(request.stream.get(), 60)) is not None:
            tokens.append(t)
        return tokens

    async def main():
        await engine.start()
        try:
            ids = engine.tokenizer.encode("which tools can read files?")
            before = [t async for t in engine.generate(ids, max_tokens=6)]
            victim = cls(request_id="victim", prompt_ids=ids, max_tokens=24)
            await engine.submit(victim)
            first = await asyncio.wait_for(victim.stream.get(), 60)
            plane = module.configure_fault_plane(True)
            plane.arm(module.FaultRule(**rule))
            queued = cls(request_id="queued", prompt_ids=ids, max_tokens=6)
            await engine.submit(queued)
            victim_tokens = [first] + await drain(victim)
            queued_tokens = await drain(queued)
            # the rule stays armed until the queued request ends: its
            # admission and decode iterations all pass the point
            fired = plane.snapshot()["rules"][0]["fired"]
            plane.disarm(rule["point"])
            after = [t async for t in engine.generate(ids, max_tokens=6)]
            return {"before": before, "victim": victim.finish_reason,
                    "victim_prefix_ok": victim_tokens[:len(before)] == before[:len(victim_tokens)],
                    "queued": (queued.finish_reason, queued_tokens == before),
                    "after": after == before, "fired": fired,
                    "alive": engine.dispatch_alive()}
        finally:
            await engine.stop()

    restarts = engine.stats.engine_restarts
    out = asyncio.run(main())
    out["restarts"] = engine.stats.engine_restarts - restarts
    out["pages_in_use"] = engine.allocator.pages_in_use
    module.configure_fault_plane(False)
    return out


def test_dispatch_error_restarts_alike(pair):
    rule = dict(point="engine.dispatch", kind="error", mode="once", scope="0")
    ref, port = (_dispatch_fault(engine, module, rule)
                 for engine, module in zip(pair, (jax_faults, port_faults)))
    assert port == ref
    assert port["victim"] == "error" and port["queued"] == ("length", True)
    assert port["after"] and port["victim_prefix_ok"] and port["alive"]
    assert (port["restarts"], port["fired"], port["pages_in_use"]) == (1, 1, 0)


def test_dispatch_latency_is_a_slow_replica(pair):
    """A latency fault on every iteration, armed once the victim streams
    and disarmed once the request queued behind it ends, slows the port's
    dispatch loop without changing a stream or restarting it. (The number
    of firings depends on the iterations, not on the CPU's speed: the
    queued request alone needs its admission and five decode steps.)"""
    rule = dict(point="engine.dispatch", kind="latency", mode="always",
                latency_ms=20.0, scope="0")
    out = _dispatch_fault(pair[1], port_faults, rule)
    assert out["victim"] == "length" and out["queued"] == ("length", True)
    assert out["after"] and out["victim_prefix_ok"]
    assert out["restarts"] == 0 and out["fired"] >= 2 and out["pages_in_use"] == 0
