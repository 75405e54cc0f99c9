"""The port's signal bus and serving controller against the JAX package's,
on the CPU. One publish sequence, on an injected clock, goes to both
``SignalBus``es: every view, EWMA, replica list, snapshot and the series
cap agree. One signal sequence goes to both ``ServingController``s, over
stand-in engines and over a ``TorchEngine`` and a ``TPUEngine`` with
``k_ladder`` (1, 4): the decisions and audit rows (all but the wall-clock
``ts``) agree, and so do the engines' knob states; the sequence walks the
cooldown, the reversal hysteresis, the spec toggle, the width floor,
``safe_mode`` and the shed bar that a published ``slo.burn_rate`` moves.
Last, ``build_llm_app`` wires the controller, the shedder, the bus and the
fault plane from the settings."""

import pytest

from mcp_context_forge_tpu.observability.degradation import OverloadShedder as JaxShedder
from mcp_context_forge_tpu.observability.signals import SignalBus as JaxBus
from mcp_context_forge_tpu.tpu_local.controller import RING_SCHEMA as JAX_SCHEMA
from mcp_context_forge_tpu.tpu_local.controller import ServingController as JaxController
from mcp_context_forge_tpu.tpu_local.engine import EngineConfig as JaxConfig
from mcp_context_forge_tpu.tpu_local.engine import TPUEngine
from mcp_context_forge_tpu_torch.observability.degradation import OverloadShedder
from mcp_context_forge_tpu_torch.observability.signals import GATEWAY_REPLICA, SignalBus
from mcp_context_forge_tpu_torch.tpu_local.controller import RING_SCHEMA, ServingController
from mcp_context_forge_tpu_torch.tpu_local.engine import EngineConfig, TorchEngine
from torch_engine_pair import SHAPE
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

PACKAGES = {"jax": (JaxBus, JaxController, JaxShedder),
            "port": (SignalBus, ServingController, OverloadShedder)}


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


PUBLISHES = [
    # (advance s, name, value, replica)
    (0.0, "llm.queue_wait_ms", 12.0, "0"), (0.1, "llm.queue_wait_ms", 30.0, "0"),
    (0.1, "llm.queue_wait_ms", "not a number", "0"), (0.0, "llm.idle_frac", 0.5, "0"),
    (0.5, "llm.idle_frac", 0.1, "0"), (0.0, "llm.idle_frac", 0.7, "1"),
    (2.0, "slo.burn_rate", 1.5, GATEWAY_REPLICA), (0.0, "llm.occupancy", 0.25, "0"),
    (0.0, "overflow.a", 1.0, "0"), (0.0, "overflow.b", 2.0, "0"),
    (1.0, "llm.queue_wait_ms", 700.0, "0"),
] + [(0.01, "llm.tokens_per_dispatch", float(i % 5), "0") for i in range(12)]


def _bus_reads(bus, clock):
    return {
        "get": {(n, r): bus.get(n, r) for n in ("llm.queue_wait_ms", "llm.idle_frac",
                                                "slo.burn_rate", "llm.tokens_per_dispatch",
                                                "overflow.a", "missing")
                for r in ("0", "1", GATEWAY_REPLICA)},
        "ewma": [bus.ewma("llm.queue_wait_ms", "0"), bus.ewma("llm.idle_frac", "1", 1.0),
                 bus.ewma("llm.idle_frac", "1", 10.0), bus.ewma("missing")],
        "replicas": bus.replicas("llm.idle_frac"),
        "snapshot": bus.snapshot(), "snapshot_llm": bus.snapshot("llm."),
        "stats": bus.stats(),
    }


@pytest.mark.parametrize("window,alpha,max_series", [(64, 0.3, 256), (4, 0.9, 6)])
def test_signal_bus_equal(window, alpha, max_series):
    reads = {}
    for name, (bus_cls, _, _) in PACKAGES.items():
        clock = Clock()
        bus = bus_cls(window=window, ewma_alpha=alpha, max_series=max_series, clock=clock)
        for advance, signal, value, replica in PUBLISHES:
            clock.t += advance
            bus.publish(signal, value, replica)
        bus.publish_many({"llm.mfu": 0.4, "llm.hbm_roofline_frac": None}, "0")
        clock.t += 3.0
        reads[name] = _bus_reads(bus, clock)
    assert reads["port"] == reads["jax"]
    if max_series == 6:
        assert reads["port"]["stats"]["dropped"] > 0


class StandIn:
    """An engine as the controller sees it: a replica id, a knob state and
    ``request_knobs`` validated against the captured ladder and widths."""

    def __init__(self, rid="0", ladder=(1, 4, 8), widths=(2, 4, 8), spec=True):
        self.config = type("Config", (), {"replica_id": rid})()
        self.state = {"superstep": ladder[0], "warmed_k": list(ladder), "width_floor": 0,
                      "warmed_widths": list(widths), "spec_built": spec,
                      "spec_enabled": spec}
        self.requests = []

    def knob_state(self):
        return dict(self.state)

    def request_knobs(self, superstep=None, width_floor=None, spec_enabled=None):
        self.requests.append((superstep, width_floor, spec_enabled))
        out = {}
        if superstep is not None:
            out["superstep"] = superstep in self.state["warmed_k"]
            if out["superstep"]:
                self.state["superstep"] = superstep
        if width_floor is not None:
            out["width_floor"] = width_floor in self.state["warmed_widths"] + [0]
            if out["width_floor"]:
                self.state["width_floor"] = width_floor
        if spec_enabled is not None:
            out["spec_enabled"] = self.state["spec_built"]
            if out["spec_enabled"]:
                self.state["spec_enabled"] = spec_enabled
        return out


# each tick: (advance s, {signal@replica: values published before it})
TICKS = [
    (0.0, {"llm.idle_frac@0": [0.6, 0.6], "llm.queue_wait_ms@0": [5.0],
           "llm.occupancy@0": [0.5, 0.6], "llm.spec_accept@0": [0.2]}),
    (1.0, {"llm.idle_frac@0": [0.9]}),                 # cooldown holds K
    (6.0, {"llm.queue_wait_ms@0": [520.0] * 30}),      # 1.04x the bar: a reversal needs 1.1x
    (1.0, {"llm.queue_wait_ms@0": [900.0] * 64}),      # past the hysteresis: K down
    (1.0, {"slo.burn_rate@-": [2.0]}),                 # shed bar down one step
    (6.0, {"slo.burn_rate@-": [2.0]}),                 # and again after the cooldown
    (6.0, {"slo.burn_rate@-": [0.0] * 8}),             # burn under burn_low: back up
    (40.0, {}),                                        # stale spec accept: re-probe
    (0.5, {}),
]


def _drive(package: str, engines_fn, safe_mode=False, with_shedder=True, ticks=TICKS):
    bus_cls, controller_cls, shedder_cls = PACKAGES[package]
    clock = Clock()
    bus = bus_cls(clock=clock)
    shedder = shedder_cls(shed_at=0.9, class_order=["batch"]) if with_shedder else None
    controller = controller_cls(bus, engines_fn, shedder=shedder, safe_mode=safe_mode,
                                tick_s=1.0, cooldown_s=5.0, eval_window_s=2.0,
                                hysteresis=0.1, queue_wait_high_ms=500.0,
                                queue_wait_low_ms=50.0, idle_frac_high=0.35,
                                spec_accept_off=0.5, burn_high=1.0, burn_low=0.25,
                                shed_floor=0.7, shed_step=0.05, clock=clock)
    out = []
    for advance, signals in ticks:
        clock.t += advance
        for key, values in signals.items():
            name, replica = key.rsplit("@", 1)
            for value in values:
                bus.publish(name, value, replica)
        rows = controller.tick()
        for engine in engines_fn():
            if hasattr(engine, "_apply_knobs") and engine._pending_knobs:
                engine._apply_knobs()
        out.append({"rows": [{k: v for k, v in row.items() if k != "ts"} for row in rows],
                    "shed_at": shedder.shed_at if shedder else None,
                    "knobs": [e.knob_state() for e in engines_fn()]})
    ring = [{k: v for k, v in row.items() if k != "ts"} for row in controller.decisions(256)]
    return out, ring, controller


def _moves(ticks):
    return [(r["knob"], r["direction"], r["from"], r["to"], r["actuated"])
            for tick in ticks for r in tick["rows"]]


@pytest.mark.parametrize("safe_mode", [False, True], ids=["actuate", "safe_mode"])
def test_controller_equal_over_stand_ins(safe_mode):
    runs = {name: _drive(name, (lambda e=StandIn(): lambda: [e])(), safe_mode=safe_mode)
            for name in PACKAGES}
    (jax_ticks, jax_ring, _), (port_ticks, port_ring, port) = runs["jax"], runs["port"]
    assert RING_SCHEMA == JAX_SCHEMA
    assert port_ticks == jax_ticks
    assert port_ring == jax_ring
    for row in port_ring:
        assert row["schema"] == RING_SCHEMA and row["safe_mode"] is safe_mode
    # every effect settles after eval_window_s
    assert all(row["effect"] is not None for row in port_ring[2:])
    assert port.snapshot()["ticks"] == len(TICKS)
    moves = _moves(port_ticks)
    first = [("superstep", "up", 1, 4), ("width_floor", "up", 0, 4), ("spec", "off", 1, 0)]
    assert moves[:3] == [m + (not safe_mode,) for m in first]
    if safe_mode:
        # the same first decisions, recorded and never actuated
        assert all(not m[4] for m in moves)
        assert all(t["knobs"] == port_ticks[0]["knobs"] and t["shed_at"] == 0.9
                   for t in port_ticks)
        return
    # tick 1: the cooldown holds K; tick 2: 520 ms clears the bar but not
    # the reversal's 1.1x; tick 3: K back down
    assert not [m for m in _moves(port_ticks[1:3]) if m[0] == "superstep"]
    assert ("superstep", "down", 4, 1, True) in _moves(port_ticks[3:4])
    shed = [m for m in moves if m[0] == "shed_bar"]
    assert [m[1:4] for m in shed] == [("down", 0.9, 0.85), ("down", 0.85, 0.8),
                                      ("up", 0.8, 0.85)]
    assert port_ticks[-1]["shed_at"] == 0.85
    assert ("spec", "on", 0, 1, True) in _moves(port_ticks[-2:])
    knobs = port_ticks[-1]["knobs"][0]
    assert knobs["superstep"] == 1 and knobs["width_floor"] == 4


def test_shed_bar_holds_without_a_fresh_burn():
    """The shed bar moves only on a published, fresh ``slo.burn_rate``; a
    controller without an SLO evaluator publishes none itself."""
    ticks = [(0.0, {}), (10.0, {"slo.burn_rate@-": [3.0]}), (30.0, {})]
    for name in PACKAGES:
        out, ring, _ = _drive(name, lambda: [], ticks=ticks)
        assert [t["shed_at"] for t in out] == [0.9, 0.85, 0.85]
        assert [(r["knob"], r["direction"]) for r in ring] == [("shed_bar", "down")]


def _warmed_ref(**config) -> TPUEngine:
    """A TPUEngine given the warmed grid its warmup would set: what the
    port captures at build."""
    ref = TPUEngine(JaxConfig(**config, attn_impl="reference"))
    ref._warmed_k = set(ref.config.k_rungs())
    ref._warmed_widths = set(ref._batch_buckets() if ref.config.batch_buckets
                             else [ref.config.max_batch])
    ref._batch_width = ref.config.max_batch
    return ref


def test_controller_equal_over_engines():
    """The same sequence steers a TorchEngine and a TPUEngine (k_ladder 1, 4)
    through the same decisions and knob states."""
    config = {**SHAPE, "k_ladder": (1, 4)}
    engines = {"jax": _warmed_ref(**config),
               "port": TorchEngine(EngineConfig(**config, device="cpu"))}
    ticks = TICKS[:4]
    runs = {name: _drive(name, lambda e=engines[name]: [e], with_shedder=False, ticks=ticks)
            for name in PACKAGES}
    assert runs["port"][0] == runs["jax"][0]
    assert runs["port"][1] == runs["jax"][1]
    moves = _moves(runs["port"][0])
    assert moves[0] == ("superstep", "up", 1, 4, True)
    assert ("superstep", "down", 4, 1, True) in moves
    assert engines["port"].knob_state() == engines["jax"].knob_state()
    assert engines["port"].knob_state()["superstep"] == 1


def test_build_llm_app_wires_the_serving_plane():
    """``build_llm_app`` with ``controller_enabled``: the controller gets
    the settings' bars, the app's shedder and bus, starts with the app and
    stops at its cleanup; the engine publishes to the app's bus; the fault
    plane is armed from ``fault_rules``."""
    import asyncio
    import dataclasses

    from aiohttp.test_utils import TestClient, TestServer

    from mcp_context_forge_tpu.config import load_settings
    from mcp_context_forge_tpu_torch.observability import faults
    from mcp_context_forge_tpu_torch.tpu_local.server import build_llm_app

    settings = load_settings(env={
        "MCPFORGE_TPU_LOCAL_MODEL": "llama3-test", "MCPFORGE_CONTROLLER_ENABLED": "true",
        "MCPFORGE_CONTROLLER_K_LADDER": "1,4", "MCPFORGE_CONTROLLER_TICK_S": "0.05",
        "MCPFORGE_CONTROLLER_COOLDOWN_S": "7", "MCPFORGE_CONTROLLER_SAFE_MODE": "true",
        "MCPFORGE_GW_SHED_SATURATION_AT": "0.8", "MCPFORGE_GW_SHED_CLASS_ORDER": '["batch"]',
        "MCPFORGE_FAULT_INJECTION_ENABLED": "true",
        "MCPFORGE_FAULT_RULES": '[{"point": "engine.dispatch", "kind": "latency",'
                                ' "latency_ms": 1, "scope": "nobody"}]',
    }, env_file=None)
    config = dataclasses.replace(EngineConfig.from_settings(settings), device="cpu",
                                 max_seq_len=128, page_size=8, num_pages=32,
                                 prefill_buckets=(16,))
    assert config.k_ladder == (1, 4)
    engine = TorchEngine(config)
    try:
        app = build_llm_app(settings, engine=engine)
        controller, shedder = app["serving_controller"], app["overload_shedder"]
        assert isinstance(controller, ServingController) and controller.safe_mode
        assert (controller.tick_s, controller.cooldown_s) == (0.05, 7.0)
        assert controller.shedder is shedder and controller.bus is app["signal_bus"]
        assert (shedder.shed_at, shedder.class_order) == (0.8, ["batch"])
        assert engine.signals is app["signal_bus"] and engine.tracer is app["tracer"]
        assert [r["point"] for r in faults.get_fault_plane().snapshot()["rules"]] == \
            ["engine.dispatch"]

        async def run():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                assert controller._task is not None
                await asyncio.sleep(0.2)
                assert controller.snapshot()["ticks"] >= 1
            finally:
                await client.close()
            assert controller._task is None

        asyncio.run(run())
    finally:
        faults.configure_fault_plane(False)
