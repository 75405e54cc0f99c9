"""The port's stdlib metrics registry against the JAX package's, which is
built on ``prometheus_client``, on the CPU: the same seeded observation
sequence (label values, values, trace-id exemplars) goes to both
``PrometheusRegistry``s, whose renders, classic text and OpenMetrics, must
be byte-identical (nothing masked on a frozen clock; ``_created`` values
and exemplar timestamps masked on the real one); ``labels()`` and the
update calls refuse where prometheus refuses, with its message; the
fleet's text-format parser reads an exposition as
``prometheus_client.parser`` does; four threads observe while one renders,
and the counts add up."""

import re
import threading
import time

import numpy as np
import pytest
from prometheus_client.parser import text_string_to_metric_families
from prometheus_client.utils import floatToGoString

from mcp_context_forge_tpu.observability.metrics import PrometheusRegistry as JaxRegistry
from mcp_context_forge_tpu.observability.tenant import TenantClamp as JaxClamp
from mcp_context_forge_tpu_torch.observability.fleet import parse_text
from mcp_context_forge_tpu_torch.observability.metrics import (PrometheusRegistry,
                                                               float_to_go_string)
from mcp_context_forge_tpu_torch.observability.tenant import TenantClamp
from torch_jax_memo import jax_compile_memo  # noqa: F401  (autouse: one compile per program)

OPENMETRICS = "application/openmetrics-text; version=1.0.0"
# label values that need escaping, and tenants past the clamp
TENANTS = ["team:a", "key:b", 'user:"q\\x\ny', "team:c", "team:d", "user:e"]
HISTOGRAMS = [("llm_ttft", ("model", "replica", "tenant")),
              ("llm_tpot", ("model", "replica", "tenant")),
              ("llm_queue_wait", ("tenant",)),
              ("http_duration", ("method", "path", "tenant"))]


def registries(clamp: int = 4):
    return JaxRegistry(tenant_clamp=JaxClamp(clamp)), PrometheusRegistry(
        tenant_clamp=TenantClamp(clamp))


def feed(reg, seed: int = 0, steps: int = 300) -> None:
    """A seeded sequence over every kind of family: labelled and bare
    counters, gauges (NaN, infinities, values past 1e6 included) and
    histograms with trace-id exemplars, children first used in a seeded
    order."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        tenant = reg.tenant_clamp.label(TENANTS[int(rng.integers(len(TENANTS)))])
        value = float(rng.lognormal(-3.0, 2.5))
        trace = f"{int(rng.integers(1 << 62)):016x}{int(rng.integers(1 << 62)):016x}"
        kind = int(rng.integers(8))
        if kind < 4:
            attr, names = HISTOGRAMS[kind]
            labels = {"model": "llama3-test", "replica": str(int(rng.integers(2))),
                      "tenant": tenant, "method": "GET", "path": "/v1/chat/completions"}
            values = tuple(labels[n] for n in names)
            exemplar = reg.exemplar(attr, value, trace, values) if rng.random() < 0.7 else None
            getattr(reg, attr).labels(*values).observe(value, exemplar=exemplar)
        elif kind == 4:
            reg.http_requests.labels("POST", "/v1/x", str(int(rng.choice([200, 429, 503])))).inc()
            reg.llm_tokens.labels(model="m", kind="prompt").inc(int(rng.integers(1, 900)))
        elif kind == 5:
            reg.llm_queue_depth.labels(replica=str(int(rng.integers(3)))).set(
                float(rng.choice([0.0, value, value * 1e7, float("nan"), float("inf"),
                                  -float("inf"), -value])))
            reg.gw_engine_saturation.set(value)
        elif kind == 6:
            reg.llm_kv_alloc_failures.inc(float(rng.integers(3)))
            reg.llm_pool_migrations.labels(**{"from": "0", "to": "1", "outcome": "ok"}).inc()
            reg.llm_pool_migration_seconds.observe(value)
        else:
            reg.llm_tenant_tokens.labels(tenant=tenant, kind="generated").inc(value)
            reg.controller_knob.labels(knob="superstep", replica="0").set(4)
            reg.sessions_active.set(float(rng.integers(5)))
    for replica, value in (("nan", float("nan")), ("big", 1.7e9), ("tiny", 5e-7)):
        reg.llm_mfu.labels(replica=replica).set(value)


def _mask(text: str) -> str:
    """_created values and exemplar timestamps: the two clocks of a run."""
    text = re.sub(r"^(\S+_created(?:\{[^}]*\})?) \S+$", r"\1 T", text, flags=re.M)
    return re.sub(r"( # \{[^}]*\} \S+) \S+$", r"\1 T", text, flags=re.M)


@pytest.mark.parametrize("accept", ["", OPENMETRICS], ids=["text", "openmetrics"])
@pytest.mark.parametrize("clock", ["frozen", "real"])
def test_render_byte_identical(accept, clock, monkeypatch):
    if clock == "frozen":
        monkeypatch.setattr(time, "time", lambda: 1760000000.123456)
    jax_reg, port_reg = registries()
    feed(jax_reg)
    feed(port_reg)
    (want, want_type), (got, got_type) = jax_reg.render(accept), port_reg.render(accept)
    assert got_type == want_type
    if clock == "real":
        want, got = _mask(want.decode()), _mask(got.decode())
    assert got == want
    text = got if isinstance(got, str) else got.decode()
    assert ' # {trace_id="' in text if accept else " # {" not in text
    assert 'tenant="other"' in text and 'NaN' in text and "+Inf" in text


def test_float_format_equals_prometheus():
    rng = np.random.default_rng(1)
    values = [0.0, -0.0, 1.0, 1e6, 999999.0, 1234567.891, 1760000000.123456, 1e10, 1e16,
              1e22, 5e-324, float("nan"), float("inf"), -float("inf"), -1234567.0]
    values += [float(v) for v in rng.lognormal(0.0, 12.0, 200)]
    assert [float_to_go_string(v) for v in values] == [floatToGoString(v) for v in values]


def _error(call):
    try:
        call()
    except Exception as exc:  # noqa: BLE001  (the type is what is compared)
        return type(exc).__name__, str(exc)
    return None


REFUSALS = {
    "wrong_names": lambda r: r.llm_ttft.labels(model="m", replica="0", tenants="x"),
    "missing_name": lambda r: r.llm_ttft.labels(model="m", replica="0"),
    "wrong_count": lambda r: r.http_requests.labels("GET", "/x"),
    "too_many": lambda r: r.llm_queue_depth.labels("0", "1"),
    "args_and_kwargs": lambda r: r.llm_tokens.labels("m", kind="prompt"),
    "labels_on_bare_family": lambda r: r.llm_kv_alloc_failures.labels("x"),
    "inc_on_labelled_parent": lambda r: r.http_requests.inc(),
    "observe_on_labelled_parent": lambda r: r.llm_ttft.observe(0.1),
    "set_on_labelled_parent": lambda r: r.llm_queue_depth.set(1.0),
    "negative_counter": lambda r: r.llm_kv_alloc_failures.inc(-1),
    "long_exemplar": lambda r: r.llm_queue_wait.labels(tenant="t").observe(
        0.1, exemplar={"trace_id": "x" * 130}),
    "reserved_exemplar_key": lambda r: r.llm_queue_wait.labels(tenant="t").observe(
        0.1, exemplar={"__x": "y"}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_labels_refuse_where_prometheus_refuses(case):
    jax_reg, port_reg = registries()
    want = _error(lambda: REFUSALS[case](jax_reg))
    assert want is not None and want[0] == "ValueError"
    assert _error(lambda: REFUSALS[case](port_reg)) == want


def test_labels_accept_what_prometheus_accepts():
    """Values are stringified, keyword order is free, and a child is the
    same object on every call."""
    for reg in registries():
        a = reg.llm_ttft.labels(model="m", tenant="t", replica=0)
        assert a is reg.llm_ttft.labels("m", "0", "t")
        a.observe(0.2)
    jax_reg, port_reg = registries()
    for reg in (jax_reg, port_reg):
        reg.llm_ttft.labels(model="m", tenant="t", replica=0).observe(0.2)
    assert _mask(port_reg.render()[0].decode()) == _mask(jax_reg.render()[0].decode())


def _families(families) -> list:
    """Each family's fields and samples; a value as its repr (NaN != NaN,
    and an int must stay an int)."""
    return [(f.name, f.documentation, f.type,
             [(s.name, s.labels, repr(s.value), s.timestamp) for s in f.samples])
            for f in families]


def test_parser_equals_prometheus():
    _, port_reg = registries()
    feed(port_reg, seed=2)
    text = port_reg.render()[0].decode() + (
        'untyped_one{a="x\\\\y\\"z",b="n\\nl"} 3 1700000000000\n'
        "# HELP odd_summary doc with \\\\ and \\n escapes\n"
        "# TYPE odd_summary summary\n"
        'odd_summary_count 4\nodd_summary_sum 1e-3\nodd_summary{quantile="0.5"} 2\n'
        "# TYPE plain_counter counter\nplain_counter 7\n"
        "# a comment line\nstray_sample 1.5\n")
    want = _families(text_string_to_metric_families(text))
    assert _families(parse_text(text)) == want
    assert len(want) > 60


def test_observes_from_four_threads_while_rendering():
    _, reg = registries(clamp=8)
    n, errors, renders = 5000, [], []
    stop = threading.Event()

    def observer(k: int) -> None:
        try:
            shared = reg.llm_ttft.labels(model="m", replica="0", tenant="shared")
            own = reg.llm_tpot.labels(model="m", replica=str(k), tenant=f"t{k}")
            for i in range(n):
                value = (i % 97) / 100.0
                shared.observe(value, exemplar={"trace_id": f"{k:02x}{i:030x}"})
                own.observe(value)
                reg.http_requests.labels("GET", "/x", "200").inc()
                reg.llm_queue_depth.labels(replica="0").set(i)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    def renderer() -> None:
        while not stop.is_set():
            renders.append(parse_text(reg.render()[0].decode()))
            reg.render(OPENMETRICS)

    threads = [threading.Thread(target=observer, args=(k,)) for k in range(4)]
    render_thread = threading.Thread(target=renderer)
    render_thread.start()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    stop.set()
    render_thread.join()
    assert not errors and renders
    samples = {(s.name, tuple(sorted(s.labels.items()))): s.value
               for f in parse_text(reg.render()[0].decode()) for s in f.samples}
    shared = (("model", "m"), ("replica", "0"), ("tenant", "shared"))
    assert samples[("mcpforge_llm_ttft_seconds_count", shared)] == 4 * n
    assert samples[("mcpforge_llm_ttft_seconds_bucket",
                    tuple(sorted(shared + (("le", "+Inf"),))))] == 4 * n
    assert samples[("mcpforge_llm_ttft_seconds_sum", shared)] == pytest.approx(
        4 * sum((i % 97) / 100.0 for i in range(n)))
    assert samples[("mcpforge_http_requests_total",
                    (("method", "GET"), ("path", "/x"), ("status", "200")))] == 4 * n
    for k in range(4):
        own = (("model", "m"), ("replica", str(k)), ("tenant", f"t{k}"))
        assert samples[("mcpforge_llm_tpot_seconds_count", own)] == n
    # every render taken mid-run saw cumulative buckets that never decrease
    for families in renders:
        for family in families:
            if family.type == "histogram":
                series: dict = {}
                for s in family.samples:
                    if s.name.endswith("_bucket"):
                        key = tuple(sorted((k, v) for k, v in s.labels.items() if k != "le"))
                        series.setdefault(key, []).append(s.value)
                assert all(b == sorted(b) for b in series.values())
