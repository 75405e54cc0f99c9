"""The metrics registry on the standard library (the JAX package's
``observability/metrics.py``, which is built on ``prometheus_client``,
a package the card does not have).

``Counter``, ``Gauge`` and ``Histogram`` are the part of
``prometheus_client``'s API that the port's call sites and ``slo.py``
use: ``labels(*values, **labels)`` (a ``ValueError`` on wrong names or a
wrong count), ``inc``, ``set``, ``observe(value, exemplar=None)``
and ``collect()``, whose families carry samples with ``name``, ``labels``,
``value`` and ``exemplar`` under prometheus's sample names (``_total``,
``_created``, ``_bucket``, ``_count``, ``_sum``). Families render in
registration order, their children in order of first use. Each child
updates under its own lock: an engine's dispatch thread observes while the
event loop renders. ``_created`` is this process's ``time.time()`` when the
child was made.

``PrometheusRegistry`` registers every family of the JAX registry under the
same name, help text, label names and buckets. ``render(accept)`` writes
the classic text format, or OpenMetrics 1.0.0 (exemplars on bucket lines,
``# EOF``) when ``accept`` names ``application/openmetrics-text``, byte for
byte as ``prometheus_client``'s ``generate_latest`` of the same
observations (``tests/test_torch_metrics.py``), with the same content
types.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Any, Iterable, NamedTuple

from .. import __version__
from .tenant import TenantClamp
from .trace_store import ExemplarLedger

CONTENT_TYPE_TEXT = "text/plain; version=1.0.0; charset=utf-8"
CONTENT_TYPE_OPENMETRICS = "application/openmetrics-text; version=1.0.0; charset=utf-8"
INF = float("inf")

def float_to_go_string(d: float) -> str:
    """A float as Go's exposition writes it (prometheus_client's
    ``floatToGoString``): ``+Inf``, ``-Inf``, ``NaN``, else Python's repr,
    with an exponent once a positive value has more than six digits before
    the point (``1e+06``)."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape(value: str) -> str:
    """A label value (and an OpenMetrics HELP text): backslash, newline and
    double quote escaped."""
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _check_exemplar(exemplar: dict[str, str]) -> None:
    """prometheus_client's rules: no reserved (``__``) key, and at most 128
    characters of keys and values together."""
    runes = 0
    for key, value in exemplar.items():
        if key.startswith("__"):
            raise ValueError("Reserved label metric name: " + key)
        runes += len(key) + len(value)
    if runes > 128:
        # prometheus_client's message, its unfilled %d included
        raise ValueError("Exemplar labels have %d UTF-8 characters, exceeding the limit of 128")


class Exemplar(NamedTuple):
    labels: dict[str, str]
    value: float
    timestamp: float | None = None


class Sample(NamedTuple):
    name: str
    labels: dict[str, str]
    value: float
    timestamp: float | None = None
    exemplar: Exemplar | None = None


class MetricFamily:
    """One family of ``collect()``: its samples in exposition order."""

    __slots__ = ("name", "documentation", "type", "samples")

    def __init__(self, name: str, documentation: str, typ: str,
                 samples: list[Sample]) -> None:
        self.name = name
        self.documentation = documentation
        self.type = typ
        self.samples = samples


# --------------------------------------------------------------- children

class _CounterChild:
    __slots__ = ("_lock", "_value", "_exemplar", "_created")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0
        self._exemplar: Exemplar | None = None
        self._created = time.time()

    def inc(self, amount: float = 1, exemplar: dict[str, str] | None = None) -> None:
        if amount < 0:
            raise ValueError("Counters can only be incremented by non-negative amounts.")
        if exemplar:
            _check_exemplar(exemplar)
            stamped = Exemplar(exemplar, amount, time.time())
        with self._lock:
            self._value += amount
            if exemplar:
                self._exemplar = stamped

    def _samples(self) -> list[tuple]:
        with self._lock:
            return [("_total", {}, self._value, self._exemplar),
                    ("_created", {}, self._created, None)]


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._value = value

    def _samples(self) -> list[tuple]:
        with self._lock:
            return [("", {}, self._value, None)]


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_les", "_counts", "_exemplars", "_sum", "_created")

    def __init__(self, bounds: list[float], les: list[str]) -> None:
        self._lock = threading.Lock()
        self._bounds = bounds
        self._les = les
        self._counts = [0.0] * len(bounds)
        self._exemplars: list[Exemplar | None] = [None] * len(bounds)
        self._sum = 0.0
        self._created = time.time()

    def observe(self, amount: float, exemplar: dict[str, str] | None = None) -> None:
        if exemplar:
            _check_exemplar(exemplar)
        # the first bucket whose bound is >= amount; a NaN lands in none
        i = bisect.bisect_left(self._bounds, amount) if amount == amount else len(self._bounds)
        with self._lock:
            self._sum += amount
            if i < len(self._bounds):
                self._counts[i] += 1
                if exemplar:
                    self._exemplars[i] = Exemplar(exemplar, amount, time.time())

    def _samples(self) -> list[tuple]:
        with self._lock:
            counts, exemplars = list(self._counts), list(self._exemplars)
            total, created = self._sum, self._created
        out = []
        acc = 0.0
        for le, count, exemplar in zip(self._les, counts, exemplars):
            acc += count
            out.append(("_bucket", {"le": le}, acc, exemplar))
        out.append(("_count", {}, acc, None))
        if self._bounds[0] >= 0:
            out.append(("_sum", {}, total, None))
        out.append(("_created", {}, created, None))
        return out


# --------------------------------------------------------------- families

class _Family:
    """A metric family: one child per label-value tuple (or one child of
    its own when it has no labels)."""

    _type = ""

    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: "CollectorRegistry | None" = None) -> None:
        if self._type == "counter" and name.endswith("_total"):
            name = name[:-6]
        self._name = name
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], Any] = {}
        self._own = None if self._labelnames else self._new_child()
        if registry is not None:
            registry.register(self)

    def __str__(self) -> str:
        return f"{self._type}:{self._name}"

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *labelvalues: Any, **labelkwargs: Any):
        """The child of these label values (made at first use), with
        prometheus_client's refusals."""
        if not self._labelnames:
            raise ValueError(f"No label names were set when constructing {self}")
        if labelvalues and labelkwargs:
            raise ValueError("Can't pass both *args and **kwargs")
        if labelkwargs:
            if sorted(labelkwargs) != sorted(self._labelnames):
                raise ValueError("Incorrect label names")
            values = tuple(str(labelkwargs[name]) for name in self._labelnames)
        else:
            if len(labelvalues) != len(self._labelnames):
                raise ValueError("Incorrect label count")
            values = tuple(str(value) for value in labelvalues)
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.get(values)
                if child is None:
                    child = self._children[values] = self._new_child()
        return child

    def _one(self):
        """The child of a family without labels."""
        if self._own is None:
            raise ValueError(f"{self._type} metric is missing label values")
        return self._own

    def collect(self) -> list[MetricFamily]:
        if self._own is not None:
            children = [((), self._own)]
        else:
            with self._lock:
                children = list(self._children.items())
        samples = []
        for values, child in children:
            series = list(zip(self._labelnames, values))
            for suffix, labels, value, exemplar in child._samples():
                samples.append(Sample(self._name + suffix, dict(series + list(labels.items())),
                                      value, None, exemplar))
        return [MetricFamily(self._name, self._documentation, self._type, samples)]


class Counter(_Family):
    _type = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1, exemplar: dict[str, str] | None = None) -> None:
        self._one().inc(amount, exemplar)


class Gauge(_Family):
    _type = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._one().set(value)


class Histogram(_Family):
    _type = "histogram"

    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: "CollectorRegistry | None" = None, *,
                 buckets: Iterable[float]) -> None:
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if bounds and bounds[-1] != INF:
            bounds.append(INF)
        if len(bounds) < 2:
            raise ValueError("Must have at least two buckets")
        self._upper_bounds = bounds
        self._les = [float_to_go_string(b) for b in bounds]
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self._upper_bounds, self._les)

    def observe(self, amount: float, exemplar: dict[str, str] | None = None) -> None:
        self._one().observe(amount, exemplar)


class CollectorRegistry:
    """The families of one registry, in registration order (all registered
    at construction, before any other thread reads them)."""

    def __init__(self) -> None:
        self._families: list[_Family] = []

    def register(self, family: _Family) -> None:
        self._families.append(family)

    def collect(self) -> Iterable[MetricFamily]:
        for family in self._families:
            yield from family.collect()


# ---------------------------------------------------------------- renders

def _label_text(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())) + "}"


def generate_text(registry: CollectorRegistry) -> bytes:
    """The classic text format: a counter's family is named with
    ``_total``, and each family's ``_created`` samples follow it as a gauge
    family of their own."""
    out: list[str] = []
    for family in registry.collect():
        name = family.name + "_total" if family.type == "counter" else family.name
        doc = family.documentation.replace("\\", r"\\").replace("\n", r"\n")
        out.append(f"# HELP {name} {doc}\n")
        out.append(f"# TYPE {name} {family.type}\n")
        created: list[str] = []
        for s in family.samples:
            line = f"{s.name}{_label_text(s.labels)} {float_to_go_string(s.value)}\n"
            (created if s.name == family.name + "_created" else out).append(line)
        if created:
            out.append(f"# HELP {family.name}_created {doc}\n")
            out.append(f"# TYPE {family.name}_created gauge\n")
            out.extend(created)
    return "".join(out).encode("utf-8")


def generate_openmetrics(registry: CollectorRegistry) -> bytes:
    """OpenMetrics 1.0.0: counters keep their bare family name over
    ``_total``/``_created`` samples, exemplars follow their sample, and the
    exposition ends with ``# EOF``."""
    out: list[str] = []
    for family in registry.collect():
        out.append(f"# HELP {family.name} {_escape(family.documentation)}\n")
        out.append(f"# TYPE {family.name} {family.type}\n")
        for s in family.samples:
            exemplar = ""
            if s.exemplar is not None:
                ex = s.exemplar
                exemplar = f" # {_label_text(ex.labels) or '{}'} {float_to_go_string(ex.value)}"
                if ex.timestamp is not None:
                    exemplar += f" {ex.timestamp}"
            out.append(f"{s.name}{_label_text(s.labels)} {float_to_go_string(s.value)}"
                       f"{exemplar}\n")
    out.append("# EOF\n")
    return "".join(out).encode("utf-8")


class PrometheusRegistry:
    """The gateway's metrics, in a registry of their own (hermetic for
    tests), under the JAX registry's names.

    ``tenant_clamp`` bounds every ``tenant`` label in this registry: the
    first N tenants observed keep a label child of their own, the rest
    clamp to ``"other"``. The app shares ONE clamp between the registry
    and the ``TenantLedger``, so that metric labels and ledger admission
    agree."""

    def __init__(self, tenant_clamp: TenantClamp | None = None,
                 exemplars: ExemplarLedger | None = None) -> None:
        self.registry = CollectorRegistry()
        self.tenant_clamp = tenant_clamp or TenantClamp()
        # per-bucket trace-id exemplars of the latency histograms
        # (observability/trace_store.py): observe sites call
        # self.exemplar(...) and pass the result to observe(), and the
        # trace store keeps every live exemplar's trace, so that the
        # OpenMetrics click-through never dangles
        self.exemplars = exemplars if exemplars is not None \
            else ExemplarLedger()
        self.app_info = Gauge(
            "mcpforge_app_info", "Application info", ["version"], registry=self.registry
        )
        self.app_info.labels(version=__version__).set(1)
        self.http_requests = Counter(
            "mcpforge_http_requests_total", "HTTP requests",
            ["method", "path", "status"], registry=self.registry,
        )
        # tenant label (clamped): the per-tenant http_p95 SLO-class
        # objective slices this histogram by label child
        self.http_duration = Histogram(
            "mcpforge_http_request_duration_seconds", "HTTP request latency",
            ["method", "path", "tenant"], registry=self.registry,
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
        )
        self.tool_invocations = Counter(
            "mcpforge_tool_invocations_total", "Tool invocations",
            ["tool", "status"], registry=self.registry,
        )
        self.tool_duration = Histogram(
            "mcpforge_tool_invocation_duration_seconds", "Tool invocation latency",
            ["tool"], registry=self.registry,
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
        )
        self.plugin_duration = Histogram(
            "mcpforge_plugin_hook_duration_seconds", "Plugin hook latency",
            ["plugin", "hook"], registry=self.registry,
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
        )
        self.llm_tokens = Counter(
            "mcpforge_llm_tokens_total", "LLM tokens processed by tpu_local",
            ["model", "kind"], registry=self.registry,  # kind: prompt|completion
        )
        self.llm_requests = Counter(
            "mcpforge_llm_requests_total", "LLM requests", ["model", "status"],
            registry=self.registry,
        )
        # every engine-fed GAUGE carries a replica label: gauges are
        # last-writer-wins, so N replicas' dispatch threads writing one
        # unlabeled series would flap between replicas' values (counters
        # and histograms aggregate correctly unlabeled and keep only the
        # labels their queries need)
        self.llm_queue_depth = Gauge(
            "mcpforge_llm_queue_depth", "tpu_local scheduler queue depth",
            ["replica"], registry=self.registry,
        )
        self.llm_kv_pages_in_use = Gauge(
            "mcpforge_llm_kv_pages_in_use", "Paged KV cache pages in use",
            ["replica"], registry=self.registry,
        )
        # dtype-aware twin of the page-count gauge: pages x page bytes
        # under the active KV storage dtype (int8 pages cost ~half their
        # bf16 twin), so mixed-mode fleets compare on one byte axis.
        # Replica-labeled: under an EnginePool each replica owns its own
        # KV pool, and a per-replica byte view is what capacity planning
        # and the drain decision read.
        self.llm_kv_bytes_in_use = Gauge(
            "mcpforge_llm_kv_bytes_in_use",
            "HBM bytes the in-use KV pages occupy under the active KV dtype",
            ["replica"], registry=self.registry,
        )
        # token-level SLO signals (fed by the engine dispatch thread):
        # TTFT = submit -> first token (queue + prefill), TPOT = mean
        # inter-token latency over the decode phase of one request.
        # The replica label separates a degraded replica's tail from the
        # pool aggregate (sum across label children for the fleet view).
        # the tenant label (clamped to top-N + "other" by tenant_clamp)
        # turns these into the per-tenant SLO-class evidence /admin/slo
        # evaluates — a noisy neighbor's tail separates from the fleet's
        self.llm_ttft = Histogram(
            "mcpforge_llm_ttft_seconds", "Time to first token",
            ["model", "replica", "tenant"], registry=self.registry,
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0),
        )
        self.llm_tpot = Histogram(
            "mcpforge_llm_tpot_seconds",
            "Per-token decode latency (mean over one request)",
            ["model", "replica", "tenant"], registry=self.registry,
            buckets=(0.002, 0.005, 0.01, 0.02, 0.04, 0.08, 0.15, 0.3,
                     0.6, 1.2, 2.5),
        )
        self.llm_queue_wait = Histogram(
            "mcpforge_llm_queue_wait_seconds",
            "Submit -> batch admission wait", ["tenant"],
            registry=self.registry,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0,
                     60.0),
        )
        self.llm_batch_occupancy = Gauge(
            "mcpforge_llm_batch_occupancy",
            "Active decode slots at the last engine step",
            ["replica"], registry=self.registry,
        )
        self.llm_kv_page_utilization = Gauge(
            "mcpforge_llm_kv_page_utilization",
            "Fraction of the paged KV pool in use (0..1)",
            ["replica"], registry=self.registry,
        )
        self.llm_kv_alloc_failures = Counter(
            "mcpforge_llm_kv_alloc_failures_total",
            "Admissions deferred or requests truncated for lack of KV pages",
            registry=self.registry,
        )
        # --- tiered prefix/KV cache (tpu_local/kv/tiers.py,
        # docs/kv_tiering.md) --- per-tier split of the prefix-cache hit
        # stream (hbm = resident pages, host/disk = pages restored from a
        # spill tier at admission); counted at the same consume site as
        # allocator.prefix_hit_tokens, so summing tiers reproduces it
        self.llm_prefix_tier_hits = Counter(
            "mcpforge_llm_prefix_tier_hits_total",
            "Prefix-cache page hits by serving tier (hbm = resident, "
            "host/disk = restored on match from a spill tier)",
            ["replica", "tier"], registry=self.registry,
        )
        # bytes resident per tier: hbm is per-replica (registered prefix
        # pages x page bytes); host/disk report the POOL-SHARED store, so
        # every replica's child carries the same value — read one child,
        # never sum across replicas for the shared tiers
        self.llm_prefix_tier_bytes = Gauge(
            "mcpforge_llm_prefix_tier_bytes",
            "Bytes resident in each prefix-cache tier (hbm per replica; "
            "host/disk are the pool-shared spill store)",
            ["replica", "tier"], registry=self.registry,
        )
        # spill/restore dataflow latency: spill = device->host page read
        # + T1 admit at eviction, restore = verified fetch + host->device
        # upload at match, writeback = the worker's T1->T2 persist
        self.llm_prefix_tier_io = Histogram(
            "mcpforge_llm_prefix_tier_io_seconds",
            "Tiered prefix-cache page movement latency by operation "
            "(spill, restore, writeback) and tier touched",
            ["op", "tier"], registry=self.registry,
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                     0.025, 0.05, 0.1, 0.25, 1.0),
        )
        # spill-tier IO failure accounting (tiers.py disk hardening):
        # transient errors retry with bounded backoff, then the entry is
        # quarantined (clean MISS, never a hang or a poisoned serve) —
        # this counter is the evidence trail per (tier, op)
        self.llm_prefix_tier_io_errors = Counter(
            "mcpforge_llm_prefix_tier_io_errors_total",
            "Tiered prefix-cache IO failures after retries, by tier and "
            "operation (the entry is quarantined — dropped to a clean "
            "MISS, counted here)",
            ["tier", "op"], registry=self.registry,
        )
        # cross-host prefix-cache fabric (tpu_local/kv/fabric/,
        # docs/cache_fabric.md): advert gossip volume — "sent" counts
        # pushes this host delivered to a peer (bus or HTTP), "merged"
        # counts NEW chain hashes learned from peers (refreshes of
        # already-known hashes don't count)
        self.llm_fabric_adverts = Counter(
            "mcpforge_llm_fabric_adverts_total",
            "Prefix-fabric advert gossip by direction (sent = pushes "
            "delivered to peers, merged = new chain hashes learned)",
            ["direction"], registry=self.registry,
        )
        self.llm_step_tokens_per_sec = Gauge(
            "mcpforge_llm_step_tokens_per_sec",
            "Tokens emitted per second by the last engine step (over the "
            "true retire-to-retire step wall, so superstep K>1 and the "
            "overlap pipeline both report truthfully)",
            ["replica"], registry=self.registry,
        )
        # K-step super-step accounting: tokens retired per device
        # dispatch (≈ batch × superstep at steady state). One host sync
        # retires this many tokens — the token-loop-fusion win is this
        # gauge rising while dispatch-gap stays flat
        self.llm_tokens_per_dispatch = Gauge(
            "mcpforge_llm_tokens_per_dispatch",
            "Tokens emitted by the last decode dispatch (superstep K>1 "
            "retires up to K per slot per host sync)",
            ["replica"], registry=self.registry,
        )
        # smoothed twin of the instantaneous gauge: a single dispatch's
        # token count whipsaws with batch occupancy, so alerts and the
        # serving controller act on this EWMA instead
        self.llm_tokens_per_dispatch_ewma = Gauge(
            "mcpforge_llm_tokens_per_dispatch_ewma",
            "EWMA of tokens per decode dispatch (alpha 0.2; the smoothed "
            "form the serving controller and alerts consume)",
            ["replica"], registry=self.registry,
        )
        # overlapped-decode health: the gap histogram is the host-side
        # stall between device dispatches (the thing the pipeline hides —
        # collapses to ~0 when overlap is on), and the idle fraction is
        # gaps / (gaps + in-step wall) over the recent decode window
        self.llm_dispatch_gap = Histogram(
            "mcpforge_llm_dispatch_gap_seconds",
            "Host-side stall between consecutive decode dispatches",
            ["replica"], registry=self.registry,
            buckets=(0.00001, 0.00005, 0.0001, 0.00025, 0.0005, 0.001,
                     0.0025, 0.005, 0.01, 0.025, 0.05, 0.1),
        )
        self.llm_device_idle_frac = Gauge(
            "mcpforge_llm_device_idle_fraction",
            "Fraction of recent decode wall time the device waited on host "
            "bookkeeping (0..1; ~0 with the overlapped pipeline)",
            ["replica"], registry=self.registry,
        )
        # decode-step phase attribution (opt-in sampling via
        # tpu_local_step_sample_every): how a sampled step's wall splits
        # between host dispatch, block-table sync, device compute,
        # read-back, and emission bookkeeping — the "where do the 87 ms
        # go" histogram the roofline gap analysis needs
        self.llm_step_phase = Histogram(
            "mcpforge_llm_step_phase_seconds",
            "Sampled decode-step phase durations (host_dispatch, "
            "table_sync, device_compute, readback, emit)",
            ["replica", "phase"], registry=self.registry,
            buckets=(0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025,
                     0.005, 0.01, 0.025, 0.05, 0.1, 0.25),
        )
        # live roofline gauges: warmup-captured XLA cost_analysis()
        # (FLOPs / bytes accessed per executable) divided by each decode
        # step's measured wall — the bench-only MFU / hbm_roofline_frac
        # numbers as always-on production signals (tpu_local/roofline.py)
        self.llm_mfu = Gauge(
            "mcpforge_llm_mfu",
            "Model FLOPs utilization of the last decode step (XLA "
            "cost-model FLOPs / wall / peak)",
            ["replica"], registry=self.registry,
        )
        self.llm_hbm_roofline = Gauge(
            "mcpforge_llm_hbm_roofline_frac",
            "Fraction of the HBM-bandwidth roofline the last decode step "
            "achieved (XLA cost-model bytes / wall / peak BW)",
            ["replica"], registry=self.registry,
        )
        # compile tracking (tpu_local/compile_events.py): on the port a
        # kernel build or graph capture at stage="serving" on a warmed
        # engine is a stall a request paid for — alert on it
        self.llm_xla_compiles = Counter(
            "mcpforge_llm_xla_compiles_total",
            "XLA backend compilations attributed to the engine, by "
            "lifecycle stage (warmup|serving)",
            ["replica", "stage"], registry=self.registry,
        )
        self.llm_xla_compile_time = Histogram(
            "mcpforge_llm_xla_compile_seconds",
            "Duration of XLA backend compilations attributed to the engine",
            ["replica"], registry=self.registry,
            buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 180.0),
        )
        # EnginePool (tpu_local/pool/) serving tier: per-replica health,
        # load, and routing outcomes — fed by the pool router/health
        # monitor on the gateway loop
        self.llm_pool_replica_up = Gauge(
            "mcpforge_llm_pool_replica_up",
            "1 while the replica is routable (ready), 0 otherwise",
            ["replica"], registry=self.registry,
        )
        self.llm_pool_outstanding = Gauge(
            "mcpforge_llm_pool_outstanding_requests",
            "In-flight requests the pool has routed to the replica",
            ["replica"], registry=self.registry,
        )
        self.llm_pool_routed = Counter(
            "mcpforge_llm_pool_routed_total",
            "Requests routed to the replica (affinity: prefix-cache hit "
            "steered the choice)",
            ["replica", "affinity"], registry=self.registry,
        )
        self.llm_pool_requeues = Counter(
            "mcpforge_llm_pool_requeues_total",
            "In-flight requests requeued off a failed replica onto a "
            "healthy one",
            ["replica"], registry=self.registry,
        )
        self.llm_pool_reloads = Counter(
            "mcpforge_llm_pool_reloads_total",
            "Rolling drain->swap->readmit reloads completed per replica",
            ["replica"], registry=self.registry,
        )
        # disaggregated prefill/decode serving (docs/disaggregation.md):
        # KV-page migration hops between role-specialized replicas
        self.llm_pool_migrations = Counter(
            "mcpforge_llm_pool_migrations_total",
            "Prefill->decode KV-page migration hops (outcome: ok = decode "
            "continued on the target, degraded = decode-in-place fallback)",
            ["from", "to", "outcome"], registry=self.registry,
        )
        self.llm_pool_migration_seconds = Histogram(
            "mcpforge_llm_pool_migration_seconds",
            "Wall time of one KV-page migration hop (export + verify + "
            "re-dispatch)",
            registry=self.registry,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
        )
        self.llm_pool_migration_pages = Counter(
            "mcpforge_llm_pool_migration_pages_total",
            "KV pages moved by migration per stage (spilled off the "
            "prefill replica, restored toward the decode target, degraded "
            "= served in place after a failed hop)",
            ["stage"], registry=self.registry,
        )
        self.llm_pool_migration_bytes = Counter(
            "mcpforge_llm_pool_migration_bytes_total",
            "Serialized KV bytes verified through the tier store during "
            "migration hops",
            registry=self.registry,
        )
        self.llm_providers_wired = Gauge(
            "mcpforge_llm_providers_wired",
            "External LLM providers currently wired into the registry",
            registry=self.registry,
        )
        # --- gateway data-plane flight recorder (gateway/flight_recorder.py,
        # docs/observability.md "Gateway flight recorder & loop health") ---
        # per-request wall time split into attributed phases (edge
        # middleware pre-work, authn, plugin pipeline, db, engine
        # handoff, serialization, handler residue, error residue) — the
        # gateway twin of mcpforge_llm_step_phase_seconds
        self.gw_request_phase = Histogram(
            "mcpforge_gw_request_phase_seconds",
            "Gateway request wall time attributed to a phase "
            "(edge, auth, plugins, routing, db, engine, serialize, "
            "handler, error)",
            ["route", "phase", "tenant"], registry=self.registry,
            buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                     0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
        )
        # slow requests past gw_slow_request_ms — the counter twin of the
        # phase-vector warning log line
        self.gw_slow_requests = Counter(
            "mcpforge_gw_slow_requests_total",
            "Requests slower than the configured gw_slow_request_ms "
            "threshold (each also logs its phase vector)",
            ["route"], registry=self.registry,
        )
        # event-loop health: how late the loop ran a timer that asked
        # for gw_loop_lag_interval_s — sustained mass in the upper
        # buckets means a callback is blocking the loop (the runtime
        # complement of mcpforge-lint's static async-blocking rule).
        # Per-worker by construction: each process owns its registry.
        self.gw_loop_lag = Histogram(
            "mcpforge_gw_loop_lag_seconds",
            "Scheduled-callback delta of the gateway event loop "
            "(per worker; lag = blocked-loop time)",
            registry=self.registry,
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0),
        )
        # engine/pool admission saturation (0..1) as seen by the HTTP
        # tier — the value behind the X-Queue-Depth / Retry-After
        # backpressure headers
        self.gw_engine_saturation = Gauge(
            "mcpforge_gw_engine_saturation",
            "Engine admission-queue saturation the gateway last surfaced "
            "to clients (queued work / admission capacity, 0..1)",
            registry=self.registry,
        )
        # --- per-tenant usage metering (observability/metering.py,
        # docs/multitenancy.md) --- exported views of the TenantLedger;
        # every tenant label below rides the registry's clamp, so the
        # child set is bounded at tenant_label_clamp + 1 ("other")
        self.llm_tenant_tokens = Counter(
            "mcpforge_llm_tenant_tokens_total",
            "Tokens accounted to a tenant by the metering ledger "
            "(kind: prompt|generated|cache_hit; cache_hit = prefill "
            "tokens served from shared prefix-cache pages)",
            ["tenant", "kind"], registry=self.registry,
        )
        self.llm_tenant_kv_page_seconds = Counter(
            "mcpforge_llm_tenant_kv_page_seconds_total",
            "KV-page-seconds of HBM residency accounted to a tenant "
            "(pages held x seconds resident, summed at request retire)",
            ["tenant"], registry=self.registry,
        )
        self.gw_tenant_quota_used_ratio = Gauge(
            "mcpforge_gw_tenant_quota_used_ratio",
            "Fraction of the per-tenant token quota consumed in the "
            "current rollup window (0 when no quota is configured) — "
            "the admission signal the distributed rate limiter reads",
            ["tenant"], registry=self.registry,
        )
        # --- fault-injection plane + degradation ladder
        # (observability/faults.py, observability/degradation.py,
        # docs/resilience.md) ---
        # every fault an armed rule injected, by point and kind — the
        # chaos matrix gates on "the fault actually fired" so a scenario
        # whose fault never armed cannot pass vacuously
        self.faults_injected = Counter(
            "mcpforge_faults_injected_total",
            "Faults injected by the fault plane, by fault point and kind "
            "(error, latency, corrupt); only counts when "
            "fault_injection_enabled is set and a rule fired",
            ["point", "kind"], registry=self.registry,
        )
        # per-component breaker state: 0 closed (healthy), 1 half-open
        # (probing recovery), 2 open (degraded path active). Components:
        # tier.disk, federation (worst peer), ledger.rollup, llm.overload
        self.degradation_state = Gauge(
            "mcpforge_degradation_state",
            "Degradation-ladder state per component (0=closed, "
            "1=half_open, 2=open); multi-member components report their "
            "worst member",
            ["component"], registry=self.registry,
        )
        # admission-time load shedding on the LLM surface: 429 +
        # Retry-After, lowest SLO class first (docs/resilience.md)
        self.gw_requests_shed = Counter(
            "mcpforge_gw_requests_shed_total",
            "LLM-surface requests shed with 429 + Retry-After, by the "
            "tenant's SLO class and cause (overload = saturation past "
            "the class's shed bar, quota = tenant window exhausted)",
            ["slo_class", "reason"], registry=self.registry,
        )
        # --- multi-worker scale-out (docs/scaleout.md) ---
        # cross-worker session handoff outcomes: an SSE stream or elicit
        # request landing on a non-owning worker is relayed to the owner
        # over the bus RPC seam (kind: stream|elicit); stream_lost
        # counts relays terminated because the OWNING worker died
        # mid-stream (clean EOF to the client, loss counted — never a
        # hang), refused counts the 409 fallback when no owner answers
        self.gw_session_handoffs = Counter(
            "mcpforge_gw_session_handoffs_total",
            "Cross-worker session handoffs by outcome (stream / elicit "
            "served via the owning worker; stream_lost = owner died "
            "mid-relay; refused = the 409 fallback)",
            ["kind"], registry=self.registry,
        )
        self.sessions_active = Gauge(
            "mcpforge_sessions_active", "Active MCP sessions", registry=self.registry,
        )
        self.client_disconnects = Counter(
            "mcpforge_client_disconnects_total",
            "Requests whose client went away mid-flight",
            registry=self.registry,
        )
        # --- OTLP export health (observability/otlp.py): a collector
        # outage used to log at debug and silently drop the batch; the
        # exporter now retries with backoff and accounts every span's
        # fate here, so "traces stopped arriving" is a dashboard fact
        # rather than a grep through debug logs
        self.otel_spans_exported = Counter(
            "mcpforge_otel_spans_exported_total",
            "Spans successfully delivered to the OTLP collector",
            registry=self.registry,
        )
        self.otel_spans_dropped = Counter(
            "mcpforge_otel_spans_dropped_total",
            "Spans dropped by the OTLP exporter, by cause (buffer_full, "
            "rejected = collector 4xx, retry_exhausted, shutdown = "
            "undeliverable at process exit)",
            ["reason"], registry=self.registry,
        )
        # --- closed-loop serving controller (tpu_local/controller.py,
        # docs/controller.md) --- every knob move is a counted, labeled
        # event; the knob gauges mirror the CURRENT actuated posture so
        # a dashboard can overlay knob position on the signals that
        # drove it
        self.controller_decisions = Counter(
            "mcpforge_controller_decisions_total",
            "Serving-controller knob decisions, by knob (superstep, "
            "width_floor, spec, shed_bar) and direction (up, down, on, "
            "off, hold_rejected = the engine refused the staged value)",
            ["knob", "direction"], registry=self.registry,
        )
        self.controller_knob = Gauge(
            "mcpforge_controller_knob",
            "Current serving-knob posture per replica (superstep = "
            "active K, width_floor = decode width floor, spec = 0/1, "
            "shed_bar = OverloadShedder shed_at; gateway-scope knobs "
            "use replica '-')",
            ["knob", "replica"], registry=self.registry,
        )
        # exemplar bucket registration: the ledger places an observed
        # value into its bucket without re-deriving prometheus internals
        # (docs/observability.md "Request forensics & exemplars")
        for attr in ("llm_ttft", "llm_tpot", "llm_queue_wait",
                     "http_duration"):
            metric = getattr(self, attr)
            self.exemplars.register(attr, metric._upper_bounds)


    def families(self) -> dict[str, _Family]:
        """Attribute name -> family, in registration order."""
        return {name: value for name, value in vars(self).items()
                if isinstance(value, _Family)}

    def exemplar(self, metric: str, value: float, trace_id: str | None,
                 labels: tuple = ()) -> dict[str, str] | None:
        """The exemplar dict for ``observe(value, exemplar=)``: None when
        exemplars are off or the request has no trace. It also pins
        ``trace_id`` in the trace store's retention set through the shared
        ``ExemplarLedger``. ``labels`` must be the label values the child
        was selected with: exemplars are kept per child, so a label-blind
        cell would let tenant B's observe unpin tenant A's trace while A's
        bucket line still prints it. Errors never reach the observe
        site."""
        try:
            return self.exemplars.note(metric, value, trace_id, labels)
        except Exception:
            return None

    def render(self, accept: str = "") -> tuple[bytes, str]:
        """Exposition bytes and content type. A scraper that negotiates
        OpenMetrics (``Accept: application/openmetrics-text``) gets the
        exemplar-bearing format; everyone else the classic text format,
        where exemplars are not legal."""
        if "application/openmetrics-text" in (accept or ""):
            return generate_openmetrics(self.registry), CONTENT_TYPE_OPENMETRICS
        return generate_text(self.registry), CONTENT_TYPE_TEXT
