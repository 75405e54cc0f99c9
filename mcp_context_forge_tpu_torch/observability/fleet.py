"""Per-worker metrics aggregation: the fleet's numbers from any worker (a
copy of the JAX package's ``observability/fleet.py``, with a text-format
parser of its own on the standard library in place of
``prometheus_client.parser``).

Each worker of a multi-worker gateway owns one registry, so a scrape of one
worker reports its share of the counters and its own gauges. Here:

- each worker publishes its classic-text exposition on the
  ``fleet.metrics`` bus topic every ``interval_s`` and keeps its peers'
  latest frames, which expire at ``stale_factor`` x the interval;
- ``render_fleet()`` merges the live frames: counter and histogram samples
  SUM across workers, gauges keep each worker's value under an added
  ``worker`` label;
- ``FleetMetricsView`` serves the summed samples through the ``collect()``
  shape the SLO evaluator reads, so ``/admin/slo?scope=fleet`` judges the
  fleet's p95, not one worker's.

On the memory bus there are no peers and the fleet view is the local one.

The frame is the JAX package's (the text exposition, not the ``collect()``
samples), because the port's buses are the JAX package's on the wire: a
fleet part way through moving to the port runs JAX and port workers on one
bus, and each merges the other's frames.
"""

from __future__ import annotations

import asyncio
import logging
import re
import time
from typing import Any, NamedTuple

from .metrics import CONTENT_TYPE_TEXT

logger = logging.getLogger(__name__)

TOPIC = "fleet.metrics"

_SUMMED_TYPES = {"counter", "histogram", "summary"}
_METRIC_TYPES = {"counter", "gauge", "summary", "histogram", "gaugehistogram", "unknown",
                 "info", "stateset"}
_ESCAPE_SEQUENCES = {"\\\\": "\\", "\\n": "\n", '\\"': '"'}
_HELP_ESCAPING = re.compile(r"\\[\\n]")
_ESCAPING = re.compile(r'\\[\\n"]')


class ParsedSample(NamedTuple):
    name: str
    labels: dict[str, str]
    value: float
    timestamp: float | None = None


class ParsedFamily:
    """One family of a parsed exposition (``prometheus_client``'s
    ``Metric`` fields: a counter's name without ``_total``, ``untyped`` as
    ``unknown``)."""

    __slots__ = ("name", "documentation", "type", "samples")

    def __init__(self, name: str, documentation: str, typ: str,
                 samples: list[ParsedSample]) -> None:
        if typ == "untyped":
            typ = "unknown"
        if typ not in _METRIC_TYPES:
            raise ValueError("Invalid metric type: " + typ)
        self.name = name
        self.documentation = documentation
        self.type = typ
        self.samples = samples


def _unescape(text: str, pattern: re.Pattern = _ESCAPING) -> str:
    if "\\" not in text:
        return text
    return pattern.sub(lambda m: _ESCAPE_SEQUENCES[m.group(0)], text)


def _escaped(text: str, pos: int) -> bool:
    """Whether the character at ``pos`` follows an odd run of backslashes."""
    n = 0
    while pos - 1 - n >= 0 and text[pos - 1 - n] == "\\":
        n += 1
    return n % 2 == 1


def _parse_labels(text: str) -> dict[str, str]:
    labels: dict[str, str] = {}
    rest = text.strip()
    while rest:
        if rest[0] == ",":
            rest = rest[1:].strip()
            if not rest:
                break
        name, eq, rest = rest.partition("=")
        name = name.strip()
        rest = rest.lstrip()
        if not eq or not name or not rest.startswith('"'):
            raise ValueError("Invalid labels: " + text)
        end = 1
        while True:
            end = rest.index('"', end)
            if not _escaped(rest, end):
                break
            end += 1
        if name in labels or name.startswith("__"):
            raise ValueError("Invalid labels: " + text)
        labels[name] = _unescape(rest[1:end])
        rest = rest[end + 1:].strip()
        if rest and rest[0] != ",":
            raise ValueError("Invalid labels: " + text)
    return labels


def _parse_value(value: str) -> float:
    if value != value.strip() or "_" in value:
        raise ValueError(f"Invalid value: {value!r}")
    try:
        return int(value)
    except ValueError:
        return float(value)


def _label_end(line: str, start: int) -> int:
    """The closing brace of the label set opened at ``start``, outside
    quotes."""
    quoted = False
    for i in range(start, len(line)):
        c = line[i]
        if c == '"' and not _escaped(line, i):
            quoted = not quoted
        elif c == "}" and not quoted:
            return i
    raise ValueError("Invalid labels: " + line)


def _parse_sample(line: str) -> ParsedSample:
    brace = line.find("{")
    if brace < 0:
        name, _, rest = line.partition(" ") if " " in line else line.partition("\t")
        labels: dict[str, str] = {}
    else:
        name = line[:brace].strip()
        end = _label_end(line, brace + 1)
        labels = _parse_labels(line[brace + 1:end])
        rest = line[end + 1:]
    name = name.strip()
    if not name or not re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$", name):
        raise ValueError("invalid metric name:" + line)
    values = rest.split()
    if not values:
        raise ValueError("missing value: " + line)
    value = _parse_value(values[0])
    timestamp = _parse_value(values[-1]) / 1000 if len(values) > 1 else None
    return ParsedSample(name, labels, value, timestamp)


def _family(name: str, documentation: str, typ: str,
            samples: list[ParsedSample]) -> ParsedFamily:
    if typ == "counter":
        if name.endswith("_total"):
            name = name[:-6]
        else:
            samples = [s._replace(name=s.name + "_total") for s in samples]
    return ParsedFamily(name, documentation, typ, samples)


def parse_text(text: str) -> list[ParsedFamily]:
    """The families of a classic text exposition, as
    ``prometheus_client.parser.text_string_to_metric_families`` reads them
    (``tests/test_torch_metrics.py`` holds the two equal): samples are
    grouped under the family their HELP/TYPE lines opened, and a sample
    whose name the family does not allow is a family of its own."""
    families: list[ParsedFamily] = []
    name, documentation, typ = "", "", "untyped"
    samples: list[ParsedSample] = []
    allowed: list[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue
            candidate = parts[2]
            if parts[1] == "HELP":
                if candidate != name:
                    if name:
                        families.append(_family(name, documentation, typ, samples))
                    name, typ, samples, allowed = candidate, "untyped", [], [candidate]
                documentation = (_unescape(parts[3], _HELP_ESCAPING)
                                 if len(parts) == 4 else "")
            else:
                if len(parts) < 4:
                    raise ValueError("TYPE without a type: " + line)
                if candidate != name:
                    if name:
                        families.append(_family(name, documentation, typ, samples))
                    name, documentation, samples = candidate, "", []
                typ = parts[3]
                allowed = [name + suffix for suffix in {
                    "summary": ("_count", "_sum", ""),
                    "histogram": ("_count", "_sum", "_bucket")}.get(typ, ("",))]
            continue
        sample = _parse_sample(line)
        if sample.name not in allowed:
            if name:
                families.append(_family(name, documentation, typ, samples))
            name, documentation, typ, samples, allowed = "", "", "untyped", [], []
            families.append(_family(sample.name, "", "untyped", [sample]))
        else:
            samples.append(sample)
    if name:
        families.append(_family(name, documentation, typ, samples))
    return families


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels_key(labels: dict[str, str]) -> tuple:
    return tuple(sorted(labels.items()))


def _parse(text: str) -> list:
    try:
        return parse_text(text)
    except Exception:
        logger.debug("fleet metrics: unparseable peer exposition",
                     exc_info=True)
        return []


class FleetMetrics:
    """Bus-published exposition frames + the merged fleet view."""

    def __init__(self, bus: Any, worker_id: str, metrics: Any,
                 interval_s: float = 2.0, stale_factor: float = 3.0) -> None:
        self.bus = bus
        self.worker_id = worker_id
        self.metrics = metrics
        self.interval_s = max(0.05, float(interval_s))
        self.stale_factor = max(1.5, float(stale_factor))
        self._peers: dict[str, tuple[float, str]] = {}
        self._task: asyncio.Task | None = None
        self._unsub = None

    async def start(self) -> None:
        if self._unsub is None:
            self._unsub = self.bus.subscribe(TOPIC, self._on_frame)
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="fleet-metrics-publish")

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
        if self._unsub is not None:
            self._unsub()
            self._unsub = None

    async def _run(self) -> None:
        while True:
            try:
                await self.publish_once()
            except Exception:
                logger.exception("fleet metrics publish failed")
            await asyncio.sleep(self.interval_s)

    async def publish_once(self) -> None:
        body, _ctype = self.metrics.render()
        await self.bus.publish(TOPIC, {
            "worker": self.worker_id, "ts": time.time(),
            "text": body.decode()})

    async def _on_frame(self, topic: str, message: dict[str, Any]) -> None:
        worker = str(message.get("worker", ""))
        if not worker or worker == self.worker_id:
            return
        self._peers[worker] = (float(message.get("ts") or time.time()),
                               str(message.get("text") or ""))

    def live_peers(self) -> dict[str, str]:
        """worker -> exposition text, stale frames pruned."""
        horizon = time.time() - self.interval_s * self.stale_factor
        for worker, (ts, _text) in list(self._peers.items()):
            if ts < horizon:
                del self._peers[worker]
        return {w: text for w, (ts, text) in self._peers.items()}

    # -------------------------------------------------------------- merging

    def _worker_families(self) -> list[tuple[str, list]]:
        local_text = self.metrics.render()[0].decode()
        frames = [(self.worker_id, local_text)]
        frames += sorted(self.live_peers().items())
        return [(worker, _parse(text)) for worker, text in frames]

    def merged_samples(self, family_name: str
                       ) -> tuple[str, list[tuple[str, dict, float]]]:
        """(type, [(sample_name, labels, value)]) for one family summed
        across workers — the SLO evaluator's fleet source."""
        acc: dict[tuple, float] = {}
        order: list[tuple[str, tuple]] = []
        ftype = "counter"
        for _worker, families in self._worker_families():
            for family in families:
                if family.name != family_name:
                    continue
                ftype = family.type
                for sample in family.samples:
                    key = (sample.name, _labels_key(sample.labels))
                    if key not in acc:
                        order.append(key)
                        acc[key] = 0.0
                    acc[key] += sample.value
        return ftype, [(name, dict(labels), acc[(name, labels)])
                       for name, labels in order]

    def render_fleet(self) -> tuple[bytes, str]:
        """Merged classic-text exposition: counters/histograms summed,
        gauges per-worker under an added ``worker`` label."""
        merged: dict[str, dict[str, Any]] = {}
        for worker, families in self._worker_families():
            for family in families:
                entry = merged.setdefault(family.name, {
                    "type": family.type,
                    "documentation": family.documentation,
                    "sums": {}, "order": [], "gauges": []})
                if family.type in _SUMMED_TYPES:
                    for sample in family.samples:
                        key = (sample.name, _labels_key(sample.labels))
                        if key not in entry["sums"]:
                            entry["order"].append(key)
                            entry["sums"][key] = 0.0
                        entry["sums"][key] += sample.value
                else:
                    for sample in family.samples:
                        entry["gauges"].append(
                            (sample.name,
                             {**sample.labels, "worker": worker},
                             sample.value))
        lines: list[str] = []
        for name, entry in merged.items():
            doc = entry["documentation"].replace("\\", r"\\") \
                .replace("\n", r"\n")
            lines.append(f"# HELP {name} {doc}")
            lines.append(f"# TYPE {name} {entry['type']}")
            if entry["type"] in _SUMMED_TYPES:
                samples = [(key[0], dict(key[1]), entry["sums"][key])
                           for key in entry["order"]]
            else:
                samples = entry["gauges"]
            for sname, labels, value in samples:
                if labels:
                    body = ",".join(
                        f'{k}="{_escape(str(v))}"'
                        for k, v in sorted(labels.items()))
                    lines.append(f"{sname}{{{body}}} {value}")
                else:
                    lines.append(f"{sname} {value}")
        return ("\n".join(lines) + "\n").encode(), CONTENT_TYPE_TEXT

    def stats(self) -> dict[str, Any]:
        return {"worker_id": self.worker_id,
                "peers": sorted(self.live_peers()),
                "interval_s": self.interval_s}


class _Sample:
    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict, value: float) -> None:
        self.name = name
        self.labels = labels
        self.value = value


class _MergedFamily:
    def __init__(self, samples: list[_Sample]) -> None:
        self.samples = samples


class _MergedMetric:
    """collect() duck-type over the fleet-summed samples of one metric."""

    def __init__(self, aggregator: FleetMetrics, family_name: str) -> None:
        self._aggregator = aggregator
        self._family_name = family_name

    def collect(self):
        _type, samples = self._aggregator.merged_samples(self._family_name)
        return [_MergedFamily([_Sample(n, l, v) for n, l, v in samples])]


class FleetMetricsView:
    """PrometheusRegistry facade whose histogram attributes read the
    fleet-summed samples — handed to a second SloEvaluator for
    ``/admin/slo?scope=fleet``."""

    def __init__(self, local_metrics: Any, aggregator: FleetMetrics) -> None:
        self._local = local_metrics
        self._aggregator = aggregator

    def __getattr__(self, attr: str) -> Any:
        metric = getattr(self._local, attr)
        name = getattr(metric, "_name", None)
        if name is None:
            return metric
        return _MergedMetric(self._aggregator, name)
