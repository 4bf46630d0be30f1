"""Labeled metrics registry: counters, gauges, fixed-bucket histograms.

One ``MetricsRegistry`` is the scrapeable telemetry surface for a whole
coordinator (pipeline, cell, or cluster): every layer emits into it, and
the registry serializes three ways —

  * ``snapshot()``       — a plain, JSON-able dict (what benchmarks dump
                           next to their ``BENCH_*.json`` numbers),
  * ``to_json()``        — the snapshot as deterministic JSON text,
  * ``to_prometheus()``  — Prometheus text exposition format (what a
                           future HTTP ``/metrics`` endpoint serves
                           verbatim; see docs/observability.md).

The three agree exactly: ``MetricsRegistry.from_json(reg.to_json())``
rebuilds a registry whose ``to_prometheus()`` output is byte-identical
to the original's (tested).

Design constraints, all driven by the chaos suite:

  * **injectable clock** — the registry's clock (and everything timed
    against it) is a constructor argument, so seeded fault schedules
    produce byte-identical snapshots run over run.
  * **per-registry isolation** — there is no process-global default
    registry; tests can never share counter state by accident.
  * **determinism** — snapshots sort families by name and series by
    label values, so equal histories serialize equally.

Metric families are created idempotently: asking for an existing
``(name)`` with the same kind/labels returns the same family; asking
with a different kind or label set raises (one name, one schema).
"""
from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "histogram_quantile",
]

# Latency-shaped default bounds (seconds): 100us .. 10s, roughly 2.5x apart.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt(v: float) -> str:
    """Prometheus-style number rendering: integral values drop the '.0'."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Counter:
    """A monotonically increasing value (one labeled series)."""

    __slots__ = ("_value", "_lock")

    def __init__(self, lock: threading.Lock):
        self._value = 0.0
        self._lock = lock

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (must be >= 0) to the counter."""
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """The current cumulative value."""
        return self._value


class Gauge:
    """A value that can go up and down (one labeled series)."""

    __slots__ = ("_value", "_lock")

    def __init__(self, lock: threading.Lock):
        self._value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        """Set the gauge to ``v``."""
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (may be negative) to the gauge."""
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        """The current value."""
        return self._value


class Histogram:
    """Fixed-bucket histogram (one labeled series).

    ``bounds`` are inclusive upper bounds in ascending order; an implicit
    ``+Inf`` bucket catches everything beyond the last bound.  Bucket
    counts are stored per-bucket (not cumulative); exporters emit the
    Prometheus cumulative form.
    """

    __slots__ = ("bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds: tuple[float, ...], lock: threading.Lock):
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, v: float) -> None:
        """Record one observation."""
        v = float(v)
        with self._lock:
            self._counts[bisect_left(self.bounds, v)] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self) -> float:
        """Sum of all observations."""
        return self._sum

    @property
    def count(self) -> int:
        """Number of observations."""
        return self._count

    def buckets(self) -> list[tuple[float, int]]:
        """Cumulative ``(upper_bound, count)`` pairs, ``+Inf`` last."""
        out, acc = [], 0
        for bound, n in zip(self.bounds, self._counts):
            acc += n
            out.append((bound, acc))
        out.append((float("inf"), acc + self._counts[-1]))
        return out

    def _restore(self, buckets: list, total_sum: float, count: int) -> None:
        """Install exported cumulative buckets (``from_snapshot`` path)."""
        prev = 0
        for i, (_, cum) in enumerate(buckets[: len(self.bounds)]):
            self._counts[i] = int(cum) - prev
            prev = int(cum)
        self._counts[len(self.bounds)] = int(buckets[-1][1]) - prev
        self._sum = float(total_sum)
        self._count = int(count)


def histogram_quantile(buckets: list[tuple[float, int]], q: float) -> float:
    """Estimate the q-quantile from cumulative ``(le, count)`` buckets.

    Linear interpolation inside the containing bucket, Prometheus-style;
    the lowest bucket interpolates from 0.  Returns 0.0 on an empty
    histogram.  ``q`` is a fraction in [0, 1] (0.5 = p50, 0.99 = p99).
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = buckets[-1][1]
    if total == 0:
        return 0.0
    rank = q * total
    prev_le, prev_cum = 0.0, 0
    for le, cum in buckets:
        if cum >= rank:
            if le == float("inf"):
                return prev_le  # open-ended tail: best estimate is the edge
            if cum == prev_cum:
                return le
            return prev_le + (le - prev_le) * (rank - prev_cum) / (cum - prev_cum)
        prev_le, prev_cum = le, cum
    return prev_le


class _Family:
    """One named metric family: a set of labeled series of one kind."""

    __slots__ = ("name", "kind", "help", "label_names", "_series",
                 "_registry", "_buckets")

    def __init__(self, registry: "MetricsRegistry", name: str, kind: str,
                 help: str, label_names: tuple[str, ...],
                 buckets: tuple[float, ...] | None = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self._series: dict[tuple[str, ...], object] = {}
        self._registry = registry
        self._buckets = buckets

    def labels(self, **labels: str):
        """The series for one label assignment (created on first use)."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._registry._lock:
            series = self._series.get(key)
            if series is None:
                series = self._registry._new_series(self.kind, self._buckets)
                self._series[key] = series
        return series

    def drop(self, **labels: str) -> bool:
        """Remove one series (rebind hygiene); True if it existed."""
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._registry._lock:
            return self._series.pop(key, None) is not None

    # label-less families act as their single default series -------------

    def _default(self):
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.label_names}; "
                "call .labels(...) first"
            )
        return self.labels()

    def inc(self, n: float = 1.0) -> None:
        """Increment the default (label-less) series."""
        self._default().inc(n)

    def set(self, v: float) -> None:
        """Set the default (label-less) gauge series."""
        self._default().set(v)

    def observe(self, v: float) -> None:
        """Observe into the default (label-less) histogram series."""
        self._default().observe(v)

    @property
    def value(self) -> float:
        """Value of the default (label-less) series."""
        return self._default().value

    def series(self) -> list[tuple[dict[str, str], object]]:
        """Every ``(labels, series)`` pair, sorted by label values."""
        with self._registry._lock:
            items = sorted(self._series.items())
        return [(dict(zip(self.label_names, key)), s) for key, s in items]


class MetricsRegistry:
    """An isolated set of metric families with deterministic exporters."""

    def __init__(self, *, clock=None):
        self.clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _new_series(self, kind: str, buckets: tuple[float, ...] | None = None):
        if kind == "counter":
            return Counter(self._lock)
        if kind == "gauge":
            return Gauge(self._lock)
        return Histogram(buckets if buckets is not None else DEFAULT_BUCKETS,
                         self._lock)

    def _family(self, name: str, kind: str, help: str,
                labels: tuple[str, ...], buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} with "
                        f"labels {fam.label_names}; cannot re-register as "
                        f"{kind} with labels {tuple(labels)}"
                    )
                return fam
            bounds = None
            if kind == "histogram":
                bounds = tuple(buckets if buckets is not None else DEFAULT_BUCKETS)
            fam = _Family(self, name, kind, help, tuple(labels), bounds)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", *, labels: tuple[str, ...] = ()) -> _Family:
        """Register (or fetch) a counter family."""
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "", *, labels: tuple[str, ...] = ()) -> _Family:
        """Register (or fetch) a gauge family."""
        return self._family(name, "gauge", help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        *,
        labels: tuple[str, ...] = (),
        buckets: tuple[float, ...] | None = None,
    ) -> _Family:
        """Register (or fetch) a fixed-bucket histogram family."""
        fam = self._family(name, "histogram", help, labels, buckets=buckets)
        return fam

    def names(self) -> list[str]:
        """Registered family names (sorted)."""
        return sorted(self._families)

    def get(self, name: str) -> _Family:
        """The named family (KeyError if absent)."""
        return self._families[name]

    # -- exporters -----------------------------------------------------------

    def _sorted_families(self) -> list[tuple[str, _Family]]:
        with self._lock:
            return sorted(self._families.items())

    def drop_series(self, **labels: str) -> int:
        """Drop every series whose labels include the given assignment.

        The rebind hygiene hook: when a component re-homes *within* one
        registry under new labels (or a recovered cell replaces a dead
        incarnation), the stale series would otherwise linger in every
        snapshot.  Families lacking one of the label names are untouched.
        Returns the number of series dropped.
        """
        dropped = 0
        for _, fam in self._sorted_families():
            if not set(labels) <= set(fam.label_names):
                continue
            want = {n: str(v) for n, v in labels.items()}
            with self._lock:
                keys = [
                    key for key in fam._series
                    if all(key[fam.label_names.index(n)] == v
                           for n, v in want.items())
                ]
                for key in keys:
                    del fam._series[key]
                    dropped += 1
        return dropped

    # -- exporters -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The whole registry as one JSON-able dict (sorted, deterministic)."""
        metrics = {}
        for name, fam in self._sorted_families():
            series = []
            for labels, s in fam.series():
                if fam.kind == "histogram":
                    series.append({
                        "labels": labels,
                        "buckets": [["+Inf" if le == float("inf") else le, n]
                                    for le, n in s.buckets()],
                        "sum": s.sum,
                        "count": s.count,
                    })
                else:
                    series.append({"labels": labels, "value": s.value})
            entry = {
                "kind": fam.kind,
                "help": fam.help,
                "label_names": list(fam.label_names),
                "series": series,
            }
            if fam.kind == "histogram":
                entry["bounds"] = list(fam._buckets)
            metrics[name] = entry
        return {"metrics": metrics}

    def to_json(self, *, indent: int | None = None) -> str:
        """The snapshot as deterministic JSON text."""
        return json.dumps(self.snapshot(), sort_keys=True, indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (the future ``/metrics`` body)."""
        lines: list[str] = []
        for name, fam in self._sorted_families():
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels, s in fam.series():
                lbl = ",".join(f'{k}="{v}"' for k, v in labels.items())
                if fam.kind == "histogram":
                    for le, n in s.buckets():
                        le_s = "+Inf" if le == float("inf") else _fmt(le)
                        blbl = (lbl + "," if lbl else "") + f'le="{le_s}"'
                        lines.append(f"{name}_bucket{{{blbl}}} {n}")
                    tail = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}_sum{tail} {_fmt(s.sum)}")
                    lines.append(f"{name}_count{tail} {s.count}")
                else:
                    tail = f"{{{lbl}}}" if lbl else ""
                    lines.append(f"{name}{tail} {_fmt(s.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- importers -----------------------------------------------------------

    @classmethod
    def from_snapshot(cls, snap: dict, *, clock=None) -> "MetricsRegistry":
        """Rebuild a registry from ``snapshot()`` output (exact values)."""
        reg = cls(clock=clock)
        for name, entry in snap["metrics"].items():
            label_names = tuple(entry["label_names"])
            kind = entry["kind"]
            if kind == "counter":
                fam = reg.counter(name, entry["help"], labels=label_names)
            elif kind == "gauge":
                fam = reg.gauge(name, entry["help"], labels=label_names)
            else:
                fam = reg.histogram(
                    name, entry["help"], labels=label_names,
                    buckets=tuple(entry["bounds"]),
                )
            for s in entry["series"]:
                child = fam.labels(**s["labels"])
                if kind == "counter":
                    child.inc(s["value"])
                elif kind == "gauge":
                    child.set(s["value"])
                else:
                    buckets = [
                        (float("inf") if le == "+Inf" else float(le), int(n))
                        for le, n in s["buckets"]
                    ]
                    child._restore(buckets, s["sum"], s["count"])
        return reg

    @classmethod
    def from_json(cls, text: str, *, clock=None) -> "MetricsRegistry":
        """Rebuild a registry from ``to_json()`` output (exact values)."""
        return cls.from_snapshot(json.loads(text), clock=clock)
