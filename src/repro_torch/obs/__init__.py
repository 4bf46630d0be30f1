"""Unified telemetry: metrics registry + request tracing.

An ``Observability`` bundle ties one :class:`~repro_torch.obs.MetricsRegistry`
and one :class:`~repro_torch.obs.Tracer` to one shared monotonic clock.  Every
coordinator object (``StreamingPipeline``, ``PipelineCell``,
``ClusterRouter``) owns a bundle; when cells join a router, their
telemetry is re-homed into the router's bundle via the components'
``bind_obs`` methods so the whole cluster scrapes as one registry and
one query traces end to end.

Scope labels ride the bundle: ``obs.scoped(cell="cell-0")`` is a view
sharing the same registry/tracer/clock whose base labels stamp every
series a component binds through it.  Standalone components default to
``cell="-"`` so one metric name keeps one label schema no matter where
it is emitted from.

See ``docs/observability.md`` for the metric catalogue, label
conventions, and trace anatomy.
"""
from __future__ import annotations

import time

from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    histogram_quantile,
)
from repro_torch.obs.tracing import Span, SpanEvent, TraceNode, Tracer

__all__ = [
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Observability",
    "Span",
    "SpanEvent",
    "TraceNode",
    "Tracer",
    "histogram_quantile",
    "rebind",
    "rehome_families",
]


class Observability:
    """One registry + one tracer + one clock, owned by a coordinator.

    ``labels`` are the bundle's base labels — merged under every series
    handle fetched through :meth:`handle`.  The default scope is
    ``{"cell": "-"}`` (standalone, not yet part of a cluster).
    """

    def __init__(self, *, clock=None, max_finished_spans: int = 8192,
                 registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None,
                 labels: dict[str, str] | None = None):
        self.clock = clock if clock is not None else time.perf_counter
        self.registry = (
            registry if registry is not None else MetricsRegistry(clock=self.clock)
        )
        self.tracer = (
            tracer
            if tracer is not None
            else Tracer(clock=self.clock, max_finished=max_finished_spans)
        )
        self.labels = dict(labels) if labels is not None else {"cell": "-"}

    def scoped(self, **labels: str) -> "Observability":
        """A view on the same registry/tracer/clock with merged base labels."""
        return Observability(
            clock=self.clock,
            registry=self.registry,
            tracer=self.tracer,
            labels={**self.labels, **{k: str(v) for k, v in labels.items()}},
        )

    def trace(self, name: str, *, trace_id: str | None = None, **attrs):
        """Shorthand for ``self.tracer.trace(...)``."""
        return self.tracer.trace(name, trace_id=trace_id, **attrs)

    def handle(self, kind: str, name: str, help: str = "", *,
               labels: dict[str, str] | None = None,
               buckets: tuple[float, ...] | None = None):
        """One series handle under this bundle's base labels (+ extras)."""
        merged = {**self.labels, **{k: str(v) for k, v in (labels or {}).items()}}
        names = tuple(sorted(merged))
        if kind == "counter":
            fam = self.registry.counter(name, help, labels=names)
        elif kind == "gauge":
            fam = self.registry.gauge(name, help, labels=names)
        elif kind == "histogram":
            fam = self.registry.histogram(name, help, labels=names, buckets=buckets)
        else:
            raise ValueError(f"unknown metric kind {kind!r}")
        return fam.labels(**merged)


def rebind(obs: Observability, kind: str, name: str, help: str = "", *,
           labels: dict[str, str] | None = None,
           buckets: tuple[float, ...] | None = None, old=None):
    """Fetch a series handle on ``obs``, carrying an old handle's state.

    Components re-home their telemetry when they join a larger scope
    (cell joins router): the value accumulated under the old registry is
    merged into the new series so no history is lost, and a no-op rebind
    (same series object) never double-counts.  Counters add their old
    value, gauges carry the last set value, histograms merge bucket
    counts/sum/count.
    """
    handle = obs.handle(kind, name, help, labels=labels, buckets=buckets)
    if old is None or old is handle:
        return handle
    if kind == "counter":
        if old.value:
            handle.inc(old.value)
    elif kind == "gauge":
        handle.set(old.value)
    else:
        if old.count:
            if old.bounds != handle.bounds:
                raise ValueError(
                    f"cannot rebind histogram {name!r}: bucket bounds differ"
                )
            with handle._lock:
                for i, n in enumerate(old._counts):
                    handle._counts[i] += n
                handle._sum += old.sum
                handle._count += old.count
    return handle


def rehome_families(old_obs: Observability | None, new_obs: Observability,
                    families) -> None:
    """Move a component's metric families from one bundle to another.

    ``families`` is an iterable of ``(kind, name, help)``.  Every series
    of each family that sits under ``old_obs``'s base labels is carried
    into ``new_obs`` (same extra labels, new base labels, values merged
    via :func:`rebind`).  When both bundles share one registry — a
    same-registry relabel, e.g. a bare pipeline joining a named cell —
    the old series are dropped afterwards so snapshots never carry a
    stale duplicate.  A no-op rebind (same registry, same labels) leaves
    everything untouched.
    """
    if old_obs is None:
        return
    same = old_obs.registry is new_obs.registry
    if same and old_obs.labels == new_obs.labels:
        return
    base = old_obs.labels
    for kind, name, help in families:
        try:
            fam = old_obs.registry.get(name)
        except KeyError:
            continue
        for labels, series in fam.series():
            if not all(labels.get(k) == v for k, v in base.items()):
                continue
            extra = {k: v for k, v in labels.items() if k not in base}
            rebind(
                new_obs, kind, name, help, labels=extra, old=series,
                buckets=fam._buckets if kind == "histogram" else None,
            )
            if same:
                fam.drop(**labels)
