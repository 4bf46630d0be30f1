"""Span-based request tracing with deterministic IDs.

A ``Tracer`` hands out spans through the ``trace(name, **attrs)``
context manager.  Spans nest on a per-thread stack, so one
``query_batch`` call produces a single tree —

    router.query_batch
      transport.message (cell-0)
        transport.send (attempt 1)
          cell.deliver
            engine.query_packed
      transport.message (cell-1)
        ...

— with per-stage durations read off ``Span.duration_s``.

Trace IDs propagate across process-internal message boundaries by
riding the envelope types' optional ``trace_id`` field: the router
stamps the current trace ID onto each ``Ingest``/``Query``/``Export``/
``Heartbeat`` it sends, and the receiving cell re-enters that trace
when it opens its ``cell.deliver`` span.  A replayed or late-delivered
envelope therefore re-attaches to its *original* trace (as a detached
root of that trace), which is exactly what the chaos suite asserts.

Determinism: trace and span IDs are zero-padded per-tracer counters
(``t000001``, ``s000001``), not random, and the clock is injectable —
two runs of the same seeded fault schedule produce identical trees.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import NamedTuple

__all__ = ["Span", "SpanEvent", "TraceNode", "Tracer"]


class SpanEvent(NamedTuple):
    """A timestamped point event attached to a span (e.g. one retry)."""

    ts_s: float
    name: str
    attrs: dict


class Span:
    """One timed operation within a trace."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "attrs",
        "start_s", "end_s", "events", "_clock",
    )

    def __init__(self, *, trace_id: str, span_id: str, parent_id: str | None,
                 name: str, attrs: dict, start_s: float, clock):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.start_s = start_s
        self.end_s: float | None = None
        self.events: list[SpanEvent] = []
        self._clock = clock

    @property
    def duration_s(self) -> float | None:
        """Wall time between enter and exit (None while still open)."""
        if self.end_s is None:
            return None
        return self.end_s - self.start_s

    def event(self, name: str, **attrs) -> None:
        """Attach a timestamped point event (e.g. a retry/backoff)."""
        self.events.append(SpanEvent(self._clock(), name, attrs))

    def as_dict(self) -> dict:
        """The span as a plain JSON-able dict."""
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "attrs": dict(self.attrs),
            "start_s": self.start_s,
            "end_s": self.end_s,
            "duration_s": self.duration_s,
            "events": [
                {"ts_s": e.ts_s, "name": e.name, "attrs": dict(e.attrs)}
                for e in self.events
            ],
        }

    def __repr__(self) -> str:  # noqa: D105
        return (
            f"Span({self.name!r}, trace={self.trace_id}, span={self.span_id}, "
            f"parent={self.parent_id}, dur={self.duration_s})"
        )


class TraceNode(NamedTuple):
    """One node of an assembled trace tree."""

    span: Span
    children: list

    def walk(self):
        """Yield this node and every descendant, depth-first."""
        yield self
        for child in self.children:
            yield from child.walk()


class Tracer:
    """Allocates spans with deterministic IDs and keeps finished ones."""

    def __init__(self, *, clock=None, max_finished: int = 8192):
        self.clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._local = threading.local()
        self._finished: deque[Span] = deque(maxlen=max_finished)
        self._n_traces = 0
        self._n_spans = 0

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _new_trace_id(self) -> str:
        with self._lock:
            self._n_traces += 1
            return f"t{self._n_traces:06d}"

    def _new_span_id(self) -> str:
        with self._lock:
            self._n_spans += 1
            return f"s{self._n_spans:06d}"

    @contextmanager
    def trace(self, name: str, *, trace_id: str | None = None, **attrs):
        """Open a span named ``name`` and yield it.

        Without ``trace_id``, the span nests under the current span on
        this thread (or roots a fresh trace if there is none).  With an
        explicit ``trace_id``, the span joins that trace: it still nests
        under the current span when the IDs agree, and otherwise becomes
        a detached root of the foreign trace — the replay/late-delivery
        case, where an envelope stamped in an old trace is processed
        inside some newer operation.
        """
        stack = self._stack()
        parent = stack[-1] if stack else None
        if trace_id is None:
            if parent is not None:
                tid, parent_id = parent.trace_id, parent.span_id
            else:
                tid, parent_id = self._new_trace_id(), None
        elif parent is not None and parent.trace_id == trace_id:
            tid, parent_id = trace_id, parent.span_id
        else:
            tid, parent_id = trace_id, None
        span = Span(
            trace_id=tid,
            span_id=self._new_span_id(),
            parent_id=parent_id,
            name=name,
            attrs=dict(attrs),
            start_s=self.clock(),
            clock=self.clock,
        )
        stack.append(span)
        try:
            yield span
        finally:
            stack.pop()
            span.end_s = self.clock()
            with self._lock:
                self._finished.append(span)

    def current(self) -> Span | None:
        """The innermost open span on this thread, if any."""
        stack = self._stack()
        return stack[-1] if stack else None

    def current_trace_id(self) -> str | None:
        """Trace ID of the innermost open span on this thread, if any."""
        span = self.current()
        return span.trace_id if span is not None else None

    def event(self, name: str, **attrs) -> bool:
        """Attach an event to the current span; False if none is open."""
        span = self.current()
        if span is None:
            return False
        span.event(name, **attrs)
        return True

    def finished(self, *, trace_id: str | None = None,
                 name: str | None = None) -> list[Span]:
        """Finished spans, optionally filtered by trace ID and/or name."""
        with self._lock:
            spans = list(self._finished)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        if name is not None:
            spans = [s for s in spans if s.name == name]
        return spans

    def trace_ids(self) -> list[str]:
        """Distinct trace IDs among finished spans, in first-seen order."""
        seen: dict[str, None] = {}
        for s in self.finished():
            seen.setdefault(s.trace_id, None)
        return list(seen)

    def tree(self, trace_id: str) -> list[TraceNode]:
        """Assemble the finished spans of one trace into root nodes.

        Children are ordered by ``(start_s, span_id)``.  Multiple roots
        occur when replays re-attach to a trace after the original root
        closed.
        """
        spans = sorted(
            self.finished(trace_id=trace_id),
            key=lambda s: (s.start_s, s.span_id),
        )
        nodes = {s.span_id: TraceNode(s, []) for s in spans}
        roots: list[TraceNode] = []
        for s in spans:
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            if parent is not None:
                parent.children.append(node)
            else:
                roots.append(node)
        return roots
