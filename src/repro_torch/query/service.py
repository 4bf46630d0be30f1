"""Admission + batching front-ends over the query engine.

A copy of the reference's ``query/service.py`` with its imports rewritten
to the port's engine and ``obs``.

Modeled on the ``ServeEngine`` host loop: callers submit single directions
(the traffic pattern of the paper's coordinator under heavy query load) and
the service coalesces them into kernel-sized batches so the hot path always
sees a few fixed batch shapes.  Ragged tails are zero-padded up to a
power-of-two bucket (zero directions cost zero and are discarded), bounding
the number of batch shapes to ``log2(max_batch)`` per tenant.

    svc = QueryService(engine, tenant="run-42")
    tickets = [svc.submit(x) for x in directions]
    svc.flush()                       # or wait for max_batch auto-flush
    tickets[0].result()               # (estimate, error_bound, version)

``PackedQueryService`` is the multi-tenant variant: cross-tenant packing,
per-query deadlines, and per-tenant admission control (bounded queue depth
with shed-and-report via ``QueryShedError``, priority-ordered dispatch
under overload).  ``stats()`` on either service reports served queries,
batches/flushes, padding overhead, shed counts, and the measured
queries/sec of the engine-facing hot path.

``ServicePump`` is the real deadline executor: a small background thread
driving ``PackedQueryService.poll()`` so per-entry deadlines hold even
when nothing else touches the service — no cooperative pumping from an
ingest loop required.  ``PackedQueryService`` is thread-safe (one RLock
around queue state), so submits and pump sweeps may interleave freely.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.obs import Observability, rehome_families
from repro_torch.query.engine import PackedRequest, QueryEngine

__all__ = [
    "PackedQueryService",
    "PackedServiceStats",
    "QueryService",
    "QueryShedError",
    "QueryTicket",
    "ServicePump",
    "ServicePumpError",
    "ServiceStats",
]


class QueryShedError(RuntimeError):
    """A submit was rejected because the tenant's admission quota is full.

    Shedding is *reported*, never silent: the submitter gets this error
    synchronously (no ticket is created, nothing is queued) and the service
    counts the event in ``stats().shed`` / ``shed_counts()``.  Carries
    ``tenant``, ``pending`` (the tenant's queue depth at rejection), and
    ``max_pending`` (the quota that was hit).
    """

    def __init__(self, tenant: str, pending: int, max_pending: int):
        super().__init__(
            f"tenant {tenant!r} admission quota full "
            f"({pending}/{max_pending} queries pending); query shed"
        )
        self.tenant = tenant
        self.pending = pending
        self.max_pending = max_pending


class ServiceStats(NamedTuple):
    """Lifetime counters of a single-tenant ``QueryService``."""

    queries: int
    batches: int
    padded: int  # zero-filled slots added to round batches up
    busy_s: float  # wall time inside the engine hot path
    queries_per_sec: float


class QueryTicket:
    """Handle for one submitted direction; resolved at flush time."""

    __slots__ = ("_service", "estimate", "error_bound", "version", "done")

    def __init__(self, service: "QueryService"):
        self._service = service
        self.estimate: float | None = None
        self.error_bound: float | None = None
        self.version: int | None = None
        self.done = False

    def result(self) -> tuple[float, float, int]:
        """(estimate, error_bound, version) — flushes the service if pending."""
        if not self.done:
            self._service.flush()
        assert self.done, "flush() must resolve every pending ticket"
        return self.estimate, self.error_bound, self.version

    def _resolve(self, estimate: float, error_bound: float, version: int) -> None:
        self.estimate = estimate
        self.error_bound = error_bound
        self.version = version
        self.done = True


def _bucket(n: int, min_bucket: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, clamped to [min_bucket, max_batch]."""
    b = min_bucket
    while b < n:
        b *= 2
    return min(b, max_batch)


class QueryService:
    """Single-tenant admission: coalesce directions into kernel batches."""

    def __init__(
        self,
        engine: QueryEngine,
        *,
        tenant: str = "default",
        path: str = "kernel",
        max_batch: int = 1024,
        min_bucket: int = 8,
        auto_flush: bool = True,
    ):
        if max_batch < min_bucket or min_bucket < 1:
            raise ValueError(f"need 1 <= min_bucket <= max_batch, got {min_bucket}, {max_batch}")
        self.engine = engine
        self.tenant = tenant
        self.path = path
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.auto_flush = auto_flush
        self._pending: list[tuple[np.ndarray, QueryTicket]] = []
        self._queries = 0
        self._batches = 0
        self._padded = 0
        self._busy_s = 0.0

    def submit(self, x: np.ndarray) -> QueryTicket:
        """Enqueue one direction; auto-flushes when a full batch is waiting."""
        x = np.asarray(x, np.float32)
        if x.ndim != 1:
            raise ValueError(f"submit takes a single (d,) direction, got shape {x.shape}")
        ticket = QueryTicket(self)
        self._pending.append((x, ticket))
        if self.auto_flush and len(self._pending) >= self.max_batch:
            self.flush()
        return ticket

    def pending(self) -> int:
        """Queued-but-unserved query count."""
        return len(self._pending)

    def flush(self) -> int:
        """Serve every pending ticket in coalesced batches; returns #served."""
        served = 0
        while self._pending:
            # Pop only after the engine succeeds: a raising batch stays
            # pending, so the caller can fix the cause and flush again.
            take = self._pending[: self.max_batch]
            rows = np.stack([x for x, _ in take])
            bucket = _bucket(rows.shape[0], self.min_bucket, self.max_batch)
            batch = np.zeros((bucket, rows.shape[1]), np.float32)
            batch[: rows.shape[0]] = rows
            t0 = self.engine.obs.clock()
            res = self.engine.query_batch(
                batch, tenant=self.tenant, path=self.path
            )
            self._busy_s += self.engine.obs.clock() - t0
            del self._pending[: len(take)]
            for (_, ticket), est in zip(take, res.estimates):
                ticket._resolve(float(est), res.error_bound, res.version)
            self._queries += len(take)
            self._batches += 1
            self._padded += bucket - len(take)
            served += len(take)
        return served

    def stats(self) -> ServiceStats:
        """Lifetime service counters (see ``ServiceStats``)."""
        qps = self._queries / self._busy_s if self._busy_s > 0 else 0.0
        return ServiceStats(
            queries=self._queries,
            batches=self._batches,
            padded=self._padded,
            busy_s=self._busy_s,
            queries_per_sec=qps,
        )


# ---------------------------------------------------------------------------
# Cross-tenant packed admission with deadlines
# ---------------------------------------------------------------------------


class PackedServiceStats(NamedTuple):
    """Lifetime counters of a ``PackedQueryService``."""

    queries: int
    flushes: int  # engine round-trips (each = one packed dispatch sweep)
    packed_tenants: int  # tenant batches packed across all flushes
    padded: int  # zero-filled query slots added while packing
    deadline_flushes: int  # sweeps forced by an expired deadline
    busy_s: float
    queries_per_sec: float
    shed: int = 0  # submits rejected by a tenant quota (QueryShedError)


class PackedQueryService:
    """Multi-tenant admission: pack queued queries across tenants.

    The single-tenant ``QueryService`` coalesces directions for one sketch;
    under many-tenant traffic that still costs one kernel dispatch per
    tenant per flush.  This front-end queues (tenant, direction, deadline)
    triples and, at dispatch time, hands the engine ``query_packed`` calls:
    tenants whose pinned sketches share (l, d) ride a single kernel launch.

    Dispatch triggers:
      * ``max_batch`` total queued directions (admission pressure), or
      * the earliest queued deadline expiring — ``poll()`` is the deadline
        pump; call it from the ingest loop (the pipeline does).

    Each engine round-trip is one *sweep* of at most ``max_batch`` queries,
    packed in descending tenant-priority order (``set_quota``), so under
    overload high-priority tenants are served first and the deadline pump
    does bounded work per call.  ``flush()`` loops sweeps until drained.

    Admission control is per tenant: ``set_quota(tenant, max_pending=...)``
    bounds the tenant's queued depth; a submit beyond it raises
    ``QueryShedError`` (shed-and-report — the caller learns synchronously,
    the service counts it, nothing is silently dropped).

    ``clock`` is injectable so deadline behaviour is testable without
    sleeping; it governs deadlines only — durations and metrics run off
    ``obs.clock``.  All public methods are thread-safe (one RLock around
    queue state), so a ``ServicePump`` thread can drive ``poll()`` while
    the ingest thread keeps submitting; a sweep holds the lock for its
    engine round-trip, briefly blocking concurrent submits.
    """

    _FAMILIES = (
        ("counter", "repro_service_queries_total", "Queries served by packed sweeps."),
        ("counter", "repro_service_flushes_total", "Engine round-trips (packed dispatch sweeps)."),
        ("counter", "repro_service_packed_tenants_total", "Tenant batches packed across all sweeps."),
        ("counter", "repro_service_padded_total", "Zero-filled query slots added while packing."),
        ("counter", "repro_service_deadline_flushes_total", "Sweeps forced by an expired deadline."),
        ("counter", "repro_service_busy_seconds_total", "Wall time inside the engine hot path."),
        ("counter", "repro_service_sheds_total", "Submits rejected by a tenant quota."),
        ("counter", "repro_service_tenant_sheds_total", "Submits rejected by a tenant quota, per tenant."),
        ("histogram", "repro_serve_latency_seconds", "Engine round-trip latency per packed sweep."),
        ("histogram", "repro_service_poll_seconds", "Deadline-pump poll() latency."),
    )

    def __init__(
        self,
        engine: QueryEngine,
        *,
        max_batch: int = 1024,
        default_deadline_s: float = 0.02,
        auto_flush: bool = True,
        clock: Callable[[], float] = time.monotonic,
        obs: Observability | None = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if default_deadline_s < 0:
            raise ValueError(f"default_deadline_s must be >= 0, got {default_deadline_s}")
        self.engine = engine
        self.max_batch = max_batch
        self.default_deadline_s = default_deadline_s
        self.auto_flush = auto_flush
        self.clock = clock
        self.obs = obs if obs is not None else engine.obs
        self._lock = threading.RLock()
        # tenant -> [(x, ticket, abs_deadline), ...] in FIFO order.
        self._pending: dict[str, list[tuple[np.ndarray, QueryTicket, float]]] = {}
        self._n_pending = 0
        self._earliest_deadline = float("inf")
        self._quotas: dict[str, tuple[int, int]] = {}  # tenant -> (max_pending, priority)
        self._bind_metrics()

    def _bind_metrics(self) -> None:
        handles = {}
        for kind, name, help in self._FAMILIES:
            if name == "repro_service_tenant_sheds_total":
                continue
            handles[name] = self.obs.handle(kind, name, help)
        self._m_queries = handles["repro_service_queries_total"]
        self._m_flushes = handles["repro_service_flushes_total"]
        self._m_packed_tenants = handles["repro_service_packed_tenants_total"]
        self._m_padded = handles["repro_service_padded_total"]
        self._m_deadline_flushes = handles["repro_service_deadline_flushes_total"]
        self._m_busy = handles["repro_service_busy_seconds_total"]
        self._m_shed = handles["repro_service_sheds_total"]
        self._m_serve_latency = handles["repro_serve_latency_seconds"]
        self._m_poll = handles["repro_service_poll_seconds"]
        # Per-tenant shed handles are label-dynamic; cache and re-fetch the
        # known tenants so a re-home keeps shed_counts() intact.
        tenants = tuple(getattr(self, "_m_tenant_sheds", ()))
        self._m_tenant_sheds = {t: self._tenant_shed_handle(t) for t in tenants}

    def _tenant_shed_handle(self, tenant: str):
        return self.obs.handle(
            "counter", "repro_service_tenant_sheds_total",
            "Submits rejected by a tenant quota, per tenant.",
            labels={"tenant": tenant},
        )

    def bind_obs(self, obs: Observability) -> None:
        """Re-home this service's telemetry into another bundle."""
        with self._lock:
            old, self.obs = self.obs, obs
            rehome_families(old, obs, self._FAMILIES)
            self._bind_metrics()

    # -- admission control ---------------------------------------------------

    def set_quota(self, tenant: str, *, max_pending: int = 0, priority: int = 0) -> None:
        """Set a tenant's admission quota and dispatch priority.

        max_pending: maximum queued-but-unserved queries for the tenant
                     (0 = unbounded); overflow submits raise
                     ``QueryShedError``.
        priority:    higher values are packed earlier within each capped
                     dispatch sweep (ties broken by tenant name).
        """
        if max_pending < 0:
            raise ValueError(f"max_pending must be >= 0, got {max_pending}")
        with self._lock:
            self._quotas[tenant] = (int(max_pending), int(priority))

    def quota(self, tenant: str) -> tuple[int, int]:
        """The tenant's ``(max_pending, priority)`` (defaults ``(0, 0)``)."""
        with self._lock:
            return self._quotas.get(tenant, (0, 0))

    def clear_quota(self, tenant: str) -> None:
        """Forget a tenant's quota/priority (tenant removal; no-op if unset)."""
        with self._lock:
            self._quotas.pop(tenant, None)

    def shed_counts(self) -> dict[str, int]:
        """Per-tenant count of submits rejected by the quota (fresh dict)."""
        with self._lock:
            return {
                t: int(h.value) for t, h in self._m_tenant_sheds.items() if h.value
            }

    # -- submission ----------------------------------------------------------

    def submit(
        self,
        x: np.ndarray,
        *,
        tenant: str,
        deadline_s: float | None = None,
    ) -> QueryTicket:
        """Enqueue one (d,) direction for ``tenant``; returns its ticket.

        Raises ``QueryShedError`` (before queuing anything) when the
        tenant's ``max_pending`` quota is already full.
        """
        x = np.asarray(x, np.float32)
        if x.ndim != 1:
            raise ValueError(f"submit takes a single (d,) direction, got shape {x.shape}")
        with self._lock:
            max_pending, _ = self._quotas.get(tenant, (0, 0))
            depth = len(self._pending.get(tenant, ()))
            if max_pending and depth >= max_pending:
                self._m_shed.inc()
                if tenant not in self._m_tenant_sheds:
                    self._m_tenant_sheds[tenant] = self._tenant_shed_handle(tenant)
                self._m_tenant_sheds[tenant].inc()
                raise QueryShedError(tenant, depth, max_pending)
            ticket = QueryTicket(self)
            if deadline_s is None:
                deadline_s = self.default_deadline_s
            deadline = self.clock() + deadline_s
            self._pending.setdefault(tenant, []).append((x, ticket, deadline))
            self._n_pending += 1
            self._earliest_deadline = min(self._earliest_deadline, deadline)
            if self.auto_flush and self._n_pending >= self.max_batch:
                self.flush()
            return ticket

    def pending(self, tenant: str | None = None) -> int:
        """Queued-but-unserved query count (for one tenant, or in total)."""
        with self._lock:
            if tenant is not None:
                return len(self._pending.get(tenant, ()))
            return self._n_pending

    # -- dispatch ------------------------------------------------------------

    def poll(self) -> int:
        """Deadline pump: one priority-ordered sweep iff a deadline passed.

        Bounded work per call (at most ``max_batch`` queries served), so an
        ingest loop — or a ``ServicePump`` thread — can pump it freely; if
        expired queries remain after the sweep the next ``poll`` fires
        again.
        """
        with self._lock:
            t0 = self.obs.clock()
            served = 0
            if self._n_pending and self.clock() >= self._earliest_deadline:
                self._m_deadline_flushes.inc()
                served = self._sweep()
            self._m_poll.observe(self.obs.clock() - t0)
            return served

    def flush(self) -> int:
        """Drain everything pending in capped priority-ordered sweeps."""
        with self._lock:
            served = 0
            while self._n_pending:
                served += self._sweep()
            return served

    def _sweep(self) -> int:
        """One engine round-trip: up to ``max_batch`` queries, priority order."""
        if not self._pending:
            return 0
        order = sorted(
            self._pending, key=lambda t: (-self._quotas.get(t, (0, 0))[1], t)
        )
        take: list[tuple[str, list[tuple[np.ndarray, QueryTicket, float]]]] = []
        budget = self.max_batch
        for tenant in order:
            if budget <= 0:
                break
            entries = self._pending[tenant][:budget]
            take.append((tenant, entries))
            budget -= len(entries)
        requests = [
            PackedRequest(tenant=tenant, x=np.stack([x for x, _, _ in entries]))
            for tenant, entries in take
        ]
        t0 = self.obs.clock()
        # Pending state is only consumed after the engine succeeds: a raising
        # pack (e.g. an unpublished tenant) leaves every ticket pending.
        pad0 = self.engine.packed_pad_slots
        results = self.engine.query_packed(requests)
        elapsed = self.obs.clock() - t0
        self._m_busy.inc(elapsed)
        self._m_serve_latency.observe(elapsed)
        # The engine pads per (l, d) shape group; read its exact count.
        self._m_padded.inc(self.engine.packed_pad_slots - pad0)
        served = 0
        for (tenant, entries), res in zip(take, results):
            rest = self._pending[tenant][len(entries):]
            if rest:
                self._pending[tenant] = rest
            else:
                del self._pending[tenant]
            for (_, ticket, _), est in zip(entries, res.estimates):
                ticket._resolve(float(est), res.error_bound, res.version)
            served += len(entries)
        self._n_pending -= served
        self._earliest_deadline = min(
            (dl for entries in self._pending.values() for _, _, dl in entries),
            default=float("inf"),
        )
        self._m_queries.inc(served)
        self._m_flushes.inc()
        self._m_packed_tenants.inc(len(take))
        return served

    def stats(self) -> PackedServiceStats:
        """Lifetime service counters — a fresh view over the obs registry."""
        with self._lock:
            queries = int(self._m_queries.value)
            busy_s = self._m_busy.value
            qps = queries / busy_s if busy_s > 0 else 0.0
            return PackedServiceStats(
                queries=queries,
                flushes=int(self._m_flushes.value),
                packed_tenants=int(self._m_packed_tenants.value),
                padded=int(self._m_padded.value),
                deadline_flushes=int(self._m_deadline_flushes.value),
                busy_s=busy_s,
                queries_per_sec=qps,
                shed=int(self._m_shed.value),
            )


# ---------------------------------------------------------------------------
# Background deadline executor
# ---------------------------------------------------------------------------


class ServicePumpError(RuntimeError):
    """The pump thread died on an exception raised by ``poll()``.

    Raised by ``ServicePump.stop()`` (and ``start()`` on restart) so a
    crashed pump can never fail silently; the original exception rides
    ``__cause__``.
    """


class ServicePump:
    """Background thread driving ``PackedQueryService.poll()``.

    The deadline pump as a real executor: per-entry deadlines hold even
    when the ingest loop is idle or gone — no cooperative ``poll()`` calls
    required.  The thread wakes every ``interval_s`` seconds, fires one
    bounded deadline sweep, and exits cleanly on ``stop()``.

    Exception safety: an exception escaping ``poll()`` stops the loop and
    is *recorded*, never swallowed — ``error`` exposes it immediately and
    the next ``stop()`` (or restart attempt) raises ``ServicePumpError``
    from it.  The thread is a daemon, so a crashed or forgotten pump never
    blocks interpreter shutdown.
    """

    def __init__(self, service: PackedQueryService, *, interval_s: float = 0.001,
                 name: str = "service-pump"):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.service = service
        self.interval_s = interval_s
        self.name = name
        self._thread: threading.Thread | None = None
        self._stop: threading.Event | None = None
        self._error: BaseException | None = None
        self.polls = 0  # completed poll() calls
        self.served = 0  # queries resolved by deadline sweeps

    def _run(self, stop: threading.Event) -> None:
        # ``stop`` is captured per thread: a later start() gets a fresh
        # event, so it can never accidentally un-stop an older thread.
        while not stop.wait(self.interval_s):
            try:
                self.served += self.service.poll()
                self.polls += 1
            except BaseException as exc:  # noqa: B036 — recorded, re-raised on stop
                self._error = exc
                return

    def start(self) -> "ServicePump":
        """Start the pump thread (idempotent while running)."""
        if self._error is not None:
            self._raise_error()
        if self.running:
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(self._stop,), name=self.name, daemon=True
        )
        self._thread.start()
        return self

    def stop(self, *, timeout: float = 5.0) -> None:
        """Stop the thread and re-raise any exception the pump captured.

        Raises ``ServicePumpError`` if the thread is still alive after
        ``timeout`` (the pump keeps its reference, so a later ``stop``
        can retry — it is never orphaned).
        """
        thread = self._thread
        if thread is not None:
            self._stop.set()
            thread.join(timeout)
            if thread.is_alive():
                raise ServicePumpError(
                    f"pump {self.name!r} did not stop within {timeout}s "
                    "(a poll() sweep is still running); call stop() again"
                )
            self._thread = None
        if self._error is not None:
            self._raise_error()

    def _raise_error(self) -> None:
        error, self._error = self._error, None
        raise ServicePumpError(
            f"pump {self.name!r} died driving poll(): {error!r}"
        ) from error

    @property
    def running(self) -> bool:
        """Whether the pump thread is alive."""
        return self._thread is not None and self._thread.is_alive()

    @property
    def error(self) -> BaseException | None:
        """The exception that killed the pump loop, if any (not yet raised)."""
        return self._error

    def __enter__(self) -> "ServicePump":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.stop()
