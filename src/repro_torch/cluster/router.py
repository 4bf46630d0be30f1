"""ClusterRouter: ring-placed ingest + per-shard packed query fan-out.

A copy of the reference's ``cluster/router.py`` with its imports
rewritten to the port's packages.  ``ingest_many(parallel=True)`` keeps a
thread per cell: the kernels' launch code is safe for one cell a thread
(``kernels/_build.py``).

The thin routing layer ROADMAP's refactor milestone asks for: tenants
live on exactly one ``PipelineCell`` (consistent-hash placement, see
``hashring``), and the router is the only component that knows the
topology.  Its core duties:

  * registration/ingest routing — ``add_*_tenant`` and ``ingest`` go to
    the ring-placed owner; the cell's own ``TenantQuota`` admission still
    applies, and a shed (``QueryShedError``) propagates to the submitter
    *and* is counted per cell (``shed_counts``) so overload is visible at
    the cluster edge, not just inside one shard.
  * query fan-out — ``query_batch`` takes a mixed-tenant batch, groups
    it per owning cell, hands each cell ONE ``query_packed`` call (so
    the cross-tenant ``quadform_packed`` sweep the single pipeline
    earned still fires inside every shard), and gathers results back in
    submission order.
  * parallel drive — ``ingest_many(..., parallel=True)`` runs each
    cell's batch sequence on its own worker thread; cells share nothing
    (own store/engine/service), so the only synchronization is the join.
  * rebalance — ``scale_to(new_cells)`` computes the minimal
    ``RebalancePlan`` between the old and new rings and applies it by
    draining + exporting each moved tenant from its source cell and
    importing it (bit-identically, version numbers preserved) into its
    destination.  A readers-writer lock serializes rebalances against
    in-flight ingest/query routing, so a move can never race a live
    wave into dropping or double-applying a batch.

With a ``Transport`` attached the router stops calling cells directly
and speaks typed envelopes instead, layering the resilience stack the
paper's exactly-once communication model needs in practice:

  * every ``Ingest`` is stamped ``(tenant, site, seq)`` and retained in
    a per-cell replay queue until the owning cell's checkpoint makes it
    durable — so a crash-restarted cell can be caught up by replay, and
    the cell's dedup window (see ``PipelineCell.ingest_from``) makes
    that replay safe.
  * sends retry under a ``RetryPolicy`` (capped exponential backoff,
    seeded jitter; the spent budget is in ``stats()["_resilience"]``).
  * each cell has a ``CircuitBreaker``; while open, ingest parks in the
    bounded replay queue (overflow -> ``IngestShedError`` through the
    existing shed path) and queries degrade to the router's attached
    ``ServingReplica``, whose ``versions_behind`` staleness bound is
    enforced on every degraded answer.
  * ``heartbeat_all`` drives health: probes every cell, lets half-open
    breakers trial, drains replay backlogs on recovery, and syncs the
    degraded-serving replica from healthy cells.
  * ``checkpoint_cell``/``recover_cell`` are the crash-restart path:
    checkpoint trims the replay queue to the durable horizon; recovery
    rebuilds a dead cell tenant-by-tenant from its checkpoint via the
    ``ckpt.read_subset`` payload path and replays the retained tail.

One-cell degeneracy: a router over a single cell routes everything to
that cell's pipeline, which is exactly the pre-cluster architecture —
the determinism tests pin 1-cell == 4-cell == bare pipeline per tenant.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Iterable, Sequence

import numpy as np

from repro_torch.cluster import transport as tp
from repro_torch.cluster.cell import PipelineCell
from repro_torch.cluster.hashring import HashRing, RebalancePlan, rebalance_plan
from repro_torch.cluster.replica import ServingReplica
from repro_torch.obs import Observability
from repro_torch.query.engine import PackedRequest, QueryResult
from repro_torch.query.service import QueryShedError, QueryTicket
from repro_torch.runtime.policies import RetryPolicy

__all__ = ["ClusterRouter"]


class _RWLock:
    """Many readers xor one writer: routing reads, rebalance writes.

    Keeps ``scale_to`` (which rewrites tenant placement mid-loop) from
    interleaving with a live ``ingest_many`` wave or query fan-out —
    the race that could send a batch to a cell that no longer owns the
    tenant (drop) or to both owners (double-apply).  Read acquisition
    is reentrant-safe by construction: a pending writer waits for
    readers to drain but never blocks new read acquisitions by a thread
    that already holds one (readers only wait on an *active* writer).
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writing = False

    @contextmanager
    def read(self):
        """Shared acquisition (routing paths)."""
        with self._cond:
            while self._writing:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                self._cond.notify_all()

    @contextmanager
    def write(self):
        """Exclusive acquisition (rebalance / recovery / checkpoint-trim)."""
        with self._cond:
            while self._writing or self._readers:
                self._cond.wait()
            self._writing = True
        try:
            yield
        finally:
            with self._cond:
                self._writing = False
                self._cond.notify_all()


class _ReplayEntry:
    """One retained ``Ingest`` envelope + whether the owner acked it."""

    __slots__ = ("env", "acked")

    def __init__(self, env: tp.Ingest):
        self.env = env
        self.acked = False


_BREAKER_STATES = {"closed": 0, "half-open": 1, "open": 2}


class ClusterRouter:
    """Routes tenants, ingest, and query batches across coordinator cells.

    The router owns the cluster's one ``Observability`` bundle: every
    cell's pipeline/engine/service telemetry is re-homed into it at
    construction (``bind_obs``), the transport and the degraded-serving
    replica emit into it, and a query fans out as one trace tree —
    ``router.query_batch`` → ``transport.message``/``transport.send`` →
    ``cell.deliver`` → ``engine.query_packed``.  ``obs.registry`` is the
    scrape surface (``to_prometheus()`` is a ready ``/metrics`` body).
    """

    # Resilience counter order is the legacy _resilience dict order.
    _RES_KEYS = (
        ("messages", "Logical sends (first attempts)."),
        ("attempts", "Total transport sends incl. retries."),
        ("retries", "Attempts beyond the first."),
        ("backoff_s", "Total backoff budget slept (seconds)."),
        ("unreachable", "Messages that exhausted their retry budget."),
        ("parked_ingest", "Batches retained while the owner was out."),
        ("ingest_shed", "Replay-queue overflows (IngestShedError)."),
        ("degraded_queries", "Answers served by the replica."),
        ("heartbeats", "Heartbeat probes sent."),
        ("recoveries", "Crash-restart cell recoveries."),
    )

    def __init__(
        self,
        cells: Sequence[PipelineCell],
        *,
        vnodes: int = 64,
        transport: tp.Transport | None = None,
        retry: RetryPolicy | None = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        replay_bound: int = 256,
        staleness_bound: int | None = None,
        retry_seed: int = 0,
        clock=None,
        sleep=None,
    ):
        names = [c.name for c in cells]
        self.ring = HashRing(names, vnodes=vnodes)
        self._cells: dict[str, PipelineCell] = {c.name: c for c in cells}
        self._tenant_cell: dict[str, str] = {}
        self.rebalances = 0
        self._rw = _RWLock()

        # -- transport / resilience state (all None-guarded on the hot path) --
        self._transport = transport
        self._retry = (retry or RetryPolicy()).validate()
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self._replay_bound = replay_bound
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = sleep if sleep is not None else time.sleep
        self._rng = np.random.default_rng(retry_seed)
        self._seq_lock = threading.Lock()
        self._seq: dict[tuple[str, str], int] = {}  # (tenant, site) -> next seq
        self._replay: dict[str, list[_ReplayEntry]] = {}
        self._breakers: dict[str, tp.CircuitBreaker] = {}
        self._hb_seq = 0
        self.degraded_log: list[tuple[str, int]] = []  # (tenant, versions_behind)

        # -- unified telemetry: one bundle for the whole cluster --------------
        # The router's clock (injectable, like the breakers') times every
        # span and latency metric, so seeded chaos schedules with a fake
        # clock serialize byte-identically run over run.
        self.obs = Observability(clock=clock, labels={})
        self._m_res = {
            k: self.obs.handle(
                "counter",
                f"repro_router_{'backoff_seconds' if k == 'backoff_s' else k}_total",
                h)
            for k, h in self._RES_KEYS
        }
        self._m_shed = {name: self._shed_handle(name) for name in names}
        for cell in cells:
            cell.bind_obs(self.obs.scoped(cell=cell.name))
        self.replica: ServingReplica | None = None
        if transport is not None:
            transport.bind_obs(self.obs)
            for cell in cells:
                transport.register(cell.name, cell.deliver)
                self._breakers[cell.name] = self._new_breaker()
                self._set_breaker_gauge(cell.name)
            self.replica = ServingReplica(
                self, max_versions_behind=staleness_bound,
                obs=self.obs.scoped(cell="replica"),
            )

    # -- telemetry helpers -----------------------------------------------------

    def _shed_handle(self, name: str):
        return self.obs.handle(
            "counter", "repro_router_sheds_total",
            "Sheds that propagated through this router, per cell.",
            labels={"cell": name},
        )

    def _set_breaker_gauge(self, name: str) -> None:
        self.obs.handle(
            "gauge", "repro_router_breaker_state",
            "Per-cell breaker state: 0 closed, 1 half-open, 2 open.",
            labels={"cell": name},
        ).set(_BREAKER_STATES[self._breakers[name].state])

    def _new_breaker(self) -> tp.CircuitBreaker:
        return tp.CircuitBreaker(
            failure_threshold=self._breaker_threshold,
            cooldown_s=self._breaker_cooldown_s,
            clock=self._clock,
        )

    # -- topology --------------------------------------------------------------

    def cells(self) -> list[str]:
        """Cell names on the ring (sorted)."""
        return list(self.ring.cells())

    def cell(self, name: str) -> PipelineCell:
        """The named cell."""
        return self._cells[name]

    def cell_for(self, tenant: str) -> PipelineCell:
        """The cell that owns (or would own) ``tenant``."""
        return self._cells[self._tenant_cell.get(tenant) or self.ring.place(tenant)]

    def tenants(self) -> list[str]:
        """All tenant names registered through this router (sorted)."""
        return sorted(self._tenant_cell)

    def placement(self) -> dict[str, str]:
        """tenant -> owning cell name, for every registered tenant."""
        return dict(self._tenant_cell)

    # -- tenant registration (ring-placed) ------------------------------------

    def _route_add(self, tenant: str):
        if tenant in self._tenant_cell:
            raise ValueError(f"tenant {tenant!r} already registered")
        name = self.ring.place(tenant)
        self._tenant_cell[tenant] = name
        return self._cells[name]

    def add_tenant(self, tenant: str, d: int, **kw):
        """Register a matrix tenant on its ring-placed cell; returns its tracker."""
        return self._route_add(tenant).pipeline.add_tenant(tenant, d, **kw)

    def add_hh_tenant(self, tenant: str, **kw):
        """Register a heavy-hitter tenant on its ring-placed cell."""
        return self._route_add(tenant).pipeline.add_hh_tenant(tenant, **kw)

    def add_quantile_tenant(self, tenant: str, **kw):
        """Register a quantile tenant on its ring-placed cell."""
        return self._route_add(tenant).pipeline.add_quantile_tenant(tenant, **kw)

    def add_leverage_tenant(self, tenant: str, d: int, **kw):
        """Register a leverage-sampling tenant on its ring-placed cell."""
        return self._route_add(tenant).pipeline.add_leverage_tenant(tenant, d, **kw)

    def add_windowed_tenant(self, tenant: str, **kw):
        """Register a time-windowed tenant on its ring-placed cell."""
        return self._route_add(tenant).pipeline.add_windowed_tenant(tenant, **kw)

    def _owner(self, tenant: str) -> PipelineCell:
        try:
            return self._cells[self._tenant_cell[tenant]]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r} (registered: {self.tenants()})"
            ) from None

    # -- transported send (retry + breaker accounting) -------------------------

    def _send_with_retry(self, name: str, envelope):
        """One logical message: send, retry on loss, settle the breaker.

        Returns the reply, or None when the retry budget is exhausted
        (the message is *unreachable*, counted, and — for ``Ingest`` —
        still safely retained in the replay queue).  Every attempt
        consumes a transport message index, which is what lets the chaos
        suite reconcile ``transport.sends`` against
        ``messages + retries`` exactly.

        Tracing: the logical message is one ``transport.message`` span;
        every attempt opens its own ``transport.send`` child (so counting
        a trace's ``transport.send`` spans counts its attempts exactly),
        and each retry lands as a timestamped event on the message span.
        """
        retry = self._retry
        self._m_res["messages"].inc()
        with self.obs.trace(
            "transport.message", cell=name, kind=type(envelope).__name__
        ) as msg:
            for attempt in range(1, retry.max_attempts + 1):
                self._m_res["attempts"].inc()
                try:
                    with self.obs.trace("transport.send", cell=name, attempt=attempt):
                        reply = self._transport.send(name, envelope)
                except (tp.TransportTimeout, tp.CellDownError) as exc:
                    if attempt < retry.max_attempts:
                        self._m_res["retries"].inc()
                        delay = retry.backoff_s(attempt, float(self._rng.random()))
                        self._m_res["backoff_s"].inc(delay)
                        msg.event(
                            "retry", attempt=attempt,
                            error=type(exc).__name__, backoff_s=delay,
                        )
                        self._sleep(delay)
                else:
                    self._breakers[name].record_success()
                    self._set_breaker_gauge(name)
                    return reply
            self._breakers[name].record_failure()
            self._set_breaker_gauge(name)
            self._m_res["unreachable"].inc()
            return None

    # -- ingest routing --------------------------------------------------------

    def ingest(self, tenant: str, rows, *, site: str = "site-0",
               ts: float | None = None):
        """Route one super-step batch to the tenant's owning cell.

        ``ts`` stamps the batch's event time for windowed tenants; the
        timestamp rides the ingest envelope (``TimedRows``), so seq
        stamping, the replay queue, and idempotent cell-side dedup all
        see one opaque batch — replaying a timed batch after a fault
        applies the same event time.

        Direct mode (no transport) returns whatever the pipeline's
        ingest returns.  Transported mode stamps the batch with the next
        ``(tenant, site)`` seq, retains it in the owner's replay queue
        (bounded; overflow sheds with ``IngestShedError``), and returns
        the owner's ``IngestAck`` — or None when the owner is open/
        unreachable and the batch is parked for later replay.
        """
        if ts is not None:
            from repro_torch.core.windows import TimedRows

            rows = TimedRows(
                rows.rows if isinstance(rows, TimedRows) else rows, float(ts)
            )
        with self._rw.read():
            if self._transport is None:
                with self.obs.trace("router.ingest", tenant=tenant, site=site):
                    return self._owner(tenant).ingest(tenant, rows)
            with self.obs.trace("router.ingest", tenant=tenant, site=site):
                cell_name = self._owner(tenant).name
                with self._seq_lock:
                    buf = self._replay.setdefault(cell_name, [])
                    pending = sum(1 for e in buf if not e.acked)
                    if pending >= self._replay_bound:
                        self._m_shed[cell_name].inc()
                        self._m_res["ingest_shed"].inc()
                        raise tp.IngestShedError(tenant, pending, self._replay_bound)
                    seq = self._seq.get((tenant, site), 1)
                    self._seq[(tenant, site)] = seq + 1
                    entry = _ReplayEntry(tp.Ingest(
                        tenant, site, seq, rows,
                        trace_id=self.obs.tracer.current_trace_id(),
                    ))
                    buf.append(entry)
                if not self._breakers[cell_name].allow():
                    self._m_res["parked_ingest"].inc()
                    return None
                ack = self._send_with_retry(cell_name, entry.env)
                if ack is None:
                    self._m_res["parked_ingest"].inc()
                    return None
                entry.acked = True
                return ack

    def ingest_many(
        self,
        batches: Iterable[tuple[str, "np.ndarray"]],
        *,
        parallel: bool = False,
        packed: bool = True,
    ) -> int:
        """Drive interleaved tenants; returns snapshots published.

        Each cell receives its tenants' batch subsequence as ONE
        ``StreamingPipeline.ingest_many`` call, so in-cell packing (same
        pack-key shard tenants stacked into one super-step launch, see
        ``runtime.ingest_packed``) fires behind every shard boundary;
        ``packed=False`` forces the strict serial loop inside every cell.
        ``parallel=True`` additionally runs each cell's call on its own
        worker thread (thread-per-cell x in-cell packing) — per-tenant
        order is preserved (a tenant lives on one cell, and each cell
        replays its subsequence in order), which is all bit-identical
        ingest requires.  Cells share no state, so the fan-out needs no
        locks beyond the join — and the router-level readers-writer lock
        holds the placement fixed for the whole wave, so a concurrent
        ``scale_to`` waits rather than moving a tenant mid-wave.

        With a transport attached the wave crosses the message boundary
        batch-by-batch instead (seq stamping has no packed equivalent);
        returns the number of publishes acked.

        Entries may carry event time for windowed tenants as
        ``(tenant, rows, ts)`` triples or ``(tenant, TimedRows)`` pairs.
        """
        from repro_torch.core.windows import TimedRows

        batches = [
            (b[0], TimedRows(b[1].rows if isinstance(b[1], TimedRows) else b[1],
                             float(b[2])))
            if len(b) == 3 else (b[0], b[1])
            for b in (tuple(b) for b in batches)
        ]
        if self._transport is not None:
            published = 0
            for tenant, rows in batches:
                ack = self.ingest(tenant, rows)
                if ack is not None and ack.version is not None:
                    published += 1
            return published
        with self._rw.read():
            per_cell: dict[str, list[tuple[str, np.ndarray]]] = {}
            for tenant, rows in batches:
                per_cell.setdefault(self._tenant_cell[tenant], []).append((tenant, rows))

            def drive(name: str, sub: list[tuple[str, np.ndarray]]) -> int:
                return self._cells[name].pipeline.ingest_many(sub, packed=packed)

            if not parallel or len(per_cell) <= 1:
                return sum(drive(name, sub) for name, sub in per_cell.items())

            with ThreadPoolExecutor(max_workers=len(per_cell)) as pool:
                futures = [
                    pool.submit(drive, name, sub) for name, sub in per_cell.items()
                ]
                return sum(f.result() for f in futures)

    # -- query fan-out ---------------------------------------------------------

    def submit(self, tenant: str, x, *, deadline_s: float | None = None) -> QueryTicket:
        """Admit one query on the owning cell's packed service.

        A quota shed propagates to the caller unchanged (shed-and-report
        end to end) and is additionally counted per cell — the cluster
        edge sees which shard is saturating.
        """
        with self._rw.read():
            cell = self._owner(tenant)
            try:
                return cell.submit(tenant, x, deadline_s=deadline_s)
            except QueryShedError:
                self._m_shed[cell.name].inc()
                raise

    def shed_counts(self) -> dict[str, int]:
        """Per-cell count of sheds that propagated through this router."""
        return {name: int(h.value) for name, h in self._m_shed.items()}

    def query_batch(
        self, queries: Sequence[tuple[str, "np.ndarray"]]
    ) -> list[QueryResult]:
        """Serve a mixed-tenant batch: one packed engine call per cell.

        ``queries`` is ``[(tenant, x_batch), ...]``; entries are grouped
        by owning cell, each cell serves its group through
        ``QueryEngine.query_packed`` (tenants sharing an (l, d) sketch
        shape inside a cell still ride one ``quadform_packed`` launch),
        and results come back in submission order — exactly what the
        single pipeline would return for the same list, shard boundaries
        invisible.

        With a transport attached, a cell whose breaker is open (or that
        stays unreachable through the retry budget) degrades gracefully:
        its group's answers come from the attached ``ServingReplica``,
        each enforced against the declared ``staleness_bound`` and logged
        in ``degraded_log`` as ``(tenant, versions_behind)``.
        """
        with self._rw.read(), self.obs.trace(
            "router.query_batch", queries=len(queries)
        ):
            per_cell: dict[str, list[int]] = {}
            for i, (tenant, _) in enumerate(queries):
                per_cell.setdefault(self._tenant_cell[tenant], []).append(i)
            out: list[QueryResult | None] = [None] * len(queries)
            for name, idxs in per_cell.items():
                requests = [
                    PackedRequest(
                        tenant=queries[i][0], x=np.asarray(queries[i][1], np.float32)
                    )
                    for i in idxs
                ]
                if self._transport is None:
                    results = self._cells[name].engine.query_packed(requests)
                else:
                    results = None
                    if self._breakers[name].allow():
                        env = tp.Query(
                            tuple(requests),
                            trace_id=self.obs.tracer.current_trace_id(),
                        )
                        results = self._send_with_retry(name, env)
                    if results is None:
                        results = [self._degraded(req) for req in requests]
                for i, res in zip(idxs, results):
                    out[i] = res
            return out  # type: ignore[return-value]

    def _degraded(self, request: PackedRequest) -> QueryResult:
        """Serve one request from the replica (owner open/unreachable)."""
        rr = self.replica.query_degraded(request.x, tenant=request.tenant)
        self._m_res["degraded_queries"].inc()
        self.degraded_log.append((request.tenant, rr.versions_behind))
        return rr.result

    def flush(self) -> int:
        """Drain every cell's pending queries; returns total served."""
        return sum(cell.flush() for cell in self._cells.values())

    def poll(self) -> int:
        """Deadline pump across every cell; returns total served."""
        return sum(cell.poll() for cell in self._cells.values())

    # -- health / replay / crash-restart (transport mode) ----------------------

    def heartbeat_all(self) -> dict[str, str]:
        """Probe every cell; returns ``{name: "ok" | "open" | "failed"}``.

        The operator loop: a healthy reply settles the breaker closed
        and — if the cell has a replay backlog — drains it (dedup makes
        over-delivery safe); an open breaker past its cooldown gets its
        half-open trial here; replicas sync from every healthy cell so
        degraded serving has fresh versions *before* the next outage.
        """
        if self._transport is None:
            raise RuntimeError("heartbeat_all requires a transport-attached router")
        out: dict[str, str] = {}
        with self._rw.read():
            for name in self.cells():
                if not self._breakers[name].allow():
                    out[name] = "open"
                    continue
                self._hb_seq += 1
                self._m_res["heartbeats"].inc()
                env = tp.Heartbeat(
                    self._hb_seq, trace_id=self.obs.tracer.current_trace_id()
                )
                ack = self._send_with_retry(name, env)
                if ack is None:
                    out[name] = "failed"
                    continue
                out[name] = "ok"
                if any(not e.acked for e in self._replay.get(name, ())):
                    self._drain_replay(name)
            for tenant, cname in sorted(self._tenant_cell.items()):
                if out.get(cname) == "ok":
                    self.replica.sync(tenant)
        return out

    def _drain_replay(self, name: str, *, include_acked: bool = False) -> int:
        """Resend retained batches in per-(tenant, site) seq order.

        The receiving cell's dedup window drops anything already applied
        or already durable, so replaying conservatively cannot
        double-count a row.  Ordinary drains (heartbeat recovery from a
        transient outage) resend only unacked entries; a crash-restart
        drain (``include_acked=True``) resends *everything* retained —
        an ack from the dead incarnation proves nothing about the
        rebuilt one, which rolled back to the checkpoint horizon.  Stops
        at the first unreachable send; returns the number acked.
        """
        pending = sorted(
            (
                e
                for e in self._replay.get(name, ())
                if include_acked or not e.acked
            ),
            key=lambda e: (e.env.tenant, e.env.site, e.env.seq),
        )
        acked = 0
        for entry in pending:
            if self._send_with_retry(name, entry.env) is None:
                break
            entry.acked = True
            acked += 1
        return acked

    def checkpoint_cell(self, name: str, directory: str, *, step: int = 0) -> str:
        """Checkpoint one cell and trim its replay queue to the durable horizon.

        The cell's save carries its dedup horizons as a manifest
        attachment; every retained batch that is both acked *and* below
        the checkpointed horizon is now durable at the owner and can be
        forgotten here — the replay queue is a write-ahead tail, not a
        full log.
        """
        with self._rw.write():
            cell = self._cells[name]
            cell.flush()
            path = cell.save(directory, step=step)
            horizons = cell.dedup_state()
            self._replay[name] = [
                e
                for e in self._replay.get(name, [])
                if not (
                    e.acked
                    and e.env.seq
                    < horizons.get(e.env.tenant, {}).get(e.env.site, 1)
                )
            ]
            return path

    def recover_cell(
        self,
        name: str,
        fresh_cell: PipelineCell,
        directory: str,
        *,
        step: int | None = None,
    ) -> int:
        """Crash-restart: rebuild a dead cell from its checkpoint, replay the tail.

        Every tenant the ring assigns to ``name`` is rebuilt into
        ``fresh_cell`` via the tenant-scoped ``ckpt.read_subset`` payload
        path (``StreamingPipeline.read_tenant_export``), the checkpointed
        dedup horizons are restored (so replay cannot double-apply what
        was already durable), the transport endpoint is revived, the
        breaker resets closed, and the retained replay queue is drained.
        Returns the number of batches re-acked during the drain.
        """
        from repro_torch import ckpt

        if self._transport is None:
            raise RuntimeError("recover_cell requires a transport-attached router")
        if fresh_cell.name != name:
            raise ValueError(
                f"replacement cell is named {fresh_cell.name!r}, expected {name!r}"
            )
        with self._rw.write():
            if step is None:
                step = ckpt.latest_step(directory)
                if step is None:
                    raise FileNotFoundError(f"no cell checkpoint under {directory!r}")
            try:
                self._cells[name].close()
            except Exception:
                pass  # the old object is dead weight either way
            owned = sorted(t for t, c in self._tenant_cell.items() if c == name)
            from repro_torch.runtime.pipeline import StreamingPipeline

            for tenant in owned:
                payload = StreamingPipeline.read_tenant_export(
                    directory, tenant, step=step
                )
                fresh_cell.import_tenant(payload)
            attachments = ckpt.read_extra(directory, step).get("attachments", {})
            fresh_cell.restore_dedup(attachments.get("cell", {}).get("dedup", {}))
            self._cells[name] = fresh_cell
            # The dead incarnation's per-cell series go with it — but router
            # sheds are *router* state, so carry that one value across.
            shed = self._m_shed[name].value
            self.obs.registry.drop_series(cell=name)
            self._m_shed[name] = self._shed_handle(name)
            if shed:
                self._m_shed[name].inc(shed)
            fresh_cell.bind_obs(self.obs.scoped(cell=name))
            self._transport.revive(name, fresh_cell.deliver)
            self._breakers[name] = self._new_breaker()
            self._set_breaker_gauge(name)
            self._m_res["recoveries"].inc()
            return self._drain_replay(name, include_acked=True)

    # -- rebalance -------------------------------------------------------------

    def plan_scale_to(self, cell_names: Sequence[str]) -> RebalancePlan:
        """The minimal move plan for resizing to ``cell_names`` (dry run)."""
        return rebalance_plan(
            self.ring, self.ring.with_cells(cell_names), self._tenant_cell
        )

    def scale_to(self, cells: Sequence[PipelineCell]) -> RebalancePlan:
        """Resize the cluster to ``cells``, moving only the tenants that must.

        ``cells`` is the *complete* new cell set; existing cells are
        matched by name (their objects are kept — passing a fresh object
        under an existing name replaces it only if it is the same object,
        otherwise raises to protect live state).  Each planned move
        drains the source cell, exports the tenant, imports it into the
        destination, then removes it from the source — queries answered
        after the move are bit-identical to before, version numbers
        included.  A cell leaving the ring must end up empty; a non-empty
        removed cell raises before anything is touched.

        Runs under the router's writer lock: an in-flight ``ingest_many``
        wave or query fan-out finishes against the old placement before
        any tenant moves, and later waves see only the new placement — a
        batch can be neither dropped nor double-applied mid-move.  With a
        transport attached, each export crosses the message boundary
        (``Export`` envelope, retried; an unreachable source aborts the
        rebalance), and the moved tenant's seq horizons + retained replay
        entries follow it to the destination cell.
        """
        with self._rw.write():
            new_by_name: dict[str, PipelineCell] = {}
            for cell in cells:
                if cell.name in new_by_name:
                    raise ValueError(f"duplicate cell name {cell.name!r}")
                new_by_name[cell.name] = cell
            for name, cell in new_by_name.items():
                if name in self._cells and cell is not self._cells[name]:
                    raise ValueError(
                        f"cell {name!r} already exists with live state; reuse its object"
                    )
            new_ring = self.ring.with_cells(new_by_name)
            plan = rebalance_plan(self.ring, new_ring, self._tenant_cell)
            removed = set(self._cells) - set(new_by_name)
            stranded = {
                t: c for t, c in self._tenant_cell.items()
                if c in removed and not any(m.tenant == t for m in plan.moves)
            }
            if stranded:  # cannot happen with a consistent plan; belt-and-braces
                raise RuntimeError(f"tenants stranded on removed cells: {stranded}")

            for name, cell in new_by_name.items():
                if name not in self._cells:
                    cell.bind_obs(self.obs.scoped(cell=name))
                    self._m_shed.setdefault(name, self._shed_handle(name))
                    if self._transport is not None:
                        self._transport.register(name, cell.deliver)
                        self._breakers[name] = self._new_breaker()
                        self._set_breaker_gauge(name)

            for move in plan.moves:
                src, dst = self._cells[move.src], new_by_name[move.dst]
                src.flush()
                if self._transport is not None:
                    payload = self._send_with_retry(move.src, tp.Export(move.tenant))
                    if payload is None:
                        raise RuntimeError(
                            f"cell {move.src!r} unreachable; cannot rebalance "
                            f"tenant {move.tenant!r}"
                        )
                else:
                    payload = src.export_tenant(move.tenant)
                dst.import_tenant(payload)
                if self._transport is not None:
                    dst.adopt_dedup(move.tenant, src.dedup_for(move.tenant))
                    src_buf = self._replay.get(move.src, [])
                    moved = [e for e in src_buf if e.env.tenant == move.tenant]
                    if moved:
                        self._replay[move.src] = [
                            e for e in src_buf if e.env.tenant != move.tenant
                        ]
                        self._replay.setdefault(move.dst, []).extend(moved)
                src.remove_tenant(move.tenant)
                if self._transport is not None:
                    src.drop_dedup(move.tenant)
                self._tenant_cell[move.tenant] = move.dst
                # Tenant-labelled gauges under the old owner are stale now.
                self.obs.registry.drop_series(cell=move.src, tenant=move.tenant)

            self.ring = new_ring
            self._cells = new_by_name
            for name in removed:
                self._m_shed.pop(name, None)
                self._breakers.pop(name, None)
                self._replay.pop(name, None)
                # A removed cell's label series would otherwise linger on
                # the scrape surface forever at their final values.
                self.obs.registry.drop_series(cell=name)
            self.rebalances += 1
            return plan

    # -- accounting / lifecycle ------------------------------------------------

    def stats(self) -> dict[str, dict]:
        """Per-cell snapshot: tenants, pending queries, sheds, cache hit
        rate, plus the cell pipeline's ingest-side counters
        (``StreamingPipeline.stats()`` with no tenant: rows_per_sec,
        shrink_launches, pack_occupancy, retraces, ...) under
        ``"ingest"``.  A transport-attached router adds per-cell breaker
        state / replay depth / endpoint delivery counters, and one
        reserved ``"_resilience"`` entry carrying the spent retry budget
        (messages, attempts, retries, backoff seconds) and the raw
        transport outcome counters."""
        out = {}
        for name in self.cells():
            cell = self._cells[name]
            cache = cell.engine.cache_stats()
            out[name] = {
                "tenants": len(cell.tenants()),
                "pending": cell.pipeline.service.pending(),
                "shed": int(self._m_shed[name].value) if name in self._m_shed else 0,
                "cache_hit_rate": cache["hit_rate"],
                "cache_evictions": cache["evictions"],
                "ingest": cell.pipeline.stats(),
            }
            if self._transport is not None:
                buf = self._replay.get(name, [])
                out[name]["breaker"] = self._breakers[name].state
                out[name]["replay_pending"] = sum(1 for e in buf if not e.acked)
                out[name]["replay_retained"] = len(buf)
                out[name]["transport"] = dict(cell.transport_counts)
        if self._transport is not None:
            out["_resilience"] = {
                **{
                    k: (h.value if k == "backoff_s" else int(h.value))
                    for k, h in self._m_res.items()
                },
                "transport": {
                    "sends": self._transport.sends,
                    **self._transport.counters,
                },
            }
        return out

    def close(self) -> None:
        """Release every cell's background resources."""
        for cell in self._cells.values():
            cell.close()

    def __enter__(self) -> "ClusterRouter":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()
