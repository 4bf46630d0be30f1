"""StreamingPipeline: many tenants' ingest→publish→serve as one object.

The paper's model is a single continuous loop — sites stream rows, the
coordinator maintains a sketch, queries are answered at any time.  The
pipeline owns the whole lifecycle for a fleet of tenants.  Ported so far:
matrix tracking (paper Section 5) and leverage-score row sampling
(Boutsidis--Woodruff--Zhong) tenants::

    pipeline = StreamingPipeline(m=8, eps=0.02, policy=EveryKSteps(4))
    pipeline.add_tenant("run-a", d=1024)                     # matrix
    pipeline.add_leverage_tenant("rowspace", d=1024, engine="shard")

    pipeline.ingest("run-a", rows)         # super-step + policy publish
    pipeline.ingest("rowspace", rows)      # (n, d) rows, like matrix
    t = pipeline.submit("run-a", x, deadline_s=0.005)
    s = pipeline.submit("rowspace", subspace_query(x))
    pipeline.flush()                       # packed sweep
    estimate, bound, version = t.result()

It is the reference's ``runtime/pipeline.py`` with ``m`` and ``device``
where the reference takes a mesh: the m sites of every tenant are the
site axis of one device, ``None`` meaning the CUDA card (pass
``device="cpu"`` for the plain PyTorch versions of the kernels).

Ingest drives the tenant's protocol one super-step and asks its
``PublishPolicy`` whether the live state drifted enough to become a new
immutable ``SketchStore`` version (matrix tenants publish their sketch B,
leverage tenants their [row | score | weight] sample).  Queries are
admitted through a ``PackedQueryService`` under per-tenant
``TenantQuota``s: overflow is shed with a typed error, and each dispatch
sweep packs tenants in priority order — matrix batches that share (l, d)
ride one packed quadform launch, leverage subspace/score queries ride
weighted quadform / levscore sweeps.  Deadlines are held either
cooperatively (every ``ingest`` pumps ``poll()``) or by a ``ServicePump``
background thread the pipeline owns — pass ``pump_interval_s`` (or call
``start_pump``); ``close()`` (or the context manager) stops it.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: heavy-hitter and quantile tenants and their lookups
(item 8), windowed tenants (item 10), packed multi-tenant ingest
``ingest_many`` (item 9), and checkpoints ``save``/``load``/
``export_tenant``/``import_tenant``/``read_tenant_export`` (item 7).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.obs import Observability, rehome_families
from repro_torch.query import QueryEngine, SketchStore
from repro_torch.query.service import PackedQueryService, QueryTicket, ServicePump
from repro_torch.runtime.policies import EveryKSteps, PublishPolicy, TenantQuota

__all__ = ["StreamingPipeline", "TenantStats"]


def _not_ported(what: str, item: int):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, open item {item})"
    )


class TenantStats(NamedTuple):
    """One tenant's lifetime pipeline counters."""

    tenant: str
    steps: int  # ingest super-steps absorbed
    rows: int  # stream rows absorbed
    publishes: int  # snapshots auto- or force-published
    latest_version: int | None
    live_frob: float  # live stream-mass estimate ||A||_F^2
    comm_total: int  # protocol messages spent (paper units)
    workload: str = "matrix"  # "matrix" | "leverage"


class _MatrixAdapter:
    """Uniform ingest/publish face over a ``DistributedMatrixTracker``."""

    workload = "matrix"

    def __init__(self, tracker):
        self.tracker = tracker

    def ingest(self, rows, ts: float | None = None) -> None:
        """Advance the tracker one super-step on an (n, d) row batch."""
        if ts is not None:
            raise ValueError(
                "matrix tenants are full-stream: timestamps only apply to "
                "windowed tenants (add_windowed_tenant)"
            )
        self.tracker.update(rows)

    def live_mass(self) -> float:
        """Live ``||A||_F^2`` estimate (what publish policies read)."""
        return self.tracker.frob_estimate()

    def publish(self, store, tenant: str, meta: dict, published_at: float = 0.0):
        """Publish the coordinator sketch B as the tenant's next version."""
        return self.tracker.publish(store, tenant, meta=meta, published_at=published_at)

    def check_query(self, x: np.ndarray) -> None:
        """Reject wrong-shape queries at the submitter (see pipeline.submit)."""
        d = self.tracker.cfg.d
        if x.shape != (d,):
            raise ValueError(f"matrix tenants take a ({d},) direction, got shape {x.shape}")

    def rows(self) -> int:
        """Stream rows absorbed so far."""
        return self.tracker.rows_fed

    def comm_report(self):
        """Protocol messages spent, in the paper's units."""
        return self.tracker.comm_report()

    @property
    def target(self):
        """The wrapped tracker (what ``pipeline.tracker()`` returns)."""
        return self.tracker


class _RegistryAdapter:
    """Uniform ingest/publish face over a registry protocol.

    Everything a registered ``(kind, engine, name)`` protocol exposes is
    uniform — ``step``/``total_weight``/``snapshot_matrix`` — so this one
    adapter serves every non-matrix kind; subclasses only pin ``workload``
    and the per-kind query shape.
    """

    workload = ""  # set by subclasses; also the snapshot meta tag

    def __init__(self, proto):
        self.proto = proto

    def ingest(self, rows, ts: float | None = None) -> None:
        """Advance the protocol one step on an ingest batch."""
        if ts is not None:
            raise ValueError(
                f"{self.workload} tenants are full-stream: timestamps only "
                "apply to windowed tenants (add_windowed_tenant)"
            )
        self.proto.step(rows)

    def live_mass(self) -> float:
        """Live stream-mass estimate (what publish policies read)."""
        return self.proto.total_weight()

    def check_query(self, x: np.ndarray) -> None:
        """Reject wrong-shape queries at the submitter (see pipeline.submit)."""
        raise NotImplementedError

    def publish(self, store, tenant: str, meta: dict, published_at: float = 0.0):
        """Publish the encoded snapshot table as the tenant's next version."""
        md = {
            "workload": self.workload,
            "protocol": self.proto.name,
            "engine": self.proto.engine,
            "m": self.proto.m,
        }
        md.update(meta)
        return store.publish(
            tenant,
            self.proto.snapshot_matrix(),
            frob=self.proto.total_weight(),
            eps=self.proto.eps,
            n_seen=self.proto.rows_seen,
            meta=md,
            published_at=published_at,
        )

    def rows(self) -> int:
        """Stream rows absorbed so far."""
        return self.proto.rows_seen

    def comm_report(self):
        """Protocol messages spent, in the paper's units."""
        return self.proto.comm_report()

    @property
    def target(self):
        """The wrapped protocol (what ``pipeline.tracker()`` returns)."""
        return self.proto


class _LeverageAdapter(_RegistryAdapter):
    """Registry adapter for ``LeverageProtocol`` tenants."""

    workload = "leverage"

    def check_query(self, x: np.ndarray) -> None:
        """Reject wrong-shape queries at the submitter (see pipeline.submit)."""
        from repro_torch.core.leverage import QUERY_SCORE, QUERY_SUBSPACE

        d = self.proto.d
        if x.shape != (d + 1,):
            raise ValueError(
                f"leverage tenants take a ({d + 1},) [mode, x] query, got "
                f"shape {x.shape} (use core.leverage.subspace_query / "
                "score_query)"
            )
        if x[0] not in (QUERY_SUBSPACE, QUERY_SCORE):
            raise ValueError(
                f"leverage query mode must be {QUERY_SUBSPACE} (subspace) or "
                f"{QUERY_SCORE} (score), got {x[0]}"
            )

    def publish(self, store, tenant: str, meta: dict, published_at: float = 0.0):
        """Publish the sample table, pinning the live ridge in the metadata."""
        return super().publish(
            store,
            tenant,
            {"lam": self.proto.lam(), "d": self.proto.d, **meta},
            published_at=published_at,
        )


class _Tenant:
    __slots__ = ("adapter", "policy", "quota", "steps", "steps_since_publish",
                 "publishes", "published_frob", "latest_version", "metrics")

    def __init__(self, adapter, policy: PublishPolicy, quota: TenantQuota | None):
        self.adapter = adapter
        self.policy = policy
        self.quota = quota
        self.steps = 0
        self.steps_since_publish = 0
        self.publishes = 0
        self.published_frob: float | None = None
        self.latest_version: int | None = None
        # Per-tenant gauge handles (f_hat / version / lag), cached here so
        # the hot ingest path never re-resolves labeled series.
        self.metrics: dict = {}


class StreamingPipeline:
    """Owns trackers, store, engine, and packed service for many tenants."""

    # Ingest-side counters (see stats() with no tenant): every one is
    # lifetime-cumulative; ingest_s is wall time inside protocol steps,
    # excluding publishes and query pumping.  Stored as
    # ``repro_ingest_<key>_total`` counters in the obs registry (ingest_s as
    # ``repro_ingest_seconds_total``).  The reference's packed-ingest and
    # late-row counters arrive with packed ingest and windows.
    _INGEST_KEYS = (
        ("rows", "Real stream rows / weighted items absorbed."),
        ("batches", "Ingest batches absorbed (serial + packed slices)."),
        ("serial_steps", "Per-tenant serial protocol steps."),
        ("ingest_s", "Wall time inside protocol steps."),
    )

    _FAMILIES = tuple(
        ("counter",
         f"repro_ingest_{'seconds' if k == 'ingest_s' else k}_total", h)
        for k, h in _INGEST_KEYS
    ) + (
        ("counter", "repro_publish_total", "Snapshots published to the store."),
        ("counter", "repro_publish_seconds_total", "Wall time spent publishing."),
        ("histogram", "repro_publish_latency_seconds", "Publish latency per snapshot."),
        ("gauge", "repro_tenant_f_hat", "Published Frobenius mass per tenant."),
        ("gauge", "repro_tenant_version", "Latest published store version per tenant."),
        ("gauge", "repro_tenant_publish_lag_steps", "Ingest steps since the tenant last published."),
        ("gauge", "repro_comm_scalar_msgs", "Protocol communication accounting (paper units)."),
        ("gauge", "repro_comm_row_msgs", "Protocol communication accounting (paper units)."),
        ("gauge", "repro_comm_broadcast_events", "Protocol communication accounting (paper units)."),
        ("gauge", "repro_comm_m", "Protocol communication accounting (paper units)."),
        ("gauge", "repro_comm_total", "Protocol communication accounting (paper units)."),
    )

    def __init__(
        self,
        m: int,
        *,
        eps: float = 0.1,
        protocol: str = "P2",
        policy: PublishPolicy | None = None,
        store: SketchStore | None = None,
        retain: int = 0,
        max_batch: int = 1024,
        default_deadline_s: float = 0.02,
        pump_interval_s: float | None = None,
        obs: Observability | None = None,
        device=None,
    ):
        if m < 1:
            raise ValueError(f"a pipeline needs m >= 1 sites, got {m}")
        self.m = m
        self.device = resolve_device(device)
        self.default_eps = eps
        self.default_protocol = protocol
        self.default_policy = policy if policy is not None else EveryKSteps(1)
        self.store = store if store is not None else SketchStore(retain=retain)
        self.obs = obs if obs is not None else Observability()
        self.engine = QueryEngine(self.store, device=self.device, obs=self.obs)
        self.service = PackedQueryService(
            self.engine, max_batch=max_batch, default_deadline_s=default_deadline_s,
            obs=self.obs,
        )
        self._tenants: dict[str, _Tenant] = {}
        self._bind_metrics()
        # Deadline executor: None means cooperative pumping (every ingest
        # calls service.poll()); an interval starts a ServicePump thread
        # the pipeline owns, and ingest stops pumping cooperatively.
        self.pump: ServicePump | None = None
        if pump_interval_s is not None:
            self.start_pump(pump_interval_s)

    # -- telemetry binding ----------------------------------------------------

    def _bind_metrics(self) -> None:
        self._m_ingest = {
            k: self.obs.handle(
                "counter",
                f"repro_ingest_{'seconds' if k == 'ingest_s' else k}_total", h,
            )
            for k, h in self._INGEST_KEYS
        }
        self._m_publish = self.obs.handle(
            "counter", "repro_publish_total", "Snapshots published to the store.")
        self._m_publish_s = self.obs.handle(
            "counter", "repro_publish_seconds_total", "Wall time spent publishing.")
        self._m_publish_latency = self.obs.handle(
            "histogram", "repro_publish_latency_seconds",
            "Publish latency per snapshot.")
        for name, t in self._tenants.items():
            t.metrics = self._tenant_gauges(name)

    def _tenant_gauges(self, tenant: str) -> dict:
        labels = {"tenant": tenant}
        return {
            "f_hat": self.obs.handle(
                "gauge", "repro_tenant_f_hat",
                "Published Frobenius mass per tenant.", labels=labels),
            "version": self.obs.handle(
                "gauge", "repro_tenant_version",
                "Latest published store version per tenant.", labels=labels),
            "lag": self.obs.handle(
                "gauge", "repro_tenant_publish_lag_steps",
                "Ingest steps since the tenant last published.", labels=labels),
        }

    def bind_obs(self, obs: Observability) -> None:
        """Re-home the whole serving stack's telemetry into ``obs``.

        Carries pipeline, engine, and service families (values merged, old
        series dropped on a same-registry relabel) and re-fetches every
        cached handle — including the per-tenant gauges — under the new
        bundle's base labels.
        """
        old, self.obs = self.obs, obs
        rehome_families(old, obs, self._FAMILIES)
        self._bind_metrics()
        self.engine.bind_obs(obs)
        self.service.bind_obs(obs)

    # -- deadline executor lifecycle ------------------------------------------

    def start_pump(self, interval_s: float = 0.001) -> ServicePump:
        """Start (or restart) the background deadline executor.

        While a pump runs, per-entry deadlines hold with no cooperative
        ``poll()`` calls from the ingest loop — ``ingest`` stops pumping.
        """
        if self.pump is not None:
            self.pump.stop()
        self.pump = ServicePump(self.service, interval_s=interval_s)
        return self.pump.start()

    def stop_pump(self) -> None:
        """Stop the background deadline executor (cooperative pumping resumes)."""
        pump, self.pump = self.pump, None
        if pump is not None:
            pump.stop()

    def close(self) -> None:
        """Release background resources (stops the pump thread if running)."""
        self.stop_pump()

    def __enter__(self) -> "StreamingPipeline":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- tenant lifecycle ----------------------------------------------------

    def _register(self, tenant: str, adapter, policy, quota) -> None:
        t = _Tenant(adapter, policy or self.default_policy, quota)
        t.metrics = self._tenant_gauges(tenant)
        self._tenants[tenant] = t
        if quota is not None:
            self.service.set_quota(
                tenant, max_pending=quota.max_pending, priority=quota.priority
            )

    def add_tenant(
        self,
        tenant: str,
        d: int,
        *,
        eps: float | None = None,
        protocol: str | None = None,
        policy: PublishPolicy | None = None,
        quota: TenantQuota | None = None,
    ):
        """Register a matrix-tracking tenant stream; returns its tracker."""
        from repro_torch.core.tracker import DistributedMatrixTracker

        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} already registered")
        tracker = DistributedMatrixTracker(
            self.m,
            d,
            eps=self.default_eps if eps is None else eps,
            protocol=self.default_protocol if protocol is None else protocol,
            device=self.device,
        )
        self._register(tenant, _MatrixAdapter(tracker), policy, quota)
        return tracker

    def add_leverage_tenant(
        self,
        tenant: str,
        d: int,
        *,
        eps: float | None = None,
        protocol: str = "P1",
        engine: str = "event",
        policy: PublishPolicy | None = None,
        quota: TenantQuota | None = None,
        **kw,
    ):
        """Register a leverage-score row-sampling tenant; returns its protocol.

        ``engine="event"`` runs the paper-style simulator in-process;
        ``engine="shard"`` runs the threshold-forwarding super-step engine
        with its sites on the pipeline's device.  ``m`` defaults to the
        pipeline's (pass ``m=...`` to override).  Extra ``kw`` pass
        through to the registered protocol factory — event P1 takes
        ``l``/``s``/``seed``, event P2 ``s``/``seed``, the shard engine
        ``lev_cap``/``l_site``/``l_coord``.
        """
        from repro_torch.runtime.registry import create_protocol

        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} already registered")
        if engine not in ("event", "shard"):
            raise ValueError(
                f"unknown leverage engine {engine!r}; choose 'event' or 'shard'"
            )
        eps = self.default_eps if eps is None else eps
        kw.setdefault("m", self.m)
        proto = create_protocol(
            protocol, engine=engine, kind="leverage", d=d, eps=eps, device=self.device, **kw,
        )
        self._register(tenant, _LeverageAdapter(proto), policy, quota)
        return proto

    def add_hh_tenant(self, tenant: str, **kw):
        """Heavy-hitter tenants wait for the heavy-hitter kind."""
        _not_ported("add_hh_tenant (heavy-hitter tenants)", 8)

    def add_quantile_tenant(self, tenant: str, **kw):
        """Quantile tenants wait for the quantile kind."""
        _not_ported("add_quantile_tenant (quantile tenants)", 8)

    def add_windowed_tenant(self, tenant: str, **kw):
        """Windowed tenants wait for the window layer."""
        _not_ported("add_windowed_tenant (windowed tenants)", 10)

    def export_tenant(self, tenant: str) -> dict:
        """Tenant export rides the checkpoint format."""
        _not_ported("export_tenant", 7)

    def import_tenant(self, payload: dict) -> None:
        """Tenant import rides the checkpoint format."""
        _not_ported("import_tenant", 7)

    @staticmethod
    def read_tenant_export(directory: str, tenant: str, *, step: int | None = None) -> dict:
        """Tenant export from a checkpoint rides the checkpoint format."""
        _not_ported("read_tenant_export", 7)

    def remove_tenant(self, tenant: str) -> None:
        """Deregister a tenant and drop its published versions.

        Refuses while queries are pending (flush first); the quota entry
        is cleared so a later re-add starts clean.
        """
        self._tenant(tenant)  # raise KeyError with the registered list
        if self.service.pending(tenant):
            raise RuntimeError(
                f"tenant {tenant!r} has {self.service.pending(tenant)} queries "
                "pending; flush() before removing"
            )
        del self._tenants[tenant]
        self.service.clear_quota(tenant)
        self.store.drop_tenant(tenant)

    def tenants(self) -> list[str]:
        """Registered tenant names (sorted)."""
        return sorted(self._tenants)

    def workload(self, tenant: str) -> str:
        """The tenant's workload kind (``"matrix"`` or ``"leverage"``)."""
        return self._tenant(tenant).adapter.workload

    def tracker(self, tenant: str):
        """The tenant's underlying protocol object (tracker or protocol)."""
        return self._tenant(tenant).adapter.target

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        """Set or replace a tenant's admission quota / dispatch priority."""
        t = self._tenant(tenant)
        t.quota = quota
        self.service.set_quota(
            tenant, max_pending=quota.max_pending, priority=quota.priority
        )

    def _tenant(self, tenant: str) -> _Tenant:
        try:
            return self._tenants[tenant]
        except KeyError:
            raise KeyError(
                f"unknown tenant {tenant!r} (registered: {self.tenants()})"
            ) from None

    # -- ingest → publish ----------------------------------------------------

    def ingest(self, tenant: str, rows, ts: float | None = None):
        """Absorb one super-step batch; auto-publish per the tenant's policy.

        Matrix and leverage tenants take an (n, d) row batch (numpy or a
        tensor; a tensor on the pipeline's device is never copied through
        the host).  ``ts`` belongs to windowed tenants and is refused here.
        Returns the new ``SketchSnapshot`` if the policy fired, else None.
        When no ``ServicePump`` is running this also pumps the packed
        service's deadlines cooperatively, so a pure ingest loop still
        serves queries on time.  A pump that died on an exception is
        detected here and surfaced as ``ServicePumpError``.
        """
        t = self._tenant(tenant)
        with self.obs.trace("pipeline.ingest", tenant=tenant):
            t0 = self.obs.clock()
            t.adapter.ingest(rows, ts=ts)
            self._m_ingest["ingest_s"].inc(self.obs.clock() - t0)
            self._m_ingest["serial_steps"].inc()
            self._m_ingest["batches"].inc()
            self._m_ingest["rows"].inc(len(rows))
            snap = self._post_ingest(tenant, t)
        self._pump_or_poll()
        return snap

    def ingest_many(self, batches, *, packed: bool = True) -> int:
        """Packed multi-tenant ingest waits for the packed runner."""
        _not_ported("ingest_many (packed multi-tenant ingest)", 9)

    def _post_ingest(self, tenant: str, t: _Tenant):
        """Per-batch bookkeeping: advance the step counters and publish if
        the tenant's policy fires.  Returns the new snapshot or None."""
        t.steps += 1
        t.steps_since_publish += 1
        t.metrics["lag"].set(t.steps_since_publish)
        # Only pay for the mass estimate when the policy reads it.
        live = t.adapter.live_mass() if t.policy.needs_live_frob else 0.0
        if t.policy.should_publish(
            steps_since_publish=t.steps_since_publish,
            live_frob=live,
            published_frob=t.published_frob,
        ):
            return self._publish(tenant, t)
        return None

    def _pump_or_poll(self) -> None:
        """Pump deadlines cooperatively unless a live executor owns them."""
        if self.pump is None:
            self.service.poll()
        elif not self.pump.running:
            # The executor died or was stopped behind our back: detach it
            # (raising its captured error, if any) and pump cooperatively
            # so deadlines never silently stop being enforced.
            self.stop_pump()
            self.service.poll()

    def publish(self, tenant: str):
        """Force-publish a tenant's live state now (OnDemand's trigger)."""
        return self._publish(tenant, self._tenant(tenant))

    def _publish(self, tenant: str, t: _Tenant):
        with self.obs.trace("pipeline.publish", tenant=tenant):
            t0 = self.obs.clock()
            snap = t.adapter.publish(
                self.store, tenant, meta={"step": t.steps},
                published_at=float(self.obs.clock()),
            )
            elapsed = self.obs.clock() - t0
        self._m_publish.inc()
        self._m_publish_s.inc(elapsed)
        self._m_publish_latency.observe(elapsed)
        t.steps_since_publish = 0
        t.publishes += 1
        t.published_frob = snap.frob
        t.latest_version = snap.version
        t.metrics["f_hat"].set(snap.frob)
        t.metrics["version"].set(snap.version)
        t.metrics["lag"].set(0)
        t.adapter.comm_report().emit(
            self.obs.registry, **{**self.obs.labels, "tenant": tenant}
        )
        return snap

    # -- serve ---------------------------------------------------------------

    def submit(self, tenant: str, x, *, deadline_s: float | None = None) -> QueryTicket:
        """Admit one query for a tenant into the packed service.

        Matrix tenants take a (d,) direction; leverage tenants a (d+1,)
        [mode, x] row (see ``core.leverage.subspace_query`` /
        ``score_query``).  The tenant must have at least one published
        snapshot, and ``x`` must match the tenant's workload shape:
        admitting a query nothing can answer would poison every later
        packed flush (the service keeps failing batches pending by
        design).  Fail at the submitter instead.  Raises
        ``QueryShedError`` when the tenant's quota is full.
        """
        t = self._tenant(tenant)
        if t.latest_version is None and tenant not in self.store.tenants():
            raise KeyError(
                f"tenant {tenant!r} has no published snapshot yet — ingest "
                "until its policy fires, or call publish()"
            )
        x = np.asarray(x, np.float32)
        t.adapter.check_query(x)
        return self.service.submit(x, tenant=tenant, deadline_s=deadline_s)

    def poll(self) -> int:
        """Deadline pump; returns queries served by a deadline-forced sweep."""
        return self.service.poll()

    def flush(self) -> int:
        """Serve everything pending in capped priority-ordered sweeps."""
        return self.service.flush()

    def heavy_hitters(self, tenant: str, phi: float, *, version: int | None = None):
        """Heavy-hitter sets wait for the heavy-hitter kind."""
        _not_ported("heavy_hitters", 8)

    def quantiles(self, tenant: str, phis, *, version: int | None = None):
        """Quantile lookups wait for the quantile kind."""
        _not_ported("quantiles", 8)

    def sampled_rows(
        self, tenant: str, *, version: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The published leverage sample as ``(rows, scores, weights)``.

        Reads the pinned store version — the same [row | score | weight]
        table packed subspace/score queries are answered from.
        """
        from repro_torch.core.leverage import decode_leverage_snapshot

        snap = self.store.get(tenant, version)
        if snap.meta.get("workload") != "leverage":
            raise ValueError(f"tenant {tenant!r} is not a leverage tenant")
        return decode_leverage_snapshot(snap.matrix)

    # -- persistence / accounting -------------------------------------------

    def save(self, directory: str, *, step: int = 0, attachments: dict | None = None) -> str:
        """Pipeline checkpoints wait for the checkpoint format."""
        _not_ported("StreamingPipeline.save (pipeline checkpoints)", 7)

    @classmethod
    def load(cls, directory: str, m: int, **kw) -> "StreamingPipeline":
        """Pipeline checkpoints wait for the checkpoint format."""
        _not_ported("StreamingPipeline.load (pipeline checkpoints)", 7)

    def publish_latency_s(self) -> float:
        """Total wall time spent publishing (store copies + host sync)."""
        return self._m_publish_s.value

    def stats(self, tenant: str | None = None):
        """Lifetime counters: one tenant's ``TenantStats``, or — with no
        tenant — the pipeline's ingest-side observability dict: the raw
        ingest counters plus ``rows_per_sec`` (real rows over ingest wall
        time) and ``shrink_launches`` (protocol super-steps dispatched).
        """
        if tenant is None:
            # A fresh view over the obs registry (ints stay ints).
            c = {
                k: (h.value if k == "ingest_s" else int(h.value))
                for k, h in self._m_ingest.items()
            }
            c["rows_per_sec"] = (
                c["rows"] / c["ingest_s"] if c["ingest_s"] > 0 else 0.0
            )
            c["shrink_launches"] = c["serial_steps"]
            return c
        t = self._tenant(tenant)
        return TenantStats(
            tenant=tenant,
            steps=t.steps,
            rows=t.adapter.rows(),
            publishes=t.publishes,
            latest_version=t.latest_version,
            live_frob=t.adapter.live_mass(),
            comm_total=t.adapter.comm_report().total,
            workload=t.adapter.workload,
        )
