"""StreamingPipeline: many tenants' ingest→publish→serve as one object.

The paper's model is a single continuous loop — sites stream rows, the
coordinator maintains a sketch, queries are answered at any time.  The
pipeline owns the whole lifecycle for a fleet of tenants, and a tenant may
be any workload kind in the registry: matrix tracking (paper Section 5),
weighted heavy hitters (Section 4), distributed quantiles (Yi--Zhang), or
leverage-score row sampling (Boutsidis--Woodruff--Zhong)::

    pipeline = StreamingPipeline(m=8, eps=0.02, policy=EveryKSteps(4))
    pipeline.add_tenant("run-a", d=1024)                     # matrix
    pipeline.add_hh_tenant("clicks", eps=0.05, engine="shard")
    pipeline.add_quantile_tenant("latency", eps=0.02, engine="shard")
    pipeline.add_leverage_tenant("rowspace", d=1024, engine="shard")

    pipeline.ingest("run-a", rows)         # super-step + policy publish
    pipeline.ingest("clicks", pairs)       # (n, 2) [element, weight] rows
    pipeline.ingest("latency", samples)    # (n, 2) [value, weight] rows
    pipeline.ingest("rowspace", rows)      # (n, d) rows, like matrix
    t = pipeline.submit("run-a", x, deadline_s=0.005)
    e = pipeline.submit("clicks", np.array([element_id], np.float32))
    q = pipeline.submit("latency", quantile_query(0.99))
    s = pipeline.submit("rowspace", subspace_query(x))
    pipeline.flush()                       # packed sweep
    estimate, bound, version = t.result()

It is the reference's ``runtime/pipeline.py`` with ``m`` and ``device``
where the reference takes a mesh: the m sites of every super-step tenant
are the site axis of one device, ``None`` meaning the CUDA card (pass
``device="cpu"`` for the plain PyTorch versions of the kernels).  The event
engines are host simulators, as in the reference.

Ingest drives the tenant's protocol one super-step and asks its
``PublishPolicy`` whether the live state drifted enough to become a new
immutable ``SketchStore`` version (matrix tenants publish their sketch B,
HH tenants their encoded estimate table, quantile tenants their sorted
[value, rank] table, leverage tenants their [row | score | weight]
sample).  Queries are admitted through a ``PackedQueryService`` under
per-tenant ``TenantQuota``s: overflow is shed with a typed error, and each
dispatch sweep packs tenants in priority order — matrix batches that share
(l, d) ride one packed quadform launch, HH and quantile lookups ride the
same sweep without a kernel, leverage subspace/score queries ride weighted
quadform / levscore sweeps.  Deadlines are held either cooperatively
(every ``ingest`` pumps ``poll()``) or by a ``ServicePump`` background
thread the pipeline owns — pass ``pump_interval_s`` (or call
``start_pump``); ``close()`` (or the context manager) stops it.

``ingest_many`` drives many tenants in waves: same-config super-step
tenants of the row-input kinds advance together in one stacked step
(``runtime.ingest_packed``); HH and quantile tenants step serially, as in
the reference.  ``save``/``load`` persist the *whole* pipeline — published
store versions and every tenant's live protocol state — through
``repro_torch.ckpt`` in the reference's format, so a restarted coordinator
resumes ingest mid-stream and answers identically, and each package loads
the other's checkpoints; ``export_tenant``/``import_tenant`` move one
tenant.

Not ported yet: windowed tenants, which raise ``NotImplementedError``
naming their ROADMAP item (10).
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.obs import Observability, rehome_families
from repro_torch.query import QueryEngine, SketchStore
from repro_torch.query.service import PackedQueryService, QueryTicket, ServicePump
from repro_torch.runtime.policies import (
    EveryKSteps,
    PublishPolicy,
    TenantQuota,
    policy_from_config,
    policy_to_config,
)

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
    workload: str = "matrix"  # "matrix" | "hh" | "quantile" | "leverage"


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

    def state_payload(self):
        """Live protocol state as ``(arrays, meta)`` checkpoint halves."""
        return self.tracker.state_payload()

    def restore_payload(self, arrays, meta) -> None:
        """Restore a ``state_payload`` capture bit-identically."""
        self.tracker.restore_payload(arrays, meta)

    def ctor_meta(self) -> dict:
        """Construction parameters ``load`` needs to rebuild the tenant."""
        cfg = self.tracker.cfg
        return {"protocol": self.tracker.protocol, "d": cfg.d, "eps": cfg.eps}

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

    def __init__(self, proto, ctor_kw: dict):
        self.proto = proto
        self._ctor_kw = ctor_kw

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

    def state_payload(self):
        """Live protocol state as ``(arrays, meta)`` checkpoint halves."""
        return self.proto.state_payload()

    def restore_payload(self, arrays, meta) -> None:
        """Restore a ``state_payload`` capture bit-identically."""
        self.proto.restore_payload(arrays, meta)

    def ctor_meta(self) -> dict:
        """Construction parameters ``load`` needs to rebuild the tenant."""
        return {
            "protocol": self.proto.name,
            "engine": self.proto.engine,
            "eps": self.proto.eps,
            "kw": dict(self._ctor_kw),
        }

    @property
    def target(self):
        """The wrapped protocol (what ``pipeline.tracker()`` returns)."""
        return self.proto


class _HHAdapter(_RegistryAdapter):
    """Registry adapter for ``HHProtocol`` tenants."""

    workload = "hh"

    def check_query(self, x: np.ndarray) -> None:
        """Reject wrong-shape queries at the submitter (see pipeline.submit)."""
        if x.shape != (1,):
            raise ValueError(
                f"HH tenants take a (1,) element id, got shape {x.shape}"
            )


class _QuantileAdapter(_RegistryAdapter):
    """Registry adapter for ``QuantileProtocol`` tenants."""

    workload = "quantile"

    def check_query(self, x: np.ndarray) -> None:
        """Reject wrong-shape queries at the submitter (see pipeline.submit)."""
        from repro_torch.core.quantiles import QUERY_QUANTILE, QUERY_RANK

        if x.shape != (2,):
            raise ValueError(
                f"quantile tenants take a (2,) [mode, arg] query, got shape "
                f"{x.shape} (use core.quantiles.rank_query / quantile_query)"
            )
        if x[0] not in (QUERY_RANK, QUERY_QUANTILE):
            raise ValueError(
                f"quantile query mode must be {QUERY_RANK} (rank) or "
                f"{QUERY_QUANTILE} (phi-quantile), got {x[0]}"
            )


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

    def ctor_meta(self) -> dict:
        """Construction parameters ``load`` needs to rebuild the tenant."""
        return {**super().ctor_meta(), "d": self.proto.d}


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
    # lifetime-cumulative; ingest_s is wall time inside protocol steps
    # (packed launches + serial steps), excluding publishes and query
    # pumping.  Stored as ``repro_ingest_<key>_total`` counters in the obs
    # registry (ingest_s as ``repro_ingest_seconds_total``).  The
    # reference's late-row counter arrives with windows.
    _INGEST_KEYS = (
        ("rows", "Real stream rows / weighted items absorbed."),
        ("batches", "Ingest batches absorbed (serial + packed slices)."),
        ("waves", "ingest_many waves driven."),
        ("packed_launches", "Stacked super-step launches."),
        ("packed_tenants", "Tenant-batches that rode a packed launch."),
        ("packed_rows", "Real rows absorbed via packed launches."),
        ("pad_rows", "Zero-filled slots added while packing."),
        ("serial_steps", "Per-tenant serial protocol steps."),
        ("retraces", "Packed launch shapes seen for the first time."),
        # restacks: packed launches that could not reuse a resident stacked
        # state (first wave of a group, or a member stepped / restored out
        # of band since the last wave).
        ("restacks", "Packed launches that had to restack member states."),
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
        # The recorded kw is what ``load`` passes back, as the reference
        # records it: the event engine's m, not the super-step engine's
        # (whose m is the pipeline's, as the reference's is its mesh's).
        kw = dict(kw)
        if engine == "event":
            kw.setdefault("m", self.m)
        proto = create_protocol(
            protocol, engine=engine, kind="leverage", d=d, eps=eps, device=self.device,
            **{"m": self.m, **kw},
        )
        self._register(tenant, _LeverageAdapter(proto, kw), policy, quota)
        return proto

    def _add_pair_tenant(self, tenant: str, kind: str, adapter_cls, eps, protocol, engine,
                         policy, quota, kw):
        """Register an HH or quantile tenant (the two pair-input kinds)."""
        from repro_torch.runtime.registry import create_protocol

        if tenant in self._tenants:
            raise ValueError(f"tenant {tenant!r} already registered")
        if engine not in ("event", "shard"):
            what = "HH" if kind == "hh" else kind
            raise ValueError(f"unknown {what} engine {engine!r}; choose 'event' or 'shard'")
        eps = self.default_eps if eps is None else eps
        # The recorded kw is what ``load`` passes back, as the reference
        # records it: the event engine's m, not the super-step engine's.
        kw = dict(kw)
        if engine == "shard":
            proto = create_protocol(protocol, engine="shard", kind=kind, m=self.m, eps=eps,
                                    device=self.device, **kw)
        else:
            kw.setdefault("m", self.m)
            proto = create_protocol(protocol, engine="event", kind=kind, eps=eps, **kw)
        self._register(tenant, adapter_cls(proto, kw), policy, quota)
        return proto

    def add_hh_tenant(
        self,
        tenant: str,
        *,
        eps: float | None = None,
        protocol: str = "P1",
        engine: str = "event",
        policy: PublishPolicy | None = None,
        quota: TenantQuota | None = None,
        **kw,
    ):
        """Register a weighted heavy-hitter tenant; returns its protocol.

        ``engine="event"`` runs the paper-exact simulator on the host (``m``
        defaults to the pipeline's; pass ``m=...`` to override);
        ``engine="shard"`` runs the MG-merge super-step engine with its
        sites on the pipeline's device.  Extra ``kw`` (``k``, ``s``,
        ``seed``) pass through to the registered protocol factory and are
        recorded so ``load`` rebuilds the tenant identically.
        """
        return self._add_pair_tenant(tenant, "hh", _HHAdapter, eps, protocol, engine, policy,
                                     quota, kw)

    def add_quantile_tenant(
        self,
        tenant: str,
        *,
        eps: float | None = None,
        protocol: str = "P1",
        engine: str = "event",
        policy: PublishPolicy | None = None,
        quota: TenantQuota | None = None,
        **kw,
    ):
        """Register a distributed-quantile tenant; returns its protocol.

        ``engine="event"`` runs the paper-style simulator on the host (``m``
        defaults to the pipeline's; pass ``m=...`` to override);
        ``engine="shard"`` runs the summary-merge super-step engine with its
        sites on the pipeline's device.  Extra ``kw`` (``s``, ``q_cap``,
        ``seed``) pass through to the registered protocol factory and are
        recorded so ``load`` rebuilds the tenant identically.
        """
        return self._add_pair_tenant(tenant, "quantile", _QuantileAdapter, eps, protocol,
                                     engine, policy, quota, kw)

    def add_windowed_tenant(self, tenant: str, **kw):
        """Windowed tenants wait for the window layer."""
        _not_ported("add_windowed_tenant (windowed tenants)", 10)

    def _add_from_ctor(
        self,
        tenant: str,
        workload: str,
        ctor: dict,
        policy: PublishPolicy | None,
        quota: TenantQuota | None,
    ) -> None:
        """Rebuild one tenant from its recorded ``ctor_meta`` (load/import)."""
        if workload in ("hh", "quantile"):
            add = self.add_hh_tenant if workload == "hh" else self.add_quantile_tenant
            add(
                tenant,
                eps=float(ctor["eps"]),
                protocol=str(ctor["protocol"]),
                engine=str(ctor["engine"]),
                policy=policy,
                quota=quota,
                **ctor["kw"],
            )
        elif workload == "leverage":
            self.add_leverage_tenant(
                tenant,
                int(ctor["d"]),
                eps=float(ctor["eps"]),
                protocol=str(ctor["protocol"]),
                engine=str(ctor["engine"]),
                policy=policy,
                quota=quota,
                **ctor["kw"],
            )
        elif workload == "matrix":
            self.add_tenant(
                tenant,
                int(ctor["d"]),
                eps=float(ctor["eps"]),
                protocol=str(ctor["protocol"]),
                policy=policy,
                quota=quota,
            )
        elif workload == "windowed":
            _not_ported("windowed tenants", 10)
        else:
            raise ValueError(f"unknown tenant workload {workload!r}")

    def _tenant_record(self, t: _Tenant) -> dict:
        """The manifest record of one tenant: recipe, policy, counters."""
        return {
            "workload": t.adapter.workload,
            "ctor": t.adapter.ctor_meta(),
            "policy": policy_to_config(t.policy),
            "quota": None if t.quota is None else list(t.quota),
            "steps": t.steps,
            "steps_since_publish": t.steps_since_publish,
            "publishes": t.publishes,
            "published_frob": t.published_frob,
            "latest_version": t.latest_version,
        }

    def _install_tenant(self, name: str, record: dict, arrays: dict, proto_meta: dict) -> None:
        """Register a tenant from its record and restore its state and counters."""
        policy = policy_from_config(record["policy"])
        quota = None if record["quota"] is None else TenantQuota(*record["quota"])
        self._add_from_ctor(name, record["workload"], record["ctor"], policy, quota)
        t = self._tenants[name]
        t.adapter.restore_payload({k: np.asarray(v) for k, v in arrays.items()}, proto_meta)
        t.steps = int(record["steps"])
        t.steps_since_publish = int(record["steps_since_publish"])
        t.publishes = int(record["publishes"])
        t.published_frob = (
            None if record["published_frob"] is None else float(record["published_frob"])
        )
        t.latest_version = (
            None if record["latest_version"] is None else int(record["latest_version"])
        )

    # -- tenant migration -----------------------------------------------------

    def export_tenant(self, tenant: str) -> dict:
        """Capture one live tenant as a portable payload (cluster rebalance).

        The payload holds everything ``import_tenant`` on *another*
        pipeline needs to continue the tenant bit-identically: the
        construction recipe (``ctor_meta``), live protocol state
        (``state_payload`` — the same halves the checkpoint writes),
        publish policy/quota/counters, and the tenant's published store
        versions (``SketchStore.export_tenant``, version numbers
        preserved).  The tenant must have no queries pending here — a live
        move drains (``flush``) first, because tickets cannot cross
        pipelines.  The tenant stays registered; callers remove it with
        ``remove_tenant`` once the importing side has it.
        """
        t = self._tenant(tenant)
        if self.service.pending(tenant):
            raise RuntimeError(
                f"tenant {tenant!r} has {self.service.pending(tenant)} queries "
                "pending; flush() before exporting"
            )
        arrays, proto_meta = t.adapter.state_payload()
        store_tree, store_extra = self.store.export_tenant(tenant)
        return {
            "format": "tenant-export-v1",
            "tenant": tenant,
            **self._tenant_record(t),
            "proto_meta": proto_meta,
            "arrays": {k: np.asarray(v) for k, v in dict(arrays).items()},
            "store_tree": store_tree,
            "store_extra": store_extra,
        }

    def import_tenant(self, payload: dict) -> None:
        """Install an ``export_tenant`` payload as a live tenant here.

        Restores the protocol state, counters, and published store
        versions bit-identically — answers after the move match answers
        before it, version numbers included.  Raises if the tenant name
        is already registered (or has snapshots) on this pipeline.
        """
        if payload.get("format") != "tenant-export-v1":
            raise ValueError(
                f"not a tenant export payload: format={payload.get('format')!r}"
            )
        name = payload["tenant"]
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        # Store first: import_tenant refuses resident tenants, so a
        # half-applied payload cannot leave a registered tenant whose
        # snapshots never arrived.
        self.store.import_tenant(payload["store_tree"], payload["store_extra"])
        self._install_tenant(name, payload, payload["arrays"], payload["proto_meta"])

    @staticmethod
    def read_tenant_export(directory: str, tenant: str, *, step: int | None = None) -> dict:
        """Build an ``import_tenant`` payload straight from a saved checkpoint.

        Reads only the tenant's leaves (``ckpt.read_subset`` over its
        ``tenant_NNNN__*`` protocol state and the store snapshots whose
        manifest entry names it), so a rebalance from a checkpoint never
        pays for the other tenants' I/O.
        """
        from repro_torch import ckpt

        step, manifest = StreamingPipeline._pipeline_manifest(directory, step)
        extra = manifest["extra"]
        meta = extra["tenants"].get(tenant)
        if meta is None:
            raise KeyError(
                f"tenant {tenant!r} not in checkpoint (has: {sorted(extra['tenants'])})"
            )
        prefix = meta["key"] + "__"
        proto_names = [n for n in manifest["leaves"] if n.startswith(prefix)]
        snap_entries = sorted(
            (e for e in extra["store"]["snapshots"] if e["tenant"] == tenant),
            key=lambda e: e["version"],
        )
        snap_names = [f"store__{e['key']}" for e in snap_entries]
        leaves = ckpt.read_subset(directory, step, proto_names + snap_names)
        # Renumber the snapshot keys from 0, so the payload has the shape a
        # live ``SketchStore.export_tenant`` produces.
        store_tree, renumbered = {}, []
        for i, e in enumerate(snap_entries):
            key = f"snap_{i:05d}"
            store_tree[key] = leaves[f"store__{e['key']}"]
            renumbered.append({**e, "key": key})
        store_extra = {
            "kind": "sketch_store",
            "retain": extra["store"].get("retain", 0),
            "next_version": {tenant: extra["store"]["next_version"].get(tenant, 1)},
            "snapshots": renumbered,
        }
        record = {k: meta[k] for k in (
            "workload", "ctor", "policy", "quota", "steps", "steps_since_publish",
            "publishes", "published_frob", "latest_version", "proto_meta")}
        return {
            "format": "tenant-export-v1",
            "tenant": tenant,
            **record,
            "arrays": {n[len(prefix):]: leaves[n] for n in proto_names},
            "store_tree": store_tree,
            "store_extra": store_extra,
        }

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
        """The tenant's workload kind (``"matrix"``, ``"hh"``, ``"quantile"``
        or ``"leverage"``)."""
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
        the host), HH tenants an (n, 2) [element, weight] batch, quantile
        tenants an (n, 2) [value, weight] batch (or, for both, a ``(keys or
        values, weights)`` pair of 1-D arrays).  ``ts`` belongs to windowed
        tenants and is refused here.
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
            self._m_ingest["rows"].inc(self._batch_len(rows))
            snap = self._post_ingest(tenant, t)
        self._pump_or_poll()
        return snap

    @staticmethod
    def _batch_len(rows) -> int:
        """Items in one ingest batch ((n, ...) array or (keys, weights))."""
        if isinstance(rows, tuple):
            rows = rows[0]
        return int(rows.shape[0]) if hasattr(rows, "shape") else len(rows)

    def ingest_many(self, batches: Iterable[tuple], *, packed: bool = True) -> int:
        """Drive interleaved tenants: ``[(tenant, rows), ...]``; returns the
        number of snapshots published.

        Entries may also be ``(tenant, rows, ts)`` triples; timed batches
        always take the serial per-tenant path (the packed launch has no
        time axis), where full-stream tenants refuse them.

        With ``packed=True`` (the default) the batches are regrouped into
        waves — wave ``i`` holds each tenant's ``i``-th batch — and every
        wave's super-step tenants that share a pack key (same protocol
        config and device; see ``runtime.ingest_packed``) advance in ONE
        stacked super-step instead of one per tenant.  Per-tenant batch
        order is preserved, so each tenant's final state matches the
        serial path to fp tolerance (zero padding is exact for the
        packable protocols); only the cross-tenant interleaving — and so
        the order snapshots publish within a wave — changes.  Deadlines
        are pumped once per wave rather than once per batch.
        ``packed=False`` is the strict one-``ingest``-per-batch loop.
        """
        batches = [tuple(b) if len(b) == 3 else (b[0], b[1], None) for b in batches]
        if not packed:
            return sum(self.ingest(tenant, rows, ts) is not None for tenant, rows, ts in batches)
        per_tenant: dict[str, list] = {}
        for tenant, rows, ts in batches:
            per_tenant.setdefault(tenant, []).append((rows, ts))
        published = 0
        n_waves = max((len(v) for v in per_tenant.values()), default=0)
        for w in range(n_waves):
            wave = [(name, *v[w]) for name, v in per_tenant.items() if w < len(v)]
            published += self._ingest_wave(wave)
        return published

    def _ingest_wave(self, wave: list) -> int:
        """One wave of ``ingest_many``: pack what groups, step the rest.

        Tenants whose adapters expose equal pack signatures (two or more of
        them, untimed shardable batches) ride one ``ingest_packed`` call;
        all others take the serial adapter path.  Publishes fire per tenant
        exactly as serial ingest would; the wave's fresh matrix snapshots
        then warm the query engine's spectrum cache with one batched
        ``refresh_spectra`` pass.
        """
        from repro_torch.runtime.ingest_packed import (
            ingest_packed,
            pack_signature,
            pack_target,
        )

        m = self._m_ingest
        m["waves"].inc()
        groups: dict = {}
        serial: list = []
        for name, rows, ts in wave:
            t = self._tenant(name)
            sig = pack_signature(t.adapter)
            n = self._batch_len(rows)
            if ts is None and sig is not None and n and n % sig[1].m == 0:
                groups.setdefault(sig, []).append((name, t, rows))
            else:
                serial.append((name, t, rows, ts))
        snaps: list = []
        with self.obs.trace("pipeline.ingest_wave", tenants=len(wave)):
            t0 = self.obs.clock()
            for members in groups.values():
                if len(members) < 2:  # a pack of one gains nothing
                    serial.extend((name, t, rows, None) for name, t, rows in members)
                    continue
                stats = ingest_packed(
                    [(pack_target(t.adapter), rows) for _, t, rows in members]
                )
                m["packed_launches"].inc()
                m["packed_tenants"].inc(stats["tenants"])
                m["packed_rows"].inc(stats["rows"])
                m["rows"].inc(stats["rows"])
                m["batches"].inc(stats["tenants"])
                m["pad_rows"].inc(stats["pad_rows"])
                m["retraces"].inc(bool(stats["new_shape"]))
                m["restacks"].inc(bool(stats["restacked"]))
                for name, t, _ in members:
                    snaps.append(self._post_ingest(name, t))
            for name, t, rows, ts in serial:
                t.adapter.ingest(rows, ts=ts)
                m["serial_steps"].inc()
                m["batches"].inc()
                m["rows"].inc(self._batch_len(rows))
                snaps.append(self._post_ingest(name, t))
            m["ingest_s"].inc(self.obs.clock() - t0)
            fresh = [s for s in snaps if s is not None]
            if fresh:
                # One stacked eigh warms every same-shape matrix publish.
                self.engine.refresh_spectra(fresh)
        self._pump_or_poll()
        return len(fresh)

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

        Matrix tenants take a (d,) direction; HH tenants a (1,) element
        id; quantile tenants a (2,) [mode, arg] row (see
        ``core.quantiles.rank_query`` / ``quantile_query``); leverage
        tenants a (d+1,) [mode, x] row (see ``core.leverage.subspace_query``
        / ``score_query``).  The tenant must have at least one published
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

    def heavy_hitters(
        self, tenant: str, phi: float, *, version: int | None = None
    ) -> list[int]:
        """The paper's phi-heavy-hitter set from a published HH snapshot.

        Returns every element whose published estimate crosses the
        ``(phi - eps/2) hat{W}`` threshold (Section 4's no-false-negative
        rule), read from the pinned store version — the same data packed
        queries are answered from, so restart recovery covers it too.
        """
        from repro_torch.core.hh import decode_hh_snapshot, threshold_heavy_hitters

        snap = self.store.get(tenant, version)
        if snap.meta.get("workload") != "hh":
            raise ValueError(f"tenant {tenant!r} is not a heavy-hitter tenant")
        return threshold_heavy_hitters(
            decode_hh_snapshot(snap.matrix), snap.frob, snap.eps, phi
        )

    def quantiles(
        self, tenant: str, phis, *, version: int | None = None
    ) -> np.ndarray:
        """Eps-approximate phi-quantile values from a published snapshot.

        Reads the pinned store version — the same sorted [value, rank]
        table packed queries are answered from, so restart recovery
        covers it too.
        """
        from repro_torch.core.quantiles import table_quantile

        snap = self.store.get(tenant, version)
        if snap.meta.get("workload") != "quantile":
            raise ValueError(f"tenant {tenant!r} is not a quantile tenant")
        return table_quantile(snap.matrix, snap.frob, phis)

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
        """Checkpoint the whole pipeline atomically; returns the path.

        One ``repro_torch.ckpt`` step holds both halves of the coordinator:
        the published ``SketchStore`` versions *and* every tenant's live
        protocol state (``state_payload``), plus policies, quotas, and
        publish counters in the manifest — the reference's layout, so
        either package loads it.  ``load`` rebuilds a pipeline that answers
        queries bit-identically and resumes ingest mid-stream.  A running
        ``ServicePump`` is stopped for the duration of the write and
        restarted after (its interval is recorded, so ``load`` revives it
        on the restored pipeline too).

        ``attachments`` is a JSON-able dict stored verbatim under the
        manifest's ``extra["attachments"]``, for wrapping layers to make
        their own state durable in the same atomic step.  ``load`` ignores
        it; owners read it back via ``ckpt.read_extra``.
        """
        pump = self.pump
        if pump is not None:
            pump.stop()
        try:
            return self._save(directory, step=step, attachments=attachments)
        finally:
            if pump is not None:
                pump.start()

    def _save(self, directory: str, *, step: int = 0, attachments: dict | None = None) -> str:
        from repro_torch import ckpt

        store_tree, store_extra = self.store.state_tree()
        tree: dict = {"store": store_tree}
        tenants_meta: dict[str, dict] = {}
        # Tenant names are free-form; leaves get synthetic keys (the store
        # does the same with snap_NNNNN) so a name with '/' or '__' can
        # neither break checkpoint file paths nor alias the leaf namespace.
        for i, (name, t) in enumerate(sorted(self._tenants.items())):
            arrays, proto_meta = t.adapter.state_payload()
            key = f"tenant_{i:04d}"
            tree[key] = dict(arrays)
            tenants_meta[name] = {"key": key, **self._tenant_record(t),
                                  "proto_meta": proto_meta}
        extra = {
            "kind": "streaming_pipeline",
            "store": store_extra,
            "tenants": tenants_meta,
            "defaults": {
                "eps": self.default_eps,
                "protocol": self.default_protocol,
                "policy": policy_to_config(self.default_policy),
                "pump_interval_s": None if self.pump is None else self.pump.interval_s,
            },
        }
        if attachments is not None:
            extra["attachments"] = attachments
        return ckpt.save(directory, step, tree, extra=extra)

    @staticmethod
    def _pipeline_manifest(directory: str, step: int | None) -> tuple[int, dict]:
        """The step (latest by default) and manifest of a pipeline checkpoint."""
        from repro_torch import ckpt

        if step is None:
            step = ckpt.latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no pipeline checkpoint under {directory!r}")
        manifest = ckpt.read_manifest(directory, step)
        if manifest["extra"].get("kind") != "streaming_pipeline":
            raise ValueError(
                f"checkpoint at {directory!r} step {step} is not a streaming pipeline"
            )
        return step, manifest

    @classmethod
    def load(cls, directory: str, m: int, *, step: int | None = None, device=None,
             **pipeline_kw) -> "StreamingPipeline":
        """Rebuild a pipeline from ``save`` output (latest step by default).

        ``m`` must be the checkpoint's site count (protocol state is
        per-site); ``device`` is where the restored tenants run (``None``:
        the CUDA card).  A checkpoint the reference wrote on a mesh of m
        devices loads here with the same m.  Remaining keyword arguments
        (``max_batch``, ...) configure the fresh serving stack — queue
        contents are not checkpointed; unresolved tickets do not survive a
        coordinator crash.
        """
        from repro_torch import ckpt

        step, manifest = cls._pipeline_manifest(directory, step)
        extra = manifest["extra"]
        # The manifest is the single source of truth for leaf shapes/dtypes:
        # build each tenant's restore template from its synthetic key prefix
        # ('tenant_NNNN__...', as written by save).  restore() then verifies
        # per-leaf sha256, and restore_payload rejects config mismatches.
        template: dict = {"store": SketchStore.state_template(extra["store"])}
        for meta in extra["tenants"].values():
            prefix = meta["key"] + "__"
            template[meta["key"]] = {
                leaf[len(prefix):]: np.zeros(info["shape"], info["dtype"])
                for leaf, info in manifest["leaves"].items()
                if leaf.startswith(prefix)
            }
        # Snapshots and payloads are host arrays: read to the CPU, and each
        # protocol moves its own state to ``device``.
        tree, _ = ckpt.restore(directory, step, template, device="cpu")

        defaults = extra.get("defaults", {})
        if "pump_interval_s" not in pipeline_kw and defaults.get("pump_interval_s"):
            pipeline_kw["pump_interval_s"] = float(defaults["pump_interval_s"])
        pipe = cls(
            m,
            eps=float(defaults.get("eps", 0.1)),
            protocol=str(defaults.get("protocol", "P2")),
            policy=policy_from_config(defaults["policy"]) if "policy" in defaults else None,
            store=SketchStore.from_state_tree(tree["store"], extra["store"]),
            device=device,
            **pipeline_kw,
        )
        for name, meta in sorted(extra["tenants"].items()):
            pipe._install_tenant(name, meta, tree[meta["key"]], meta["proto_meta"])
        return pipe

    def publish_latency_s(self) -> float:
        """Total wall time spent publishing (store copies + host sync)."""
        return self._m_publish_s.value

    def stats(self, tenant: str | None = None):
        """Lifetime counters: one tenant's ``TenantStats``, or — with no
        tenant — the pipeline's ingest-side observability dict.

        The pipeline-wide dict carries the raw ingest counters (rows,
        batches, waves, packed launches/tenants/rows, pad slots, serial
        steps, retraces, restacks, ingest seconds) plus the derived gauges
        packed ingest is judged by: ``rows_per_sec`` (real rows over ingest
        wall time), ``shrink_launches`` (packed launches + serial steps —
        the protocol super-steps actually dispatched), and
        ``pack_occupancy`` (real-row fraction of packed launch slots; 1.0
        means no padding).
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
            c["shrink_launches"] = c["packed_launches"] + c["serial_steps"]
            c["pack_occupancy"] = c["packed_rows"] / max(c["packed_rows"] + c["pad_rows"], 1)
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
