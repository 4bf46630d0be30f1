"""ServingReplica: read-only query serving off published snapshot versions.

The store is already versioned and immutable — the cluster leans into
it: cells keep publishing, and any number of replicas pull the published
versions and serve queries without ever touching a cell's ingest path.
This is the classic read-replica split (database-replication /
distributed-cache shape) built on three properties the repo already has:

  * immutability — a ``SketchSnapshot`` never changes after publish, so
    replication is "install the missing versions" (``versions_since`` on
    the owning cell), idempotent and order-safe; the snapshot *object*
    is shared, never copied.
  * cache-aside factors — the replica runs its own ``QueryEngine``, so
    spectrum/ridge-factor LRU entries are computed beside the replica
    (keyed by the same immutable ``(tenant, version)``) and its
    ``cache_stats`` expose the hit rate per replica.
  * versioned staleness — every answer carries ``versions_behind``: how
    many publishes the owning cell is ahead of the version that answered.
    ``max_versions_behind`` turns the surfaced bound into an enforced
    one — the replica read-through-syncs before answering staler than
    allowed.  A miss (unknown tenant / unpulled pinned version) always
    read-through-fetches from the owner.

The port of the reference's ``cluster/replica.py``: the engine runs on a
``device`` (by default the device of the source's cells, so a replica
serves on the same card) where the reference takes ``interpret=``, and the
quadform path is ``"kernel"`` where the reference's is ``"pallas"``.

Replicas answer from whatever they pulled — the answer's ``error_bound``
certificate still holds (it is the *snapshot's* certificate); staleness
only means the stream has moved on since that version was published.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.cluster.cell import PipelineCell
from repro_torch.cluster.transport import StalenessExceededError
from repro_torch.obs import Observability, rehome_families
from repro_torch.query.engine import QueryEngine, QueryResult
from repro_torch.query.store import SketchStore

__all__ = ["ReplicaResult", "ServingReplica", "StalenessExceededError"]


class ReplicaResult(NamedTuple):
    """One replica-served batch + its per-tenant staleness bound."""

    result: QueryResult  # estimates + the snapshot's own certificate
    owner_version: int  # newest version the owning cell had published
    versions_behind: int  # owner_version - served version (0 = fresh)


class ServingReplica:
    """Read-only serving node: pulls published versions, answers queries.

    ``source`` is where ownership lives: a ``ClusterRouter`` (tenants
    resolve through its ring) or a single ``PipelineCell``.  The replica
    holds its own ``SketchStore`` + ``QueryEngine``; nothing it does can
    write back to a cell.
    """

    _FAMILIES = (
        ("counter", "repro_replica_syncs_total",
         "sync() calls (explicit + read-through)."),
        ("counter", "repro_replica_pulled_total",
         "Snapshot versions installed."),
        ("counter", "repro_replica_read_throughs_total",
         "Queries that had to fetch before answering."),
        ("counter", "repro_replica_degraded_total",
         "Owner-blind answers served (query_degraded)."),
        ("gauge", "repro_replica_versions_behind",
         "Publishes the owner is ahead of the last served version, per tenant."),
    )

    def __init__(
        self,
        source,
        *,
        cache_size: int = 16,
        device=None,
        max_versions_behind: int | None = None,
        retain: int = 0,
        obs: Observability | None = None,
    ):
        if max_versions_behind is not None and max_versions_behind < 0:
            raise ValueError(
                f"max_versions_behind must be >= 0, got {max_versions_behind}"
            )
        self.source = source
        self.max_versions_behind = max_versions_behind
        self.store = SketchStore(retain=retain)
        self.obs = obs if obs is not None else Observability(labels={"cell": "replica"})
        if device is None:
            cell = source
            if not isinstance(source, PipelineCell):
                cell = source.cell(source.cells()[0])
            device = cell.pipeline.device
        self.engine = QueryEngine(
            self.store, cache_size=cache_size, device=device, obs=self.obs
        )
        self._synced: dict[str, int] = {}  # tenant -> highest pulled version
        self._owner_seen: dict[str, int] = {}  # newest owner version ever observed
        self._bind_metrics()

    # -- telemetry ------------------------------------------------------------

    def _bind_metrics(self) -> None:
        handles = {
            name: self.obs.handle(kind, name, help)
            for kind, name, help in self._FAMILIES
            if kind == "counter"
        }
        self._m_syncs = handles["repro_replica_syncs_total"]
        self._m_pulled = handles["repro_replica_pulled_total"]
        self._m_read_throughs = handles["repro_replica_read_throughs_total"]
        self._m_degraded = handles["repro_replica_degraded_total"]
        tenants = tuple(getattr(self, "_m_behind", ()))
        self._m_behind = {t: self._behind_handle(t) for t in tenants}

    def _behind_handle(self, tenant: str):
        return self.obs.handle(
            "gauge", "repro_replica_versions_behind",
            "Publishes the owner is ahead of the last served version, per tenant.",
            labels={"tenant": tenant},
        )

    def _set_behind(self, tenant: str, behind: int) -> None:
        h = self._m_behind.get(tenant)
        if h is None:
            h = self._m_behind[tenant] = self._behind_handle(tenant)
        h.set(behind)

    def bind_obs(self, obs: Observability) -> None:
        """Re-home the replica's telemetry (incl. its engine) into ``obs``."""
        old, self.obs = self.obs, obs
        rehome_families(old, obs, self._FAMILIES)
        self._bind_metrics()
        self.engine.bind_obs(obs)

    # Legacy counter attributes, now registry views.

    @property
    def syncs(self) -> int:
        """sync() calls (explicit + read-through)."""
        return int(self._m_syncs.value)

    @property
    def pulled(self) -> int:
        """Snapshot versions installed."""
        return int(self._m_pulled.value)

    @property
    def read_throughs(self) -> int:
        """Queries that had to fetch before answering."""
        return int(self._m_read_throughs.value)

    @property
    def degraded(self) -> int:
        """Owner-blind answers served (query_degraded)."""
        return int(self._m_degraded.value)

    def _cell_for(self, tenant: str) -> PipelineCell:
        if isinstance(self.source, PipelineCell):
            return self.source
        return self.source.cell_for(tenant)

    def _source_tenants(self) -> list[str]:
        return self.source.tenants()

    # -- replication -----------------------------------------------------------

    def sync(self, tenant: str | None = None) -> int:
        """Pull every published version newer than the local high-water mark.

        One tenant, or (``tenant=None``) every tenant the source knows.
        Returns the number of versions installed; pulling is idempotent
        (``SketchStore.install`` keyed by immutable version numbers).
        """
        tenants = [tenant] if tenant is not None else self._source_tenants()
        installed = 0
        for t in tenants:
            after = self._synced.get(t, 0)
            for snap in self._cell_for(t).versions_since(t, after):
                self.store.install(snap)
                self._synced[t] = snap.version
                installed += 1
            self._owner_seen[t] = max(self._owner_seen.get(t, 0), self._synced.get(t, 0))
        self._m_syncs.inc()
        self._m_pulled.inc(installed)
        return installed

    def synced_version(self, tenant: str) -> int:
        """The tenant's highest locally-installed version (0 = none yet)."""
        return self._synced.get(tenant, 0)

    # -- read path -------------------------------------------------------------

    def query_batch(
        self,
        x: np.ndarray,
        *,
        tenant: str,
        version: int | None = None,
        path: str = "kernel",
    ) -> ReplicaResult:
        """Serve a batch from the local versions, surfacing staleness.

        Cache-aside with read-through: answers come from the replica's
        own store/engine; a miss — unknown tenant, or a pinned
        ``version`` that was never pulled — fetches from the owning cell
        first (counted in ``read_throughs``).  When
        ``max_versions_behind`` is set, the replica also refreshes before
        answering more than that many publishes behind the owner.  The
        returned ``versions_behind`` is measured against the owner at
        answer time, so callers always see the bound they actually got.
        """
        have = set(self.store.versions(tenant)) if tenant in self.store.tenants() else set()
        miss = not have if version is None else version not in have
        if miss:
            self._m_read_throughs.inc()
            self.sync(tenant)
        owner_latest = self._cell_for(tenant).latest_version(tenant) or 0
        if (
            version is None
            and self.max_versions_behind is not None
            and owner_latest - self._synced.get(tenant, 0) > self.max_versions_behind
        ):
            self.sync(tenant)
        self._owner_seen[tenant] = max(self._owner_seen.get(tenant, 0), owner_latest)
        res = self.engine.query_batch(x, tenant=tenant, version=version, path=path)
        behind = max(0, owner_latest - res.version)
        self._set_behind(tenant, behind)
        return ReplicaResult(
            result=res,
            owner_version=max(owner_latest, res.version),
            versions_behind=behind,
        )

    def query_degraded(
        self, x: np.ndarray, *, tenant: str, path: str = "kernel"
    ) -> ReplicaResult:
        """Serve purely from local versions — the owner is NOT contacted.

        The open-circuit path: when a cell's breaker is open (or it is
        crashed outright), the router answers from whatever this replica
        already pulled.  ``versions_behind`` is measured against the last
        owner version this replica ever *observed* (recorded at sync /
        read-through time — the owner may have published more since, but
        an unreachable owner cannot be asked), and the declared
        ``max_versions_behind`` bound is enforced: a replica that has
        fallen beyond it raises ``StalenessExceededError`` instead of
        silently serving an answer staler than promised.  Raises
        ``KeyError`` when the tenant was never synced here at all.
        """
        if tenant not in self.store.tenants():
            raise KeyError(
                f"tenant {tenant!r} has no local versions on this replica; "
                "degraded serving needs at least one pre-outage sync"
            )
        res = self.engine.query_batch(x, tenant=tenant, path=path)
        owner_latest = max(self._owner_seen.get(tenant, 0), res.version)
        behind = owner_latest - res.version
        self._set_behind(tenant, behind)
        if self.max_versions_behind is not None and behind > self.max_versions_behind:
            raise StalenessExceededError(tenant, behind, self.max_versions_behind)
        self._m_degraded.inc()
        return ReplicaResult(
            result=res, owner_version=owner_latest, versions_behind=behind
        )

    def stats(self) -> dict:
        """Replication + cache counters (cache half from the engine)."""
        return {
            "syncs": self.syncs,
            "pulled": self.pulled,
            "read_throughs": self.read_throughs,
            "degraded": self.degraded,
            "tenants": len(self.store.tenants()),
            "cache": self.engine.cache_stats(),
        }
