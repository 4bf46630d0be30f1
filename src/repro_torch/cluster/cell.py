"""PipelineCell: today's ``StreamingPipeline`` as one coordinator shard.

The port of the reference's ``cluster/cell.py``: a cell builds its
pipeline from the site count ``m`` and a ``device`` (``None``: the CUDA
card) where the reference takes a ``jax.sharding.Mesh``; the rest is the
reference's.

The paper's coordinator, recursed: each cell IS a full single-process
coordinator — its own ``SketchStore``, ``QueryEngine``, packed service,
quotas, ``ServicePump``, and ``repro_torch.ckpt`` save/load — owning the
disjoint tenant subset the cluster's ``HashRing`` assigns it.  The cell
adds exactly the shard-boundary surface the router and replicas need:

  * tenant migration — ``export_tenant``/``import_tenant`` ride the
    pipeline's checkpoint contract (``state_payload``/``restore_payload``
    plus the store's version-preserving tenant subset), so a rebalance
    moves a *live* tenant between cells bit-identically: protocol state,
    publish counters, and every published version number survive.
  * replica sync — ``versions_since`` hands out the tenant's immutable
    published snapshots newer than a high-water mark (what
    ``ServingReplica`` pulls), and ``latest_version`` is the staleness
    reference point.

The transport boundary (``repro_torch.cluster.transport``) lands here as the
``deliver`` endpoint: every ``Ingest`` envelope carries ``(tenant, site,
seq)`` and the cell keeps a per-``(tenant, site)`` dedup window — seq
below the window is acknowledged but NOT re-applied (idempotence: a
retried batch whose ack was lost cannot double-count rows), seq ahead of
the window is parked in a bounded reassembly buffer until the gap fills
(delayed/reordered deliveries apply in stream order).  The window's
horizons ride the pipeline checkpoint as an attachment, so a
crash-restarted cell keeps refusing batches that are already durable.

Everything else is deliberately a thin delegation: a one-cell cluster
behaves exactly like the bare pipeline (tested), which is what makes the
N-cell determinism argument compositional.
"""
from __future__ import annotations

from repro_torch.cluster import transport as tp
from repro_torch.obs import Observability, rehome_families
from repro_torch.query.store import SketchSnapshot
from repro_torch.runtime.pipeline import StreamingPipeline

__all__ = ["PipelineCell"]


class PipelineCell:
    """One coordinator shard: a named ``StreamingPipeline`` + move/sync APIs."""

    # Event order is the legacy transport_counts dict order.
    _EVENTS = (
        "applied",  # Ingest envelopes absorbed (first delivery)
        "duplicate",  # acknowledged without re-applying
        "parked",  # held for reassembly (gap ahead of them)
        "queries",  # Query envelopes served
        "heartbeats",  # Heartbeat probes answered
    )

    _FAMILIES = (
        ("counter", "repro_cell_transport_total",
         "Transport envelopes handled, partitioned by event."),
    )

    def __init__(
        self,
        name: str,
        m: int,
        *,
        device=None,
        pipeline: StreamingPipeline | None = None,
        park_bound: int = 64,
        **pipeline_kw,
    ):
        if not name:
            raise ValueError("a cell needs a non-empty name")
        if park_bound < 1:
            raise ValueError(f"park_bound must be >= 1, got {park_bound}")
        self.name = name
        if pipeline is None:
            # The cell's bundle carries its name as the base ``cell`` label
            # so every pipeline/engine/service series is scoped to it.
            pipeline_kw.setdefault("obs", Observability(labels={"cell": name}))
            pipeline = StreamingPipeline(m, device=device, **pipeline_kw)
        elif pipeline.obs.labels.get("cell") != name:
            # An adopted standalone pipeline (cell="-"): relabel its whole
            # telemetry under this cell's name.
            pipeline.bind_obs(pipeline.obs.scoped(cell=name))
        self.pipeline = pipeline
        self.obs = pipeline.obs
        self._bind_metrics()
        self.park_bound = park_bound
        # transport dedup window: (tenant, site) -> next expected seq (from 1)
        self._next_seq: dict[tuple[str, str], int] = {}
        # out-of-order reassembly: (tenant, site) -> {seq: rows}, bounded
        self._parked: dict[tuple[str, str], dict[int, object]] = {}

    # -- telemetry ------------------------------------------------------------

    def _bind_metrics(self) -> None:
        self._m_transport = {
            e: self.obs.handle(
                "counter", "repro_cell_transport_total",
                "Transport envelopes handled, partitioned by event.",
                labels={"event": e})
            for e in self._EVENTS
        }

    def bind_obs(self, obs: Observability) -> None:
        """Re-home the whole cell (incl. its pipeline stack) into ``obs``."""
        old, self.obs = self.obs, obs
        rehome_families(old, obs, self._FAMILIES)
        self._bind_metrics()
        self.pipeline.bind_obs(obs)

    @property
    def transport_counts(self) -> dict[str, int]:
        """Envelopes handled per event (fresh dict, registry view)."""
        return {e: int(self._m_transport[e].value) for e in self._EVENTS}

    # -- thin delegation (the cell IS a coordinator) --------------------------

    @property
    def store(self):
        """The cell's own versioned snapshot store."""
        return self.pipeline.store

    @property
    def engine(self):
        """The cell's own query engine (per-cell spectrum/factor caches)."""
        return self.pipeline.engine

    def tenants(self) -> list[str]:
        """Tenant names this cell owns (sorted)."""
        return self.pipeline.tenants()

    def ingest(self, tenant: str, rows):
        """Absorb one super-step batch for an owned tenant (see pipeline)."""
        return self.pipeline.ingest(tenant, rows)

    def ingest_many(self, batches, *, packed: bool = True) -> int:
        """Drive owned tenants' interleaved batches, packing same-shape
        shard tenants per wave (see ``StreamingPipeline.ingest_many``)."""
        return self.pipeline.ingest_many(batches, packed=packed)

    # -- transport endpoint (idempotent ingest + packed serve) -----------------

    def deliver(self, envelope):
        """Dispatch one typed transport envelope (the cell's wire surface).

        ``Ingest`` goes through the dedup/reassembly window
        (``ingest_from``), ``Query`` through the packed engine sweep,
        ``Export`` through the rebalance export, ``Heartbeat`` answers
        with the tenant count.  This is what the router registers with
        the ``Transport`` — and re-registers on ``revive`` after a
        crash-restart rebuild.
        """
        # Join the sender's trace: a delivery that happens inside the
        # sender's live send span nests under it; a late replay whose
        # originating trace has moved on becomes a detached root of the
        # *original* trace (same trace_id) — one logical message, one tree.
        with self.obs.trace(
            "cell.deliver",
            trace_id=getattr(envelope, "trace_id", None),
            cell=self.name,
            kind=type(envelope).__name__,
        ):
            if isinstance(envelope, tp.Ingest):
                return self.ingest_from(
                    envelope.tenant, envelope.site, envelope.seq, envelope.rows
                )
            if isinstance(envelope, tp.Query):
                self._m_transport["queries"].inc()
                return self.engine.query_packed(list(envelope.requests))
            if isinstance(envelope, tp.Export):
                return self.export_tenant(envelope.tenant)
            if isinstance(envelope, tp.Heartbeat):
                self._m_transport["heartbeats"].inc()
                return tp.HeartbeatAck(envelope.seq, len(self.tenants()))
            raise TypeError(f"unknown envelope type {type(envelope).__name__}")

    def ingest_from(self, tenant: str, site: str, seq: int, rows) -> "tp.IngestAck":
        """Idempotent, order-restoring ingest: apply exactly once, in seq order.

        seq below the window: already absorbed — ack ``"duplicate"``, do
        NOT re-apply (this is what makes sender retries safe).  seq ahead
        of the window: park in the bounded reassembly buffer and ack
        ``"parked"`` (an overflowing gap raises — the sender's replay
        queue still holds the batch).  seq == window: apply, then drain
        any contiguously-parked successors, so a delayed-then-flushed
        batch lands in exactly the order the stream produced it.
        """
        key = (tenant, site)
        expected = self._next_seq.get(key, 1)
        if seq < expected:
            self._m_transport["duplicate"].inc()
            return tp.IngestAck("duplicate", seq, None)
        if seq > expected:
            parked = self._parked.setdefault(key, {})
            if seq not in parked:
                if len(parked) >= self.park_bound:
                    raise tp.IngestShedError(tenant, len(parked), self.park_bound)
                parked[seq] = rows
            self._m_transport["parked"].inc()
            return tp.IngestAck("parked", seq, None)
        version = self._apply(tenant, key, rows)
        # gap just filled: absorb contiguous parked successors in order
        parked = self._parked.get(key)
        while parked:
            nxt = self._next_seq[key]
            if nxt not in parked:
                break
            v = self._apply(tenant, key, parked.pop(nxt))
            version = v if v is not None else version
        self._m_transport["applied"].inc()
        return tp.IngestAck("applied", seq, version)

    def _apply(self, tenant: str, key: tuple[str, str], rows) -> int | None:
        snap = self.pipeline.ingest(tenant, rows)
        self._next_seq[key] = self._next_seq.get(key, 1) + 1
        return None if snap is None else snap.version

    # -- dedup window persistence / migration ----------------------------------

    def dedup_state(self) -> dict:
        """The durable half of the window: ``{tenant: {site: next_seq}}``.

        Parked (not-yet-applied) batches are deliberately volatile —
        the router's replay queue still owns them until they apply.
        """
        out: dict[str, dict[str, int]] = {}
        for (tenant, site), nxt in sorted(self._next_seq.items()):
            out.setdefault(tenant, {})[site] = nxt
        return out

    def restore_dedup(self, state: dict) -> None:
        """Install checkpointed dedup horizons (crash-restart path)."""
        for tenant, sites in state.items():
            for site, nxt in sites.items():
                self._next_seq[(tenant, site)] = int(nxt)

    def dedup_for(self, tenant: str) -> dict[str, int]:
        """One tenant's ``{site: next_seq}`` horizons (rebalance handoff)."""
        return {s: n for (t, s), n in self._next_seq.items() if t == tenant}

    def adopt_dedup(self, tenant: str, horizons: dict[str, int]) -> None:
        """Take over a moved-in tenant's seq horizons from its old owner."""
        for site, nxt in horizons.items():
            self._next_seq[(tenant, site)] = int(nxt)

    def drop_dedup(self, tenant: str) -> None:
        """Forget a moved-away tenant's window (horizons and parked gaps)."""
        for key in [k for k in self._next_seq if k[0] == tenant]:
            del self._next_seq[key]
        for key in [k for k in self._parked if k[0] == tenant]:
            del self._parked[key]

    def parked_count(self, tenant: str | None = None) -> int:
        """Batches held for reassembly (one tenant, or all)."""
        return sum(
            len(v)
            for (t, _), v in self._parked.items()
            if tenant is None or t == tenant
        )

    def submit(self, tenant: str, x, *, deadline_s: float | None = None):
        """Admit one query for an owned tenant (see pipeline.submit)."""
        return self.pipeline.submit(tenant, x, deadline_s=deadline_s)

    def flush(self) -> int:
        """Drain this cell's pending queries in packed sweeps."""
        return self.pipeline.flush()

    def poll(self) -> int:
        """Deadline pump for this cell's packed service."""
        return self.pipeline.poll()

    def close(self) -> None:
        """Release the cell's background resources (pump thread)."""
        self.pipeline.close()

    def __enter__(self) -> "PipelineCell":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- tenant migration (rebalance path) ------------------------------------

    def export_tenant(self, tenant: str) -> dict:
        """Capture a live owned tenant as a portable payload (drained first)."""
        return self.pipeline.export_tenant(tenant)

    def import_tenant(self, payload: dict) -> str:
        """Install an exported tenant here; returns its name."""
        self.pipeline.import_tenant(payload)
        return payload["tenant"]

    def remove_tenant(self, tenant: str) -> None:
        """Deregister a moved-away tenant and drop its local versions."""
        self.pipeline.remove_tenant(tenant)

    # -- replica sync ----------------------------------------------------------

    def versions_since(self, tenant: str, after: int) -> list[SketchSnapshot]:
        """Published snapshots newer than ``after`` (ascending; [] if none)."""
        return self.store.versions_since(tenant, after)

    def latest_version(self, tenant: str) -> int | None:
        """The tenant's newest published version here (None before first)."""
        try:
            return self.store.latest_version(tenant)
        except KeyError:
            return None

    # -- persistence -----------------------------------------------------------

    def save(self, directory: str, *, step: int = 0) -> str:
        """Checkpoint the whole cell (one pipeline ckpt); returns the path.

        The transport dedup horizons ride the same atomic step as a
        manifest attachment, so recovery restores the exactly-once
        window together with the state it protects: a replayed batch
        that is already durable here stays refused after a crash.
        """
        return self.pipeline.save(
            directory,
            step=step,
            attachments={"cell": {"name": self.name, "dedup": self.dedup_state()}},
        )

    @classmethod
    def load(
        cls,
        name: str,
        directory: str,
        m: int,
        *,
        step: int | None = None,
        device=None,
        **pipeline_kw,
    ) -> "PipelineCell":
        """Rebuild a cell from ``save`` output (latest step by default).

        Restores the pipeline *and* the checkpoint's dedup horizons, so
        the reloaded cell refuses replays of batches that were durable
        at save time.  ``m`` is the checkpoint's site count; ``device``
        is where the restored tenants run (``None``: the CUDA card).  A
        cell checkpoint the reference wrote loads here, and the other way.
        """
        from repro_torch import ckpt

        if step is None:
            step = ckpt.latest_step(directory)
        pipeline = StreamingPipeline.load(
            directory, m, step=step, device=device, **pipeline_kw
        )
        cell = cls(name, m, pipeline=pipeline)
        if step is not None:
            attachments = ckpt.read_extra(directory, step).get("attachments", {})
            cell.restore_dedup(attachments.get("cell", {}).get("dedup", {}))
        return cell

    def __repr__(self) -> str:
        return f"PipelineCell({self.name!r}, tenants={self.tenants()})"
