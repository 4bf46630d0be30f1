"""Sharded coordinator cells: the paper's m-site recursion applied to itself.

A copy of the reference's ``cluster/__init__.py`` with its imports rewritten.

The paper scales *sites* horizontally but keeps one coordinator; this
package shards the coordinator the same way the paper shards the stream.
Every protocol kind already proves the merge identity that makes this
sound (``fd_merge``, ``mg_merge``, ``quant_merge``, ``lev_merge``), so a
tenant's whole lifecycle can live on any one shard:

  * ``hashring``  — deterministic consistent-hash tenant placement with
                    virtual nodes + minimal rebalance planning.
  * ``cell``      — ``PipelineCell``: one ``StreamingPipeline`` as a
                    shard, plus the tenant export/import move path and
                    the replica-facing ``versions_since`` sync API.
  * ``router``    — ``ClusterRouter``: ring-placed registration/ingest,
                    per-shard packed query fan-out (gathered in
                    submission order), shed propagation, live rebalance.
  * ``replica``   — ``ServingReplica``: read-only serving off published
                    immutable versions with surfaced staleness bounds,
                    including owner-blind degraded serving for cells
                    whose circuit breaker is open.
  * ``transport`` — the fault-injectable message boundary: typed
                    envelopes with ``(tenant, site, seq)``-stamped
                    idempotent ingest, scripted/seeded ``FaultPlan``
                    chaos injection, ``CircuitBreaker``, and the typed
                    loss/crash errors the router's retry loop handles.

See ``docs/cluster.md`` for the ring diagram, cell lifecycle, rebalance
plan format, and staleness semantics, and ``docs/resilience.md`` for the
failure-mode/retry/breaker/staleness contract and how to script a
``FaultPlan``.
"""
from repro_torch.cluster.cell import PipelineCell
from repro_torch.cluster.hashring import HashRing, RebalancePlan, TenantMove, rebalance_plan
from repro_torch.cluster.replica import ReplicaResult, ServingReplica
from repro_torch.cluster.router import ClusterRouter
from repro_torch.cluster.transport import (
    CellDownError,
    CircuitBreaker,
    Export,
    FaultPlan,
    Heartbeat,
    HeartbeatAck,
    Ingest,
    IngestAck,
    IngestShedError,
    Query,
    StalenessExceededError,
    Transport,
    TransportTimeout,
)

__all__ = [
    "CellDownError",
    "CircuitBreaker",
    "ClusterRouter",
    "Export",
    "FaultPlan",
    "HashRing",
    "Heartbeat",
    "HeartbeatAck",
    "Ingest",
    "IngestAck",
    "IngestShedError",
    "PipelineCell",
    "Query",
    "RebalancePlan",
    "ReplicaResult",
    "ServingReplica",
    "StalenessExceededError",
    "TenantMove",
    "Transport",
    "TransportTimeout",
    "rebalance_plan",
]
