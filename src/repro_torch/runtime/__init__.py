"""Streaming runtime: the paper's continuous loop as one coherent layer.

Ported so far:

  * registry.py — typed ``SketchProtocol`` / ``LeverageProtocol`` interfaces
                  + one registration point; the event-driven and super-step
                  engines of the matrix and leverage kinds.
  * policies.py — publish policies and tenant quotas (a copy).
  * pipeline.py — ``StreamingPipeline``: matrix and leverage tenants'
                  ingest → publish → packed serve, checkpoints.
  * ingest_packed.py — stacked multi-tenant ingest: same-shape super-step
                  tenants advance in one step (``ingest_many``).
"""
from repro_torch.runtime.ingest_packed import ingest_packed, pack_signature
from repro_torch.runtime.pipeline import StreamingPipeline, TenantStats
from repro_torch.runtime.policies import (
    EveryKSteps,
    FrobDrift,
    OnDemand,
    PublishPolicy,
    RetryPolicy,
    TenantQuota,
)
from repro_torch.runtime.registry import (
    LeverageProtocol,
    ProtocolSpec,
    SketchProtocol,
    create_protocol,
    get_spec,
    protocol_names,
    register_protocol,
    specs,
)

__all__ = [
    "EveryKSteps",
    "FrobDrift",
    "LeverageProtocol",
    "OnDemand",
    "ProtocolSpec",
    "PublishPolicy",
    "RetryPolicy",
    "SketchProtocol",
    "StreamingPipeline",
    "TenantQuota",
    "TenantStats",
    "create_protocol",
    "get_spec",
    "ingest_packed",
    "pack_signature",
    "protocol_names",
    "register_protocol",
    "specs",
]
