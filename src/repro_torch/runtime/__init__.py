"""Streaming runtime: the paper's continuous loop as one coherent layer.

Ported so far:

  * registry.py — typed ``SketchProtocol`` / ``HHProtocol`` /
                  ``QuantileProtocol`` / ``LeverageProtocol`` interfaces
                  + one registration point; the event-driven and super-step
                  engines of the matrix, heavy-hitter, quantile and
                  leverage kinds.
  * policies.py — publish policies and tenant quotas (a copy).
  * pipeline.py — ``StreamingPipeline``: matrix, heavy-hitter, quantile,
                  leverage and windowed tenants' ingest → publish → packed
                  serve, checkpoints.
  * windowed.py — sliding-window and exponential-decay flavours of all four
                  kinds, registered as ``(kind, engine, name)`` specs.
  * ingest_packed.py — stacked multi-tenant ingest: same-shape super-step
                  tenants advance in one step (``ingest_many``).
"""
from repro_torch.runtime.ingest_packed import ingest_packed, pack_signature
from repro_torch.runtime.pipeline import StreamingPipeline, TenantStats
from repro_torch.runtime.policies import (
    EveryKSteps,
    FrobDrift,
    OnDemand,
    OnWindowClose,
    PublishPolicy,
    RetryPolicy,
    TenantQuota,
    policy_from_config,
    policy_to_config,
)
from repro_torch.runtime.registry import (
    HHProtocol,
    LeverageProtocol,
    ProtocolSpec,
    QuantileProtocol,
    SketchProtocol,
    create_protocol,
    get_spec,
    protocol_names,
    register_protocol,
    specs,
)
from repro_torch.runtime.windowed import (
    WindowedHHProtocol,
    WindowedLeverageProtocol,
    WindowedMatrixProtocol,
    WindowedQuantileProtocol,
)

__all__ = [
    "EveryKSteps",
    "FrobDrift",
    "HHProtocol",
    "LeverageProtocol",
    "OnDemand",
    "OnWindowClose",
    "ProtocolSpec",
    "PublishPolicy",
    "QuantileProtocol",
    "RetryPolicy",
    "SketchProtocol",
    "StreamingPipeline",
    "TenantQuota",
    "TenantStats",
    "WindowedHHProtocol",
    "WindowedLeverageProtocol",
    "WindowedMatrixProtocol",
    "WindowedQuantileProtocol",
    "create_protocol",
    "get_spec",
    "ingest_packed",
    "pack_signature",
    "policy_from_config",
    "policy_to_config",
    "protocol_names",
    "register_protocol",
    "specs",
]
