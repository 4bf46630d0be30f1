"""Coordinator query-serving subsystem.

The paper splits the problem in two: cheap continuous communication builds a
coordinator sketch B, and B then answers ``||A x||^2`` queries for any
direction at any time.  This package is the second half at serving scale:

  * store.py   — versioned, per-tenant registry of immutable published
                 sketches (trackers publish; readers pin a version).
  * engine.py  — batched quadratic-form serving with an LRU-cached
                 spectrum per (tenant, version), the quadform CUDA kernel
                 path, and cross-tenant batch packing (``query_packed`` —
                 tenants whose sketches share (l, d) ride one
                 ``quadform_packed`` launch); leverage tenants' subspace
                 and score queries (quadform / levscore kernels).
  * service.py — admission front-ends: single-tenant coalescing and the
                 multi-tenant packed service with deadlines and quotas.
"""
from repro_torch.query.engine import PackedRequest, QueryEngine, QueryResult, Spectrum
from repro_torch.query.service import (
    PackedQueryService,
    QueryService,
    QueryShedError,
    QueryTicket,
    ServicePump,
)
from repro_torch.query.store import SketchSnapshot, SketchStore

__all__ = [
    "PackedQueryService",
    "PackedRequest",
    "QueryEngine",
    "QueryResult",
    "QueryService",
    "QueryShedError",
    "QueryTicket",
    "ServicePump",
    "SketchSnapshot",
    "SketchStore",
    "Spectrum",
]
