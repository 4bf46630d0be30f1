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
                 ``quadform_packed`` launch).
"""
from repro_torch.query.engine import PackedRequest, QueryEngine, QueryResult, Spectrum
from repro_torch.query.store import SketchSnapshot, SketchStore

__all__ = [
    "PackedRequest",
    "QueryEngine",
    "QueryResult",
    "SketchSnapshot",
    "SketchStore",
    "Spectrum",
]
