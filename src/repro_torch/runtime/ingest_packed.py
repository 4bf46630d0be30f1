"""Packed multi-tenant ingest: one stacked super-step for same-shape tenants.

A ``StreamingPipeline`` fleet often holds many tenants with identical
protocol configs — same ``(l, d)`` sketch shapes, same m, same device.
Serially each ingest batch pays its own Python dispatch and its own FD
shrinks (a Gram launch, an ``eigh``, a projection launch per chunk);
packed ingest stacks the group's protocol states into ``(T, ...)`` leaves,
coalesces their row batches into one zero-padded ``(T, n_pad, d)`` tensor,
and advances every tenant with ONE ``dist.make_packed_runner`` call, whose
shrinks take all ``T * m`` site buffers at once.

Zero padding is exact for the packable protocols (``dist.
PACKABLE_PROTOCOLS``): zero rows contribute nothing to any Gram, mass, or
threshold, so a ragged batch or a cold tenant rides the same call as a
full one — served answers are checked against serial ingest.

Padding layout: the packed step splits each tenant's row axis into m
contiguous site blocks, so site ``j`` reads ``rows[:, j*n_pad/m :
(j+1)*n_pad/m]``.  To keep the serial row→site assignment, each tenant's
batch is split into its ``m`` per-site blocks and each block is zero-padded
on its own (``_pad_rows``), on the device.  Per-site lengths are bucketed
to powers of two (``_bucket``), so the launch shapes number O(log n), not
one per distinct batch size; ``retraces`` counts the distinct ``(key, T,
n_pad)`` shapes, as the reference counts its XLA traces.

The pack's stacked state stays RESIDENT between waves: the first call for
a group restacks the members' states (``PackedRunner.from_states``) and
every later wave feeds the cached stacked output straight back in
(``PackedRunner.stacked``).  Each member holds a lazy ``(stacked, index)``
slot and slices its own state out only when a publish, query, or
checkpoint reads it; per-member ``_epoch`` counters detect out-of-band
writes (a serial step, a restore) and force a restack on the next wave.
"""
from __future__ import annotations

import torch

from repro_torch import f32_on
from repro_torch.core import distributed as dist

__all__ = ["ingest_packed", "pack_signature", "pack_target", "shape_cache_stats"]

# Distinct (pack_key, T, n_pad) launch shapes seen; the pipeline surfaces
# their number as its retrace counter.
_SHAPES_SEEN: set = set()


def shape_cache_stats() -> dict:
    """Packed-launch shape stats: ``retraces`` = distinct shapes launched."""
    return {"retraces": len(_SHAPES_SEEN)}


def pack_target(adapter):
    """The super-step protocol behind a pipeline adapter, or None.

    Matrix adapters wrap a ``DistributedMatrixTracker`` whose ``_proto`` is
    the registry's ``ShardProtocol``; leverage adapters hold the registry
    protocol directly.  Event-engine protocols (no ``pack_key``) return
    None — they always ingest serially.
    """
    target = adapter.target
    proto = getattr(target, "_proto", target)
    return proto if hasattr(proto, "pack_key") else None


def pack_signature(adapter):
    """The tenant's pack grouping key, or None when it must go serial."""
    proto = pack_target(adapter)
    return None if proto is None else proto.pack_key()


def _bucket(n: int) -> int:
    """Next power of two >= n (>= 1): bounds launch shapes to O(log n)."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _pad_rows(rows: torch.Tensor, m: int, per_pad: int) -> torch.Tensor:
    """Zero-pad an (n, d) batch to (m * per_pad, d), per-site block-wise.

    Keeps the serial row→site assignment: site ``j``'s rows land in the
    ``j``-th contiguous ``per_pad`` block, front-aligned, zeros after.
    """
    n, d = rows.shape
    per = n // m
    out = rows.new_zeros((m, per_pad, d))
    out[:, :per] = rows.reshape(m, per, d)
    return out.reshape(m * per_pad, d)


def ingest_packed(entries: list) -> dict:
    """Advance a group of same-key super-step protocols in one stacked call.

    ``entries`` is a list of ``(proto, rows)`` pairs whose ``pack_key()``
    values are all equal (the caller groups by ``pack_signature``); rows
    are (n_t, d) batches (numpy or tensors) with ``n_t % m == 0`` (the
    same shardability the serial path requires).  Each protocol is pointed
    at its slot in the stacked result via ``apply_packed`` — afterwards
    its state, row counter, and host caches look exactly as if it had
    stepped serially, but the per-tenant slice is deferred until something
    reads it.

    Steady state is restack-free: the group's stacked output is cached on
    the first member as ``_pack_group = (members, stacked, epochs)`` and
    reused whenever the same members arrive with unchanged epochs;
    otherwise the call restacks the members' current states first.

    Returns launch counters: ``tenants``, ``rows`` (real rows absorbed),
    ``pad_rows`` (zero-filled slots), ``new_shape`` (True when this launch
    shape had not been seen before), ``restacked`` (True when the call
    could not reuse a cached stacked state).
    """
    if not entries:
        return {
            "tenants": 0, "rows": 0, "pad_rows": 0,
            "new_shape": False, "restacked": False,
        }
    protos = tuple(p for p, _ in entries)
    key = protos[0].pack_key()
    for p in protos[1:]:
        if p.pack_key() != key:
            raise ValueError("ingest_packed entries must share one pack_key")
    name, cfg, device = key
    d, m = cfg.d, cfg.m
    batches = []
    for _, rows in entries:
        rows = f32_on(device, rows)
        if rows.ndim != 2 or rows.shape[1] != d:
            raise ValueError(
                f"packed ingest batches must be (n, {d}) rows, got {tuple(rows.shape)}"
            )
        if rows.shape[0] % m:
            raise ValueError(
                f"packed ingest batch of {rows.shape[0]} rows does not shard "
                f"over {m} sites"
            )
        batches.append(rows)

    runner = dist.make_packed_runner(name, cfg)
    per_pad = _bucket(max(b.shape[0] // m for b in batches))
    packed = torch.stack([_pad_rows(b, m, per_pad) for b in batches])

    shape = (key, len(entries), per_pad * m)
    new_shape = shape not in _SHAPES_SEEN
    _SHAPES_SEEN.add(shape)

    group = getattr(protos[0], "_pack_group", None)
    hit = (
        group is not None
        and group[0] == protos
        and all(p._epoch == e for p, e in zip(protos, group[2]))
    )
    if hit:
        stacked = runner.stacked(group[1], packed)
    else:
        stacked = runner.from_states(tuple(p.state for p in protos), packed)
    for i, (p, b) in enumerate(zip(protos, batches)):
        p.apply_packed(stacked, i, b.shape[0])
    protos[0]._pack_group = (protos, stacked, tuple(p._epoch for p in protos))

    rows_real = sum(b.shape[0] for b in batches)
    return {
        "tenants": len(entries),
        "rows": rows_real,
        "pad_rows": len(entries) * per_pad * m - rows_real,
        "new_shape": new_shape,
        "restacked": not hit,
    }
