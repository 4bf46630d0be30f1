"""Consistent-hash tenant partitioning for coordinator cells.

A copy of the reference's ``cluster/hashring.py`` (pure Python: placement
is the reference's for the same cell and tenant names).

The paper's topology is m sites streaming into one coordinator; the
cluster layer applies the same recursion to the coordinator itself —
many ``PipelineCell`` shards, each owning a disjoint tenant subset.  The
ring decides ownership:

  * deterministic — placement is a pure function of ``(cell names,
    vnodes, tenant name)`` via blake2b, so every router replica, every
    restarted process, and every test computes the same owner.  No
    process-seeded ``hash()`` anywhere.
  * virtual nodes — each cell projects ``vnodes`` points onto the ring,
    smoothing the per-cell tenant share to ``~1/cells`` without any
    central assignment table.
  * minimal rebalance — when the cell set changes, consistent hashing
    moves only the tenants whose arc changed owner (classically ``~K/n``
    of them); ``rebalance_plan`` enumerates exactly those moves so the
    router can stream each affected tenant's live state between cells
    and touch nothing else.

``HashRing`` is immutable: resizing builds a new ring (``with_cells``),
and a plan is computed *between* two rings — the router applies it by
exporting/importing tenants (see ``repro_torch.cluster.router``).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, NamedTuple

__all__ = ["HashRing", "TenantMove", "RebalancePlan", "rebalance_plan"]


def _point(key: str) -> int:
    """Deterministic 64-bit ring coordinate of ``key`` (blake2b, not hash())."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class TenantMove(NamedTuple):
    """One tenant's relocation in a rebalance plan."""

    tenant: str
    src: str  # owning cell under the old ring
    dst: str  # owning cell under the new ring


class RebalancePlan(NamedTuple):
    """A minimal tenant-move plan between two rings.

    ``moves`` holds exactly the tenants whose owner changed (sorted by
    tenant name, so plans are reproducible artifacts); ``unmoved`` counts
    the tenants consistent hashing kept in place — the number a naive
    mod-N repartition would have shuffled for nothing.
    """

    moves: tuple[TenantMove, ...]
    unmoved: int

    @property
    def moved_fraction(self) -> float:
        """Fraction of tenants the plan relocates (0.0 when no tenants)."""
        total = len(self.moves) + self.unmoved
        return len(self.moves) / total if total else 0.0


class HashRing:
    """Immutable consistent-hash ring mapping tenant names to cell names."""

    def __init__(self, cells: Iterable[str], *, vnodes: int = 64):
        names = list(cells)
        if not names:
            raise ValueError("a hash ring needs at least one cell")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cell names: {sorted(names)}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._cells = tuple(sorted(names))
        points: list[tuple[int, str]] = []
        for cell in self._cells:
            for v in range(vnodes):
                points.append((_point(f"{cell}#{v}"), cell))
        # blake2b collisions across distinct keys are not a practical
        # concern; ties (if ever) break deterministically by cell name.
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [c for _, c in points]

    def cells(self) -> tuple[str, ...]:
        """The ring's cell names (sorted)."""
        return self._cells

    def place(self, tenant: str) -> str:
        """The cell that owns ``tenant`` — first vnode clockwise of its point."""
        h = _point(tenant)
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):  # wrap past the top of the ring
            i = 0
        return self._owners[i]

    def with_cells(self, cells: Iterable[str]) -> "HashRing":
        """A new ring over ``cells`` with the same vnode density."""
        return HashRing(cells, vnodes=self.vnodes)

    def spread(self, tenants: Iterable[str]) -> dict[str, int]:
        """Tenant count per cell (every cell listed, empty cells at 0)."""
        counts = {cell: 0 for cell in self._cells}
        for t in tenants:
            counts[self.place(t)] += 1
        return counts

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, HashRing)
            and self._cells == other._cells
            and self.vnodes == other.vnodes
        )

    def __hash__(self) -> int:
        return hash((self._cells, self.vnodes))

    def __repr__(self) -> str:
        return f"HashRing(cells={list(self._cells)}, vnodes={self.vnodes})"


def rebalance_plan(
    old: HashRing, new: HashRing, tenants: Iterable[str]
) -> RebalancePlan:
    """The minimal move set taking ``tenants`` from ``old`` to ``new``.

    Only tenants whose placement differs between the rings appear; a
    grow-by-one ring change therefore moves tenants *onto* the new cell
    only (the consistent-hashing guarantee the tests pin down).
    """
    moves = []
    unmoved = 0
    for tenant in sorted(set(tenants)):
        src, dst = old.place(tenant), new.place(tenant)
        if src != dst:
            moves.append(TenantMove(tenant, src, dst))
        else:
            unmoved += 1
    return RebalancePlan(moves=tuple(moves), unmoved=unmoved)
