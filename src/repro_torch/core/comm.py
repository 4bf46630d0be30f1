"""Uniform protocol-level message accounting (the paper's units).

Both protocol engines keep engine-specific counters while running — the
event-driven engine distinguishes element/row messages from rows shipped
inside sketch sends, the shard_map engine keeps jit-able i32 scalars — but
everything downstream (tracker snapshots, the runtime registry, benchmarks)
consumes one shape: ``CommReport``.  A message is one d-dimensional row or
one scalar pair; a sketch of r rows costs r messages; a coordinator
broadcast costs m messages.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CommReport", "build_report"]


@dataclass(frozen=True)
class CommReport:
    """Engine-agnostic communication report with uniform field names.

    scalar_msgs:      (total, W_i)-style scalar messages, site -> C.
    row_msgs:         d-dimensional row messages, site -> C — element/
                      direction sends *and* rows shipped inside sketches.
    broadcast_events: coordinator -> all-sites broadcasts (each costs m).
    m:                number of sites, so ``total`` is self-contained.
    """

    scalar_msgs: int
    row_msgs: int
    broadcast_events: int
    m: int

    @property
    def total(self) -> int:
        """Total message cost in the paper's units (broadcasts cost m each)."""
        return self.scalar_msgs + self.row_msgs + self.broadcast_events * self.m

    def as_dict(self) -> dict[str, int]:
        """The report as a plain dict (includes the derived ``total``)."""
        return {
            "scalar_msgs": self.scalar_msgs,
            "row_msgs": self.row_msgs,
            "broadcast_events": self.broadcast_events,
            "m": self.m,
            "total": self.total,
        }

    def __getitem__(self, key: str) -> int:
        # Dict-style access; "scalar"/"rows" kept as aliases of the old
        # TrackerSnapshot.messages dict keys.
        aliases = {"scalar": "scalar_msgs", "rows": "row_msgs"}
        return self.as_dict()[aliases.get(key, key)]

    def emit(self, registry, **labels) -> None:
        """Set the paper-level comm gauges on an obs registry.

        ``labels`` (typically ``cell=...``, ``tenant=...``) select the
        series; one gauge per report field plus the derived total in the
        paper's units.  Gauges, not counters: a report is a snapshot of
        cumulative protocol state, re-emitted whole at every publish.
        """
        names = tuple(sorted(labels))
        for field, value in self.as_dict().items():
            registry.gauge(
                f"repro_comm_{field}",
                "Protocol communication accounting (paper units); "
                "total = scalar + rows + broadcasts*m.",
                labels=names,
            ).labels(**labels).set(value)


def build_report(*, scalar_msgs, row_msgs, broadcast_events, m) -> CommReport:
    """The one place engine counters collapse into a ``CommReport``.

    Both engines route through here — the event engine with
    ``item_msgs + sketch_rows`` as its row count, the shard_map engine
    with jit-able i32 scalars — so they cannot drift in what they count
    or how values are coerced (everything lands as a Python ``int``).
    """
    return CommReport(
        scalar_msgs=int(scalar_msgs),
        row_msgs=int(row_msgs),
        broadcast_events=int(broadcast_events),
        m=int(m),
    )
