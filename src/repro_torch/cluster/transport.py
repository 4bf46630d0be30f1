"""Fault-injectable in-process transport between the router and its cells.

A copy of the reference's ``cluster/transport.py`` with its imports
rewritten to the port's ``obs``, query engine and query service.

The paper's eps-guarantee and its O((m/eps) log(beta N)) communication
bound both assume every site->coordinator message is delivered exactly
once: a dropped push silently weakens the served envelope, a duplicated
one double-counts rows and breaks it outright.  This module makes that
assumption *checkable* instead of implicit by putting a real message
boundary between ``ClusterRouter`` and each ``PipelineCell``:

  * typed envelopes — ``Ingest`` (stamped ``(tenant, site, seq)`` so the
    receiving cell can deduplicate and reassemble), ``Query``,
    ``Export``, and ``Heartbeat``; replies are ``IngestAck`` /
    ``HeartbeatAck`` / the cell's native return values.
  * ``Transport`` — a synchronous in-process link with per-send fault
    injection.  Every ``send`` consumes one global message index
    (retries included — that is what lets the chaos tests account for
    every retry), and a ``FaultPlan`` scripts what happens at each
    index: **drop** (the message is lost; the sender sees
    ``TransportTimeout``), **duplicate** (delivered twice; the second
    delivery's reply is discarded, exercising receiver idempotence),
    **delay** (parked at the destination and delivered *after* a later
    message — an observable reorder), **crash** (the destination dies
    mid-receive and stays dead until ``revive``).
  * ``CircuitBreaker`` — the classic closed/open/half-open machine the
    router keeps per cell, with an injectable clock so tests drive the
    cooldown deterministically.
  * ``IngestShedError`` — raised when an unreachable cell's bounded
    replay queue overflows; it subclasses ``QueryShedError`` so the
    overflow rides the existing ``TenantQuota`` shed-and-report path.

Determinism is the design goal: a ``FaultPlan`` is a pure function of
the global send index, so the same sequence of sends under the same plan
produces the same faults, the same retries, and — because the cells are
idempotent — byte-identical served answers (``tests/test_chaos.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.obs import Observability, rehome_families
from repro_torch.query.engine import PackedRequest
from repro_torch.query.service import QueryShedError

__all__ = [
    "Ingest",
    "Query",
    "Export",
    "Heartbeat",
    "IngestAck",
    "HeartbeatAck",
    "TransportTimeout",
    "CellDownError",
    "IngestShedError",
    "StalenessExceededError",
    "FaultPlan",
    "Transport",
    "CircuitBreaker",
]


# ---------------------------------------------------------------------------
# Envelopes (the wire format, minus the wire)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Ingest:
    """One super-step batch: ``(tenant, site, seq)`` is the dedup identity.

    ``seq`` is per ``(tenant, site)`` and starts at 1; the receiving cell
    applies batches in seq order exactly once, acking duplicates without
    re-applying and parking out-of-order arrivals until the gap fills.
    ``rows`` is whatever the tenant's workload ingests (a row block, or a
    ``(keys, weights)`` pair for item workloads).

    ``trace_id`` (here and on every envelope kind) stitches distributed
    traces: the sender stamps its live trace, and the receiving cell
    joins its ``cell.deliver`` span to that trace — retries, duplicates,
    and late replays of one logical message all land in one tree.
    """

    tenant: str
    site: str
    seq: int
    rows: object
    trace_id: str | None = None


@dataclass(frozen=True)
class Query:
    """A packed query group for one cell (a tuple of ``PackedRequest``)."""

    requests: tuple[PackedRequest, ...]
    trace_id: str | None = None


@dataclass(frozen=True)
class Export:
    """Request one tenant's portable export payload (rebalance path)."""

    tenant: str
    trace_id: str | None = None


@dataclass(frozen=True)
class Heartbeat:
    """Liveness probe; the reply carries the cell's tenant count."""

    seq: int
    trace_id: str | None = None


class IngestAck(NamedTuple):
    """Receiver's answer to one ``Ingest``.

    status:  ``"applied"`` (first delivery, absorbed now — possibly along
             with previously-parked successors), ``"duplicate"`` (seq is
             below the dedup window; acknowledged, NOT re-applied), or
             ``"parked"`` (ahead of the window; held until the gap fills).
    seq:     echo of the envelope's seq.
    version: the newest version published while absorbing this delivery
             (None if the publish policy did not fire or nothing applied).
    """

    status: str
    seq: int
    version: int | None


class HeartbeatAck(NamedTuple):
    """Reply to a ``Heartbeat``: the probe's seq + the cell's tenant count."""

    seq: int
    tenants: int


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


class TransportTimeout(RuntimeError):
    """The message was lost (dropped/delayed/crashed mid-receive): no reply.

    The sender cannot distinguish "never arrived" from "arrived but the
    ack was lost" — which is exactly why receivers must be idempotent.
    """


class CellDownError(RuntimeError):
    """The destination endpoint is crashed and has not been revived."""


class IngestShedError(QueryShedError):
    """An unreachable cell's bounded replay queue overflowed.

    Subclasses ``QueryShedError`` so cluster-edge accounting
    (``ClusterRouter.shed_counts``) and callers' shed handling treat
    ingest overflow exactly like the existing ``TenantQuota`` query
    sheds: typed, counted, never silent.
    """


class StalenessExceededError(RuntimeError):
    """A degraded replica answer would exceed its declared staleness bound."""

    def __init__(self, tenant: str, behind: int, bound: int):
        super().__init__(
            f"tenant {tenant!r}: replica is {behind} versions behind the last "
            f"known owner version, beyond the declared bound {bound}"
        )
        self.tenant = tenant
        self.behind = behind
        self.bound = bound


# ---------------------------------------------------------------------------
# FaultPlan — scripted, seeded, deterministic
# ---------------------------------------------------------------------------


class FaultPlan:
    """Scripted faults keyed by the transport's global send index.

    Each action set holds message indices (0-based, in send order —
    retries consume indices too).  An index may appear in at most one
    set; overlap is an authoring error and raises.  ``seeded`` builds a
    reproducible plan from a PRNG seed, which is how the chaos suite
    sweeps schedules: same seed, same plan, same run.
    """

    def __init__(self, *, drop=(), duplicate=(), delay=(), crash=()):
        self.drop = frozenset(int(i) for i in drop)
        self.duplicate = frozenset(int(i) for i in duplicate)
        self.delay = frozenset(int(i) for i in delay)
        self.crash = frozenset(int(i) for i in crash)
        sets = [self.drop, self.duplicate, self.delay, self.crash]
        total = sum(len(s) for s in sets)
        if len(frozenset().union(*sets)) != total:
            raise ValueError("fault plan assigns multiple actions to one message index")

    @classmethod
    def seeded(
        cls,
        seed: int,
        n_messages: int,
        *,
        p_drop: float = 0.05,
        p_duplicate: float = 0.05,
        p_delay: float = 0.05,
        crash_at: int | None = None,
    ) -> "FaultPlan":
        """A reproducible random plan over the first ``n_messages`` sends.

        Disjoint probability bands of one uniform draw per index assign
        at most one action each; ``crash_at`` (if given) overrides
        whatever band its index fell in.
        """
        if p_drop + p_duplicate + p_delay > 1.0:
            raise ValueError("fault probabilities must sum to <= 1")
        u = np.random.default_rng(seed).random(n_messages)
        drop = {i for i in range(n_messages) if u[i] < p_drop}
        duplicate = {
            i for i in range(n_messages) if p_drop <= u[i] < p_drop + p_duplicate
        }
        delay = {
            i
            for i in range(n_messages)
            if p_drop + p_duplicate <= u[i] < p_drop + p_duplicate + p_delay
        }
        crash = set()
        if crash_at is not None:
            drop.discard(crash_at)
            duplicate.discard(crash_at)
            delay.discard(crash_at)
            crash.add(crash_at)
        return cls(drop=drop, duplicate=duplicate, delay=delay, crash=crash)

    def action(self, index: int) -> str | None:
        """The scripted action for one send index (None = deliver cleanly)."""
        if index in self.crash:
            return "crash"
        if index in self.drop:
            return "drop"
        if index in self.duplicate:
            return "duplicate"
        if index in self.delay:
            return "delay"
        return None

    def __repr__(self) -> str:
        return (
            f"FaultPlan(drop={sorted(self.drop)}, duplicate={sorted(self.duplicate)}, "
            f"delay={sorted(self.delay)}, crash={sorted(self.crash)})"
        )


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------


class Transport:
    """Synchronous in-process message link with scripted fault injection.

    Endpoints are ``name -> handler(envelope) -> reply`` registrations
    (a cell's ``deliver``).  ``send`` consumes one global message index,
    consults the ``FaultPlan`` (if any), and either delivers, raises
    ``TransportTimeout`` (drop/delay/crash-mid-receive), or raises
    ``CellDownError`` (endpoint crashed earlier, not yet revived).

    Delayed envelopes park at their destination and flush — in park
    order, reply discarded — right after the *next* successful delivery
    to that endpoint: a later message observably overtakes an earlier
    one, which is the reorder the cells' seq windows must absorb.  A
    crash discards the crashed endpoint's parked envelopes (in-flight
    messages die with the link).

    ``counters`` partition every send by outcome, so chaos tests can
    assert ``sends == delivered + dropped + delayed + crashed + down``
    exactly — no message unaccounted for.  Both it and ``sends`` are
    views over the obs registry (``repro_transport_sends_total`` /
    ``repro_transport_outcomes_total{outcome=...}``).
    """

    # Outcome order is the legacy counters-dict order (tests rely on it).
    _OUTCOMES = (
        "delivered",  # primary deliveries that returned a reply
        "dropped",  # lost outright (scripted drop)
        "delayed",  # parked for late delivery (scripted delay)
        "crashed",  # killed the destination mid-receive
        "down",  # sent at a dead endpoint
        "duplicate_deliveries",  # extra handler calls beyond delivered
        "late_deliveries",  # parked envelopes flushed late
    )

    _FAMILIES = (
        ("counter", "repro_transport_sends_total",
         "Global message indices consumed (retries included)."),
        ("counter", "repro_transport_outcomes_total",
         "Sends partitioned by delivery outcome."),
    )

    def __init__(self, *, plan: FaultPlan | None = None,
                 obs: Observability | None = None):
        self.plan = plan
        self.obs = obs if obs is not None else Observability(labels={})
        self._bind_metrics()
        self._endpoints: dict[str, Callable] = {}
        self._down: set[str] = set()
        self._parked: dict[str, list[object]] = {}

    # -- telemetry ----------------------------------------------------------

    def _bind_metrics(self) -> None:
        self._m_sends = self.obs.handle(
            "counter", "repro_transport_sends_total",
            "Global message indices consumed (retries included).")
        self._m_outcomes = {
            k: self.obs.handle(
                "counter", "repro_transport_outcomes_total",
                "Sends partitioned by delivery outcome.",
                labels={"outcome": k})
            for k in self._OUTCOMES
        }

    def bind_obs(self, obs: Observability) -> None:
        """Re-home the transport's telemetry into another bundle."""
        old, self.obs = self.obs, obs
        rehome_families(old, obs, self._FAMILIES)
        self._bind_metrics()

    @property
    def sends(self) -> int:
        """Global message index consumed per ``send()`` (registry view)."""
        return int(self._m_sends.value)

    @property
    def counters(self) -> dict[str, int]:
        """Every send partitioned by outcome (fresh dict, registry view)."""
        return {k: int(self._m_outcomes[k].value) for k in self._OUTCOMES}

    # -- topology ------------------------------------------------------------

    def register(self, name: str, handler: Callable) -> None:
        """Attach an endpoint (replacing any previous handler under ``name``)."""
        self._endpoints[name] = handler
        self._down.discard(name)

    def endpoints(self) -> list[str]:
        """Registered endpoint names (sorted; includes crashed ones)."""
        return sorted(self._endpoints)

    def is_down(self, name: str) -> bool:
        """Whether the endpoint is crashed and awaiting ``revive``."""
        return name in self._down

    def crash(self, name: str) -> None:
        """Kill an endpoint: parked envelopes are lost, sends raise until
        ``revive``.  Also reachable from a plan's scripted ``crash`` index."""
        if name not in self._endpoints:
            raise KeyError(f"unknown endpoint {name!r}")
        self._down.add(name)
        self._parked.pop(name, None)

    def revive(self, name: str, handler: Callable) -> None:
        """Bring a crashed endpoint back with a (possibly rebuilt) handler."""
        if name not in self._endpoints:
            raise KeyError(f"unknown endpoint {name!r}")
        self._endpoints[name] = handler
        self._down.discard(name)

    # -- the link ------------------------------------------------------------

    def send(self, name: str, envelope) -> object:
        """Deliver one envelope; returns the handler's reply.

        Raises ``TransportTimeout`` when the scripted fault loses the
        message (drop, delay, crash-mid-receive) and ``CellDownError``
        when the endpoint is already dead.  Either way the caller has no
        reply and must retry — receivers are idempotent precisely so
        that retrying after an ack-loss cannot double-apply.
        """
        if name not in self._endpoints:
            raise KeyError(f"unknown endpoint {name!r}")
        index = int(self._m_sends.value)
        self._m_sends.inc()
        action = self.plan.action(index) if self.plan is not None else None
        if name in self._down:
            self._m_outcomes["down"].inc()
            raise CellDownError(f"cell {name!r} is down (message {index})")
        if action == "crash":
            self._m_outcomes["crashed"].inc()
            self.crash(name)
            raise TransportTimeout(f"cell {name!r} crashed receiving message {index}")
        if action == "drop":
            self._m_outcomes["dropped"].inc()
            raise TransportTimeout(f"message {index} to {name!r} dropped")
        if action == "delay":
            self._m_outcomes["delayed"].inc()
            self._parked.setdefault(name, []).append(envelope)
            raise TransportTimeout(f"message {index} to {name!r} delayed")
        reply = self._endpoints[name](envelope)
        self._m_outcomes["delivered"].inc()
        if action == "duplicate":
            # The network delivered a second copy; its reply goes nowhere.
            self._endpoints[name](envelope)
            self._m_outcomes["duplicate_deliveries"].inc()
        self._flush_parked(name)
        return reply

    def _flush_parked(self, name: str) -> None:
        # Late arrivals land after the message that followed them — the
        # receiver sees a genuine reorder (and, for already-retried
        # envelopes, a genuine duplicate).  Replies are discarded: the
        # original sender gave up on these long ago.
        for envelope in self._parked.pop(name, []):
            self._endpoints[name](envelope)
            self._m_outcomes["late_deliveries"].inc()


# ---------------------------------------------------------------------------
# CircuitBreaker
# ---------------------------------------------------------------------------


@dataclass
class CircuitBreaker:
    """Per-cell closed/open/half-open breaker with an injectable clock.

    Closed counts consecutive *message* failures (a message fails only
    after its retry budget is exhausted); at ``failure_threshold`` the
    breaker opens and ``allow`` refuses traffic for ``cooldown_s``.
    After the cooldown, one probe is allowed (half-open): success closes
    the breaker, failure re-opens it for a fresh cooldown.  The clock is
    injectable so tests step time deterministically.
    """

    failure_threshold: int = 3
    cooldown_s: float = 30.0
    clock: Callable[[], float] = field(default=None)  # type: ignore[assignment]
    state: str = "closed"
    failures: int = 0
    opens: int = 0
    _opened_at: float = 0.0
    _probing: bool = False

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {self.failure_threshold}")
        if self.clock is None:
            import time

            self.clock = time.monotonic

    def allow(self) -> bool:
        """Whether a message may be sent now (may transition open->half-open)."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.clock() - self._opened_at >= self.cooldown_s:
                self.state = "half-open"
                self._probing = True
                return True
            return False
        # half-open: exactly one in-flight probe
        if not self._probing:
            self._probing = True
            return True
        return False

    def record_success(self) -> None:
        """A message got a reply: reset the failure run and close."""
        self.state = "closed"
        self.failures = 0
        self._probing = False

    def record_failure(self) -> None:
        """A message exhausted its retries: count it; open at the threshold."""
        self.failures += 1
        if self.state == "half-open" or self.failures >= self.failure_threshold:
            if self.state != "open":
                self.opens += 1
            self.state = "open"
            self._opened_at = self.clock()
            self._probing = False
