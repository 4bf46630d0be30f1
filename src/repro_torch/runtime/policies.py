"""Tenant policies: when to publish, and how much serving a tenant may queue.

The tracker side of the runtime ingests continuously; the serving side
reads immutable versioned snapshots from the ``SketchStore``.  A
``PublishPolicy`` decides, after every ingest super-step, whether the gap
between the live sketch and the last published version justifies a new
version.  Publishing is cheap (one host copy of an (l, d) matrix) but not
free: every version is a spectrum-cache miss for the serving engine, so
policies trade snapshot freshness against cache churn.

``TenantQuota`` is the admission-side policy: a bound on how many queries a
tenant may hold queued in the ``PackedQueryService`` at once (overflow is
shed at submit time with a typed error — never silently dropped) and a
priority that orders tenants inside each capped packed dispatch sweep.

Policies are plain-config objects; ``policy_to_config``/``policy_from_config``
round-trip them through JSON so a ``StreamingPipeline`` checkpoint can
restore each tenant's publish cadence exactly.
"""
from __future__ import annotations

import abc
from typing import NamedTuple

__all__ = [
    "PublishPolicy",
    "EveryKSteps",
    "FrobDrift",
    "OnDemand",
    "OnWindowClose",
    "TenantQuota",
    "RetryPolicy",
    "policy_to_config",
    "policy_from_config",
]


class PublishPolicy(abc.ABC):
    """Decides when a tenant's live sketch becomes a served store version."""

    #: Whether the policy reads ``live_frob``.  When False the pipeline
    #: skips computing the tracker's Frobenius estimate each ingest step
    #: (for P3 that materializes the whole estimator matrix).
    needs_live_frob: bool = True

    #: Whether the policy reads ``windows_closed``.  When True the pipeline
    #: passes the tenant adapter's closed-window count as an extra keyword
    #: after each ingest step (only windowed adapters track one).
    needs_window_close: bool = False

    @abc.abstractmethod
    def should_publish(
        self,
        *,
        steps_since_publish: int,
        live_frob: float,
        published_frob: float | None,
    ) -> bool:
        """Decide right after an ingest step.

        steps_since_publish: ingest steps since the last publish (>= 1).
        live_frob:           the tracker's current ``||A||_F^2`` estimate.
        published_frob:      the last published snapshot's estimate, or
                             None if this tenant has never published.
        """


class EveryKSteps(PublishPolicy):
    """Publish after every k ingest steps (k=1: a snapshot per super-step)."""

    needs_live_frob = False

    def __init__(self, k: int = 1):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k

    def should_publish(self, *, steps_since_publish, live_frob, published_frob):
        """Publish iff k ingest steps have accumulated since the last one."""
        return steps_since_publish >= self.k

    def __repr__(self):
        return f"EveryKSteps(k={self.k})"


class FrobDrift(PublishPolicy):
    """Publish when the stream mass grew by a relative factor.

    The paper's protocols themselves only react when ``||A||_F^2`` drifts by
    (1 + eps); serving snapshots on the same geometric schedule keeps the
    store's version count logarithmic in the stream mass while bounding the
    staleness of any served answer to one ``rel`` factor.  A tenant that has
    never published always publishes.
    """

    def __init__(self, rel: float = 0.1):
        if rel <= 0:
            raise ValueError(f"rel must be > 0, got {rel}")
        self.rel = rel

    def should_publish(self, *, steps_since_publish, live_frob, published_frob):
        """Publish on first call, then only on > (1+rel) relative mass growth."""
        if published_frob is None:
            return True
        return live_frob > (1.0 + self.rel) * published_frob

    def __repr__(self):
        return f"FrobDrift(rel={self.rel})"


class OnDemand(PublishPolicy):
    """Never auto-publish; snapshots appear only via ``pipeline.publish()``."""

    needs_live_frob = False

    def should_publish(self, *, steps_since_publish, live_frob, published_frob):
        """Never auto-publish."""
        return False

    def __repr__(self):
        return "OnDemand()"


class OnWindowClose(PublishPolicy):
    """Publish whenever the tenant's watermark closes a window bucket.

    The natural cadence for windowed tenants: a version appears exactly
    when a bucket boundary passes the watermark, so every served snapshot
    corresponds to a completed window edge rather than an arbitrary step
    count.  ``seen`` tracks the closed-window count already published
    (checkpointed, so a restored pipeline does not re-publish old edges).
    Non-windowed adapters never report closed windows, so attaching this
    policy to one behaves like ``OnDemand``.
    """

    needs_live_frob = False
    needs_window_close = True

    def __init__(self, seen: int = 0):
        if seen < 0:
            raise ValueError(f"seen must be >= 0, got {seen}")
        self.seen = int(seen)

    def should_publish(
        self, *, steps_since_publish, live_frob, published_frob, windows_closed=0
    ):
        """Publish iff new window buckets closed since the last publish."""
        if windows_closed > self.seen:
            self.seen = int(windows_closed)
            return True
        return False

    def __repr__(self):
        return f"OnWindowClose(seen={self.seen})"


# ---------------------------------------------------------------------------
# Admission quotas / priorities (enforced by query.service.PackedQueryService)
# ---------------------------------------------------------------------------


class TenantQuota(NamedTuple):
    """Per-tenant admission policy for the packed query service.

    max_pending: bound on queued-but-unserved queries for the tenant; a
                 submit beyond it is *shed* — rejected with a typed
                 ``QueryShedError`` and counted in service stats, never
                 silently dropped (0 = unbounded).
    priority:    tenants are packed into each capped dispatch sweep in
                 descending priority order (ties broken by tenant name), so
                 under overload high-priority tenants are served first.
    """

    max_pending: int = 0
    priority: int = 0


# ---------------------------------------------------------------------------
# Transport resilience (consumed by the cluster router/transport layer)
# ---------------------------------------------------------------------------


class RetryPolicy(NamedTuple):
    """Capped exponential backoff with deterministic jitter.

    A message gets ``max_attempts`` total sends; retry ``k`` (1-based)
    waits ``min(cap_s, base_s * 2**(k-1))``, reduced by up to ``jitter``
    fraction via a caller-supplied uniform draw (the router feeds a
    seeded PRNG so the whole backoff schedule is reproducible).  The
    spent budget — retries sent and seconds slept — is surfaced in
    ``ClusterRouter.stats()``.
    """

    max_attempts: int = 4
    base_s: float = 0.01
    cap_s: float = 1.0
    jitter: float = 0.5

    def validate(self) -> "RetryPolicy":
        """Raise on nonsensical parameters; returns self for chaining."""
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_s < 0 or self.cap_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        return self

    def backoff_s(self, attempt: int, u: float = 0.0) -> float:
        """Sleep before retry ``attempt`` (1-based); ``u`` in [0, 1) jitters."""
        raw = min(self.cap_s, self.base_s * (2.0 ** (attempt - 1)))
        return raw * (1.0 - self.jitter * u)


# ---------------------------------------------------------------------------
# Policy <-> JSON config (for pipeline checkpoints)
# ---------------------------------------------------------------------------

_POLICY_TYPES = {
    "EveryKSteps": EveryKSteps,
    "FrobDrift": FrobDrift,
    "OnDemand": OnDemand,
    "OnWindowClose": OnWindowClose,
}


def policy_to_config(policy: PublishPolicy) -> dict:
    """Serialize a policy to a JSON-able ``{"type": ..., params...}`` dict."""
    if isinstance(policy, EveryKSteps):
        return {"type": "EveryKSteps", "k": policy.k}
    if isinstance(policy, FrobDrift):
        return {"type": "FrobDrift", "rel": policy.rel}
    if isinstance(policy, OnDemand):
        return {"type": "OnDemand"}
    if isinstance(policy, OnWindowClose):
        return {"type": "OnWindowClose", "seen": policy.seen}
    raise TypeError(
        f"cannot serialize publish policy {policy!r}; custom policies must be "
        "re-attached after StreamingPipeline.load"
    )


def policy_from_config(config: dict) -> PublishPolicy:
    """Invert ``policy_to_config``."""
    kw = {k: v for k, v in config.items() if k != "type"}
    try:
        cls = _POLICY_TYPES[config["type"]]
    except KeyError:
        raise ValueError(f"unknown publish policy config {config!r}") from None
    return cls(**kw)
