"""Versioned sketch store — the coordinator's published artifact shelf.

In the paper the coordinator maintains one sketch B and answers
``||A x||^2 ~ ||B x||^2`` queries against it.  At serving scale the sketch
and the query path must be decoupled: trackers *publish* coordinator
sketches here as immutable, monotonically-versioned snapshots (one sequence
per tenant namespace), and the query engine pins a version for the lifetime
of a batch — readers never observe a half-updated sketch and repeated
queries against a pinned version are trivially cacheable.

    tracker.publish(store, tenant="run-42")   # writer side, cheap
    store.get("run-42")                       # latest snapshot
    store.get("run-42", version=7)            # pinned historical snapshot

``retain`` bounds memory: only the newest ``retain`` versions per tenant
are kept (0 = unbounded).  All operations are thread-safe.

``state_tree``/``from_state_tree`` give the store as checkpoint halves,
and ``save``/``load`` write and read them through ``repro_torch.ckpt`` in
the reference's format.
"""
from __future__ import annotations

import threading
from typing import Any, Mapping, NamedTuple

import numpy as np

__all__ = ["SketchSnapshot", "SketchStore"]


class SketchSnapshot(NamedTuple):
    """One immutable published sketch.

    matrix:    (l, d) f32 sketch B, write-protected.
    frob:      coordinator estimate of the stream mass ``||A||_F^2``.
    eps:       approximation parameter the sketch was built for.
    delta_sum: accumulated FD shrink mass when known (single-stream
               sketches) — the instance-specific error bound; None for
               distributed protocols where only the paper's worst case
               ``eps * ||A||_F^2`` is certified.
    n_seen:    rows of the stream the sketch summarizes.
    published_at: publish timestamp on the tenant's own timeline —
               wall-clock (``obs`` clock) for full-stream tenants, the
               event-time watermark for windowed tenants; 0.0 when the
               publisher tracks no time.  The axis ``as_of`` reads along.
    """

    tenant: str
    version: int
    matrix: np.ndarray
    frob: float
    eps: float
    delta_sum: float | None
    n_seen: int
    meta: Mapping[str, Any]
    published_at: float = 0.0

    @property
    def error_bound(self) -> float:
        """Additive bound on ``||A x||^2 - ||B x||^2`` for unit directions x."""
        if self.delta_sum is not None:
            return float(self.delta_sum)
        return float(self.eps * self.frob)


class SketchStore:
    """Per-tenant, monotonically versioned snapshot registry."""

    def __init__(self, *, retain: int = 0):
        if retain < 0:
            raise ValueError(f"retain must be >= 0, got {retain}")
        self.retain = retain
        self._lock = threading.Lock()
        self._snaps: dict[str, dict[int, SketchSnapshot]] = {}
        self._next_version: dict[str, int] = {}

    def publish(
        self,
        tenant: str,
        matrix: np.ndarray,
        *,
        frob: float,
        eps: float,
        delta_sum: float | None = None,
        n_seen: int = 0,
        meta: Mapping[str, Any] | None = None,
        published_at: float = 0.0,
    ) -> SketchSnapshot:
        """Register a sketch as the tenant's next version; returns the snapshot."""
        b = np.array(matrix, dtype=np.float32, copy=True)
        if b.ndim != 2:
            raise ValueError(f"sketch matrix must be 2-D, got shape {b.shape}")
        b.setflags(write=False)
        with self._lock:
            version = self._next_version.get(tenant, 1)
            self._next_version[tenant] = version + 1
            snap = SketchSnapshot(
                tenant=tenant,
                version=version,
                matrix=b,
                frob=float(frob),
                eps=float(eps),
                delta_sum=None if delta_sum is None else float(delta_sum),
                n_seen=int(n_seen),
                meta=dict(meta or {}),
                published_at=float(published_at),
            )
            shelf = self._snaps.setdefault(tenant, {})
            shelf[version] = snap
            if self.retain:
                for old in sorted(shelf)[: -self.retain]:
                    del shelf[old]
            return snap

    def get(self, tenant: str, version: int | None = None) -> SketchSnapshot:
        """Fetch a snapshot; ``version=None`` means the latest."""
        with self._lock:
            shelf = self._snaps.get(tenant)
            if not shelf:
                raise KeyError(f"no sketches published for tenant {tenant!r}")
            if version is None:
                version = max(shelf)
            snap = shelf.get(version)
            if snap is None:
                raise KeyError(
                    f"tenant {tenant!r} has no version {version} "
                    f"(available: {sorted(shelf)})"
                )
            return snap

    def latest_version(self, tenant: str) -> int:
        """The tenant's newest published version number."""
        return self.get(tenant).version

    def versions(self, tenant: str) -> list[int]:
        """All retained version numbers for a tenant (ascending)."""
        with self._lock:
            return sorted(self._snaps.get(tenant, {}))

    def versions_since(self, tenant: str, after: int) -> list[SketchSnapshot]:
        """Retained snapshots newer than version ``after`` (ascending).

        The replica-sync API: a ``ServingReplica`` tracks the last version
        it pulled per tenant and asks the owning cell for everything
        published since.  ``after=0`` returns every retained version; an
        unknown tenant returns ``[]`` (replicas poll ahead of the first
        publish).  Snapshots are immutable, so handing them across the
        cell boundary shares, never copies.
        """
        with self._lock:
            shelf = self._snaps.get(tenant, {})
            return [shelf[v] for v in sorted(shelf) if v > after]

    def as_of(self, tenant: str, t: float) -> SketchSnapshot:
        """Time-travel read: the newest snapshot published at or before ``t``.

        Versions are immutable and ``published_at`` rides the tenant's own
        timeline (watermark time for windowed tenants), so ``as_of`` lets
        a query replay the exact sketch that was live at any retained
        instant.  Ties (equal ``published_at``) resolve to the higher
        version.  Raises ``KeyError`` when the tenant has no snapshot that
        old — same contract as ``get`` on an unknown version.
        """
        t = float(t)
        with self._lock:
            shelf = self._snaps.get(tenant)
            if not shelf:
                raise KeyError(f"no sketches published for tenant {tenant!r}")
            for v in sorted(shelf, reverse=True):
                if shelf[v].published_at <= t:
                    return shelf[v]
            raise KeyError(
                f"tenant {tenant!r} has no snapshot published at or before t={t} "
                f"(oldest retained: {min(s.published_at for s in shelf.values())})"
            )

    def install(self, snap: SketchSnapshot) -> SketchSnapshot:
        """Install an already-versioned snapshot (replica sync / tenant import).

        Unlike ``publish`` the version number is *preserved* — the cell
        that built the snapshot owns the tenant's version sequence and
        this store mirrors it.  Installing an existing ``(tenant,
        version)`` pair is a no-op returning the resident snapshot
        (idempotent sync); the per-tenant ``retain`` bound still applies.
        """
        with self._lock:
            shelf = self._snaps.setdefault(snap.tenant, {})
            if snap.version in shelf:
                return shelf[snap.version]
            shelf[snap.version] = snap
            nxt = self._next_version.get(snap.tenant, 1)
            self._next_version[snap.tenant] = max(nxt, snap.version + 1)
            if self.retain:
                for old in sorted(shelf)[: -self.retain]:
                    del shelf[old]
            return snap

    def drop_tenant(self, tenant: str) -> int:
        """Forget a tenant's snapshots *and* its version counter.

        Returns the number of snapshots dropped.  Used by the cluster
        rebalancer after a tenant export: the destination cell now owns
        the version sequence, so the source must not retain a counter
        that could fork it.
        """
        with self._lock:
            dropped = len(self._snaps.pop(tenant, {}))
            self._next_version.pop(tenant, None)
            return dropped

    def export_tenant(self, tenant: str) -> tuple[dict, dict]:
        """One tenant's snapshots as ``(tree, extra)`` checkpoint halves.

        The tenant-scoped subset of ``state_tree``: same leaf/extra format
        (``kind: "sketch_store"``), restricted to one tenant's versions
        and version counter.  ``import_tenant`` on another store installs
        it bit-identically — the cluster rebalancer's payload for moving
        a live tenant between cells.
        """
        with self._lock:
            shelf = self._snaps.get(tenant, {})
            snaps = [shelf[v] for v in sorted(shelf)]
            next_version = {tenant: self._next_version.get(tenant, 1)}
        tree = {f"snap_{i:05d}": snap.matrix for i, snap in enumerate(snaps)}
        extra = {
            "kind": "sketch_store",
            "retain": self.retain,
            "next_version": next_version,
            "snapshots": [
                {
                    "key": f"snap_{i:05d}",
                    "tenant": snap.tenant,
                    "version": snap.version,
                    "shape": list(snap.matrix.shape),
                    "frob": snap.frob,
                    "eps": snap.eps,
                    "delta_sum": snap.delta_sum,
                    "n_seen": snap.n_seen,
                    "meta": dict(snap.meta),
                    "published_at": snap.published_at,
                }
                for i, snap in enumerate(snaps)
            ],
        }
        return tree, extra

    def import_tenant(self, tree: dict, extra: dict) -> list[int]:
        """Install an ``export_tenant`` payload; returns installed versions.

        Refuses to overwrite: importing a tenant that already has
        snapshots (or a version counter) here raises — a rebalance must
        move a tenant onto a cell that does not serve it yet.
        """
        if extra.get("kind") != "sketch_store":
            raise ValueError(
                f"tenant payload is not a sketch store export: {extra.get('kind')!r}"
            )
        tenants = {e["tenant"] for e in extra["snapshots"]} | set(extra["next_version"])
        if len(tenants) > 1:
            raise ValueError(f"tenant payload spans multiple tenants: {sorted(tenants)}")
        with self._lock:
            for t in tenants:
                if t in self._snaps or t in self._next_version:
                    raise ValueError(
                        f"tenant {t!r} already present in this store; "
                        "drop_tenant it before importing"
                    )
        # Validate the whole payload BEFORE installing anything: a truncated
        # tree or a manifest/leaf mismatch must raise with the store
        # untouched, never leave a half-imported tenant behind.
        for e in extra["snapshots"]:
            if e["key"] not in tree:
                raise ValueError(
                    f"truncated tenant payload: snapshot entry {e['key']!r} "
                    f"(version {e['version']}) has no matrix in the tree"
                )
            got = np.shape(tree[e["key"]])
            want = tuple(e.get("shape", got))
            if tuple(got) != want:
                raise ValueError(
                    f"tenant payload mismatch: snapshot {e['key']!r} has shape "
                    f"{tuple(got)}, manifest says {want}"
                )
        installed = []
        for e in extra["snapshots"]:
            b = np.asarray(tree[e["key"]], np.float32)
            b.setflags(write=False)
            self.install(
                SketchSnapshot(
                    tenant=e["tenant"],
                    version=int(e["version"]),
                    matrix=b,
                    frob=float(e["frob"]),
                    eps=float(e["eps"]),
                    delta_sum=None if e["delta_sum"] is None else float(e["delta_sum"]),
                    n_seen=int(e["n_seen"]),
                    meta=dict(e["meta"]),
                    published_at=float(e.get("published_at", 0.0)),
                )
            )
            installed.append(int(e["version"]))
        with self._lock:
            for t, v in extra["next_version"].items():
                self._next_version[t] = max(self._next_version.get(t, 1), int(v))
        return installed

    def tenants(self) -> list[str]:
        """All tenant namespaces with at least one published snapshot."""
        with self._lock:
            return sorted(self._snaps)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(s) for s in self._snaps.values())

    # -- persistence (checkpoint halves) -------------------------------------------

    def state_tree(self) -> tuple[dict, dict]:
        """The store as ``(tree, extra)`` checkpoint halves.

        ``tree`` maps leaf keys to snapshot matrices (hashed, compressed
        checkpoint leaves); ``extra`` is the JSON-able structure — tenant
        names, version numbers, certificates, metadata — that
        ``from_state_tree`` needs to rebuild the exact store.
        """
        with self._lock:
            snaps = [s for shelf in self._snaps.values() for s in shelf.values()]
            next_version = dict(self._next_version)
        snaps.sort(key=lambda s: (s.tenant, s.version))
        tree = {f"snap_{i:05d}": snap.matrix for i, snap in enumerate(snaps)}
        extra = {
            "kind": "sketch_store",
            "retain": self.retain,
            "next_version": next_version,
            "snapshots": [
                {
                    "key": f"snap_{i:05d}",
                    "tenant": snap.tenant,
                    "version": snap.version,
                    "shape": list(snap.matrix.shape),
                    "frob": snap.frob,
                    "eps": snap.eps,
                    "delta_sum": snap.delta_sum,
                    "n_seen": snap.n_seen,
                    "meta": dict(snap.meta),
                    "published_at": snap.published_at,
                }
                for i, snap in enumerate(snaps)
            ],
        }
        return tree, extra

    @staticmethod
    def state_template(extra: dict) -> dict:
        """Zero-filled restore template matching a ``state_tree`` extra."""
        return {e["key"]: np.zeros(e["shape"], np.float32) for e in extra["snapshots"]}

    @classmethod
    def from_state_tree(cls, tree: dict, extra: dict) -> "SketchStore":
        """Rebuild a store from ``state_tree`` halves (exact round-trip)."""
        if extra.get("kind") != "sketch_store":
            raise ValueError(f"state extra is not a sketch store: {extra.get('kind')!r}")
        store = cls(retain=int(extra.get("retain", 0)))
        with store._lock:
            for e in extra["snapshots"]:
                b = np.asarray(tree[e["key"]], np.float32)
                b.setflags(write=False)
                snap = SketchSnapshot(
                    tenant=e["tenant"],
                    version=int(e["version"]),
                    matrix=b,
                    frob=float(e["frob"]),
                    eps=float(e["eps"]),
                    delta_sum=None if e["delta_sum"] is None else float(e["delta_sum"]),
                    n_seen=int(e["n_seen"]),
                    meta=dict(e["meta"]),
                    published_at=float(e.get("published_at", 0.0)),
                )
                store._snaps.setdefault(snap.tenant, {})[snap.version] = snap
            store._next_version = {t: int(v) for t, v in extra["next_version"].items()}
        return store

    def save(self, directory: str, *, step: int = 0) -> str:
        """Persist every tenant's versions atomically; returns the path.

        Matrices become checkpoint leaves (hashed, compressed); everything
        else — tenant names, version numbers, certificates, metadata — rides
        the manifest's ``extra`` so ``load`` can rebuild the exact store.
        """
        from repro_torch import ckpt

        tree, extra = self.state_tree()
        return ckpt.save(directory, step, tree, extra=extra)

    @classmethod
    def load(cls, directory: str, *, step: int | None = None) -> "SketchStore":
        """Rebuild a store from ``save`` output (latest step by default).

        Snapshots are host numpy arrays, so the leaves are read to the CPU.
        """
        from repro_torch import ckpt

        if step is None:
            step = ckpt.latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no sketch-store checkpoint under {directory!r}")
        extra = ckpt.read_extra(directory, step)
        if extra.get("kind") != "sketch_store":
            raise ValueError(f"checkpoint at {directory!r} step {step} is not a sketch store")
        # restore() checks leaf shapes against a template; the store's tree
        # structure varies per save, so the template comes from extra.
        tree, _ = ckpt.restore(directory, step, cls.state_template(extra), device="cpu")
        return cls.from_state_tree(tree, extra)
