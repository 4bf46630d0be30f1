"""Typed protocol registry — one dispatch point for every engine and workload.

The reference registers every (kind, engine, protocol) implementation here
and its consumers (``DistributedMatrixTracker``, the streaming pipeline,
benchmarks) construct protocols through it.  Ported: the matrix,
heavy-hitter, quantile and leverage workload interfaces, each on the
event-driven engine (``core/protocols.py``, ``core/quantiles.py``,
``core/leverage.py``) and the super-step engine (``core/distributed.py``)::

    SketchProtocol
        step(rows, sites=None)   absorb a batch of stream rows
        matrix()                 the coordinator sketch B, (l, d) numpy
        frob_estimate()          coordinator estimate of ||A||_F^2
        comm_report()            uniform CommReport (paper message units)
        query(x) / query_batch() ||B x||^2 via the shared quadform kernel

    HHProtocol
        step(pairs, sites=None)  absorb an (n, 2) [element, weight] batch
        estimates()              coordinator {element: weight-estimate} map
        total_weight()           coordinator estimate of the stream mass W
        estimate(keys)           vectorized point lookups
        heavy_hitters(phi)       the paper's (phi - eps/2) W threshold set
        snapshot_matrix()        publishable (n, 2) encoding for the store

    QuantileProtocol
        step(pairs, sites=None)  absorb an (n, 2) [value, weight] batch
        table()                  coordinator (k, 2) [value, rank] table
        total_weight()           coordinator estimate of the stream mass W
        rank(values)             vectorized weighted-rank estimates
        quantile(phis)           vectorized eps-approximate phi-quantiles
        snapshot_matrix()        publishable (n, 2) encoding for the store

    LeverageProtocol
        step(rows, sites=None)   absorb an (n, d) batch of stream rows
        sampled_rows()           coordinator (k, d+2) [row|score|weight] table
        total_weight()           coordinator estimate of ||A||_F^2
        lam()                    the live ridge lambda the sample is scored at
        subspace_query(x)        importance-weighted ||A x||^2 estimate
        score_batch(xs)          ridge leverage scores via ops.levscore
        snapshot_matrix()        publishable (n, d+2) encoding for the store

All also speak the pipeline checkpoint contract — ``state_payload()`` /
``restore_payload()`` — with the reference's layout: the super-step
engine's state as the reference's flattened leaves, the event engines'
as their JSON-able ``state_dict``, so a payload taken from the reference
restores here and vice versa.  The super-step engines also speak the
packed-ingest contract (``pack_key`` / ``apply_packed``, a lazy ``state``);
only the row-input kinds pack.  The windowed flavours are not ported yet.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import f32_on, resolve_device
from repro_torch.core import distributed as dist
from repro_torch.core import leverage as lev
from repro_torch.core import protocols as event
from repro_torch.core import quantiles as quant
from repro_torch.core.comm import CommReport
from repro_torch.core.hh import encode_hh_snapshot

__all__ = [
    "SketchProtocol",
    "HHProtocol",
    "QuantileProtocol",
    "LeverageProtocol",
    "EventProtocol",
    "EventHHProtocol",
    "EventQuantileProtocol",
    "EventLeverageProtocol",
    "ShardProtocol",
    "ShardHHProtocol",
    "ShardQuantileProtocol",
    "ShardLeverageProtocol",
    "ProtocolSpec",
    "register_protocol",
    "get_spec",
    "protocol_names",
    "specs",
    "create_protocol",
]


class _StatefulStream:
    """Shared lifecycle of every registered protocol: identity + checkpointing.

    ``state_payload`` / ``restore_payload`` are the pipeline checkpoint
    contract: ``(arrays, meta)`` where ``arrays`` is a flat dict of numpy
    leaves and ``meta`` is a JSON-able dict.  Restoring into a freshly
    constructed protocol of the same spec/config must reproduce the stream
    state bit-identically.
    """

    name: str
    engine: str
    kind: str
    m: int
    eps: float

    def __init__(self, name: str, engine: str, kind: str, m: int, eps: float):
        self.name = name
        self.engine = engine
        self.kind = kind
        self.m = m
        self.eps = eps
        self.rows_seen = 0

    def state_payload(self) -> tuple[dict[str, np.ndarray], dict]:
        """Serialize live protocol state; override to opt into checkpointing."""
        raise NotImplementedError(
            f"{type(self).__name__} ({self.kind}/{self.engine}/{self.name}) does "
            "not implement pipeline checkpointing"
        )

    def restore_payload(self, arrays: dict[str, np.ndarray], meta: dict) -> None:
        """Restore state captured by ``state_payload`` into this instance."""
        raise NotImplementedError(
            f"{type(self).__name__} ({self.kind}/{self.engine}/{self.name}) does "
            "not implement pipeline checkpointing"
        )


class SketchProtocol(_StatefulStream, abc.ABC):
    """Uniform matrix-sketch interface over every engine/protocol pair."""

    d: int
    device: torch.device

    def __init__(self, name: str, engine: str, m: int, eps: float, d: int, device=None):
        super().__init__(name, engine, "matrix", m, eps)
        self.d = d
        self.device = resolve_device(device)

    @abc.abstractmethod
    def step(self, rows, sites: np.ndarray | None = None) -> None:
        """Absorb an (n, d) batch of stream rows (continuing prior state)."""

    @abc.abstractmethod
    def matrix(self) -> np.ndarray:
        """The coordinator's current sketch matrix B, shape (l, d)."""

    @abc.abstractmethod
    def frob_estimate(self) -> float:
        """Coordinator estimate of the stream mass ``||A||_F^2``."""

    @abc.abstractmethod
    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""

    # -- queries: one code path for every engine (and the serving layer) ----

    def query_batch(self, x: np.ndarray) -> np.ndarray:
        """``||B x_j||^2`` for each row of ``x`` via ``kernels.ops.quadform``.

        The same kernel the serving engine's kernel path launches, so
        tracker-side and serving-side answers can never diverge.
        """
        from repro_torch.kernels.ops import quadform

        b = self.matrix()
        x = np.asarray(x, np.float32)
        if b.shape[0] == 0:  # empty sketch: every quadratic form is 0
            return np.zeros(x.shape[0], np.float32)
        return quadform(f32_on(self.device, b), f32_on(self.device, x)).cpu().numpy()

    def query(self, x: np.ndarray) -> float:
        """Single-direction ``||B x||^2`` over the shared quadform path."""
        return float(self.query_batch(np.asarray(x)[None, :])[0])


class HHProtocol(_StatefulStream, abc.ABC):
    """Uniform weighted heavy-hitter interface over every engine."""

    def __init__(self, name: str, engine: str, m: int, eps: float):
        super().__init__(name, engine, "hh", m, eps)

    @staticmethod
    def split_pairs(pairs) -> tuple[np.ndarray, np.ndarray]:
        """Normalize an ingest batch to ``(keys int64, weights float64)``.

        Accepts an ``(n, 2)`` array of [element, weight] rows (the pipeline
        wire format — element ids must stay in [0, 2**24) to survive f32) or
        an explicit ``(keys, weights)`` pair of 1-D arrays.  Negative ids
        are rejected: -1 is the MG empty-slot sentinel in the shard engine,
        so letting one through would silently corrupt the sketch.
        """
        if isinstance(pairs, tuple):
            keys, weights = pairs
        else:
            arr = np.asarray(pairs)
            if arr.ndim != 2 or arr.shape[1] != 2:
                raise ValueError(
                    f"HH ingest batch must be (n, 2) [element, weight] rows or a "
                    f"(keys, weights) tuple, got shape {arr.shape}"
                )
            keys, weights = arr[:, 0], arr[:, 1]
        keys = np.asarray(keys).astype(np.int64)
        if keys.size and not (0 <= int(keys.min()) and int(keys.max()) < 1 << 24):
            raise ValueError(
                "HH element ids must be in [0, 2**24): negative ids collide with "
                "the MG empty-slot sentinel, larger ones don't survive the f32 "
                "snapshot encoding"
            )
        return keys, np.asarray(weights, np.float64)

    @abc.abstractmethod
    def step(self, pairs, sites: np.ndarray | None = None) -> None:
        """Absorb a batch of weighted elements (continuing prior state)."""

    @abc.abstractmethod
    def estimates(self) -> dict[int, float]:
        """The coordinator's current ``{element: weight-estimate}`` map."""

    @abc.abstractmethod
    def total_weight(self) -> float:
        """Coordinator estimate of the total stream weight ``W``."""

    @abc.abstractmethod
    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""

    # -- queries ------------------------------------------------------------

    def estimate(self, keys) -> np.ndarray:
        """Vectorized point lookups: estimated weight per queried element."""
        est = self.estimates()
        flat = np.asarray(keys).ravel()
        return np.array([est.get(int(e), 0.0) for e in flat], np.float32)

    def heavy_hitters(self, phi: float) -> list[int]:
        """Elements with ``hat{W}_e >= (phi - eps/2) hat{W}`` (paper Sec. 4)."""
        from repro_torch.core.hh import threshold_heavy_hitters

        return threshold_heavy_hitters(
            self.estimates(), self.total_weight(), self.eps, phi
        )

    def snapshot_matrix(self) -> np.ndarray:
        """Publishable ``(n, 2)`` [element, estimate] encoding of the state."""
        return encode_hh_snapshot(self.estimates())


class QuantileProtocol(_StatefulStream, abc.ABC):
    """Uniform distributed-quantile interface over every engine."""

    def __init__(self, name: str, engine: str, m: int, eps: float):
        super().__init__(name, engine, "quantile", m, eps)

    @staticmethod
    def split_pairs(pairs) -> tuple[np.ndarray, np.ndarray]:
        """Normalize an ingest batch to ``(values f64, weights f64)``.

        Accepts an ``(n, 2)`` array of [value, weight] rows (the pipeline
        wire format) or an explicit ``(values, weights)`` pair of 1-D
        arrays.  Values must be finite *as float32* (the summaries and
        the published table are f32; a value that rounds to ``+/-inf``
        would collide with the jit summary's empty-slot sentinel and be
        silently dropped) and weights non-negative.
        """
        if isinstance(pairs, tuple):
            values, weights = pairs
        else:
            arr = np.asarray(pairs)
            if arr.ndim != 2 or arr.shape[1] != 2:
                raise ValueError(
                    f"quantile ingest batch must be (n, 2) [value, weight] rows "
                    f"or a (values, weights) tuple, got shape {arr.shape}"
                )
            values, weights = arr[:, 0], arr[:, 1]
        values = np.asarray(values, np.float64)
        weights = np.asarray(weights, np.float64)
        if values.size and not np.all(
            np.isfinite(values) & (np.abs(values) <= np.finfo(np.float32).max)
        ):
            raise ValueError(
                "quantile values must be finite in float32: +/-inf (incl. "
                "f32 overflow) collides with the summary's empty-slot "
                "sentinel and NaN cannot be ranked"
            )
        if weights.size and (not np.all(np.isfinite(weights)) or weights.min() < 0):
            raise ValueError("quantile weights must be finite and >= 0")
        return values, weights

    @abc.abstractmethod
    def step(self, pairs, sites: np.ndarray | None = None) -> None:
        """Absorb a batch of weighted values (continuing prior state)."""

    @abc.abstractmethod
    def table(self) -> np.ndarray:
        """The coordinator's ``(k, 2)`` [value, rank-estimate] table."""

    @abc.abstractmethod
    def total_weight(self) -> float:
        """Coordinator estimate of the total stream weight ``W``."""

    @abc.abstractmethod
    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""

    # -- queries: one searchsorted path for every engine and the serving ----

    def rank(self, values) -> np.ndarray:
        """Vectorized weighted-rank estimates (error <= eps W)."""
        return quant.table_rank(self.table(), values)

    def quantile(self, phis) -> np.ndarray:
        """Vectorized eps-approximate phi-quantile values."""
        return quant.table_quantile(self.table(), self.total_weight(), phis)

    def snapshot_matrix(self) -> np.ndarray:
        """Publishable sorted ``(n, 2)`` [value, rank] encoding of the state."""
        return quant.encode_quantile_snapshot(self.table())


class LeverageProtocol(_StatefulStream, abc.ABC):
    """Uniform leverage-score row-sampling interface over every engine."""

    d: int
    device: torch.device

    def __init__(self, name: str, engine: str, m: int, eps: float, d: int, device=None):
        super().__init__(name, engine, "leverage", m, eps)
        self.d = d
        self.device = resolve_device(device)
        # Live ridge factor (f32, on ``device``), memoized until the next
        # step() — repeated score_batch sweeps against unchanged state skip
        # the O(d^3) pinv (the serving engine caches the same factor per
        # (tenant, version)).
        self._live_factor: torch.Tensor | None = None

    def check_rows(self, rows) -> np.ndarray:
        """Normalize an ingest batch to finite f32 ``(n, d)`` host rows."""
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu()
        arr = np.asarray(rows, np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.d:
            raise ValueError(
                f"leverage ingest batch must be (n, {self.d}) rows, got shape "
                f"{arr.shape}"
            )
        if arr.size and not np.all(np.isfinite(arr)):
            raise ValueError("leverage stream rows must be finite in float32")
        return arr

    @abc.abstractmethod
    def step(self, rows, sites: np.ndarray | None = None) -> None:
        """Absorb an (n, d) batch of stream rows (continuing prior state)."""

    @abc.abstractmethod
    def sampled_rows(self) -> np.ndarray:
        """The coordinator's ``(k, d+2)`` [row | score | weight] table."""

    @abc.abstractmethod
    def total_weight(self) -> float:
        """Coordinator estimate of the stream mass ``||A||_F^2``."""

    @abc.abstractmethod
    def lam(self) -> float:
        """The live ridge ``lambda`` the sample is scored at."""

    @abc.abstractmethod
    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""

    # -- queries: the serving engine's kernel paths, shared verbatim ---------

    def subspace_query_batch(self, x: np.ndarray) -> np.ndarray:
        """Importance-weighted ``||A x_j||^2`` per (d,) direction row.

        Rides ``core.leverage.serve_subspace`` — the exact code path the
        serving engine's leverage sweeps launch, so live and published
        answers can never diverge.
        """
        return lev.serve_subspace(
            self.sampled_rows(), np.asarray(x, np.float32), device=self.device
        )

    def subspace_query(self, x: np.ndarray) -> float:
        """Single-direction ``||A x||^2`` estimate over the shared path."""
        return float(self.subspace_query_batch(np.asarray(x)[None, :])[0])

    def score_batch(self, x: np.ndarray) -> np.ndarray:
        """Ridge leverage score per queried vector via ``ops.levscore``."""
        from repro_torch.kernels.ops import levscore

        if self._live_factor is None:
            rows, _, w = lev.decode_leverage_snapshot(self.sampled_rows())
            self._live_factor = f32_on(self.device, lev.ridge_factor(rows, w, self.lam()))
        return levscore(self._live_factor, f32_on(self.device, x)).cpu().numpy()

    def snapshot_matrix(self) -> np.ndarray:
        """Publishable ``(n, d+2)`` [row|score|weight] encoding of the state."""
        return lev.encode_leverage_snapshot(self.sampled_rows())


@dataclass(frozen=True)
class ProtocolSpec:
    """One registered (kind, engine, protocol) implementation.

    err_factor: multiple of the eps guarantee the protocol is certified to
    stay under — covariance error relative to ``eps ||A||_F^2`` for matrix
    protocols, subspace-query error relative to ``eps ||A||_F^2`` for
    leverage sampling (1.0 for the deterministic protocols; sampling
    protocols carry the paper's looser constants).
    """

    name: str
    engine: str  # "event" | "shard"
    factory: Callable[..., _StatefulStream]
    err_factor: float = 1.0
    description: str = ""
    kind: str = "matrix"  # "matrix" | "hh" | "quantile" | "leverage"


_REGISTRY: dict[tuple[str, str, str], ProtocolSpec] = {}


def register_protocol(spec: ProtocolSpec) -> ProtocolSpec:
    """Add a spec under its ``(kind, engine, name)`` key; rejects duplicates."""
    key = (spec.kind, spec.engine, spec.name)
    if key in _REGISTRY:
        raise ValueError(
            f"protocol {spec.name!r} already registered for "
            f"kind {spec.kind!r} / engine {spec.engine!r}"
        )
    _REGISTRY[key] = spec
    return spec


def get_spec(name: str, engine: str = "event", kind: str = "matrix") -> ProtocolSpec:
    """Look up one spec; raises KeyError naming what *is* registered."""
    try:
        return _REGISTRY[(kind, engine, name)]
    except KeyError:
        raise KeyError(
            f"no {kind} protocol {name!r} for engine {engine!r} "
            f"(registered: {sorted(_REGISTRY)})"
        ) from None


def protocol_names(engine: str | None = None, kind: str | None = None) -> list[str]:
    """Registered protocol names, optionally filtered by engine and/or kind."""
    return sorted(
        {
            n
            for (k, e, n) in _REGISTRY
            if (engine is None or e == engine) and (kind is None or k == kind)
        }
    )


def specs(engine: str | None = None, kind: str | None = None) -> list[ProtocolSpec]:
    """All registered specs, optionally filtered by engine and/or kind."""
    return [
        s
        for (k, e, _), s in sorted(_REGISTRY.items())
        if (engine is None or e == engine) and (kind is None or k == kind)
    ]


def create_protocol(
    name: str, *, engine: str = "event", kind: str = "matrix", **kw: Any
):
    """Instantiate a registered protocol.

    Event engine:  ``create_protocol("P2", m=8, eps=0.1, d=64, seed=0)``
    Shard engine:  ``create_protocol("P2", engine="shard", m=8, d=1024,
    eps=0.02)`` — m sites on the site axis of one device.
    Leverage:      pass ``kind="leverage"`` (streams are (n, d) row batches
    like matrix tracking; see ``LeverageProtocol``).
    HH / quantile: pass ``kind="hh"`` / ``kind="quantile"`` (streams are
    (n, 2) [element or value, weight] batches).
    Every super-step factory and the matrix and leverage event factories
    take ``device=`` (``None``: the CUDA card); the HH and quantile event
    engines are numpy simulators on the host and take none.
    """
    return get_spec(name, engine, kind).factory(**kw)


# ---------------------------------------------------------------------------
# Event-driven engine adapters (core/protocols.py, core/leverage.py streams)
# ---------------------------------------------------------------------------


class EventProtocol(SketchProtocol):
    """Paper-exact event-at-a-time matrix engine behind the uniform interface."""

    def __init__(self, name: str, stream_cls, *, m: int, eps: float, d: int,
                 seed: int = 0, device=None, **kw: Any):
        super().__init__(name, "event", m, eps, d, device)
        self._rng = np.random.default_rng(seed)
        self._stream = stream_cls(m, eps, d, self._rng, **kw)
        self._rr = 0  # round-robin cursor for site-less feeds
        self._cached_result: event.MatrixResult | None = None

    def step(self, rows, sites: np.ndarray | None = None) -> None:
        """Absorb an (n, d) batch; site-less feeds get round-robin sites."""
        rows = np.asarray(rows)
        if sites is None:
            sites = (np.arange(rows.shape[0]) + self._rr) % self.m
            self._rr = int((self._rr + rows.shape[0]) % self.m)
        self._stream.step(rows, np.asarray(sites))
        self.rows_seen += int(rows.shape[0])
        self._cached_result = None

    def _result(self) -> event.MatrixResult:
        # result() is pure in the stream state; cache until the next step.
        if self._cached_result is None:
            self._cached_result = self._stream.result()
        return self._cached_result

    def matrix(self) -> np.ndarray:
        """The coordinator's current sketch matrix B."""
        return np.asarray(self._result().b)

    def frob_estimate(self) -> float:
        """Coordinator estimate of ``||A||_F^2``."""
        return float(self._result().f_hat)

    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""
        return self._stream.comm.report(self.m)


class EventHHProtocol(HHProtocol):
    """Paper-exact event-at-a-time HH engine behind the uniform interface."""

    def __init__(self, name: str, stream_cls, *, m: int, eps: float,
                 seed: int = 0, **kw: Any):
        super().__init__(name, "event", m, eps)
        self._rng = np.random.default_rng(seed)
        self._stream = stream_cls(m, eps, self._rng, **kw)
        self._rr = 0  # round-robin cursor for site-less feeds
        self._cached_result: event.HHResult | None = None

    def step(self, pairs, sites: np.ndarray | None = None) -> None:
        """Absorb an (n, 2) [element, weight] batch (round-robin if site-less)."""
        keys, weights = self.split_pairs(pairs)
        if sites is None:
            sites = (np.arange(keys.shape[0]) + self._rr) % self.m
            self._rr = int((self._rr + keys.shape[0]) % self.m)
        self._stream.step(keys, weights, np.asarray(sites))
        self.rows_seen += int(keys.shape[0])
        self._cached_result = None

    def _result(self) -> event.HHResult:
        if self._cached_result is None:
            self._cached_result = self._stream.result()
        return self._cached_result

    def estimates(self) -> dict[int, float]:
        """The coordinator's current estimate map."""
        return dict(self._result().estimates)

    def total_weight(self) -> float:
        """Coordinator estimate of the total stream weight."""
        return float(self._result().w_hat)

    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""
        return self._stream.comm.report(self.m)

    def state_payload(self) -> tuple[dict[str, np.ndarray], dict]:
        """Full stream state as JSON-able meta (HH state is all small)."""
        return {}, {
            "stream": self._stream.state_dict(),
            "rr": self._rr,
            "rows_seen": self.rows_seen,
        }

    def restore_payload(self, arrays: dict[str, np.ndarray], meta: dict) -> None:
        """Restore a ``state_payload`` capture bit-identically."""
        self._stream.load_state(meta["stream"])
        self._rr = int(meta["rr"])
        self.rows_seen = int(meta["rows_seen"])
        self._cached_result = None


class EventQuantileProtocol(QuantileProtocol):
    """Paper-exact event-at-a-time quantile engine behind the interface."""

    def __init__(self, name: str, stream_cls, *, m: int, eps: float,
                 seed: int = 0, **kw: Any):
        super().__init__(name, "event", m, eps)
        self._rng = np.random.default_rng(seed)
        self._stream = stream_cls(m, eps, self._rng, **kw)
        self._rr = 0  # round-robin cursor for site-less feeds
        self._cached_result: quant.QuantileResult | None = None

    def step(self, pairs, sites: np.ndarray | None = None) -> None:
        """Absorb an (n, 2) [value, weight] batch (round-robin if site-less)."""
        values, weights = self.split_pairs(pairs)
        if sites is None:
            sites = (np.arange(values.shape[0]) + self._rr) % self.m
            self._rr = int((self._rr + values.shape[0]) % self.m)
        self._stream.step(values, weights, np.asarray(sites))
        self.rows_seen += int(values.shape[0])
        self._cached_result = None

    def _result(self) -> quant.QuantileResult:
        if self._cached_result is None:
            self._cached_result = self._stream.result()
        return self._cached_result

    def table(self) -> np.ndarray:
        """The coordinator's current table."""
        return np.asarray(self._result().table)

    def total_weight(self) -> float:
        """Coordinator estimate of the total stream weight."""
        return float(self._result().w_hat)

    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""
        return self._stream.comm.report(self.m)

    def state_payload(self) -> tuple[dict[str, np.ndarray], dict]:
        """Full stream state as JSON-able meta (quantile state is small)."""
        return {}, {
            "stream": self._stream.state_dict(),
            "rr": self._rr,
            "rows_seen": self.rows_seen,
        }

    def restore_payload(self, arrays: dict[str, np.ndarray], meta: dict) -> None:
        """Restore a ``state_payload`` capture bit-identically."""
        self._stream.load_state(meta["stream"])
        self._rr = int(meta["rr"])
        self.rows_seen = int(meta["rows_seen"])
        self._cached_result = None


class EventLeverageProtocol(LeverageProtocol):
    """Paper-style event-at-a-time leverage engine behind the interface."""

    def __init__(self, name: str, stream_cls, *, m: int, eps: float, d: int,
                 seed: int = 0, device=None, **kw: Any):
        super().__init__(name, "event", m, eps, d, device)
        self._rng = np.random.default_rng(seed)
        self._stream = stream_cls(m, eps, d, self._rng, **kw)
        self._rr = 0  # round-robin cursor for site-less feeds
        self._cached_result: lev.LeverageResult | None = None

    def step(self, rows, sites: np.ndarray | None = None) -> None:
        """Absorb an (n, d) row batch (round-robin sites if site-less)."""
        rows = self.check_rows(rows)
        if sites is None:
            sites = (np.arange(rows.shape[0]) + self._rr) % self.m
            self._rr = int((self._rr + rows.shape[0]) % self.m)
        self._stream.step(rows, np.asarray(sites))
        self.rows_seen += int(rows.shape[0])
        self._cached_result = None
        self._live_factor = None

    def _result(self) -> lev.LeverageResult:
        if self._cached_result is None:
            self._cached_result = self._stream.result()
        return self._cached_result

    def sampled_rows(self) -> np.ndarray:
        """The coordinator's current [row | score | weight] table."""
        return np.asarray(self._result().table)

    def total_weight(self) -> float:
        """Coordinator estimate of the stream mass ``||A||_F^2``."""
        return float(self._result().f_hat)

    def lam(self) -> float:
        """The live ridge ``lambda`` the sample is scored at."""
        return float(self._result().lam)

    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""
        return self._stream.comm.report(self.m)

    def state_payload(self) -> tuple[dict[str, np.ndarray], dict]:
        """Full stream state as JSON-able meta (leverage state is small)."""
        return {}, {
            "stream": self._stream.state_dict(),
            "rr": self._rr,
            "rows_seen": self.rows_seen,
        }

    def restore_payload(self, arrays: dict[str, np.ndarray], meta: dict) -> None:
        """Restore a ``state_payload`` capture bit-identically."""
        self._stream.load_state(meta["stream"])
        self._rr = int(meta["rr"])
        self.rows_seen = int(meta["rows_seen"])
        self._cached_result = None
        self._live_factor = None


# ---------------------------------------------------------------------------
# Super-step engine adapters (core/distributed.py)
# ---------------------------------------------------------------------------


def _leaves(state) -> list[torch.Tensor]:
    """A protocol state's tensors, depth-first in field order — the order
    ``jax.tree_util.tree_flatten`` gives the reference's NamedTuple states."""
    if isinstance(state, torch.Tensor):
        return [state]
    return [leaf for field in state for leaf in _leaves(field)]


def _rebuild(template, leaves):
    """``template``'s NamedTuple structure filled from an iterator of leaves."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    return type(template)(*(_rebuild(field, leaves) for field in template))


class _ShardCheckpointMixin:
    """Checkpoint and packed-ingest contract shared by every super-step protocol.

    Flattens the protocol's state into the reference's leaf layout and
    restores bit-identically; subclasses supply ``_invalidate()`` to drop
    their host-side caches after a restore.

    Also the packed-ingest contract: protocols whose distributed step is
    in ``dist.PACKABLE_PROTOCOLS`` expose a ``pack_key`` so the pipeline
    can stack same-shape tenants into one ``dist.make_packed_runner`` call,
    and ``apply_packed`` installs one tenant's stake in the stacked result
    with the bookkeeping a serial ``step`` performs.  The install is LAZY:
    ``state`` is a property backed by either the tenant's own state or a
    ``(stacked, index)`` slot into the pack's resident stacked state, and
    the slice happens only when something reads the state (publish, query,
    checkpoint).  ``_epoch`` counts every state write, so
    ``runtime.ingest_packed`` can tell whether a cached stacked state is
    still current for the whole group or a member stepped out of band.
    """

    device: torch.device
    # Set by each protocol's __init__: the core.distributed step name
    # ("P1", "P2", "LP1").
    _dist_key: str = ""
    _state = None
    _pack_slot: tuple | None = None
    _epoch: int = 0

    @property
    def state(self):
        """The protocol's state, sliced out of a pack on first read."""
        if self._pack_slot is not None:
            stacked, index = self._pack_slot
            self._state = dist.unstack_packed(stacked, index)
            self._pack_slot = None
        return self._state

    @state.setter
    def state(self, value) -> None:
        self._state = value
        self._pack_slot = None
        self._epoch += 1

    def state_payload(self) -> tuple[dict[str, np.ndarray], dict]:
        """Flatten the protocol state into checkpoint leaves."""
        leaves = _leaves(self.state)
        arrays = {f"leaf_{i:03d}": leaf.cpu().numpy() for i, leaf in enumerate(leaves)}
        return arrays, {"leaves": ["array"] * len(leaves), "rows_seen": self.rows_seen}

    def restore_payload(self, arrays: dict[str, np.ndarray], meta: dict) -> None:
        """Restore a ``state_payload`` capture bit-identically."""
        template = _leaves(self.state)
        tags = list(meta["leaves"])
        if len(tags) != len(template) or set(tags) != {"array"}:
            raise ValueError(
                f"checkpointed state has {len(tags)} leaves tagged {sorted(set(tags))}, "
                f"expected {len(template)} array leaves (protocol/config mismatch?)"
            )
        restored = []
        for i, old in enumerate(template):
            arr = torch.tensor(np.asarray(arrays[f"leaf_{i:03d}"]), device=self.device)
            if tuple(arr.shape) != tuple(old.shape):
                raise ValueError(
                    f"checkpointed state leaf {i} has shape {tuple(arr.shape)}, "
                    f"expected {tuple(old.shape)} (protocol/config mismatch — was the "
                    "pipeline reloaded with a different m?)"
                )
            restored.append(arr.to(old.dtype))
        self.state = _rebuild(self.state, iter(restored))
        self.rows_seen = int(meta["rows_seen"])
        self._invalidate()

    def pack_key(self):
        """Grouping key for packed multi-tenant ingest, or None.

        Tenants with equal keys — same distributed step, same resolved
        ``ProtocolConfig`` (hence same state shapes), same device — may be
        stacked into one ``(T, ...)`` super-step.  Protocols outside
        ``dist.PACKABLE_PROTOCOLS`` return None and always ingest serially.
        """
        if self._dist_key not in dist.PACKABLE_PROTOCOLS:
            return None
        return (self._dist_key, self.cfg, self.device)

    def apply_packed(self, stacked_state, index: int, n_rows: int) -> None:
        """Point this tenant at its slot in a packed super-step result.

        No per-tenant slice happens here — the pack's stacked state stays
        resident and the ``state`` property slices slot ``index`` out only
        if something reads it before the next wave.
        """
        self._state = None
        self._pack_slot = (stacked_state, index)
        self._epoch += 1
        self.rows_seen += int(n_rows)
        self._invalidate()

    def _invalidate(self) -> None:
        raise NotImplementedError


class ShardProtocol(_ShardCheckpointMixin, SketchProtocol):
    """Super-step matrix engine behind the uniform interface.

    ``sites`` is ignored: row placement is the site axis of the batch (each
    contiguous slice of ``n / m`` rows is one paper site).
    """

    def __init__(self, name: str, *, m: int, d: int, eps: float = 0.1,
                 l_site: int = 0, l_coord: int = 0, device=None):
        super().__init__(name, "shard", m, eps, d, device)
        self.cfg = dist.ProtocolConfig(eps=eps, m=m, d=d, l_site=l_site, l_coord=l_coord).resolved()
        self._dist_key = name
        self.state, self._step = dist.make_protocol_runner(name, self.cfg, self.device)
        self._cached_matrix: np.ndarray | None = None

    def step(self, rows, sites: np.ndarray | None = None) -> None:
        """Advance one super-step on an (n, d) batch (numpy or tensor)."""
        rows = f32_on(self.device, rows)
        self.state = self._step(self.state, rows)
        self.rows_seen += int(rows.shape[0])
        self._cached_matrix = None

    def matrix(self) -> np.ndarray:
        """The coordinator's current sketch matrix B."""
        # The sketch is a pure function of the state: one device->host copy
        # per super-step serves matrix/frob/query alike.
        if self._cached_matrix is None:
            self._cached_matrix = dist.protocol_matrix(self.name, self.state).cpu().numpy()
        return self._cached_matrix

    def frob_estimate(self) -> float:
        """Coordinator estimate of ``||A||_F^2``."""
        return dist.protocol_frob(self.name, self.state)

    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""
        return self.state.comm.report(self.cfg.m)

    def _invalidate(self) -> None:
        self._cached_matrix = None


class ShardHHProtocol(_ShardCheckpointMixin, HHProtocol):
    """Super-step HH engine (batched MG merge) behind the uniform interface.

    ``sites`` is ignored: element placement is the site axis of the batch
    (each contiguous slice of ``n / m`` items is one paper site).  Backed by
    ``core.distributed.hh_p1_step`` (per-site ``MGState`` on one
    ``mg_scan`` launch, ``mg_merge`` coordinator folding).
    """

    def __init__(self, name: str, *, m: int, eps: float = 0.1, k: int = 0, device=None):
        super().__init__(name, "shard", m, eps)
        self.device = resolve_device(device)
        self.cfg = dist.ProtocolConfig(eps=eps, m=m, d=2, k=k).resolved()
        self._dist_key = "HH" + name
        self.state, self._step = dist.make_protocol_runner(self._dist_key, self.cfg, self.device)
        self._cached_estimates: dict[int, float] | None = None

    def step(self, pairs, sites: np.ndarray | None = None) -> None:
        """Advance one super-step on a weighted-element batch."""
        keys, weights = self.split_pairs(pairs)
        self.state = self._step(self.state, (
            torch.as_tensor(keys, dtype=torch.int32).to(self.device),
            torch.as_tensor(weights, dtype=torch.float32).to(self.device),
        ))
        self.rows_seen += int(keys.shape[0])
        self._cached_estimates = None

    def estimates(self) -> dict[int, float]:
        """The coordinator's current estimate map (one host read per step)."""
        if self._cached_estimates is None:
            self._cached_estimates = dist.hh_estimates(self.state)
        return dict(self._cached_estimates)

    def total_weight(self) -> float:
        """Coordinator estimate of the total stream weight."""
        return dist.hh_w_hat(self.state)

    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""
        return self.state.comm.report(self.cfg.m)

    def _invalidate(self) -> None:
        self._cached_estimates = None


class ShardQuantileProtocol(_ShardCheckpointMixin, QuantileProtocol):
    """Super-step quantile engine behind the uniform interface.

    ``sites`` is ignored: value placement is the site axis of the batch.
    Backed by ``core.distributed.quant_p1_step`` (per-site ``QuantState``,
    ``quant_merge`` coordinator folding, each ending in one ``quant_pack``
    launch).
    """

    def __init__(self, name: str, *, m: int, eps: float = 0.1, q_cap: int = 0, device=None):
        super().__init__(name, "shard", m, eps)
        self.device = resolve_device(device)
        self.cfg = dist.ProtocolConfig(eps=eps, m=m, d=2, q_cap=q_cap).resolved()
        self._dist_key = "Q" + name
        self.state, self._step = dist.make_protocol_runner(self._dist_key, self.cfg, self.device)
        self._cached_table: np.ndarray | None = None

    def step(self, pairs, sites: np.ndarray | None = None) -> None:
        """Advance one super-step on a weighted-value batch."""
        values, weights = self.split_pairs(pairs)
        self.state = self._step(self.state, (
            torch.as_tensor(values, dtype=torch.float32).to(self.device),
            torch.as_tensor(weights, dtype=torch.float32).to(self.device),
        ))
        self.rows_seen += int(values.shape[0])
        self._cached_table = None

    def table(self) -> np.ndarray:
        """The coordinator's current table (one host read per step)."""
        if self._cached_table is None:
            self._cached_table = dist.quant_p1_table(self.state)
        return self._cached_table

    def total_weight(self) -> float:
        """Coordinator estimate of the total stream weight."""
        return dist.quant_p1_w_hat(self.state)

    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""
        return self.state.comm.report(self.cfg.m)

    def _invalidate(self) -> None:
        self._cached_table = None


class ShardLeverageProtocol(_ShardCheckpointMixin, LeverageProtocol):
    """Super-step leverage engine behind the uniform interface.

    ``sites`` is ignored: row placement is the site axis of the batch.
    Backed by ``core.distributed.lev_p1_step`` (per-site FD residual +
    masked candidate gather, ``lev_merge_spill`` coordinator folding).
    """

    def __init__(self, name: str, *, m: int, d: int, eps: float = 0.1,
                 lev_cap: int = 0, l_site: int = 0, l_coord: int = 0, device=None):
        super().__init__(name, "shard", m, eps, d, device)
        self.cfg = dist.ProtocolConfig(
            eps=eps, m=m, d=d, lev_cap=lev_cap, l_site=l_site, l_coord=l_coord,
        ).resolved()
        self._dist_key = "L" + name
        self.state, self._step = dist.make_protocol_runner(self._dist_key, self.cfg, self.device)
        self._cached_table: np.ndarray | None = None

    def step(self, rows, sites: np.ndarray | None = None) -> None:
        """Advance one super-step on an (n, d) row batch (numpy or tensor).

        A tensor already on the protocol's device is checked there (shape,
        finite f32) and never copied through the host.
        """
        if isinstance(rows, torch.Tensor) and rows.device == self.device:
            if rows.ndim != 2 or rows.shape[1] != self.d:
                raise ValueError(
                    f"leverage ingest batch must be (n, {self.d}) rows, got shape "
                    f"{tuple(rows.shape)}"
                )
            rows = rows.float()
            if rows.numel() and not bool(torch.isfinite(rows).all()):
                raise ValueError("leverage stream rows must be finite in float32")
        else:
            rows = self.check_rows(rows)
        self.state = self._step(self.state, f32_on(self.device, rows))
        self.rows_seen += int(rows.shape[0])
        self._invalidate()

    def sampled_rows(self) -> np.ndarray:
        """The coordinator's current table (one host read per step)."""
        if self._cached_table is None:
            self._cached_table = dist.lev_p1_table(self.cfg, self.state)
        return self._cached_table

    def total_weight(self) -> float:
        """Coordinator estimate of the stream mass ``||A||_F^2``."""
        return dist.lev_p1_mass(self.state)

    def lam(self) -> float:
        """The live ridge ``lambda`` the sample is scored at."""
        return dist.lev_p1_lambda(self.cfg, self.state)

    def comm_report(self) -> CommReport:
        """Messages spent so far, in the paper's units."""
        return self.state.comm.report(self.cfg.m)

    def _invalidate(self) -> None:
        self._cached_table = None
        self._live_factor = None


# ---------------------------------------------------------------------------
# Registrations — the one place protocol names are bound to engines.
# ---------------------------------------------------------------------------


def _factory(cls, *args):
    def make(**kw: Any):
        return cls(*args, **kw)

    return make


_EVENT_ERR = {"P1": 1.0, "P2": 1.0, "P3": 1.5, "P3wr": 3.0}

for _name, _cls in event.MATRIX_STREAMS.items():
    register_protocol(ProtocolSpec(
        name=_name,
        engine="event",
        factory=_factory(EventProtocol, _name, _cls),
        err_factor=_EVENT_ERR[_name],
        description=f"event-driven matrix {_name} (paper Section 5)",
    ))

for _name in ("P1", "P2"):
    register_protocol(ProtocolSpec(
        name=_name,
        engine="shard",
        factory=_factory(ShardProtocol, _name),
        description=f"super-step matrix {_name}, sites on a tensor axis",
    ))

# Heavy hitters: deterministic P1/P2 meet eps exactly; the sampling
# protocols (P3/P3wr) and probabilistic P4 carry the paper's 2x slack.
_HH_ERR = {"P1": 1.0, "P2": 1.0, "P3": 2.0, "P3wr": 2.0, "P4": 2.0}

for _name, _cls in event.HH_STREAMS.items():
    register_protocol(ProtocolSpec(
        name=_name,
        kind="hh",
        engine="event",
        factory=_factory(EventHHProtocol, _name, _cls),
        err_factor=_HH_ERR[_name],
        description=f"event-driven weighted heavy hitters {_name} (paper Section 4)",
    ))

register_protocol(ProtocolSpec(
    name="P1",
    kind="hh",
    engine="shard",
    factory=_factory(ShardHHProtocol, "P1"),
    err_factor=1.0,
    description="super-step weighted heavy hitters P1 (MG merge), sites on a tensor axis",
))

# Quantiles: deterministic P1 meets eps via the GK interval invariant; the
# sampling P3 and the fixed-capacity super-step summary carry 2x slack.
_QUANT_ERR = {"P1": 1.0, "P3": 2.0}

for _name, _cls in quant.QUANTILE_STREAMS.items():
    register_protocol(ProtocolSpec(
        name=_name,
        kind="quantile",
        engine="event",
        factory=_factory(EventQuantileProtocol, _name, _cls),
        err_factor=_QUANT_ERR[_name],
        description=f"event-driven distributed quantiles {_name} (GK summaries)",
    ))

register_protocol(ProtocolSpec(
    name="P1",
    kind="quantile",
    engine="shard",
    factory=_factory(ShardQuantileProtocol, "P1"),
    err_factor=2.0,
    description="super-step distributed quantiles P1 (summary merge), sites on a tensor axis",
))

# Leverage sampling: deterministic P1 (kept rows exact + FD residual) meets
# eps via the FD envelope; the score-weighted sampling P2 and the
# super-step engine carry the sampling protocols' looser slack.
_LEV_ERR = {"P1": 1.0, "P2": 3.0}

for _name, _cls in lev.LEVERAGE_STREAMS.items():
    register_protocol(ProtocolSpec(
        name=_name,
        kind="leverage",
        engine="event",
        factory=_factory(EventLeverageProtocol, _name, _cls),
        err_factor=_LEV_ERR[_name],
        description=f"event-driven leverage-score row sampling {_name}",
    ))

register_protocol(ProtocolSpec(
    name="P1",
    kind="leverage",
    engine="shard",
    factory=_factory(ShardLeverageProtocol, "P1"),
    err_factor=1.5,
    description="super-step leverage-score row sampling P1 "
                "(threshold forwarding + FD residual), sites on a tensor axis",
))
