"""Typed protocol registry — one dispatch point for every engine and workload.

The reference registers every (kind, engine, protocol) implementation here
and its consumers (``DistributedMatrixTracker``, the streaming pipeline,
benchmarks) construct protocols through it.  Ported so far: the matrix
workload interface and the super-step engine's P1 and P2::

    SketchProtocol
        step(rows, sites=None)   absorb a batch of stream rows
        matrix()                 the coordinator sketch B, (l, d) numpy
        frob_estimate()          coordinator estimate of ||A||_F^2
        comm_report()            uniform CommReport (paper message units)
        query(x) / query_batch() ||B x||^2 via the shared quadform kernel

It also speaks the pipeline checkpoint contract — ``state_payload()`` /
``restore_payload()`` — with the reference's leaf layout, so a payload
taken from the reference's shard protocol restores here and vice versa.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import f32_on, resolve_device
from repro_torch.core import distributed as dist
from repro_torch.core.comm import CommReport

__all__ = [
    "SketchProtocol",
    "ShardProtocol",
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


@dataclass(frozen=True)
class ProtocolSpec:
    """One registered (kind, engine, protocol) implementation.

    err_factor: multiple of the eps guarantee the protocol is certified to
    stay under — covariance error relative to ``eps ||A||_F^2`` for matrix
    protocols (1.0 for the deterministic protocols).
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

    Shard engine:  ``create_protocol("P2", engine="shard", m=8, d=1024,
    eps=0.02)`` — m sites on the site axis of one device.
    """
    return get_spec(name, engine, kind).factory(**kw)


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


class ShardProtocol(SketchProtocol):
    """Super-step matrix engine behind the uniform interface.

    ``sites`` is ignored: row placement is the site axis of the batch (each
    contiguous slice of ``n / m`` rows is one paper site).
    """

    def __init__(self, name: str, *, m: int, d: int, eps: float = 0.1,
                 l_site: int = 0, l_coord: int = 0, device=None):
        super().__init__(name, "shard", m, eps, d, device)
        self.cfg = dist.ProtocolConfig(eps=eps, m=m, d=d, l_site=l_site, l_coord=l_coord).resolved()
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
                    f"expected {tuple(old.shape)} (protocol/config mismatch?)"
                )
            restored.append(arr.to(old.dtype))
        self.state = _rebuild(self.state, iter(restored))
        self.rows_seen = int(meta["rows_seen"])
        self._cached_matrix = None


def _shard_factory(name: str):
    def make(**kw: Any) -> ShardProtocol:
        return ShardProtocol(name, **kw)

    return make


for _name in ("P1", "P2"):
    register_protocol(ProtocolSpec(
        name=_name,
        engine="shard",
        factory=_shard_factory(_name),
        description=f"super-step matrix {_name}, sites on a tensor axis",
    ))
