"""Distributed matrix tracking in super-steps, with the sites as a tensor axis.

The paper's transport is an event-driven network (any site may message the
coordinator at any time).  The production engine processes site streams in
*super-steps*: every site absorbs a batch of its local rows, evaluates the
paper's send predicates, and a masked gather plays the role of the
site->coordinator channel.  The reference runs one site per device under
``shard_map``; here every per-site leaf of the state carries a leading
``m`` axis, so

  * the per-site FD sketches advance together, one batched shrink per chunk;
  * ``all_gather`` over sites is the site axis itself, in site order 0..m-1;
  * ``psum`` over sites is ``.sum(0)``.

One card runs all m sites, deterministically.  Message accounting is at
*protocol* level (exactly the messages the event-driven protocol would send
— masked-out sites count zero), so the paper's communication bounds remain
the yardstick.

Super-step skew: delaying a send to the super-step boundary lets a site
overshoot its threshold by at most the batch mass ``batch * beta``; choosing
``batch * beta << (eps/2m) * F_hat`` keeps the end-to-end guarantee intact.

Every step is written once, on a *pack*: each leaf carries a leading
tenant axis T before the site axis, and the rows arrive as (T, m * b, d).
A serial step is the pack of one (``_on_packs``); ``make_packed_runner``
advances T same-config tenants in one call — one batched shrink per chunk
over all ``T * m`` site buffers — for packed multi-tenant ingest.

Protocols ported so far:

    * ``P1`` — per-site FD, ship-the-sketch on threshold, FD-merge at C.
    * ``P2`` — the paper's best: per-direction sigma^2 thresholds.  After an
      FD shrink the buffer rows *are* ``sigma_i v_i`` (orthogonal), so the
      send set is a row mask — no extra SVD on the hot path.
    * ``LP1`` — leverage-score row sampling: threshold forwarding of
      high-score rows into a coordinator reservoir, FD residual for the rest.
    * ``HHP1`` — weighted heavy hitters: per-site Misra--Gries summaries,
      shipped whole on the weight threshold and folded in with ``mg_merge``.
    * ``QP1`` — quantiles: per-site GK summaries, shipped on a ``1 + eps/4``
      weight growth and folded in with ``quant_merge``.

The two pair-input kinds (HHP1, QP1) take ``(keys or values, weights)``,
each a global ``(m * b,)`` tensor, and are not packable: the coordinator
folds the m shipped summaries one after another, in site order 0..m-1, as
the reference's static unroll does (neither merge is associative in f32).
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import fd as fdlib
from repro_torch.core import hh as hhlib
from repro_torch.core import leverage as levlib
from repro_torch.core import quantiles as qlib
from repro_torch.core.comm import CommReport, build_report

__all__ = [
    "ProtocolConfig",
    "CommCounters",
    "P1State",
    "P2State",
    "p1_init",
    "p1_step",
    "p2_init",
    "p2_step",
    "p2_query",
    "HHP1State",
    "hh_p1_init",
    "hh_p1_step",
    "hh_estimates",
    "hh_w_hat",
    "QuantP1State",
    "quant_p1_init",
    "quant_p1_step",
    "quant_p1_table",
    "quant_p1_w_hat",
    "LevP1State",
    "lev_p1_init",
    "lev_p1_step",
    "lev_p1_table",
    "lev_p1_mass",
    "lev_p1_lambda",
    "protocol_matrix",
    "protocol_frob",
    "make_protocol_runner",
    "PACKABLE_PROTOCOLS",
    "PackedRunner",
    "make_packed_runner",
    "unstack_packed",
]


class ProtocolConfig(NamedTuple):
    """Static protocol configuration (size defaults via ``resolved``)."""
    eps: float
    m: int  # number of sites == length of the site axis
    d: int  # row dimensionality
    l_site: int = 0  # site sketch rows (0 -> ceil(4/eps), paper default)
    l_coord: int = 0  # coordinator sketch rows (0 -> ceil(4/eps))
    s: int = 0  # P3 sample size (0 -> ceil(1/eps^2 * log(1/eps)))
    k: int = 0  # HH MG counters (0 -> ceil(2/eps), the MG_{eps/2} default)
    q_cap: int = 0  # quantile summary capacity (0 -> ceil(8/eps) + 8)
    lev_cap: int = 0  # leverage reservoir capacity (0 -> ceil(4/eps), floor 16)

    def resolved(self) -> "ProtocolConfig":
        """Fill size defaults: sketch rows, sample size, MG counters,
        quantile cap, leverage reservoir cap."""
        l_default = max(2, math.ceil(4.0 / self.eps))
        s_default = max(8, math.ceil((1.0 / self.eps**2) * math.log(max(math.e, 1.0 / self.eps))))
        return self._replace(
            l_site=self.l_site or l_default,
            l_coord=self.l_coord or l_default,
            s=self.s or s_default,
            k=self.k or max(2, math.ceil(2.0 / self.eps)),
            q_cap=self.q_cap or max(32, math.ceil(8.0 / self.eps) + 8),
            # the reference's core.leverage.default_cap
            lev_cap=self.lev_cap or max(16, math.ceil(4.0 / self.eps)),
        )


class CommCounters(NamedTuple):
    """Protocol-level message counters, () i32 tensors."""
    scalar_msgs: torch.Tensor  # protocol-level scalar messages
    row_msgs: torch.Tensor  # protocol-level row messages
    broadcast_events: torch.Tensor

    @staticmethod
    def zero(device=None) -> "CommCounters":
        """All-zero counters."""
        z = torch.zeros((), dtype=torch.int32, device=resolve_device(device))
        return CommCounters(z, z, z)

    def report(self, m: int) -> CommReport:
        """Collapse the counters to the engine-agnostic report."""
        return build_report(
            scalar_msgs=self.scalar_msgs,
            row_msgs=self.row_msgs,
            broadcast_events=self.broadcast_events,
            m=m,
        )


def _row_sq(x: torch.Tensor) -> torch.Tensor:
    return x.float().square().sum(-1)


def _site_rows(cfg: ProtocolConfig, rows: torch.Tensor) -> torch.Tensor:
    """A global (m * b, d) batch as (m, b, d), or a pack's (T, m * b, d) as
    (T, m, b, d): site i gets rows [i*b, (i+1)*b), the contiguous split
    ``shard_map`` gives each device."""
    if rows.ndim not in (2, 3) or rows.shape[-1] != cfg.d or rows.shape[-2] % cfg.m:
        raise ValueError(
            f"a super-step wants (m * b, {cfg.d}) rows, or (T, m * b, {cfg.d}) for a pack, "
            f"with m = {cfg.m}, got {tuple(rows.shape)}"
        )
    return rows.reshape(*rows.shape[:-2], cfg.m, -1, cfg.d)


def _per_site(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Broadcast a (T, m) mask over a per-site leaf of shape (T, m, ...)."""
    return mask.reshape(mask.shape + (1,) * (leaf.ndim - mask.ndim))


def _tree_map(fn, state):
    """``state``'s NamedTuple structure with ``fn`` applied to every tensor."""
    if isinstance(state, torch.Tensor):
        return fn(state)
    return type(state)(*(_tree_map(fn, field) for field in state))


def _tree_stack(states):
    """T same-structure states as one state whose leaves are (T, ...)."""
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    return type(first)(*(_tree_stack([s[i] for s in states]) for i in range(len(first))))


def unstack_packed(stacked_state, t: int):
    """Tenant ``t``'s state from a pack's stacked state: views, not copies.

    The steps are functional (no tensor is ever written in place), so a
    tenant's views stay valid while the pack advances to new tensors.
    """
    return _tree_map(lambda a: a[t], stacked_state)


def _on_packs(step):
    """A step written on a pack — (T, ...) state leaves, (T, m, b, d) rows —
    taking a pack's (T, m * b, d) rows, or one tenant's unstacked state and
    (m * b, d) rows as the pack of one."""

    @functools.wraps(step)
    def run(cfg: ProtocolConfig, st, rows: torch.Tensor):
        cfg = cfg.resolved()
        if rows.ndim == 3:
            return step(cfg, st, _site_rows(cfg, rows))
        one = _tree_map(lambda a: a[None], st)
        return unstack_packed(step(cfg, one, _site_rows(cfg, rows)[None]), 0)

    return run


def _tile(state, m: int):
    """An unstacked per-site state (FD, MG or quantile summary) repeated over
    the site axis."""
    return type(state)(*(leaf.expand(m, *leaf.shape).clone() for leaf in state))


# ---------------------------------------------------------------------------
# Protocol 1 — batched FD merge
# ---------------------------------------------------------------------------


class P1State(NamedTuple):
    """Matrix P1 state: per-site FD + coordinator FD/totals."""
    site_fd: fdlib.FDState  # per-site, leading m axis
    f_i: torch.Tensor  # per-site (m,) f32 — mass since last ship
    coord_fd: fdlib.FDState
    f_c: torch.Tensor  # () f32 — mass received at C
    f_hat: torch.Tensor  # () f32 — broadcast estimate
    comm: CommCounters


def p1_init(cfg: ProtocolConfig, device=None) -> P1State:
    """Initial P1 state: all m sites and the coordinator."""
    cfg = cfg.resolved()
    device = resolve_device(device)
    return P1State(
        site_fd=_tile(fdlib.fd_init(cfg.l_site, cfg.d, device=device), cfg.m),
        f_i=torch.zeros(cfg.m, dtype=torch.float32, device=device),
        coord_fd=fdlib.fd_init(cfg.l_coord, cfg.d, device=device),
        f_c=torch.zeros((), dtype=torch.float32, device=device),
        f_hat=torch.ones((), dtype=torch.float32, device=device),
        comm=CommCounters.zero(device),
    )


@_on_packs
def p1_step(cfg: ProtocolConfig, st: P1State, rows: torch.Tensor) -> P1State:
    """One super-step on a global (m * b, d) batch; site i takes slice i.

    (A pack: (T, ...) state and (T, m * b, d) rows, each tenant on its own.)
    """
    site_fd = fdlib.fd_update_stream(st.site_fd, rows)
    f_i = st.f_i + _row_sq(rows).sum(-1)  # (T, m)

    send = f_i >= (cfg.eps / (2 * cfg.m)) * st.f_hat[:, None]  # (T, m)
    live = fdlib.fd_matrix(site_fd)  # (T, m, l_site, d)
    payload = torch.where(send[..., None, None], live, 0.0)
    coord_fd = fdlib.fd_update_stream(st.coord_fd, payload.flatten(1, 2))
    shipped_rows = torch.where(send, (_row_sq(live) > 0).sum(-1), 0).sum(-1)
    n_scalar = send.sum(-1)

    f_c = st.f_c + torch.where(send, f_i, 0.0).sum(-1)
    f_i = torch.where(send, 0.0, f_i)
    # Reset shipped sketches.
    empty = fdlib.fd_init(cfg.l_site, cfg.d, device=rows.device)
    site_fd = fdlib.FDState(
        *(torch.where(_per_site(send, a), e, a) for a, e in zip(site_fd, empty))
    )

    rebroadcast = f_c / st.f_hat > 1.0 + cfg.eps / 2.0
    f_hat = torch.where(rebroadcast, f_c, st.f_hat)
    comm = CommCounters(
        scalar_msgs=st.comm.scalar_msgs + n_scalar.to(torch.int32),
        row_msgs=st.comm.row_msgs + shipped_rows.to(torch.int32),
        broadcast_events=st.comm.broadcast_events + rebroadcast.to(torch.int32),
    )
    return P1State(site_fd, f_i, coord_fd, f_c, f_hat, comm)


# ---------------------------------------------------------------------------
# Protocol 2 — per-direction thresholds (the paper's best)
# ---------------------------------------------------------------------------


class P2State(NamedTuple):
    """Matrix P2 state: per-site FD + coordinator FD/thresholds."""
    site_fd: fdlib.FDState  # per-site, leading m axis; buffer rows are sigma_i v_i
    f_j: torch.Tensor  # per-site (m,) f32 — scalar-message accumulator
    coord_fd: fdlib.FDState
    f_hat: torch.Tensor  # () f32
    n_msg: torch.Tensor  # () i32 — scalar msgs since last broadcast
    comm: CommCounters


def p2_init(cfg: ProtocolConfig, device=None) -> P2State:
    """Initial P2 state: all m sites and the coordinator."""
    cfg = cfg.resolved()
    device = resolve_device(device)
    return P2State(
        site_fd=_tile(fdlib.fd_init(cfg.l_site, cfg.d, device=device), cfg.m),
        f_j=torch.zeros(cfg.m, dtype=torch.float32, device=device),
        coord_fd=fdlib.fd_init(cfg.l_coord, cfg.d, device=device),
        f_hat=torch.ones((), dtype=torch.float32, device=device),
        n_msg=torch.zeros((), dtype=torch.int32, device=device),
        comm=CommCounters.zero(device),
    )


@_on_packs
def p2_step(cfg: ProtocolConfig, st: P2State, rows: torch.Tensor) -> P2State:
    """One P2 super-step on a global (m * b, d) batch; site i takes slice i.

    (A pack: (T, ...) state and (T, m * b, d) rows, each tenant on its own.)
    """
    # -- scalar totals (Algorithm 5.3 first half) --
    f_j = st.f_j + _row_sq(rows).sum(-1)  # (T, m)
    send_scalar = f_j >= (cfg.eps / cfg.m) * st.f_hat[:, None]  # (T, m)
    f_hat = st.f_hat + torch.where(send_scalar, f_j, 0.0).sum(-1)
    n_sent = send_scalar.sum(-1).to(torch.int32)
    f_j = torch.where(send_scalar, 0.0, f_j)
    n_msg = st.n_msg + n_sent
    rebroadcast = n_msg >= cfg.m
    n_msg = torch.where(rebroadcast, 0, n_msg)

    # -- direction sends (Algorithm 5.3 second half) --
    # After fd_update the buffer rows are orthogonal sigma_i v_i, so the
    # send set is a row mask.  Only the first l_site rows can be non-zero
    # after a shrink, so each site ships (l_site, d) and the coordinator
    # absorbs m * l_site rows, in site order.
    site_fd = fdlib.fd_update_stream(st.site_fd, rows)
    live = site_fd.buf[..., : cfg.l_site, :]  # (T, m, l_site, d)
    mask = _row_sq(live) >= (cfg.eps / cfg.m) * f_hat[:, None, None]  # (T, m, l_site)
    payload = torch.where(mask[..., None], live, 0.0)
    kept = torch.where(mask[..., None], 0.0, live)
    site_fd = site_fd._replace(
        buf=torch.cat([kept, site_fd.buf[..., cfg.l_site :, :]], dim=-2)
    )
    coord_fd = fdlib.fd_update_stream(st.coord_fd, payload.flatten(1, 2))
    n_rows = mask.sum((-2, -1)).to(torch.int32)

    comm = CommCounters(
        scalar_msgs=st.comm.scalar_msgs + n_sent,
        row_msgs=st.comm.row_msgs + n_rows,
        broadcast_events=st.comm.broadcast_events + rebroadcast.to(torch.int32),
    )
    return P2State(site_fd, f_j, coord_fd, f_hat, n_msg, comm)


def p2_query(st: P2State, x: torch.Tensor) -> torch.Tensor:
    """Coordinator estimate of ||A x||^2."""
    return fdlib.fd_query(st.coord_fd, x)


# ---------------------------------------------------------------------------
# Weighted heavy hitters, protocol 1 — batched Misra--Gries merge.
#
# The HH twin of matrix P1: every site runs a weighted MG_{eps/2} summary
# over its local (element, weight) stream (all m in one ``mg_scan`` launch);
# when a site's weight since its last ship crosses ``(eps/2m) * w_hat`` it
# ships the whole summary, and the coordinator folds shipped summaries in
# with ``mg_merge``, site by site in order.  A non-sender contributes the
# empty summary, as in the reference's masked gather.  Message units follow
# the paper: a shipped summary of ``r`` live counters costs ``r`` item
# messages plus one scalar, and a ``w_hat`` rebroadcast costs ``m``.
# ---------------------------------------------------------------------------


class HHP1State(NamedTuple):
    """HH P1 state: per-site MG summaries + the coordinator's MG and totals."""
    site_mg: hhlib.MGState  # per-site, leading m axis
    w_i: torch.Tensor  # per-site (m,) f32 — weight since last ship
    coord_mg: hhlib.MGState
    w_c: torch.Tensor  # () f32 — weight received at C
    w_hat: torch.Tensor  # () f32 — broadcast estimate
    comm: CommCounters


def hh_p1_init(cfg: ProtocolConfig, device=None) -> HHP1State:
    """Initial HH P1 state: all m sites and the coordinator."""
    cfg = cfg.resolved()
    device = resolve_device(device)
    return HHP1State(
        site_mg=_tile(hhlib.mg_init(cfg.k, device), cfg.m),
        w_i=torch.zeros(cfg.m, dtype=torch.float32, device=device),
        coord_mg=hhlib.mg_init(cfg.k, device),
        w_c=torch.zeros((), dtype=torch.float32, device=device),
        w_hat=torch.ones((), dtype=torch.float32, device=device),
        comm=CommCounters.zero(device),
    )


def _site_pairs(cfg: ProtocolConfig, pairs) -> tuple[torch.Tensor, torch.Tensor]:
    """A global ``(keys, weights)`` pair of (m * b,) tensors as two (m, b):
    site i gets items [i*b, (i+1)*b), the contiguous split ``shard_map``
    gives each device."""
    a, w = pairs
    if a.ndim != 1 or w.shape != a.shape or a.shape[0] % cfg.m:
        raise ValueError(
            f"a super-step wants two (m * b,) tensors with m = {cfg.m}, got "
            f"{tuple(a.shape)} and {tuple(w.shape)}"
        )
    return a.reshape(cfg.m, -1), w.float().reshape(cfg.m, -1)


def hh_p1_step(cfg: ProtocolConfig, st: HHP1State, pairs) -> HHP1State:
    """One super-step on ``(keys i32 (m * b,), weights f32 (m * b,))``; site i
    takes slice i."""
    cfg = cfg.resolved()
    keys, weights = _site_pairs(cfg, pairs)
    site_mg = hhlib.mg_update_stream(st.site_mg, keys, weights)
    w_i = st.w_i + weights.sum(-1)

    send = w_i >= (cfg.eps / (2 * cfg.m)) * st.w_hat  # (m,)
    # Masked ship: a non-sender contributes the empty summary, so the fold
    # below is "the coordinator merges what was shipped", site by site.
    pay = hhlib.MGState(
        keys=torch.where(send[:, None], site_mg.keys, hhlib.EMPTY),
        counts=torch.where(send[:, None], site_mg.counts, 0.0),
        weight=torch.where(send, site_mg.weight, 0.0),
        shrink=torch.where(send, site_mg.shrink, 0.0),
    )
    coord = st.coord_mg
    for j in range(cfg.m):
        coord = hhlib.mg_merge(coord, hhlib.MGState(*(leaf[j] for leaf in pay)))

    live = (site_mg.keys != hhlib.EMPTY).sum(-1)
    shipped = torch.where(send, live, 0).sum()
    n_scalar = send.sum()

    w_c = st.w_c + torch.where(send, w_i, 0.0).sum()
    w_i = torch.where(send, 0.0, w_i)
    # Reset shipped site summaries.
    empty = hhlib.mg_init(cfg.k, keys.device)
    site_mg = hhlib.MGState(
        *(torch.where(_per_site(send, a), e, a) for a, e in zip(site_mg, empty))
    )

    rebroadcast = w_c / st.w_hat > 1.0 + cfg.eps / 2.0
    w_hat = torch.where(rebroadcast, w_c, st.w_hat)
    comm = CommCounters(
        scalar_msgs=st.comm.scalar_msgs + n_scalar.to(torch.int32),
        row_msgs=st.comm.row_msgs + shipped.to(torch.int32),
        broadcast_events=st.comm.broadcast_events + rebroadcast.to(torch.int32),
    )
    return HHP1State(site_mg, w_i, coord, w_c, w_hat, comm)


def hh_estimates(st: HHP1State) -> dict[int, float]:
    """The coordinator's current ``{element: weight-estimate}`` map."""
    return hhlib.mg_items(st.coord_mg)


def hh_w_hat(st: HHP1State) -> float:
    """Coordinator estimate of the total stream weight ``W`` (HH frob analog)."""
    return float(st.w_hat)


# ---------------------------------------------------------------------------
# Distributed quantiles, protocol 1 — batched summary merge.
#
# The quantile twin of hh_p1_step: every site maintains a fixed-shape
# GK-style ``QuantState`` over its local (value, weight) stream (all m
# inserts in one sort and one ``quant_pack`` launch); when its cumulative
# weight has grown by a ``1 + eps/4`` factor since the last ship (with an
# ``eps/(4m) * w_hat`` floor so early items batch up) it ships the whole
# summary, and the coordinator folds shipped summaries in with
# ``quant_merge``, site by site in order; a non-sender contributes the
# all-pad summary.  Message units follow the paper: a shipped summary of
# ``r`` live tuples costs ``r`` item messages plus one scalar, a ``w_hat``
# rebroadcast costs m.
# ---------------------------------------------------------------------------


class QuantP1State(NamedTuple):
    """Quantile P1 state: per-site summaries + the coordinator's summary."""
    site_q: qlib.QuantState  # per-site, leading m axis
    w_i: torch.Tensor  # per-site (m,) f32 — cumulative site weight
    w_pushed: torch.Tensor  # per-site (m,) f32 — cumulative weight at last ship
    coord_q: qlib.QuantState
    w_hat: torch.Tensor  # () f32 — broadcast estimate
    comm: CommCounters


def quant_p1_init(cfg: ProtocolConfig, device=None) -> QuantP1State:
    """Initial quantile P1 state: all m sites and the coordinator."""
    cfg = cfg.resolved()
    device = resolve_device(device)
    return QuantP1State(
        site_q=_tile(qlib.quant_init(cfg.q_cap, device), cfg.m),
        w_i=torch.zeros(cfg.m, dtype=torch.float32, device=device),
        w_pushed=torch.zeros(cfg.m, dtype=torch.float32, device=device),
        coord_q=qlib.quant_init(cfg.q_cap, device),
        w_hat=torch.ones((), dtype=torch.float32, device=device),
        comm=CommCounters.zero(device),
    )


def quant_p1_step(cfg: ProtocolConfig, st: QuantP1State, pairs) -> QuantP1State:
    """One super-step on ``(values f32 (m * b,), weights f32 (m * b,))``; site
    i takes slice i."""
    cfg = cfg.resolved()
    values, weights = _site_pairs(cfg, pairs)
    site_q = qlib.quant_insert(st.site_q, values, weights, cfg.eps / 4.0)
    w_i = st.w_i + weights.sum(-1)
    unpushed = w_i - st.w_pushed

    send = (w_i >= (1.0 + cfg.eps / 4.0) * st.w_pushed) & (
        unpushed >= (cfg.eps / (4.0 * cfg.m)) * st.w_hat
    )
    pay = qlib.QuantState(
        values=torch.where(send[:, None], site_q.values, float("inf")),
        g=torch.where(send[:, None], site_q.g, 0.0),
        delta=torch.where(send[:, None], site_q.delta, 0.0),
        wv=torch.where(send[:, None], site_q.wv, 0.0),
        weight=torch.where(send, site_q.weight, 0.0),
    )
    coord = st.coord_q
    for j in range(cfg.m):
        coord = qlib.quant_merge(coord, qlib.QuantState(*(leaf[j] for leaf in pay)),
                                 cfg.eps / 2.0, cfg.q_cap)

    live = torch.isfinite(site_q.values).sum(-1)
    shipped = torch.where(send, live, 0).sum()
    n_scalar = send.sum()

    w_pushed = torch.where(send, w_i, st.w_pushed)
    # Reset shipped site summaries.
    empty = qlib.quant_init(cfg.q_cap, values.device)
    site_q = qlib.QuantState(
        *(torch.where(_per_site(send, a), e, a) for a, e in zip(site_q, empty))
    )

    rebroadcast = coord.weight / st.w_hat > 1.0 + cfg.eps / 2.0
    w_hat = torch.where(rebroadcast, coord.weight, st.w_hat)
    comm = CommCounters(
        scalar_msgs=st.comm.scalar_msgs + n_scalar.to(torch.int32),
        row_msgs=st.comm.row_msgs + shipped.to(torch.int32),
        broadcast_events=st.comm.broadcast_events + rebroadcast.to(torch.int32),
    )
    return QuantP1State(site_q, w_i, w_pushed, coord, w_hat, comm)


def quant_p1_table(st: QuantP1State) -> np.ndarray:
    """The coordinator's published ``(n, 2)`` [value, rank-estimate] table."""
    return qlib.quant_table(st.coord_q)


def quant_p1_w_hat(st: QuantP1State) -> float:
    """Coordinator estimate of the total stream weight (quantile frob analog)."""
    return float(st.coord_q.weight)


# ---------------------------------------------------------------------------
# Leverage P1 — threshold forwarding + FD residual
#
# The super-step counterpart of the event-driven ``LeverageP1Stream``:
# every site scores its local rows against the coordinator factor
# ``(B^T B + lambda I)^+`` last broadcast (B = residual FD rows + the kept
# reservoir, lambda = eps * F_hat).  Rows whose score crosses the broadcast
# threshold ``theta`` are shipped outright — a masked gather, site by site
# in order — and folded into the reservoir with ``lev_merge_spill`` (the
# all-pad candidate batch is the merge identity); reservoir spill folds
# into the residual FD sketch, so overflow never loses mass.  Everything
# below threshold rides the site FD sketch, shipped on the matrix-P1 mass
# threshold ``(eps/2m) F_hat``.  Message units follow the paper: a
# forwarded row or shipped sketch row costs one row message, a sketch ship
# one scalar, and a rebroadcast (F_hat growth or theta doubling) costs m.
# The scoring factor refreshes ONLY on those counted broadcasts.
# ---------------------------------------------------------------------------


class LevP1State(NamedTuple):
    """Leverage P1 state: per-site FD + coordinator reservoir/factor data."""
    site_fd: fdlib.FDState  # per-site, leading m axis — residual rows only
    f_i: torch.Tensor  # per-site (m,) f32 — residual mass since last ship
    coord_fd: fdlib.FDState  # residual sketch at C
    res: levlib.LevState  # kept (row, score, weight) reservoir
    f_res: torch.Tensor  # () f32 — residual mass received at C
    f_hat: torch.Tensor  # () f32 — broadcast estimate of ||A||_F^2
    theta: torch.Tensor  # () f32 — forwarding threshold
    factor: torch.Tensor  # (d, d) f32 — last BROADCAST scoring factor
    comm: CommCounters


def lev_p1_init(cfg: ProtocolConfig, device=None) -> LevP1State:
    """Initial leverage P1 state: all m sites and the coordinator."""
    cfg = cfg.resolved()
    device = resolve_device(device)
    lam0 = levlib.default_lambda(cfg.eps, 1.0)
    return LevP1State(
        site_fd=_tile(fdlib.fd_init(cfg.l_site, cfg.d, device=device), cfg.m),
        f_i=torch.zeros(cfg.m, dtype=torch.float32, device=device),
        coord_fd=fdlib.fd_init(cfg.l_coord, cfg.d, device=device),
        res=levlib.lev_init(cfg.lev_cap, cfg.d, device=device),
        f_res=torch.zeros((), dtype=torch.float32, device=device),
        f_hat=torch.ones((), dtype=torch.float32, device=device),
        theta=torch.ones((), dtype=torch.float32, device=device),
        factor=torch.eye(cfg.d, dtype=torch.float32, device=device)
        / torch.tensor(lam0, dtype=torch.float32),
        comm=CommCounters.zero(device),
    )


def _lev_factor(coord_b: torch.Tensor, res_rows: torch.Tensor,
                f_hat: torch.Tensor, cfg: ProtocolConfig) -> torch.Tensor:
    """The scoring factors ``(B^T B + lambda I)^{-1}``, (T, d, d), at broadcast time.

    B stacks each tenant's residual FD rows (T, l_coord, d) and kept
    reservoir rows (T, cap, d); the ridge ``lambda = eps * max(f_hat, 1)``
    keeps the Gram positive definite, so an f32 ``eigh``-based inverse is
    exact (as in the reference).  One batched ``eigh`` for all T.
    """
    ball = torch.cat([coord_b, res_rows], dim=-2).float()
    lam = torch.tensor(cfg.eps, dtype=torch.float32) * f_hat.clamp_min(1.0)
    eye = torch.eye(cfg.d, dtype=torch.float32, device=ball.device)
    g = ball.mT @ ball + lam[:, None, None] * eye
    evals, evecs = torch.linalg.eigh(g)
    return (evecs / evals.clamp_min(1e-30)[..., None, :]) @ evecs.mT


@_on_packs
def lev_p1_step(cfg: ProtocolConfig, st: LevP1State, rows: torch.Tensor) -> LevP1State:
    """One leverage P1 super-step on a global (m * b, d) batch; site i takes slice i.

    (A pack: (T, ...) state and (T, m * b, d) rows, each tenant on its own.)
    """
    rows = rows.float()  # (T, m, b, d)
    if rows.shape[-2] == 0:  # nothing to absorb
        return st
    t = rows.shape[0]
    # Score against the LAST BROADCAST factor: between counted broadcasts
    # the sites' view of the coordinator summary is frozen.
    scores = ((rows @ st.factor[:, None]) * rows).sum(-1)  # (T, m, b)
    # A site forwards at most lev_cap rows per super-step: the top local
    # scorers above theta.  The k-th largest score is a value, so a stable
    # descending sort gives it whatever the order among ties.
    k_local = min(cfg.lev_cap, scores.shape[-1])
    kth = torch.sort(scores, dim=-1, descending=True, stable=True).values[..., k_local - 1]
    fwd = (scores >= st.theta[:, None, None]) & (scores >= kth[..., None])  # (T, m, b)
    n_fwd = fwd.sum((-2, -1)).to(torch.int32)

    # Masked ship of forwarded candidates, sites in order: a non-forwarded
    # lane contributes a zero-score triple, the identity of lev_merge.
    cand_rows = torch.where(fwd[..., None], rows, 0.0).reshape(t, -1, cfg.d)
    cand_scores = torch.where(fwd, scores, 0.0).reshape(t, -1)
    res, spilled = levlib.lev_merge_spill(
        st.res, cand_rows, cand_scores, torch.ones_like(cand_scores)
    )
    # Reservoir spill folds into the residual sketch (coordinator-local):
    # overflow raises theta, it never drops mass.
    coord_fd = fdlib.fd_update_stream(st.coord_fd, spilled)
    spill_mass = _row_sq(spilled).sum(-1)  # (T,)
    overflow = spill_mass > 0.0
    # Threshold propagation: once the reservoir overflows, the entry bar
    # jumps to the smallest kept score (doubling at minimum).
    theta = torch.where(overflow, torch.maximum(st.theta * 2.0, res.scores[..., -1]), st.theta)

    # Below-threshold rows ride the site FD sketch (zero rows are free).
    site_rows = torch.where(fwd[..., None], 0.0, rows)
    site_fd = fdlib.fd_update_stream(st.site_fd, site_rows)
    f_i = st.f_i + _row_sq(site_rows).sum(-1)  # (T, m)

    send = f_i >= (cfg.eps / (2 * cfg.m)) * st.f_hat[:, None]  # (T, m)
    live = fdlib.fd_matrix(site_fd)  # (T, m, l_site, d)
    payload = torch.where(send[..., None, None], live, 0.0)
    coord_fd = fdlib.fd_update_stream(coord_fd, payload.flatten(1, 2))
    shipped_rows = torch.where(send, (_row_sq(live) > 0).sum(-1), 0).sum(-1)
    n_scalar = send.sum(-1)

    f_res = st.f_res + spill_mass + torch.where(send, f_i, 0.0).sum(-1)
    f_i = torch.where(send, 0.0, f_i)
    empty = fdlib.fd_init(cfg.l_site, cfg.d, device=rows.device)
    site_fd = fdlib.FDState(
        *(torch.where(_per_site(send, a), e, a) for a, e in zip(site_fd, empty))
    )

    mass_kept = _row_sq(res.rows).sum(-1)
    rebroadcast = (f_res + mass_kept) / st.f_hat > 1.0 + cfg.eps / 2.0
    f_hat = torch.where(rebroadcast, f_res + mass_kept, st.f_hat)
    # A tenant's factor refreshes only when it counts a broadcast (mass
    # growth or theta doubling); the reference computes it every step under
    # a ``where``, here only for those tenants, in one batched eigh.
    factor = st.factor
    refresh = (rebroadcast | overflow).nonzero().flatten()
    if refresh.numel():
        new = _lev_factor(fdlib.fd_matrix(coord_fd)[refresh], res.rows[refresh],
                          f_hat[refresh], cfg)
        factor = new if refresh.numel() == t else factor.index_copy(0, refresh, new)
    comm = CommCounters(
        scalar_msgs=st.comm.scalar_msgs + n_scalar.to(torch.int32),
        row_msgs=st.comm.row_msgs + shipped_rows.to(torch.int32) + n_fwd,
        broadcast_events=st.comm.broadcast_events
        + rebroadcast.to(torch.int32)
        + overflow.to(torch.int32),
    )
    return LevP1State(site_fd, f_i, coord_fd, res, f_res, f_hat, theta, factor, comm)


def lev_p1_table(cfg: ProtocolConfig, st: LevP1State) -> np.ndarray:
    """The coordinator's published ``(n, d+2)`` [row | score | weight] table.

    Assembled by the shared ``core.leverage.build_p1_table`` encoder (kept
    reservoir rows at weight 1 beside the live residual-sketch rows at
    weight 1, on the host in f64) — the same deterministic estimator the
    event stream publishes.
    """
    cfg = cfg.resolved()
    scores = st.res.scores.cpu().numpy().astype(np.float64)
    live = scores > 0
    return levlib.build_p1_table(
        st.res.rows.cpu().numpy().astype(np.float64)[live],
        scores[live],
        fdlib.fd_matrix(st.coord_fd).cpu().numpy(),
        lev_p1_lambda(cfg, st),
    )


def lev_p1_mass(st: LevP1State) -> float:
    """Coordinator estimate of ``||A||_F^2`` (residual + kept reservoir mass)."""
    return float(st.f_res) + float(_row_sq(st.res.rows).sum())


def lev_p1_lambda(cfg: ProtocolConfig, st: LevP1State) -> float:
    """The live ridge ``lambda = eps * max(f_hat, 1)`` of a super-step state.

    Based on the *broadcast* mass estimate — the same basis the in-step
    scoring factor uses — so the score column of a published table and a
    served score query for the same vector agree beyond timing lag.
    """
    return levlib.default_lambda(cfg.eps, float(st.f_hat))


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------

_INITS = {"P1": p1_init, "P2": p2_init, "HHP1": hh_p1_init, "QP1": quant_p1_init,
          "LP1": lev_p1_init}
_STEPS = {"P1": p1_step, "P2": p2_step, "HHP1": hh_p1_step, "QP1": quant_p1_step,
          "LP1": lev_p1_step}
_MATRIX_PROTOCOLS = ("P1", "P2")


def protocol_matrix(protocol: str, state) -> torch.Tensor:
    """The coordinator's sketch matrix B for any matrix protocol state (uniform)."""
    if protocol not in _MATRIX_PROTOCOLS:
        raise KeyError(f"no matrix protocol {protocol!r} (ported: {list(_MATRIX_PROTOCOLS)})")
    return fdlib.fd_matrix(state.coord_fd)


def protocol_frob(protocol: str, state) -> float:
    """Coordinator estimate of the stream mass ``||A||_F^2`` (uniform).

    P1/P2 carry the coordinator's running broadcast estimate ``f_hat``
    (within (1+eps) of ``||A||_F^2``).
    """
    if protocol not in _MATRIX_PROTOCOLS:
        raise KeyError(f"no matrix protocol {protocol!r} (ported: {list(_MATRIX_PROTOCOLS)})")
    return float(state.f_hat)


def make_protocol_runner(protocol: str, cfg: ProtocolConfig, device=None):
    """Return ``(init_state, step)`` for one protocol (``P1``, ``P2``, ``LP1``,
    ``HHP1``, ``QP1``).

    For the matrix protocols and ``LP1`` ``step(state, rows)`` consumes a
    global ``(m * b, d)`` tensor on the state's device; site i takes rows
    ``[i*b, (i+1)*b)``.  For ``HHP1`` (element keys) and ``QP1`` (quantile
    values) it consumes a ``(keys or values, weights)`` pair of global
    ``(m * b,)`` tensors, split the same way.  Per-site state
    leaves carry a leading ``m`` axis, the layout the reference's global
    (sharded) state has, so states and checkpoints line up leaf for leaf.
    """
    if protocol not in _STEPS:
        raise KeyError(f"protocol {protocol!r} is not ported (ported: {sorted(_STEPS)})")
    cfg = cfg.resolved()
    return _INITS[protocol](cfg, device), functools.partial(_STEPS[protocol], cfg)


# Protocols safe to advance as a stacked multi-tenant pack: their step is a
# deterministic function of (state, rows) for which appended zero rows are
# exact no-ops on every served quantity (zero-norm rows add nothing to site
# sketches, masses, thresholds, or candidate sets).  The reference's P3 is
# not (its per-step random draw follows the padded row count), nor are the
# pair-input HH and quantile protocols.
PACKABLE_PROTOCOLS = ("P1", "P2", "LP1")


class PackedRunner(NamedTuple):
    """The two entry points of one packed super-step.

    ``stacked(stacked_state, rows)`` advances a resident ``(T, ...)``
    stacked state on ``(T, m * n, d)`` rows — the steady-state path:
    leaves stay in their pack layout between waves, nothing restacks.
    ``from_states(states_tuple, rows)`` first stacks a tuple of T
    per-tenant states — the (re)pack path for a group's first wave or
    after a member stepped serially.  Both return the advanced *stacked*
    state; ``unstack_packed`` slices a tenant out only when its state is
    read.
    """

    stacked: Callable
    from_states: Callable


def make_packed_runner(protocol: str, cfg: ProtocolConfig) -> PackedRunner:
    """Return a ``PackedRunner`` advancing T tenants in one call.

    T per-tenant states of one packable protocol with equal ``cfg`` stack
    along a leading tenant axis — per-site leaves become ``(T, m, ...)``,
    coordinator leaves ``(T, ...)``, the tenants' zero-padded row batches
    one ``(T, m * n, d)`` block — and the protocol's step, written on that
    axis, advances them together: each FD chunk is one shrink of all
    ``T * m`` site buffers (one Gram launch, one batched ``eigh``, one
    projection launch), and likewise for the T coordinator sketches.

    Ragged packs zero-pad each tenant's rows *per site block* up to the
    common ``n`` (see ``runtime.ingest_packed``); zero rows are no-ops for
    every ``PACKABLE_PROTOCOLS`` member, so the packed advance matches T
    serial steps on every served answer.
    """
    if protocol not in PACKABLE_PROTOCOLS:
        raise ValueError(
            f"protocol {protocol!r} is not packable; choose from {PACKABLE_PROTOCOLS}"
        )
    step = functools.partial(_STEPS[protocol], cfg.resolved())

    def from_states(states, rows):
        return step(_tree_stack(list(states)), rows)

    return PackedRunner(stacked=step, from_states=from_states)
