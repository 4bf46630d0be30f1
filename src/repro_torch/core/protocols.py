"""Event-driven distributed-streaming protocols — the paper, verbatim.

A copy of the reference's ``core/protocols.py`` (plain numpy, imports
rewritten).  It implements the paper's protocols with their exact
item-at-a-time message semantics on one host (sites are simulated).  It is
the *fidelity* engine: the registry's event engine serves it, and the
super-step engine (``core/distributed.py``) is held against it.

Weighted heavy hitters (Section 4):
    * ``HHP1`` — batched Misra--Gries merge            O((m/eps^2) log(beta N))
    * ``HHP2`` — Yi--Zhang thresholds                  O((m/eps)   log(beta N))
    * ``HHP3`` — priority sampling (wor / wr)          O((m+s) log(beta N / s))
    * ``HHP4`` — Huang-et-al probabilistic sends       O((sqrt m/eps) log(beta N))

Matrix tracking (Section 5):
    * ``MP1``  — batched Frequent Directions merge     O((m/eps^2) log(beta N)) rows
    * ``MP2``  — per-direction SVD thresholds          O((m/eps)   log(beta N)) rows
    * ``MP3``  — priority row sampling (wor / wr)      O((m+s) log(beta N / s)) rows
    * ``MP4``  — Appendix C negative result (implemented to reproduce failure)

Message accounting follows the paper: a message is one d-dimensional row (or
one element/scalar pair); a sketch of r rows costs r messages; a coordinator
broadcast costs m messages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.comm import CommReport, build_report
from repro_torch.core.fd import FDSketch
from repro_torch.core.hh import MGSketch

__all__ = [
    "CommLog",
    "HHResult",
    "MatrixResult",
    "run_hh_protocol",
    "run_matrix_protocol",
    "HH_PROTOCOLS",
    "HH_STREAMS",
    "MATRIX_PROTOCOLS",
    "MATRIX_STREAMS",
]


def _rng_state(rng: np.random.Generator) -> dict:
    """JSON-able PRNG state (PCG64 state ints serialize losslessly)."""
    return rng.bit_generator.state


def _rng_from_state(state: dict) -> np.random.Generator:
    rng = np.random.default_rng(0)
    rng.bit_generator.state = state
    return rng


@dataclass
class CommLog:
    """Counts messages with the paper's units."""

    scalar_msgs: int = 0  # (total, W_i)-style scalar messages, site -> C
    item_msgs: int = 0  # element/row messages, site -> C
    sketch_rows: int = 0  # rows shipped inside sketch sends, site -> C
    broadcast_events: int = 0  # coordinator -> all sites (each costs m)

    def total(self, m: int) -> int:
        """Total message cost in the paper's units (broadcasts cost m each)."""
        return (
            self.scalar_msgs
            + self.item_msgs
            + self.sketch_rows
            + self.broadcast_events * m
        )

    def report(self, m: int) -> CommReport:
        """Collapse to the engine-agnostic report (item + sketch rows unify)."""
        return build_report(
            scalar_msgs=self.scalar_msgs,
            row_msgs=self.item_msgs + self.sketch_rows,
            broadcast_events=self.broadcast_events,
            m=m,
        )


@dataclass
class HHResult:
    """Coordinator HH answer: estimate map, total weight, message costs."""
    estimates: dict[int, float]
    w_hat: float
    comm: CommLog
    m: int
    eps: float

    def heavy_hitters(self, phi: float) -> list[int]:
        """Return e iff hat{W}_e >= (phi - eps/2) hat{W} (paper Section 4)."""
        from repro_torch.core.hh import threshold_heavy_hitters

        return threshold_heavy_hitters(self.estimates, self.w_hat, self.eps, phi)


@dataclass
class MatrixResult:
    """Coordinator matrix answer: sketch B, mass estimate, message costs."""
    b: np.ndarray  # the coordinator's sketch matrix
    f_hat: float
    comm: CommLog
    m: int
    eps: float

    def covariance_error(self, ata: np.ndarray, frob: float) -> float:
        """``||A^T A - B^T B||_2 / ||A||_F^2`` (paper's err metric)."""
        btb = self.b.T @ self.b
        return float(np.linalg.norm(ata - btb, 2) / max(frob, 1e-300))


def _comm_state(comm: CommLog) -> dict:
    return {
        "scalar_msgs": comm.scalar_msgs,
        "item_msgs": comm.item_msgs,
        "sketch_rows": comm.sketch_rows,
        "broadcast_events": comm.broadcast_events,
    }


def _comm_from_state(state: dict) -> CommLog:
    return CommLog(**{k: int(v) for k, v in state.items()})


# ---------------------------------------------------------------------------
# Weighted heavy hitters — resumable stream engines + one-shot wrappers
#
# Mirrors the matrix section below: each protocol is a class with
# ``step(keys, weights, sites)`` (absorb a batch, continuing the
# event-at-a-time semantics exactly where the last batch left off) and
# ``result()`` (the coordinator's current HHResult, callable at any time).
# Every stream also implements ``state_dict()`` / ``load_state()`` — a
# JSON-able snapshot of its full coordinator+site state — so HH tenants
# survive a ``StreamingPipeline`` checkpoint/restart bit-identically.
# The ``_hh_pX`` one-shot wrappers reproduce the historical draw sequences
# (a single whole-stream ``step`` call is the old code path, verbatim).
# ---------------------------------------------------------------------------


class HHP1Stream:
    """HH P1: per-site MG_{eps/2}, batched sketch shipping + MG merge."""

    def __init__(self, m, eps, rng=None, k=None):
        if k is None:
            k = max(2, math.ceil(2.0 / eps))  # MG_{eps/2}: err <= (eps/2) W
        self.m, self.eps, self.k = m, eps, k
        self.comm = CommLog()
        self.site_mg = [MGSketch(k) for _ in range(m)]
        self.site_w = [0.0] * m
        self.coord = MGSketch(k)
        self.w_c = 0.0
        self.w_hat = 1.0

    def step(self, keys, weights, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly where the last
        batch left off."""
        m, eps = self.m, self.eps
        for e, w, j in zip(keys.tolist(), weights.tolist(), sites.tolist()):
            mg = self.site_mg[j]
            mg.update(e, w)
            self.site_w[j] += w
            if self.site_w[j] >= (eps / (2 * m)) * self.w_hat:
                self.comm.sketch_rows += len(mg.counters)
                self.comm.scalar_msgs += 1
                self.coord.merge(mg)
                self.w_c += self.site_w[j]
                self.site_mg[j] = MGSketch(self.k)
                self.site_w[j] = 0.0
                if self.w_c / self.w_hat > 1.0 + eps / 2.0:
                    self.w_hat = self.w_c
                    self.comm.broadcast_events += 1

    def result(self) -> HHResult:
        """The coordinator's current answer (callable at any time)."""
        return HHResult(self.coord.items(), self.w_hat, self.comm, self.m, self.eps)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the full coordinator + site state."""
        return {
            "k": self.k,
            "site_mg": [mg.state_dict() for mg in self.site_mg],
            "site_w": list(self.site_w),
            "coord": self.coord.state_dict(),
            "w_c": self.w_c,
            "w_hat": self.w_hat,
            "comm": _comm_state(self.comm),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output bit-identically."""
        self.k = int(state["k"])
        self.site_mg = [MGSketch.from_state(s) for s in state["site_mg"]]
        self.site_w = [float(w) for w in state["site_w"]]
        self.coord = MGSketch.from_state(state["coord"])
        self.w_c = float(state["w_c"])
        self.w_hat = float(state["w_hat"])
        self.comm = _comm_from_state(state["comm"])


def _hh_p1(keys, weights, sites, m, eps, rng) -> HHResult:
    eng = HHP1Stream(m, eps, rng)
    eng.step(keys, weights, sites)
    return eng.result()


class HHP2Stream:
    """HH P2 (Yi--Zhang): scalar total + per-element delta thresholds."""

    def __init__(self, m, eps, rng=None):
        self.m, self.eps = m, eps
        self.comm = CommLog()
        self.site_w = [0.0] * m
        self.site_delta: list[dict[int, float]] = [dict() for _ in range(m)]
        self.w_hat = 1.0
        self.n_msg = 0
        self.est: dict[int, float] = {}
        self.thresh = (eps / m) * self.w_hat

    def step(self, keys, weights, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly where the last
        batch left off."""
        m, eps = self.m, self.eps
        for e, w, j in zip(keys.tolist(), weights.tolist(), sites.tolist()):
            self.site_w[j] += w
            d = self.site_delta[j]
            d[e] = d.get(e, 0.0) + w
            if self.site_w[j] >= self.thresh:
                self.comm.scalar_msgs += 1
                w_hat_c = self.site_w[j]
                self.site_w[j] = 0.0
                self.n_msg += 1
                self.w_hat += w_hat_c
                if self.n_msg >= m:
                    self.n_msg = 0
                    self.comm.broadcast_events += 1
                    self.thresh = (eps / m) * self.w_hat
            if d[e] >= self.thresh:
                self.comm.item_msgs += 1
                self.est[e] = self.est.get(e, 0.0) + d[e]
                d[e] = 0.0

    def result(self) -> HHResult:
        """The coordinator's current answer (callable at any time)."""
        return HHResult(dict(self.est), self.w_hat, self.comm, self.m, self.eps)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the full coordinator + site state."""
        return {
            "site_w": list(self.site_w),
            # Flushed deltas are set to 0.0, not deleted; absent and zero are
            # indistinguishable to step(), so skip them — else a checkpoint
            # embeds every element ever seen per site.
            "site_delta": [
                {str(e): w for e, w in d.items() if w != 0.0} for d in self.site_delta
            ],
            "w_hat": self.w_hat,
            "n_msg": self.n_msg,
            "est": {str(e): w for e, w in self.est.items()},
            "thresh": self.thresh,
            "comm": _comm_state(self.comm),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output bit-identically."""
        self.site_w = [float(w) for w in state["site_w"]]
        self.site_delta = [
            {int(e): float(w) for e, w in d.items()} for d in state["site_delta"]
        ]
        self.w_hat = float(state["w_hat"])
        self.n_msg = int(state["n_msg"])
        self.est = {int(e): float(w) for e, w in state["est"].items()}
        self.thresh = float(state["thresh"])
        self.comm = _comm_from_state(state["comm"])


def _hh_p2(keys, weights, sites, m, eps, rng) -> HHResult:
    eng = HHP2Stream(m, eps, rng)
    eng.step(keys, weights, sites)
    return eng.result()


class HHP3Stream:
    """HH P3: distributed priority sampling without replacement."""

    def __init__(self, m, eps, rng, s=None):
        if s is None:
            s = max(8, math.ceil((1.0 / eps**2) * math.log(max(math.e, 1.0 / eps))))
        self.m, self.eps, self.s = m, eps, s
        self.rng = rng
        self.comm = CommLog()
        self.tau = 1.0
        self.q_cur: list[tuple[int, float, float]] = []  # (element, w, rho)
        self.q_next: list[tuple[int, float, float]] = []

    def step(self, keys, weights, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly where the last
        batch left off."""
        n = len(keys)
        rho_all = weights / np.maximum(self.rng.uniform(size=n), 1e-300)
        for e, w, rho in zip(keys.tolist(), weights.tolist(), rho_all.tolist()):
            if rho >= self.tau:  # site-side check; one message
                self.comm.item_msgs += 1
                if rho >= 2.0 * self.tau:
                    self.q_next.append((e, w, rho))
                else:
                    self.q_cur.append((e, w, rho))
                if len(self.q_next) >= self.s:
                    self.tau *= 2.0
                    self.comm.broadcast_events += 1
                    self.q_cur = self.q_next
                    self.q_next = [t for t in self.q_cur if t[2] >= 2.0 * self.tau]
                    self.q_cur = [t for t in self.q_cur if t[2] < 2.0 * self.tau]

    def result(self) -> HHResult:
        """The coordinator's current answer (callable at any time)."""
        sample = self.q_cur + self.q_next
        est: dict[int, float] = {}
        if not sample:
            return HHResult(est, 0.0, self.comm, self.m, self.eps)
        sample = sorted(sample, key=lambda t: t[2])
        rho_hat = sample[0][2]
        kept = sample[1:] if len(sample) > 1 else sample
        w_hat = 0.0
        for e, w, _rho in kept:
            wbar = max(w, rho_hat)
            est[e] = est.get(e, 0.0) + wbar
            w_hat += wbar
        return HHResult(est, w_hat, self.comm, self.m, self.eps)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the full coordinator + site state."""
        return {
            "s": self.s,
            "tau": self.tau,
            "q_cur": [list(t) for t in self.q_cur],
            "q_next": [list(t) for t in self.q_next],
            "rng": _rng_state(self.rng),
            "comm": _comm_state(self.comm),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output bit-identically."""
        self.s = int(state["s"])
        self.tau = float(state["tau"])
        self.q_cur = [(int(e), float(w), float(r)) for e, w, r in state["q_cur"]]
        self.q_next = [(int(e), float(w), float(r)) for e, w, r in state["q_next"]]
        self.rng = _rng_from_state(state["rng"])
        self.comm = _comm_from_state(state["comm"])


def _hh_p3(keys, weights, sites, m, eps, rng, s=None) -> HHResult:
    eng = HHP3Stream(m, eps, rng, s=s)
    eng.step(keys, weights, sites)
    return eng.result()


class HHP3wrStream:
    """HH P3 with replacement: s independent priority samplers.

    Uniform draws are blocked by ``min(n, 1 << 22) // s`` within each
    ``step`` call, so a single whole-stream step reproduces the historical
    one-shot draw sequence exactly.
    """

    def __init__(self, m, eps, rng, s=None):
        if s is None:
            s = max(8, math.ceil((1.0 / eps**2) * math.log(max(math.e, 1.0 / eps))))
        self.m, self.eps, self.s = m, eps, s
        self.rng = rng
        self.comm = CommLog()
        self.tau = 1.0
        self.top1_rho = np.zeros(s)  # highest priority per sampler
        self.top2_rho = np.zeros(s)  # second highest per sampler
        self.top1_elem = np.full(s, -1, np.int64)

    def step(self, keys, weights, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly where the last
        batch left off."""
        s = self.s
        n = len(keys)
        block = max(1, min(n, 1 << 22) // max(s, 1) or 1)
        i = 0
        while i < n:
            hi = min(n, i + block)
            u = self.rng.uniform(size=(hi - i, s))
            rho = weights[i:hi, None] / np.maximum(u, 1e-300)
            send_any = rho >= self.tau
            for r in range(hi - i):
                hit = np.nonzero(send_any[r])[0]
                if hit.size == 0:
                    continue
                self.comm.item_msgs += int(hit.size)
                e = int(keys[i + r])
                rr = rho[r, hit]
                for t, p in zip(hit.tolist(), rr.tolist()):
                    if p > self.top1_rho[t]:
                        self.top2_rho[t] = self.top1_rho[t]
                        self.top1_rho[t] = p
                        self.top1_elem[t] = e
                    elif p > self.top2_rho[t]:
                        self.top2_rho[t] = p
                # Round ends when every sampler's 2nd priority is above 2*tau.
                if np.all(self.top2_rho > 2.0 * self.tau):
                    self.tau *= 2.0
                    self.comm.broadcast_events += 1
            i = hi

    def result(self) -> HHResult:
        """The coordinator's current answer (callable at any time)."""
        w_hat = float(np.mean(self.top2_rho))
        est: dict[int, float] = {}
        for t in range(self.s):
            e = int(self.top1_elem[t])
            if e >= 0:
                est[e] = est.get(e, 0.0) + w_hat / self.s
        return HHResult(est, w_hat, self.comm, self.m, self.eps)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the full coordinator + site state."""
        return {
            "s": self.s,
            "tau": self.tau,
            "top1_rho": self.top1_rho.tolist(),
            "top2_rho": self.top2_rho.tolist(),
            "top1_elem": self.top1_elem.tolist(),
            "rng": _rng_state(self.rng),
            "comm": _comm_state(self.comm),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output bit-identically."""
        self.s = int(state["s"])
        self.tau = float(state["tau"])
        self.top1_rho = np.array(state["top1_rho"], np.float64)
        self.top2_rho = np.array(state["top2_rho"], np.float64)
        self.top1_elem = np.array(state["top1_elem"], np.int64)
        self.rng = _rng_from_state(state["rng"])
        self.comm = _comm_from_state(state["comm"])


def _hh_p3wr(keys, weights, sites, m, eps, rng, s=None) -> HHResult:
    eng = HHP3wrStream(m, eps, rng, s=s)
    eng.step(keys, weights, sites)
    return eng.result()


class HHP4Stream:
    """HH P4 (Huang et al.): send f_e(A_j) with prob 1 - exp(-p*w)."""

    def __init__(self, m, eps, rng):
        self.m, self.eps = m, eps
        self.rng = rng
        self.comm = CommLog()
        self.w_hat = 1.0  # sites' broadcast estimate; w_hat <= W_C <= 2*w_hat
        self.w_c = 1.0  # coordinator's running total
        self.p = 2.0 * math.sqrt(m) / (eps * self.w_hat)
        self.site_f: list[dict[int, float]] = [dict() for _ in range(m)]
        self.site_w = [0.0] * m
        # Last received (e, j) -> value; coordinator-side.
        self.recv: dict[tuple[int, int], float] = {}

    def step(self, keys, weights, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly where the last
        batch left off."""
        m, eps = self.m, self.eps
        u_all = self.rng.uniform(size=len(keys))
        for idx, (e, w, j) in enumerate(zip(keys.tolist(), weights.tolist(), sites.tolist())):
            f = self.site_f[j]
            f[e] = f.get(e, 0.0) + w
            self.site_w[j] += w
            # Deterministic total-weight tracking (eps=1/2 Yi-Zhang totals);
            # the coordinator re-broadcasts w_hat each time its total doubles.
            if self.site_w[j] >= self.w_hat / (2 * m):
                self.comm.scalar_msgs += 1
                self.w_c += self.site_w[j]
                self.site_w[j] = 0.0
                if self.w_c >= 2.0 * self.w_hat:
                    self.w_hat = self.w_c
                    self.p = 2.0 * math.sqrt(m) / (eps * self.w_hat)
                    self.comm.broadcast_events += 1
            p_bar = 1.0 - math.exp(-self.p * w)
            if u_all[idx] <= p_bar:
                self.comm.item_msgs += 1
                self.recv[(e, j)] = f[e]

    def result(self) -> HHResult:
        """The coordinator's current answer (callable at any time)."""
        est: dict[int, float] = {}
        for (e, _j), v in self.recv.items():
            est[e] = est.get(e, 0.0) + v + 1.0 / self.p
        return HHResult(est, self.w_c, self.comm, self.m, self.eps)

    def state_dict(self) -> dict:
        """JSON-able snapshot of the full coordinator + site state."""
        return {
            "w_hat": self.w_hat,
            "w_c": self.w_c,
            "p": self.p,
            "site_f": [{str(e): w for e, w in f.items()} for f in self.site_f],
            "site_w": list(self.site_w),
            "recv": [[e, j, v] for (e, j), v in self.recv.items()],
            "rng": _rng_state(self.rng),
            "comm": _comm_state(self.comm),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output bit-identically."""
        self.w_hat = float(state["w_hat"])
        self.w_c = float(state["w_c"])
        self.p = float(state["p"])
        self.site_f = [{int(e): float(w) for e, w in f.items()} for f in state["site_f"]]
        self.site_w = [float(w) for w in state["site_w"]]
        self.recv = {(int(e), int(j)): float(v) for e, j, v in state["recv"]}
        self.rng = _rng_from_state(state["rng"])
        self.comm = _comm_from_state(state["comm"])


def _hh_p4(keys, weights, sites, m, eps, rng) -> HHResult:
    eng = HHP4Stream(m, eps, rng)
    eng.step(keys, weights, sites)
    return eng.result()


HH_PROTOCOLS = {
    "P1": _hh_p1,
    "P2": _hh_p2,
    "P3": _hh_p3,
    "P3wr": _hh_p3wr,
    "P4": _hh_p4,
}

# Resumable stream engines (init/step/result/state_dict) — the registry's
# event-engine HH entries.  Unlike the matrix family, P4 is a *positive*
# result for heavy hitters (Huang et al.), so all five are offered.
HH_STREAMS = {
    "P1": HHP1Stream,
    "P2": HHP2Stream,
    "P3": HHP3Stream,
    "P3wr": HHP3wrStream,
    "P4": HHP4Stream,
}


def run_hh_protocol(
    name: str,
    keys: np.ndarray,
    weights: np.ndarray,
    sites: np.ndarray,
    m: int,
    eps: float,
    seed: int = 0,
    **kw,
) -> HHResult:
    """One-shot wrapper: stream the whole feed through HH protocol ``name``."""
    rng = np.random.default_rng(seed)
    return HH_PROTOCOLS[name](keys, weights, sites, m, eps, rng, **kw)


# ---------------------------------------------------------------------------
# Matrix tracking — resumable stream engines + one-shot wrappers
#
# Each protocol is a small class with ``step(rows, sites)`` (absorb a batch,
# continuing the event-at-a-time semantics exactly where the last batch left
# off) and ``result()`` (the coordinator's current MatrixResult, callable at
# any time — this is the paper's "continuous" query surface).  The module
# level ``_mpX`` functions are one-shot wrappers kept for the benchmarks and
# figure scripts; ``repro_torch.runtime.registry`` builds its event-engine entries
# from the stream classes.
# ---------------------------------------------------------------------------


class MP1Stream:
    """Matrix P1: per-site FD_{eps/2}, batched sketch shipping + FD merge."""

    def __init__(self, m, eps, d, rng, l=None):
        if l is None:
            l = max(2, math.ceil(4.0 / eps))  # FD err 2/l <= eps/2
        self.m, self.eps, self.d = m, eps, d
        self.comm = CommLog()
        self.site_fd = [FDSketch(l, d) for _ in range(m)]
        self.site_f = [0.0] * m
        self.l = l
        self.coord = FDSketch(l, d)
        self.f_c = 0.0
        self.f_hat = 1.0

    def step(self, rows, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly where the last
        batch left off."""
        m, eps = self.m, self.eps
        row_sq = np.einsum("nd,nd->n", rows, rows)
        for i, j in enumerate(sites.tolist()):
            fd = self.site_fd[j]
            fd.append(rows[i])
            self.site_f[j] += float(row_sq[i])
            if self.site_f[j] >= (eps / (2 * m)) * self.f_hat:
                mat = fd.matrix()
                nz = mat[np.einsum("rd,rd->r", mat, mat) > 0]
                self.comm.sketch_rows += int(nz.shape[0])
                self.comm.scalar_msgs += 1
                self.coord.merge(fd)
                self.f_c += self.site_f[j]
                self.site_fd[j] = FDSketch(self.l, self.d)
                self.site_f[j] = 0.0
                if self.f_c / self.f_hat > 1.0 + eps / 2.0:
                    self.f_hat = self.f_c
                    self.comm.broadcast_events += 1

    def result(self) -> MatrixResult:
        """The coordinator's current answer (callable at any time)."""
        return MatrixResult(self.coord.matrix(), self.f_hat, self.comm, self.m, self.eps)


def _mp1(rows, sites, m, eps, rng, l=None) -> MatrixResult:
    eng = MP1Stream(m, eps, rows.shape[1], rng, l=l)
    eng.step(rows, sites)
    return eng.result()


class _MP2Site:
    """Site state for matrix P2: rank-<=d residual matrix + lazy SVD.

    The residual B_j is kept in factored form ``S`` (r x d, r <= d+buffer).
    An SVD is only computed when the cheap upper bound on sigma_1^2
    (last sigma_1^2 + Frobenius mass appended since) can cross the send
    threshold — this is exact, since appending rows raises sigma_1^2 by at
    most the appended squared-Frobenius mass.
    """

    def __init__(self, d: int):
        self.d = d
        self.dirs = np.zeros((0, d))  # sigma_i * v_i rows from last SVD
        self.pending: list[np.ndarray] = []
        self.sig1_sq = 0.0  # sigma_1^2 at last SVD
        self.pending_sq = 0.0

    def append(self, row: np.ndarray) -> None:
        # Copy: pending rows outlive the caller's batch buffer (stream use).
        """Buffer one row (Frobenius mass tracked for the lazy-SVD bound)."""
        self.pending.append(np.array(row, dtype=np.float64))
        self.pending_sq += float(row @ row)

    def maybe_send(self, thresh: float) -> list[np.ndarray]:
        """Ship every direction whose sigma^2 crosses ``thresh`` (lazy SVD)."""
        if self.sig1_sq + self.pending_sq < thresh:
            return []
        if self.pending:
            b = np.concatenate([self.dirs, np.stack(self.pending)], axis=0)
        else:
            b = self.dirs
        if b.shape[0] == 0:
            return []
        # svd: B = U diag(s) Vt
        _, s, vt = np.linalg.svd(b, full_matrices=False)
        send = s**2 >= thresh
        out = [s[i] * vt[i] for i in np.nonzero(send)[0]]
        keep = ~send
        self.dirs = s[keep, None] * vt[keep]
        self.pending = []
        self.pending_sq = 0.0
        self.sig1_sq = float(np.max(s[keep] ** 2)) if np.any(keep) else 0.0
        return out


class MP2Stream:
    """Matrix P2: the paper's best protocol — per-direction thresholds."""

    def __init__(self, m, eps, d, rng):
        self.m, self.eps, self.d = m, eps, d
        self.comm = CommLog()
        self.site = [_MP2Site(d) for _ in range(m)]
        self.site_f = [0.0] * m
        self.f_hat = 1.0
        self.n_msg = 0
        self.thresh = (eps / m) * self.f_hat
        self.coord_rows: list[np.ndarray] = []

    def step(self, rows, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly where the last
        batch left off."""
        m, eps = self.m, self.eps
        row_sq = np.einsum("nd,nd->n", rows, rows)
        for i, j in enumerate(sites.tolist()):
            self.site_f[j] += float(row_sq[i])
            if self.site_f[j] >= self.thresh:
                self.comm.scalar_msgs += 1
                self.f_hat += self.site_f[j]
                self.site_f[j] = 0.0
                self.n_msg += 1
                if self.n_msg >= m:
                    self.n_msg = 0
                    self.comm.broadcast_events += 1
                    self.thresh = (eps / m) * self.f_hat
            st = self.site[j]
            st.append(rows[i])
            sent = st.maybe_send(self.thresh)
            if sent:
                self.comm.item_msgs += len(sent)
                self.coord_rows.extend(sent)

    def result(self) -> MatrixResult:
        """The coordinator's current answer (callable at any time)."""
        b = np.stack(self.coord_rows) if self.coord_rows else np.zeros((0, self.d))
        return MatrixResult(b, self.f_hat, self.comm, self.m, self.eps)


def _mp2(rows, sites, m, eps, rng) -> MatrixResult:
    eng = MP2Stream(m, eps, rows.shape[1], rng)
    eng.step(rows, sites)
    return eng.result()


class MP3Stream:
    """Matrix P3: priority row-sampling without replacement."""

    def __init__(self, m, eps, d, rng, s=None):
        if s is None:
            s = max(8, math.ceil((1.0 / eps**2) * math.log(max(math.e, 1.0 / eps))))
        self.m, self.eps, self.d, self.s = m, eps, d, s
        self.rng = rng
        self.comm = CommLog()
        self.tau = 1.0
        self.q_cur: list[tuple[np.ndarray, float, float]] = []  # (row, w, rho)
        self.q_next: list[tuple[np.ndarray, float, float]] = []

    def step(self, rows, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly where the last
        batch left off."""
        w_all = np.einsum("nd,nd->n", rows, rows)
        rho_all = w_all / np.maximum(self.rng.uniform(size=rows.shape[0]), 1e-300)
        for i, (w, rho) in enumerate(zip(w_all.tolist(), rho_all.tolist())):
            if rho >= self.tau:
                self.comm.item_msgs += 1
                # Copy: sampled rows outlive the caller's batch buffer.
                if rho >= 2.0 * self.tau:
                    self.q_next.append((rows[i].copy(), w, rho))
                else:
                    self.q_cur.append((rows[i].copy(), w, rho))
                if len(self.q_next) >= self.s:
                    self.tau *= 2.0
                    self.comm.broadcast_events += 1
                    self.q_cur = self.q_next
                    self.q_next = [t for t in self.q_cur if t[2] >= 2.0 * self.tau]
                    self.q_cur = [t for t in self.q_cur if t[2] < 2.0 * self.tau]

    def result(self) -> MatrixResult:
        """The coordinator's current answer (callable at any time)."""
        sample = self.q_cur + self.q_next
        if not sample:
            return MatrixResult(np.zeros((0, self.d)), 0.0, self.comm, self.m, self.eps)
        sample = sorted(sample, key=lambda t: t[2])
        rho_hat = sample[0][2]
        kept = sample[1:] if len(sample) > 1 else sample
        out = []
        f_hat = 0.0
        for row, w, _rho in kept:
            wbar = max(w, rho_hat)
            f_hat += wbar
            scale = math.sqrt(wbar / max(w, 1e-300))
            out.append(row * scale)
        return MatrixResult(np.stack(out), f_hat, self.comm, self.m, self.eps)


def _mp3(rows, sites, m, eps, rng, s=None) -> MatrixResult:
    eng = MP3Stream(m, eps, rows.shape[1], rng, s=s)
    eng.step(rows, sites)
    return eng.result()


class MP3wrStream:
    """Matrix P3 with replacement: s independent row samplers.

    Uniform draws are blocked by ``min(n, 1 << 22) // s`` within each
    ``step`` call, so a single whole-stream step reproduces the historical
    one-shot draw sequence exactly.
    """

    def __init__(self, m, eps, d, rng, s=None):
        if s is None:
            s = max(8, math.ceil(1.0 / eps**2))
        self.m, self.eps, self.d, self.s = m, eps, d, s
        self.rng = rng
        self.comm = CommLog()
        self.tau = 1.0
        self.top1_rho = np.zeros(s)
        self.top2_rho = np.zeros(s)
        self.top1_row = [None] * s
        self.top1_w = np.zeros(s)

    def step(self, rows, sites) -> None:
        """Absorb a batch, continuing the event-at-a-time semantics exactly where the last
        batch left off."""
        s = self.s
        w_all = np.einsum("nd,nd->n", rows, rows)
        n = rows.shape[0]
        block = max(1, min(n, 1 << 22) // max(s, 1) or 1)
        i = 0
        while i < n:
            hi = min(n, i + block)
            u = self.rng.uniform(size=(hi - i, s))
            rho = w_all[i:hi, None] / np.maximum(u, 1e-300)
            send_any = rho >= self.tau
            for r in range(hi - i):
                hit = np.nonzero(send_any[r])[0]
                if hit.size == 0:
                    continue
                self.comm.item_msgs += int(hit.size)
                rr = rho[r, hit]
                for t, p in zip(hit.tolist(), rr.tolist()):
                    if p > self.top1_rho[t]:
                        self.top2_rho[t] = self.top1_rho[t]
                        self.top1_rho[t] = p
                        self.top1_row[t] = rows[i + r].copy()  # outlives the batch
                        self.top1_w[t] = w_all[i + r]
                    elif p > self.top2_rho[t]:
                        self.top2_rho[t] = p
                if np.all(self.top2_rho > 2.0 * self.tau):
                    self.tau *= 2.0
                    self.comm.broadcast_events += 1
            i = hi

    def result(self) -> MatrixResult:
        """The coordinator's current answer (callable at any time)."""
        w_hat = float(np.mean(self.top2_rho))
        out = []
        for t in range(self.s):
            row = self.top1_row[t]
            if row is None:
                continue
            w = float(self.top1_w[t])
            scale = math.sqrt((w_hat / self.s) / max(w, 1e-300))
            out.append(row * scale)
        b = np.stack(out) if out else np.zeros((0, self.d))
        return MatrixResult(b, w_hat, self.comm, self.m, self.eps)


def _mp3wr(rows, sites, m, eps, rng, s=None) -> MatrixResult:
    eng = MP3wrStream(m, eps, rows.shape[1], rng, s=s)
    eng.step(rows, sites)
    return eng.result()


def _mp4(rows, sites, m, eps, rng, variant="fixed") -> MatrixResult:
    """Matrix P4 (Appendix C) — the paper's NEGATIVE result, reproduced.

    Sites track hat{A}_j = Z V^T where V never changes (variant='fixed', as
    Algorithm C.1 implies) or is re-seeded from the current covariance at
    each send (variant='resvd', the charitable reading).  Either way the
    error is NOT bounded by eps — see benchmarks/p4_negative.py.
    """
    d = rows.shape[1]
    comm = CommLog()
    f_hat = 1.0
    p = 2.0 * math.sqrt(m) / (eps * f_hat)
    site_cov = [np.zeros((d, d)) for _ in range(m)]  # exact A_j^T A_j
    site_v = [np.eye(d) for _ in range(m)]
    site_z = [np.zeros(d) for _ in range(m)]
    site_w = [0.0] * m

    w_all = np.einsum("nd,nd->n", rows, rows)
    u_all = rng.uniform(size=rows.shape[0])
    for i, j in enumerate(sites.tolist()):
        a = rows[i]
        site_cov[j] += np.outer(a, a)
        site_w[j] += float(w_all[i])
        if site_w[j] >= f_hat / (2 * m):
            comm.scalar_msgs += 1
            f_hat += site_w[j]
            site_w[j] = 0.0
            p = 2.0 * math.sqrt(m) / (eps * f_hat)
        p_bar = 1.0 - math.exp(-p * float(w_all[i]))
        if u_all[i] <= p_bar:
            comm.item_msgs += 1  # one d-dim vector message z
            v = site_v[j]
            if variant == "resvd":
                lam, vec = np.linalg.eigh(site_cov[j])
                v = vec[:, ::-1]
                site_v[j] = v
            quad = np.einsum("di,dk,ki->i", v, site_cov[j], v)
            site_z[j] = np.sqrt(np.maximum(quad + 1.0 / p, 0.0))

    blocks = [site_z[j][:, None] * site_v[j].T for j in range(m)]
    b = np.concatenate(blocks, axis=0)
    return MatrixResult(b, f_hat, comm, m, eps)


MATRIX_PROTOCOLS = {
    "P1": _mp1,
    "P2": _mp2,
    "P3": _mp3,
    "P3wr": _mp3wr,
    "P4": _mp4,
}

# Resumable stream engines (init/step/result) — the registry's event entries.
# P4 is deliberately absent: it is the paper's negative result and must not
# be offered behind an interface whose contract is the eps guarantee.
MATRIX_STREAMS = {
    "P1": MP1Stream,
    "P2": MP2Stream,
    "P3": MP3Stream,
    "P3wr": MP3wrStream,
}


def run_matrix_protocol(
    name: str,
    rows: np.ndarray,
    sites: np.ndarray,
    m: int,
    eps: float,
    seed: int = 0,
    **kw,
) -> MatrixResult:
    """One-shot wrapper: stream the whole feed through matrix protocol ``name``."""
    rng = np.random.default_rng(seed)
    return MATRIX_PROTOCOLS[name](rows, sites, m, eps, rng, **kw)
