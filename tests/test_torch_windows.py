"""The port's windowed and decayed tenants against the reference, on the CPU.

``core/windows.py`` and ``runtime/windowed.py`` of both packages take the
same timed batches — out of order within the lateness, and one batch later
than it — and serve the same answers.  Held exactly: the ``CommReport``,
``windows_closed``, ``late_rows``, ``late_batches``, ``epoch``, the
Misra--Gries estimates and the windowed quantile tables (the same f32
operations in the same order; integer weights keep every f32 prefix sum
exact).  The decayed quantile tables hold their values exactly and their
ranks to 1e-6 of the mass: decayed weights are not integers, and the f32
prefix sums run in torch's order, not XLA's.  Held to 1e-5 of
the in-state mass: the matrix ``B^T B`` and ``||B x||^2`` (eigenvectors may
differ in sign), and the leverage table (its scores and weights, and the
weighted Gram of its rows: the residual's rows are eigenvectors too).

Sizes are tiny and batch sizes fixed (d = 8, eps = 0.25, 8 rows a batch,
window 4 in 4 buckets, lateness 1).  The reference's ``WindowOps`` run
eagerly, one compile an op; here each of its functions runs under one jit,
shared by every case of a kind, so it compiles once a shape.
"""
import jax
import numpy as np
import pytest

from repro.core.windows import LateRowError as RefLateRowError
from repro.runtime.pipeline import StreamingPipeline as RefPipeline
from repro.runtime.policies import OnWindowClose as RefOnWindowClose
from repro.runtime.registry import create_protocol as ref_create
from repro_torch.core.windows import LateRowError, TimedRows
from repro_torch.runtime import OnWindowClose, StreamingPipeline, create_protocol

D, EPS, B, M = 8, 0.25, 8, 2
GEOMETRY = {"win": dict(window=4.0, buckets=4, lateness=1.0),
            "decay": dict(half_life=3.0, lateness=1.0)}
# Event times in arrival order: 3 before 2 and 7 before 6 (within the
# lateness), and a batch at 2 after 9 (watermark 8: late, shed).
ARRIVALS = [0.0, 1.0, 3.0, 2.0, 4.0, 5.0, 7.0, 6.0, 8.0, 9.0]
LATE_TS = 2.0


def _mesh1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _batch(kind: str, rng, n: int = B) -> np.ndarray:
    if kind in ("matrix", "leverage"):
        return rng.normal(size=(n, D)).astype(np.float32)
    if kind == "hh":  # ids 0..11, weights in quarters: ties, exact f32 sums
        return np.stack([rng.integers(0, 12, n), rng.integers(1, 8, n) / 4.0], 1)
    return np.stack([np.round(rng.normal(size=n) * 20.0) / 4.0, rng.integers(1, 4, n)], 1)


_JITTED: dict = {}


def _jit_ops(ref):
    """Run the reference protocol's ``WindowOps`` under one jit a function,
    shared by every case of its kind (the same closures' arithmetic)."""
    ops = _JITTED.setdefault(ref.kind, ref._ops._replace(
        insert=jax.jit(ref._ops.insert), merge=jax.jit(ref._ops.merge),
        scale=jax.jit(ref._ops.scale)))
    ref._ops = ref._tracked.ops = ops
    return ref


def _pair(kind: str, mode: str, engine: str):
    name = ("P2" if kind == "matrix" else "P1") + mode
    kw = dict(eps=EPS, **GEOMETRY[mode])
    if kind in ("matrix", "leverage"):
        kw["d"] = D
    if engine == "shard":  # a one-device mesh: m = 1, with 2 software sites
        ref = ref_create(name, engine="shard", kind=kind, mesh=_mesh1(), sites=2, **kw)
        port = create_protocol(name, engine="shard", kind=kind, m=1, sites=2, device="cpu", **kw)
    else:
        ref = ref_create(name, engine="event", kind=kind, m=M, **kw)
        port = create_protocol(name, engine="event", kind=kind, m=M, device="cpu", **kw)
    return _jit_ops(ref), port


def _feed(kind: str, protos, n: int = B) -> None:
    rng = np.random.default_rng(0)
    batches = [_batch(kind, rng, n) for _ in ARRIVALS]
    late = _batch(kind, rng, n)
    for ts, batch in zip(ARRIVALS, batches):
        for p in protos:
            p.step(batch, ts=ts)
    for p, err in zip(protos, (RefLateRowError, LateRowError)):
        with pytest.raises(err):
            p.step(late, ts=LATE_TS)


def _mass(kind: str, proto) -> float:
    return max(float(proto.total_weight()), 1e-12)


def _assert_answers(kind: str, ref, port, mode: str = "win") -> None:
    mass = _mass(kind, ref)
    if kind == "matrix":
        b, rb = port.matrix().astype(np.float64), ref.matrix().astype(np.float64)
        np.testing.assert_allclose(b.T @ b, rb.T @ rb, rtol=0, atol=1e-5 * mass)
        x = np.random.default_rng(9).normal(size=(16, D)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        np.testing.assert_allclose(port.query_batch(x), np.asarray(ref.query_batch(x)),
                                   rtol=0, atol=1e-5 * mass)
        np.testing.assert_allclose(port.frob_estimate(), ref.frob_estimate(), rtol=1e-6)
    elif kind == "hh":
        assert port.estimates() == ref.estimates()
        assert port.total_weight() == ref.total_weight()
    elif kind == "quantile":
        got, want = port.table(), ref.table()
        if mode == "win":  # integer weights: every f32 prefix sum is exact
            np.testing.assert_array_equal(got, want)
            assert port.total_weight() == ref.total_weight()
        else:  # decayed weights: f32 prefix sums in torch's order, not XLA's
            np.testing.assert_array_equal(got[:, 0], want[:, 0])
            np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0, atol=1e-6 * mass)
            np.testing.assert_allclose(port.total_weight(), ref.total_weight(), rtol=1e-6)
    else:
        got, want = port.sampled_rows().astype(np.float64), ref.sampled_rows().astype(np.float64)
        assert got.shape == want.shape
        np.testing.assert_allclose(got[:, D:], want[:, D:], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[:, D:]).max())
        gram = lambda t: (t[:, :D] * t[:, D + 1:]).T @ t[:, :D]  # noqa: E731
        np.testing.assert_allclose(gram(got), gram(want), rtol=0, atol=1e-5 * mass)
        np.testing.assert_allclose(port.total_weight(), ref.total_weight(), rtol=1e-6)
        np.testing.assert_allclose(port.lam(), ref.lam(), rtol=1e-6)


CASES = [(k, mode, "event") for k in ("matrix", "hh", "quantile", "leverage")
         for mode in ("win", "decay")] + [(k, "win", "shard")
                                           for k in ("matrix", "hh", "quantile", "leverage")]


@pytest.mark.parametrize("kind,mode,engine", CASES)
def test_windowed_protocol_matches_reference(kind, mode, engine):
    ref, port = _pair(kind, mode, engine)
    # The shard flavour's 2 software sites take B rows each: the inserts'
    # shapes are the event engine's.
    _feed(kind, (ref, port), 2 * B if engine == "shard" else B)
    _assert_answers(kind, ref, port, mode)
    assert port.comm_report().as_dict() == ref.comm_report().as_dict()
    for attr in ("late_rows", "late_batches"):
        assert getattr(port, attr) == getattr(ref, attr) > 0
    assert port.windows_closed() == ref.windows_closed()
    assert port._tracked.epoch == ref._tracked.epoch
    assert port.watermark() == ref.watermark() and port.window_lag() == ref.window_lag()
    if mode == "win":
        assert port.windows_closed() > 0
        assert port._tracked.live_states() == ref._tracked.live_states()
    # The checkpoint payloads: the same leaves, and each package restores
    # the other's and serves the same answers.
    arrays, meta = port.state_payload()
    ref_arrays, ref_meta = ref.state_payload()
    assert meta == ref_meta and sorted(arrays) == sorted(ref_arrays)
    for k in arrays:
        assert arrays[k].shape == np.shape(ref_arrays[k]), k
        assert arrays[k].dtype == np.asarray(ref_arrays[k]).dtype, k
    ref2, port2 = _pair(kind, mode, engine)
    port2.restore_payload(ref_arrays, ref_meta)
    ref2.restore_payload(arrays, meta)
    _assert_answers(kind, ref, port2, mode)
    _assert_answers(kind, ref2, port, mode)


def _pipe_batches(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    return [(float(t), _batch(kind, rng)) for t in range(12)]


def test_pipeline_on_window_close_publishes_at_the_reference_edges():
    """``OnWindowClose`` publishes at the same steps, with the same
    watermark stamps and ``windows_closed``, and the served answers agree."""
    ref = RefPipeline(_mesh1(), eps=EPS)
    port = StreamingPipeline(1, eps=EPS, device="cpu")
    kw = dict(kind="matrix", d=D, window=8.0, buckets=4, lateness=1.0)
    _jit_ops(ref.add_windowed_tenant("w", policy=RefOnWindowClose(), **kw))
    port.add_windowed_tenant("w", policy=OnWindowClose(), **kw)
    edges = {id(p): [] for p in (ref, port)}
    for ts, batch in _pipe_batches("matrix", 3):
        for p in (ref, port):
            snap = p.ingest("w", TimedRows(batch, ts) if p is port else batch,
                            ts=None if p is port else ts)
            if snap is not None:
                edges[id(p)].append((ts, snap.published_at, snap.meta["windows_closed"],
                                     snap.meta["workload"], snap.version))
    assert edges[id(port)] == edges[id(ref)] and len(edges[id(port)]) > 1
    assert port.stats("w").publishes == port.tracker("w").windows_closed()
    x = np.ones((1, D), np.float32) / np.sqrt(D)
    mass = ref.tracker("w").frob_estimate()
    np.testing.assert_allclose(port.engine.query_batch(x, tenant="w").estimates,
                               ref.engine.query_batch(x, tenant="w").estimates,
                               rtol=0, atol=1e-5 * mass)
    for p in (ref, port):
        p.close()


def test_pipeline_windowed_checkpoints_cross_packages(tmp_path):
    """A windowed matrix tenant and a windowed HH tenant (shard flavour, 2
    software sites): each package loads the other's ``save``, with the same
    leaves, the same late-row counter, and the same answers after one more
    batch."""
    ref = RefPipeline(_mesh1(), eps=EPS)
    port = StreamingPipeline(1, eps=EPS, device="cpu")
    for p in (ref, port):
        p.add_windowed_tenant("mat", kind="matrix", d=D, window=8.0, buckets=4, lateness=1.0,
                              policy=RefOnWindowClose() if p is ref else OnWindowClose())
        p.add_windowed_tenant("hh", kind="hh", engine="shard", sites=2, window=8.0, buckets=4,
                              lateness=1.0,
                              policy=RefOnWindowClose() if p is ref else OnWindowClose())
    _jit_ops(ref.tracker("mat")), _jit_ops(ref.tracker("hh"))
    mats, hhs = _pipe_batches("matrix", 4), _pipe_batches("hh", 5)
    for p in (ref, port):
        p.ingest_many([(name, batch, ts) for (ts, a), (_, h) in zip(mats[:8], hhs[:8])
                       for name, batch in (("mat", a), ("hh", h))]
                      + [("hh", hhs[8][1], 1.0)])  # late: shed into late_rows
        assert p.stats()["late_rows"] == B
    ref.save(str(tmp_path / "ref"))
    port.save(str(tmp_path / "port"))
    from_ref = StreamingPipeline.load(str(tmp_path / "ref"), 1, device="cpu")
    from_port = RefPipeline.load(str(tmp_path / "port"), _mesh1())
    _jit_ops(from_port.tracker("mat")), _jit_ops(from_port.tracker("hh"))
    for name in ("mat", "hh"):
        want, want_meta = ref._tenants[name].adapter.state_payload()
        for p in (port, from_ref, from_port):
            got, got_meta = p._tenants[name].adapter.state_payload()
            assert got_meta == want_meta and sorted(got) == sorted(want)
            if name == "hh":
                for k in want:
                    np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    for p in (ref, port, from_ref, from_port):
        for name, (ts, batch) in (("mat", mats[9]), ("hh", hhs[9])):
            p.ingest(name, batch, ts=ts)
            p.publish(name)
    x = np.ones((1, D), np.float32) / np.sqrt(D)
    mass = ref.tracker("mat").frob_estimate()
    want_mat = ref.engine.query_batch(x, tenant="mat").estimates
    want_hh = ref.tracker("hh").estimates()
    for p in (port, from_ref, from_port):
        np.testing.assert_allclose(p.engine.query_batch(x, tenant="mat").estimates, want_mat,
                                   rtol=0, atol=1e-5 * mass)
        assert p.tracker("hh").estimates() == want_hh
        assert p.tracker("hh").comm_report().as_dict() == ref.tracker("hh").comm_report().as_dict()
    for p in (ref, port, from_ref, from_port):
        p.close()
