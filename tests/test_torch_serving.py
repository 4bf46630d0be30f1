"""The port's tracker -> publish -> QueryEngine chain against the reference's.

The same rows go through both trackers (P2, one site), each publishes into
its own ``SketchStore``, and both engines serve the same directions.  The
port's ``kernel`` path stands for the reference's ``pallas`` path.  Served
answers are held to 1e-5 of the largest answer (f32 sums in another
order); spectra are compared sign-free (``V^T diag(s^2) V``) at 1e-5.
"""
import jax
import numpy as np
import pytest

from repro.core.tracker import DistributedMatrixTracker as RefTracker
from repro.query import PackedRequest as RefRequest
from repro.query import QueryEngine as RefEngine
from repro.query import SketchStore as RefStore
from repro_torch.core import DistributedMatrixTracker
from repro_torch.query import PackedRequest, QueryEngine, SketchStore

D, BATCH, STEPS = 32, 48, 5
EPS = {"run": 0.5, "other": 0.5, "narrow": 0.8}  # l = 8, 8 and 5


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _dirs(seed: int, n: int) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    """Three tenants tracked and published by both packages."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    ref_store, port_store = RefStore(), SketchStore()
    trackers = {}
    for i, (tenant, eps) in enumerate(EPS.items()):
        rng = np.random.default_rng(i)
        u = rng.normal(size=(STEPS * BATCH, 4)) * np.array([8.0, 6.0, 4.0, 2.0])
        a = (u @ rng.normal(size=(4, D)) + 0.1 * rng.normal(size=(STEPS * BATCH, D)))
        a = a.astype(np.float32)
        ref = RefTracker(mesh, D, eps=eps)
        port = DistributedMatrixTracker(1, D, eps=eps, device="cpu")
        for s in range(STEPS):
            ref.update(a[s * BATCH : (s + 1) * BATCH])
            port.update(a[s * BATCH : (s + 1) * BATCH])
        ref.publish(ref_store, tenant)
        port.publish(port_store, tenant)
        trackers[tenant] = (ref, port)
    return trackers, RefEngine(ref_store), QueryEngine(port_store, device="cpu")


def test_tracker_answers_and_published_snapshot(served):
    trackers, ref_engine, engine = served
    ref, port = trackers["run"]
    x = _dirs(1, 16)
    _close(port.query_batch(x), ref.query_batch(x))
    assert port.query(x[0]) == pytest.approx(ref.query(x[0]), rel=1e-5)
    snap, ref_snap = engine.store.get("run"), ref_engine.store.get("run")
    assert (snap.version, snap.n_seen, snap.eps, snap.delta_sum) == (
        ref_snap.version, ref_snap.n_seen, ref_snap.eps, ref_snap.delta_sum)
    assert snap.error_bound == pytest.approx(ref_snap.error_bound, rel=1e-6)
    assert dict(snap.meta) == dict(ref_snap.meta)
    _close(port.snapshot(k=3).singular_values, ref.snapshot(k=3).singular_values)
    assert np.count_nonzero(np.abs(snap.matrix).sum(1)) >= 2  # rows reached the coordinator


@pytest.mark.parametrize("path,ref_path", [("kernel", "pallas"), ("cached", "cached"),
                                           ("naive", "naive")])
def test_query_batch_paths_match_reference(served, path, ref_path):
    _, ref_engine, engine = served
    x = _dirs(2, 16)
    res = engine.query_batch(x, tenant="run", path=path)
    want = ref_engine.query_batch(x, tenant="run", path=ref_path)
    _close(res.estimates, want.estimates)
    assert (res.path, res.version) == (path, want.version)
    assert res.error_bound == pytest.approx(want.error_bound, rel=1e-6)  # eps * frob


def test_refresh_spectra_and_summaries_match_reference(served):
    _, ref_engine, engine = served
    ref_engine, engine = RefEngine(ref_engine.store), QueryEngine(engine.store, device="cpu")
    snaps = [engine.store.get(t) for t in EPS]
    ref_snaps = [ref_engine.store.get(t) for t in EPS]
    assert engine.refresh_spectra(snaps) == ref_engine.refresh_spectra(ref_snaps) == 3
    assert engine.refresh_spectra(snaps) == 0  # already cached
    for t in EPS:
        s, ref_s = engine.spectrum(t), ref_engine.spectrum(t)
        _close(s.s, ref_s.s)
        _close(np.einsum("l,ld,le->de", s.s**2, s.vt, s.vt),
               np.einsum("l,ld,le->de", ref_s.s**2, ref_s.vt, ref_s.vt))
        assert engine.stable_rank(tenant=t) == pytest.approx(ref_engine.stable_rank(tenant=t),
                                                             rel=1e-5)
        _close(engine.top_directions(2, tenant=t)[1], ref_engine.top_directions(2, tenant=t)[1])
    stats, ref_stats = engine.cache_stats(), ref_engine.cache_stats()
    assert stats.keys() == ref_stats.keys()
    assert stats == ref_stats


def test_query_packed_matches_reference(served):
    _, ref_engine, engine = served
    xs = {"run": _dirs(3, 16), "other": _dirs(4, 9), "narrow": _dirs(5, 12)}
    got = engine.query_packed([PackedRequest(t, x) for t, x in xs.items()])
    want = ref_engine.query_packed([RefRequest(t, x) for t, x in xs.items()])
    for g, w in zip(got, want):
        assert (g.tenant, g.version, g.path) == (w.tenant, w.version, "kernel")
        _close(g.estimates, w.estimates)
    # One launch per shape group, the singleton included; 16 - 9 pad slots.
    assert (engine.packed_launches, engine.packed_pad_slots) == (
        ref_engine.packed_launches, ref_engine.packed_pad_slots) == (2, 7)


def test_other_workloads_and_bad_requests_raise(served):
    _, _, engine = served
    engine.store.publish("hh", np.zeros((2, 2), np.float32), frob=1.0, eps=0.1,
                         meta={"workload": "hh"})
    with pytest.raises(NotImplementedError, match="not ported"):
        engine.query_batch(np.zeros((1, 1), np.float32), tenant="hh")
    with pytest.raises(NotImplementedError, match="not ported"):
        engine.query_packed([PackedRequest("hh", np.zeros((1, 1), np.float32))])
    with pytest.raises(ValueError, match="unknown query path"):
        engine.query_batch(_dirs(6, 2), tenant="run", path="pallas")
    with pytest.raises(ValueError, match="directions must be"):
        engine.query_batch(np.zeros((2, D + 1), np.float32), tenant="run")
