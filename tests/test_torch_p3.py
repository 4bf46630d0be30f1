"""Shard P3 (distributed priority sampling) and ``core/sampling.py`` of the port.

The port draws its own random numbers (a counter-based hash of each site's
key words), not ``jax.random``'s streams, so P3 is held to the reference
two ways:

* deterministically, where the draws can be shared: at one site the test
  recomputes the reference's draws with ``jax.random`` exactly as its
  ``p3_step`` makes them and hands them to the port's ``_p3_absorb``; after
  every step ``tau``, the counters (``n_broadcast`` included) match exactly,
  the buffers, ``p3_matrix`` and ``protocol_frob`` to 1e-6 relative (f32
  row norms summed in another order);
* statistically, on the port's own draws: the reference's own check at
  m = 4 (``tests/test_distributed.py``), ``||A^T A - B^T B||_2 < 2 eps
  ||A||_F^2`` and fewer messages than rows.

Checkpoints cross packages both ways: the random keys are stored as the
reference stores its PRNG keys' raw data (u32 words, tagged
``"prng_key"``), and every leaf restores exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.runtime.registry import create_protocol as ref_create
from repro_torch.core import distributed as tdist
from repro_torch.core.sampling import PrioritySampler, priority_sample
from repro_torch.core.tracker import DistributedMatrixTracker
from repro_torch.query import PackedRequest, QueryEngine, SketchStore
from repro_torch.runtime import create_protocol

D, EPS, S, B = 16, 0.2, 48, 64


def _mesh1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _stream(seed: int, n: int, d: int = D) -> np.ndarray:
    """A rank-5 stream with decaying scales plus noise (tests/test_distributed.py)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 5)) * (np.arange(5, 0, -1) ** 2)[None]
    return (u @ rng.normal(size=(5, d)) + 0.05 * rng.normal(size=(n, d))).astype(np.float32)


# ---------------------------------------------------------------------------
# core/sampling.py: tests/test_sampling.py on the port's functions
# ---------------------------------------------------------------------------


def test_priority_sample_unbiased_subset_sum(rng):
    n, s = 500, 100
    w = torch.tensor(rng.uniform(1.0, 50.0, size=n), dtype=torch.float32)
    total = float(w.sum())
    ests = [float(priority_sample(w, torch.Generator().manual_seed(seed), s).weights.sum())
            for seed in range(60)]
    # E[sum w_bar] = W (Duffield--Lund--Thorup); 60 trials, generous CI
    assert abs(np.mean(ests) - total) / total < 0.05, (np.mean(ests), total)


def test_priority_sample_large_weights_deterministic():
    n, s = 200, 50
    w = torch.ones(n)
    w[:5] = 1e6  # heavy items must always be kept
    ps = priority_sample(w, torch.Generator().manual_seed(1), s)
    assert set(range(5)) <= set(ps.indices.tolist())
    assert ps.weights.shape == (s,) and float(ps.tau) > 0


def test_streaming_sampler_matches_oneshot_estimates(rng):
    n, s = 2000, 200
    w = rng.uniform(1.0, 20.0, size=n)
    sampler = PrioritySampler(s, np.random.default_rng(7))
    for i in range(n):
        sampler.update(i, float(w[i]))
    items, ww = sampler.sample()
    assert len(items) == s
    assert abs(ww.sum() - w.sum()) / w.sum() < 0.2
    one = priority_sample(torch.tensor(w, dtype=torch.float32), torch.Generator().manual_seed(7), s)
    assert abs(float(one.weights.sum()) - w.sum()) / w.sum() < 0.2


# ---------------------------------------------------------------------------
# shard P3
# ---------------------------------------------------------------------------


def _ref_draws(key) -> np.ndarray:
    """The draws the reference's ``p3_step`` makes at site 0 from the site's
    key (src/repro/core/distributed.py:311-318)."""
    _, sub = jax.random.split(jax.random.fold_in(key, 0))
    return np.asarray(jax.random.uniform(sub, (B,), minval=jnp.finfo(jnp.float32).tiny,
                                         maxval=1.0))


def _assert_state_matches(port: tdist.P3State, ref) -> None:
    assert float(port.tau) == float(ref.tau)
    for f in port.comm._fields:
        assert int(getattr(port.comm, f)) == int(getattr(ref.comm, f)), f
    for name in ("buf_rho", "buf_w"):
        want = np.asarray(getattr(ref, name), np.float64)
        np.testing.assert_allclose(getattr(port, name).numpy().astype(np.float64), want,
                                   rtol=1e-6, atol=1e-6 * np.abs(want).max())
    want = np.asarray(jdist.p3_matrix(ref), np.float64)
    np.testing.assert_allclose(tdist.p3_matrix(port).numpy().astype(np.float64), want,
                               rtol=1e-6, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(tdist.protocol_frob("P3", port),
                               jdist.protocol_frob("P3", ref), rtol=1e-6)


def test_p3_absorb_fed_the_reference_draws_matches_at_one_site():
    """Six steps of 64 rows at s = 48: the buffer fills, overflows and
    doubles tau (the test fails unless it does)."""
    a = _stream(0, 6 * B)
    ref = ref_create("P3", engine="shard", mesh=_mesh1(), d=D, eps=EPS, axis="data", s=S)
    cfg = tdist.ProtocolConfig(eps=EPS, m=1, d=D, s=S).resolved()
    port = tdist.p3_init(cfg, "cpu")
    for t in range(6):
        rows = a[t * B:(t + 1) * B]
        u = _ref_draws(ref.state.rng[0])
        ref.step(jnp.asarray(rows))
        port = tdist._p3_absorb(cfg, port, torch.tensor(rows), torch.tensor(u)[None])
        _assert_state_matches(port, ref.state)
    assert int(port.comm.broadcast_events) > 0  # tau doubled at least once
    assert int((port.buf_rho > 0).sum()) == S + 1


def test_p3_port_alone_at_four_sites_meets_the_reference_check():
    """tests/test_distributed.py's configuration and check, at m = 4 on the
    port's own draws; the step is a pure function of (state, rows)."""
    m, d, eps = 4, 24, 0.2
    rng = np.random.default_rng(0)
    n = 4096
    u = rng.normal(size=(n, 5)) * (np.arange(5, 0, -1) ** 2)[None]
    a = (u @ rng.normal(size=(5, d)) + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
    cfg = tdist.ProtocolConfig(eps=eps, m=m, d=d, l_site=20, l_coord=40, s=48)
    state, step = tdist.make_protocol_runner("P3", cfg, "cpu")
    batch = 64
    for t in range(n // (m * batch)):
        rows = torch.tensor(a[t * m * batch:(t + 1) * m * batch])
        nxt = step(state, rows)
        if t == 3:  # the same state and rows give the same next state
            again = step(state, rows)
            flat = lambda st: [*st[:5], *st.comm]  # noqa: E731
            assert all(torch.equal(x, y) for x, y in zip(flat(nxt), flat(again)))
            assert not torch.equal(nxt.rng, state.rng)
        state = nxt
    bm = tdist.p3_matrix(state).numpy().astype(np.float64)
    err = np.linalg.norm(a.T.astype(np.float64) @ a - bm.T @ bm, 2) / float(np.sum(a * a))
    assert err < 2 * eps, err
    c = state.comm
    assert int(c.row_msgs) > 0
    assert int(c.scalar_msgs) + int(c.row_msgs) + int(c.broadcast_events) * m < n


def test_p3_snapshot_serves_beside_p2_snapshots_of_another_l():
    """A published P3 sample (s + 1 rows) rides ``query_packed`` beside two
    P2 sketches of another L: each answer equals the tenant's own
    ``query_batch`` (the engine packs equal shapes only, as the reference's)."""
    m, a = 2, _stream(2, 4 * 2 * B)
    store = SketchStore()
    trackers = {name: DistributedMatrixTracker(m, D, eps=EPS, protocol=proto, device="cpu")
                for name, proto in (("p3", "P3"), ("p2a", "P2"), ("p2b", "P2"))}
    for t in range(4):
        for tracker in trackers.values():
            tracker.update(a[t * 2 * B:(t + 1) * 2 * B])
    for name, tracker in trackers.items():
        tracker.publish(store, name)
    assert store.get("p3").matrix.shape[0] != store.get("p2a").matrix.shape[0]
    engine = QueryEngine(store, device="cpu")
    x = np.random.default_rng(3).normal(size=(5, D)).astype(np.float32)
    packed = engine.query_packed([PackedRequest(name, x) for name in trackers])
    for res, name in zip(packed, trackers):
        np.testing.assert_array_equal(res.estimates, engine.query_batch(x, tenant=name).estimates)
    np.testing.assert_allclose(packed[0].estimates, trackers["p3"].query_batch(x), rtol=1e-6)


def test_p3_checkpoints_cross_packages_both_ways():
    a = _stream(1, 4 * B)
    ref = ref_create("P3", engine="shard", mesh=_mesh1(), d=D, eps=EPS, axis="data", s=S)
    for t in range(2):
        ref.step(jnp.asarray(a[t * B:(t + 1) * B]))
    arrays, meta = ref.state_payload()
    assert meta["leaves"][0] == "prng_key"
    port = create_protocol("P3", engine="shard", m=1, d=D, eps=EPS, s=S, device="cpu")
    port.restore_payload(arrays, meta)
    got, got_meta = port.state_payload()
    assert got_meta == meta
    for k in arrays:
        assert got[k].dtype == np.asarray(arrays[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(arrays[k]), err_msg=k)

    # The other way: the port's own steps, restored into the reference.
    for t in range(2, 4):
        port.step(a[t * B:(t + 1) * B])
    arrays, meta = port.state_payload()
    ref2 = ref_create("P3", engine="shard", mesh=_mesh1(), d=D, eps=EPS, axis="data", s=S)
    ref2.restore_payload(arrays, meta)
    back, back_meta = ref2.state_payload()
    assert back_meta == meta
    for k in arrays:
        np.testing.assert_array_equal(np.asarray(back[k]), arrays[k], err_msg=k)
    assert port.comm_report().as_dict() == ref2.comm_report().as_dict()
    np.testing.assert_allclose(port.frob_estimate(), ref2.frob_estimate(), rtol=1e-6)
    other = create_protocol("P2", engine="shard", m=1, d=D, eps=EPS, device="cpu")
    with pytest.raises(ValueError, match="tagged"):
        other.restore_payload(arrays, meta)
