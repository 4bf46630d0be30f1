"""The port's leverage kind against the reference, on the CPU.

Held to the reference on the same numpy inputs: the ``levscore`` kernel's
plain version (1e-5, against ``repro.kernels.ref`` and interpreted Pallas),
the reservoir merge (exactly), the super-step engine ``lev_p1_step`` at
m = 1 against a one-device mesh (``CommReport`` exactly; ``f_hat``,
``f_res`` and theta to 1e-6 relative, f32 sums in another order; subspace
and score answers to 1e-5 of the largest), the event streams (tables
equal: the same numpy code), every registered leverage spec through the
reference's registry harness, the serving engine's leverage lookups and
cross-kind packed sweeps, the leverage state payload across packages,
and ``StreamingPipeline`` with matrix and
leverage tenants against the reference's pipeline (versions, counters and
``CommReport``s equal; served answers to 1e-5).  The m = 4 case runs in
the four-device subprocess of ``test_torch_protocols.py``.

Threshold decisions (forwarding at ``score >= theta``, sketch ships at
``f_i >= eps/2m f_hat``, rebroadcasts) could flip for a value within f32
noise of its threshold; the exact ``CommReport`` equality checks that none
did on these inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import leverage as jlev
from repro.core.leverage import score_query as ref_score_query
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.query import PackedRequest as JRequest
from repro.query import QueryEngine as JEngine
from repro.query import SketchStore as JStore
from repro.runtime import EveryKSteps as RefEveryKSteps
from repro.runtime import StreamingPipeline as RefPipeline
from repro.runtime.registry import create_protocol as ref_create
from repro_torch.core import leverage as tlev
from repro_torch.core.leverage import score_query, subspace_query
from repro_torch.kernels import ops
from repro_torch.query import PackedRequest, QueryEngine, SketchStore
from repro_torch.runtime import EveryKSteps, StreamingPipeline, create_protocol, specs

D, EPS, B = 16, 0.2, 96


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def spiky_stream(seed: int, steps: int, m: int = 1, d: int = D) -> list[np.ndarray]:
    """Super-steps of (m * B, d) rows: a rank-3 stream plus noise, with 8
    rows a site in fresh random directions whose norm grows 1.6x a step —
    novel rows that cross theta, fill the reservoir and make it spill."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        rows = rng.normal(size=(m * B, 3)) @ rng.normal(size=(3, d)) * 0.5
        rows += 0.05 * rng.normal(size=(m * B, d))
        spikes = rng.choice(m * B, size=m * 8, replace=False)
        rows[spikes] += rng.normal(size=(m * 8, d)) * (3.0 * 1.6**s)
        out.append(rows.astype(np.float32))
    return out


def _unit(n: int, d: int = D, seed: int = 99) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _mesh1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


# ---------------------------------------------------------------------------
# kernel: the plain version against the reference oracle and Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,n", [(40, 37), (130, 257)])
def test_plain_levscore_matches_reference_and_pallas(d, n):
    """Ragged N and d, and a non-symmetric M: ``x M x`` is contracted with
    ``M[k, i]`` exactly as the reference does."""
    rng = np.random.default_rng(d + n)
    m = (rng.normal(size=(d, d)) + 0.5 * np.eye(d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    got = ops.levscore(torch.tensor(m), torch.tensor(x))
    _close(got, jref.ref_levscore(jnp.asarray(m), jnp.asarray(x)))
    _close(got, jops.levscore(jnp.asarray(m), jnp.asarray(x), path="pallas", interpret=True))
    _close(got, tlev.ridge_scores(m, x))
    assert ops.levscore(torch.tensor(m), torch.zeros(0, d)).shape == (0,)
    with pytest.raises(ValueError, match="square"):
        ops.levscore(torch.zeros(d, d + 1), torch.tensor(x))
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.levscore(torch.tensor(m), torch.zeros(2, d + 1))


# ---------------------------------------------------------------------------
# reservoir: the stable top-cap merge against lax.top_k
# ---------------------------------------------------------------------------


def test_lev_merge_spill_matches_reference_with_ties_and_pads():
    """Tied scores (the incumbent wins, then the lower index), zero-score
    candidates carrying payload, and an all-pad merge: bit-equal."""
    rng = np.random.default_rng(4)
    cap, d = 6, 5
    batches = [  # one length, so the reference's ops compile once
        ([5.0, 3.0, 9.0, 0.0, 7.0, 0.0], [1.0] * 6),
        ([7.0, 7.0, 3.0, 0.0, 9.0, 5.0], [2.0, 1.0, 1.0, 3.0, 1.0, 1.0]),
        ([3.0, 3.0, 3.0, 7.0, 0.0, 3.0], [1.0, 0.5, 1.0, 1.0, 4.0, 2.0]),
        ([0.0] * 6, [1.0] * 6),  # all pad, with non-zero payload rows
    ]
    jst, tst = jlev.lev_init(cap, d), tlev.lev_init(cap, d, device="cpu")
    for scores, weights in batches:
        rows = rng.normal(size=(len(scores), d)).astype(np.float32)
        s, w = np.array(scores, np.float32), np.array(weights, np.float32)
        jst, jspill = jlev.lev_merge_spill(jst, jnp.asarray(rows), jnp.asarray(s), jnp.asarray(w))
        tst, tspill = tlev.lev_merge_spill(tst, torch.tensor(rows), torch.tensor(s),
                                           torch.tensor(w))
        for a, b in zip(tst, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(tspill.numpy(), np.asarray(jspill))
    same = tlev.lev_merge(tst, tlev.lev_init(cap, d, device="cpu"))
    for a, b in zip(same, tst):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# super-step engine: lev_p1_step at m = 1 against a one-device mesh
# ---------------------------------------------------------------------------


def test_lev_p1_step_matches_one_device_mesh():
    ref = ref_create("P1", engine="shard", kind="leverage", mesh=_mesh1(), d=D, eps=EPS)
    port = create_protocol("P1", engine="shard", kind="leverage", m=1, d=D, eps=EPS,
                           device="cpu")
    thetas = set()
    for rows in spiky_stream(0, 7):
        ref.step(rows)
        port.step(rows)
        assert port.comm_report().as_dict() == ref.comm_report().as_dict()
        for field in ("f_hat", "f_res", "theta"):
            np.testing.assert_allclose(float(getattr(port.state, field)),
                                       float(getattr(ref.state, field)), rtol=1e-6)
        thetas.add(float(ref.state.theta))
    assert len(thetas) > 1, "the stream must overflow the reservoir at least once"
    assert port.rows_seen == ref.rows_seen
    np.testing.assert_array_equal(port.state.res.scores.numpy() > 0,
                                  np.asarray(ref.state.res.scores) > 0)
    x = _unit(24)
    _close(port.subspace_query_batch(x), ref.subspace_query_batch(x))
    _close(port.score_batch(x), ref.score_batch(x))
    np.testing.assert_allclose(port.total_weight(), ref.total_weight(), rtol=1e-6)
    np.testing.assert_allclose(port.lam(), ref.lam(), rtol=1e-6)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_leverage_state_payload_carries_across_packages(direction):
    """The cross-package payload path of ``test_torch_protocols.py`` on the
    leverage state: a payload (19 leaves in the reference's order) taken
    after three steps restores in the other package; one more step on the
    same rows gives the same comm report and subspace answers."""
    batches, x = spiky_stream(9, 4), _unit(24)
    ref = ref_create("P1", engine="shard", kind="leverage", mesh=_mesh1(), d=D, eps=EPS)
    port = create_protocol("P1", engine="shard", kind="leverage", m=1, d=D, eps=EPS,
                           device="cpu")
    src, dst = (ref, port) if direction == "reference_to_port" else (port, ref)
    for rows in batches[:3]:
        src.step(rows)
    arrays, meta = src.state_payload()
    assert sorted(arrays) == [f"leaf_{i:03d}" for i in range(19)]
    dst.restore_payload(arrays, meta)
    ref.step(batches[3])
    port.step(batches[3])
    assert port.rows_seen == ref.rows_seen == 4 * B
    assert port.comm_report().as_dict() == ref.comm_report().as_dict()
    _close(port.subspace_query_batch(x), ref.subspace_query_batch(x))
    np.testing.assert_allclose(port.total_weight(), ref.total_weight(), rtol=1e-6)


# ---------------------------------------------------------------------------
# event streams: the same numpy code, so the same tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["P1", "P2"])
def test_event_streams_match_reference(name):
    rows = np.concatenate(spiky_stream(1, 4, m=2))
    sites = np.random.default_rng(3).integers(0, 2, rows.shape[0])
    want = jlev.run_leverage_protocol(name, rows, sites, 2, EPS, seed=5)
    got = tlev.run_leverage_protocol(name, rows, sites, 2, EPS, seed=5)
    np.testing.assert_array_equal(got.table, want.table)
    assert (got.f_hat, got.lam) == (want.f_hat, want.lam)
    assert got.comm.report(2).as_dict() == want.comm.report(2).as_dict()


# ---------------------------------------------------------------------------
# registry: the reference's harness over the port's leverage specs
# ---------------------------------------------------------------------------

L_N, L_M = 12_000, 4


@pytest.fixture(scope="module")
def lev_stream():
    from repro.data.synthetic import lowrank_stream

    a = lowrank_stream(L_N, D, rank=3, seed=11)
    rng = np.random.default_rng(12)
    return a, rng.integers(0, L_M, L_N), _unit(24, seed=13)


def _make_leverage(spec):
    kw = dict(kind="leverage", engine=spec.engine, m=L_M, eps=EPS, d=D, device="cpu")
    return create_protocol(spec.name, **kw, **({"seed": 5} if spec.engine == "event" else {}))


@pytest.mark.parametrize("spec", specs(kind="leverage"), ids=lambda s: f"{s.engine}-{s.name}")
def test_registry_leverage_harness(spec, lev_stream):
    """Each registered leverage pair (tests/test_leverage.py's harness):
    the subspace envelope, comm below naive forwarding, the mass estimate,
    the shared table path, scores against the f64 oracle, and the
    checkpoint payload continuing the stream identically."""
    a, sites, xs = lev_stream
    frob = float(np.sum(a.astype(np.float64) ** 2))
    proto = _make_leverage(spec)
    step = 4_000
    for i in range(0, L_N, step):
        proto.step(a[i : i + step], sites[i : i + step] if spec.engine == "event" else None)
    assert proto.rows_seen == L_N

    true = np.sum((a.astype(np.float64) @ xs.T) ** 2, axis=0)
    est = proto.subspace_query_batch(xs)
    assert np.max(np.abs(est - true)) <= spec.err_factor * EPS * frob * (1 + 1e-5)
    assert proto.subspace_query(xs[0]) == pytest.approx(float(est[0]), rel=1e-6)
    assert 0.5 * frob <= proto.total_weight() <= 2.0 * frob
    rep = proto.comm_report()
    assert 0 < rep.total < L_N
    np.testing.assert_allclose(est, tlev.table_subspace(proto.sampled_rows(), xs),
                               rtol=1e-4, atol=1e-2)
    sc = proto.score_batch(xs)
    np.testing.assert_allclose(sc, tlev.table_scores(proto.sampled_rows(), xs, proto.lam()),
                               rtol=1e-3, atol=1e-5)
    assert np.all(sc >= -1e-6) and np.all(np.isfinite(sc))
    enc = proto.snapshot_matrix()
    assert enc.dtype == np.float32 and enc.shape[1] == D + 2

    arrays, meta = proto.state_payload()
    clone = _make_leverage(spec)
    clone.restore_payload({k: np.asarray(v) for k, v in arrays.items()}, meta)
    tail = a[:2_000]
    for p in (proto, clone):
        p.step(tail, sites[:2_000] if spec.engine == "event" else None)
    np.testing.assert_array_equal(proto.sampled_rows(), clone.sampled_rows())
    assert proto.total_weight() == clone.total_weight()
    assert proto.comm_report() == clone.comm_report()


# ---------------------------------------------------------------------------
# serving: leverage lookups and cross-kind packed sweeps vs the reference
# ---------------------------------------------------------------------------


def test_engine_serves_leverage_like_reference():
    """The same published snapshots in both stores: mixed subspace/score
    batches, ``query_packed`` over two matrix tenants and a leverage tenant,
    the factor cache, and the refusals."""
    lev_proto = create_protocol("P1", engine="shard", kind="leverage", m=2, d=D, eps=EPS,
                                device="cpu")
    for rows in spiky_stream(2, 3, m=2):
        lev_proto.step(rows)
    table, lam = lev_proto.snapshot_matrix(), lev_proto.lam()
    rng = np.random.default_rng(8)
    sketches = [rng.normal(size=(6, D)).astype(np.float32) for _ in range(2)]
    stores = (SketchStore(), JStore())
    for store in stores:
        store.publish("lev", table, frob=lev_proto.total_weight(), eps=EPS,
                      meta={"workload": "leverage", "lam": lam, "d": D})
        for i, b in enumerate(sketches):
            store.publish(f"mat{i}", b, frob=float((b * b).sum()), eps=EPS)
    port, ref = QueryEngine(stores[0], device="cpu"), JEngine(stores[1])

    x = _unit(10)
    modes = np.array([0, 1, 1, 0, 1, 0, 0, 1, 0, 1], np.float32)
    q = np.concatenate([modes[:, None], x], axis=1)
    for _ in range(2):  # the second sweep reads the factor cache
        got, want = port.query_batch(q, tenant="lev"), ref.query_batch(q, tenant="lev")
        assert (got.path, got.version, got.error_bound) == ("leverage", want.version,
                                                             want.error_bound)
        _close(got.estimates, want.estimates)
    assert port.cache_stats()["factor"] == {"hits": 1, "misses": 1, "evictions": 0}

    reqs = [("mat0", x[:4]), ("lev", q[:7]), ("mat1", x[:9])]
    got = port.query_packed([PackedRequest(t, v) for t, v in reqs])
    want = ref.query_packed([JRequest(t, v) for t, v in reqs])
    for g, w in zip(got, want):
        assert (g.tenant, g.version) == (w.tenant, w.version)
        assert g.path == {"pallas": "kernel"}.get(w.path, w.path)
        _close(g.estimates, w.estimates)
    assert (port.packed_launches, port.packed_pad_slots) == (
        ref.packed_launches, ref.packed_pad_slots)

    with pytest.raises(ValueError, match="leverage queries must be"):
        port.query_batch(x, tenant="lev")
    with pytest.raises(ValueError, match="query mode"):
        port.query_batch(np.concatenate([np.full((1, 1), 2.0, np.float32), x[:1]], 1),
                         tenant="lev")


# ---------------------------------------------------------------------------
# pipeline: matrix and leverage tenants against the reference's pipeline
# ---------------------------------------------------------------------------


def _tenants(pipe):
    pipe.add_tenant("mat", D)
    pipe.add_leverage_tenant("lev", D, engine="shard")
    pipe.add_leverage_tenant("lev-ev", D, engine="event", seed=3)


def test_pipeline_matches_reference_pipeline():
    """One matrix tenant (super-step P2) and two leverage tenants (super-step
    and event-driven P1) ingest the same batches in both pipelines, then
    serve the same submitted queries through their packed services."""
    ref = RefPipeline(_mesh1(), eps=EPS, policy=RefEveryKSteps(2))
    port = StreamingPipeline(1, eps=EPS, policy=EveryKSteps(2), device="cpu")
    _tenants(ref)
    _tenants(port)
    for rows in spiky_stream(5, 5):
        for tenant in ("mat", "lev", "lev-ev"):
            want, got = ref.ingest(tenant, rows), port.ingest(tenant, rows)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.version == want.version
    port.publish("lev")
    ref.publish("lev")

    x = np.random.default_rng(6).normal(size=(6, D)).astype(np.float32)
    queries = [("mat", v) for v in x] + [
        (t, (subspace_query if i % 2 else score_query)(v))
        for t in ("lev", "lev-ev") for i, v in enumerate(x)
    ]
    assert np.array_equal(score_query(x[0]), ref_score_query(x[0]))
    got = [port.submit(t, q) for t, q in queries]
    want = [ref.submit(t, q) for t, q in queries]
    assert port.flush() == ref.flush() == len(queries)
    for tenant in ("mat", "lev", "lev-ev"):
        idx = [i for i, (t, _) in enumerate(queries) if t == tenant]
        g = np.array([got[i].result() for i in idx], np.float64)
        w = np.array([want[i].result() for i in idx], np.float64)
        np.testing.assert_array_equal(g[:, 2], w[:, 2])  # versions
        for col in (0, 1):  # estimates, error bounds
            np.testing.assert_allclose(g[:, col], w[:, col], rtol=1e-5,
                                       atol=1e-5 * np.abs(w[:, col]).max())
        gs, ws = port.stats(tenant), ref.stats(tenant)
        assert (gs.steps, gs.rows, gs.publishes, gs.latest_version, gs.workload) == (
            ws.steps, ws.rows, ws.publishes, ws.latest_version, ws.workload)
        assert (port.tracker(tenant).comm_report().as_dict()
                == ref.tracker(tenant).comm_report().as_dict())
    for rows_p, rows_r in zip(port.sampled_rows("lev"), ref.sampled_rows("lev")):
        assert rows_p.shape == rows_r.shape
    assert port.stats()["rows"] == ref.stats()["rows"]


def test_pipeline_refuses_what_is_not_ported():
    pipe = StreamingPipeline(2, eps=EPS, device="cpu")
    pipe.add_leverage_tenant("lev", D, engine="shard")
    with pytest.raises(ValueError, match="full-stream"):
        pipe.ingest("lev", np.zeros((4, D), np.float32), ts=1.0)
    with pytest.raises(KeyError, match="no published snapshot"):
        pipe.submit("lev", subspace_query(np.ones(D)))
    pipe.publish("lev")
    with pytest.raises(ValueError, match=r"\[mode, x\]"):
        pipe.submit("lev", np.ones(D))
    # Windowed tenants are ported; like the reference's, a windowed matrix
    # tenant needs its d.
    with pytest.raises(ValueError, match="windowed matrix tenants need d"):
        pipe.add_windowed_tenant("w")
    # The heavy-hitter and quantile reads refuse a leverage tenant, as the
    # reference's do.
    with pytest.raises(ValueError, match="not a heavy-hitter tenant"):
        pipe.heavy_hitters("lev", 0.1)
    with pytest.raises(ValueError, match="not a quantile tenant"):
        pipe.quantiles("lev", [0.5])
