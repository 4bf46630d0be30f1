"""The port's cluster (``repro_torch.cluster``) against the reference's.

The same numpy inputs go through the reference's cells on a one-device
mesh and the port's cells on the CPU (``device="cpu"``: the kernels' plain
versions).  Ring placement, rebalance plans and seeded fault plans are
pure Python and must be equal.  Answers follow ROADMAP's tolerances: 1e-5
of the tenant's mass for matrix and leverage answers, exact versions and
``n_seen``-style counts; heavy-hitter and quantile answers exactly.  On the
port alone, a tenant answers with the same bytes on a bare pipeline, a
1-cell and a 4-cell cluster, and after a move (the reference's property,
``tests/test_cluster.py``): on the CPU the plain versions do not depend on
the pack's composition.
"""
import numpy as np
import pytest

from repro_torch.cluster import (
    ClusterRouter,
    HashRing,
    PipelineCell,
    ServingReplica,
    StalenessExceededError,
    rebalance_plan,
)
from repro_torch.cluster import transport as tp
from repro_torch.core.leverage import QUERY_SCORE, score_query, subspace_query
from repro_torch.core.quantiles import quantile_query
from repro_torch.query.engine import PackedRequest
from repro_torch.runtime import EveryKSteps, StreamingPipeline

D = 16
EPS = 0.2
TOL = 1e-5  # of the tenant's mass ||A_t||_F^2 (ROADMAP: served answers)
# Leverage score answers, on their own ~[0, d] scale: tests/test_leverage.py's tolerances.
SCORE_RTOL, SCORE_ATOL = 1e-3, 1e-5
N_CELLS = 4


def _matrix_batches(seed, n_batches=3, rows=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(rows, D)).astype(np.float32) for _ in range(n_batches)]


def _weighted_pairs(seed, n_batches=3, rows=100, vocab=30):
    rng = np.random.default_rng(seed)
    return [
        np.stack([rng.integers(0, vocab, rows), rng.uniform(0.5, 2.0, rows)], axis=1)
        .astype(np.float32)
        for _ in range(n_batches)
    ]


def _register(target, every=EveryKSteps):
    """The four kinds' tenants, publishing every step (``every``: the
    package's own ``EveryKSteps``, which its checkpoints name)."""
    for i in range(4):
        target.add_tenant(f"mat-{i}", D, eps=EPS, policy=every(1))
    target.add_hh_tenant("hh-a", eps=0.05, policy=every(1))
    target.add_quantile_tenant("qq-a", eps=0.05, policy=every(1))
    target.add_leverage_tenant("lev-a", D, eps=EPS, policy=every(1))


def _load():
    """The reference's mixed load (``tests/test_cluster.py::_build_mixed``)
    as ``(tenant, rows)`` batches in its order."""
    out = [(f"mat-{i}", b) for i in range(4) for b in _matrix_batches(seed=10 + i)]
    out += [("hh-a", b) for b in _weighted_pairs(seed=20)]
    qrng = np.random.default_rng(21)
    for _ in range(3):
        vals = qrng.normal(size=100).astype(np.float32)
        out.append(("qq-a", np.stack([vals, np.ones(100, np.float32)], axis=1)))
    out += [("lev-a", b) for b in _matrix_batches(seed=22)]
    return out


def _build(target, every=EveryKSteps):
    _register(target, every)
    for tenant, rows in _load():
        target.ingest(tenant, rows)


def _queries():
    rng = np.random.default_rng(99)
    x = rng.normal(size=(5, D)).astype(np.float32)
    return [(f"mat-{i}", x) for i in range(4)] + [
        ("hh-a", np.arange(6, dtype=np.float32)[:, None]),
        ("qq-a", np.stack([quantile_query(0.25), quantile_query(0.9)])),
        ("lev-a", np.stack([subspace_query(x[0]), score_query(x[1])])),
    ]


def _mass():
    """Each matrix and leverage tenant's ||A_t||_F^2, from its rows."""
    out = {}
    for tenant, rows in _load():
        if tenant.startswith(("mat", "lev")):
            out[tenant] = out.get(tenant, 0.0) + float((rows.astype(np.float64) ** 2).sum())
    return out


def _port_cells(n, **kw):
    return [PipelineCell(f"cell-{i}", 1, device="cpu", eps=EPS, policy=EveryKSteps(1), **kw)
            for i in range(n)]


def _ref_cells(mesh, n):
    from repro.cluster import PipelineCell as RefCell
    from repro.runtime import EveryKSteps as RefEvery

    return [RefCell(f"cell-{i}", mesh, eps=EPS, policy=RefEvery(1)) for i in range(n)]


def _score_rows():
    """Each leverage tenant's score rows among its ``_queries`` rows."""
    return {t: q[:, 0] == QUERY_SCORE for t, q in _queries() if t.startswith("lev")}


def _assert_close_answers(got, want, mass):
    """Port answers against the other side's: versions exact; HH and
    quantile answers and bounds exactly; matrix answers and leverage
    subspace answers within TOL of the mass, leverage score answers within
    SCORE_RTOL and SCORE_ATOL, bounds to 1e-5 relative (a matrix tenant's
    bound is its ``delta_sum``: f32 sums in another order, ROADMAP's
    tolerance)."""
    scores = _score_rows()
    for g, w in zip(got, want):
        assert g.tenant == w.tenant and g.version == w.version
        ge, we = np.asarray(g.estimates, np.float64), np.asarray(w.estimates, np.float64)
        if g.tenant in mass:
            np.testing.assert_allclose(g.error_bound, w.error_bound, rtol=1e-5)
            score = scores.get(g.tenant, np.zeros(len(we), bool))
            assert np.abs(ge - we)[~score].max() <= TOL * mass[g.tenant], g.tenant
            np.testing.assert_allclose(ge[score], we[score], rtol=SCORE_RTOL, atol=SCORE_ATOL,
                                       err_msg=g.tenant)
        else:
            assert g.error_bound == w.error_bound
            np.testing.assert_array_equal(ge, we)


def _same_answers(a, b):
    for x, y in zip(a, b):
        assert (x.tenant, x.version, x.error_bound) == (y.tenant, y.version, y.error_bound)
        np.testing.assert_array_equal(x.estimates, y.estimates)


def _leaves(pipe, tenant):
    return pipe.export_tenant(tenant)["arrays"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 4-cell cluster on the mixed load, its answers, and one
    cell's checkpoint (on a one-device mesh in-process, as
    ``tests/test_cluster.py`` runs it)."""
    import jax
    from repro.cluster import ClusterRouter as RefRouter
    from repro.runtime import EveryKSteps as RefEvery

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    router = RefRouter(_ref_cells(mesh, N_CELLS))
    _build(router, RefEvery)
    answers = router.query_batch(_queries())
    ckpt_dir = tmp_path_factory.mktemp("ref_cell")
    cell = router.cell_for("lev-a")
    cell._next_seq[("lev-a", "site-0")] = 4  # a dedup horizon to carry over
    cell.save(str(ckpt_dir), step=3)
    return dict(mesh=mesh, router=router, answers=answers, ckpt=str(ckpt_dir),
                cell_name=cell.name, cell_tenants=cell.tenants())


# ---------------------------------------------------------------------------
# pure Python: ring, rebalance plan, fault plan
# ---------------------------------------------------------------------------


def test_ring_placement_and_rebalance_plan_match_reference():
    from repro.cluster import HashRing as RefRing
    from repro.cluster import rebalance_plan as ref_plan

    tenants = [f"tenant-{i}" for i in range(200)] + ["mat-0", "hh-a", "lev/é"]
    for names, vnodes in ((["a", "b", "c"], 64), ([f"cell-{i}" for i in range(5)], 16)):
        ring, rring = HashRing(names, vnodes=vnodes), RefRing(names, vnodes=vnodes)
        assert [ring.place(t) for t in tenants] == [rring.place(t) for t in tenants]
        placement = {t: ring.place(t) for t in tenants}
        grown = names + ["new"]
        plan = rebalance_plan(ring, ring.with_cells(grown), placement)
        rplan = ref_plan(rring, rring.with_cells(grown), placement)
        assert plan.moves and [tuple(m) for m in plan.moves] == [tuple(m) for m in rplan.moves]
        assert plan.unmoved == rplan.unmoved


@pytest.mark.parametrize("seed", [1, 42])
def test_seeded_fault_plan_matches_reference(seed):
    from repro.cluster import transport as rtp

    kw = dict(p_drop=0.15, p_duplicate=0.1, p_delay=0.1)
    for crash_at in (None, 7):
        plan = tp.FaultPlan.seeded(seed, 160, crash_at=crash_at, **kw)
        rplan = rtp.FaultPlan.seeded(seed, 160, crash_at=crash_at, **kw)
        assert [plan.action(i) for i in range(170)] == [rplan.action(i) for i in range(170)]
        assert plan.drop | plan.delay


# ---------------------------------------------------------------------------
# the port's cluster against the reference's, and against itself
# ---------------------------------------------------------------------------


def test_four_cell_cluster_matches_reference(reference):
    with ClusterRouter(_port_cells(N_CELLS)) as router:
        _build(router)
        assert router.placement() == reference["router"].placement()
        assert len(set(router.placement().values())) > 1
        got = router.query_batch(_queries())
        assert [r.tenant for r in got] == [t for t, _ in _queries()]
        _assert_close_answers(got, reference["answers"], _mass())
        for t in router.tenants():
            ps = router.cell_for(t).pipeline.stats(t)
            rs = reference["router"].cell_for(t).pipeline.stats(t)
            assert (ps.steps, ps.rows, ps.latest_version) == (rs.steps, rs.rows, rs.latest_version)


def test_bare_pipeline_one_and_four_cells_answer_identically():
    single = StreamingPipeline(1, eps=EPS, policy=EveryKSteps(1), device="cpu")
    _build(single)
    base = single.engine.query_packed([PackedRequest(t, q) for t, q in _queries()])
    for n_cells in (1, N_CELLS):
        with ClusterRouter(_port_cells(n_cells)) as router:
            _build(router)
            _same_answers(base, router.query_batch(_queries()))
            for t in router.tenants():
                for k, v in _leaves(single, t).items():
                    np.testing.assert_array_equal(_leaves(router.cell_for(t).pipeline, t)[k], v)


def test_parallel_ingest_many_matches_sequential():
    """A thread per cell (``parallel=True``) against the sequential waves:
    state leaves and answers bit for bit, all four kinds."""
    runs = []
    for parallel in (False, True):
        router = ClusterRouter(_port_cells(N_CELLS))
        _register(router)
        n = router.ingest_many(_load(), parallel=parallel)
        runs.append((router, n))
    (seq, n_seq), (par, n_par) = runs
    assert n_seq == n_par == len(_load())
    _same_answers(seq.query_batch(_queries()), par.query_batch(_queries()))
    for t in seq.tenants():
        for k, v in _leaves(seq.cell_for(t).pipeline, t).items():
            np.testing.assert_array_equal(_leaves(par.cell_for(t).pipeline, t)[k], v)
    seq.close()
    par.close()


def test_packed_waves_across_pack_compositions_agree_within_tolerance():
    """Packed ``ingest_many`` stacks a cell's same-shape tenants into one
    step, padded to the largest member's bucket, so a tenant's bits follow
    its pack (ROADMAP §3): the 4-cell cluster against the bare pipeline, both
    packed, hold counts, versions and ``n_seen`` exactly, HH and quantile
    answers exactly and matrix and leverage answers within TOL of the mass."""
    rows = {"mat-0": 64, "mat-1": 32, "mat-2": 16, "mat-3": 16, "lev-a": 32}
    rng = np.random.default_rng(41)
    load = [(t, rng.normal(size=(n, D)).astype(np.float32)) for _ in range(3)
            for t, n in rows.items()]
    load += [(t, b) for t, b in _load() if t in ("hh-a", "qq-a")]
    mass = {t: sum(float((b.astype(np.float64) ** 2).sum()) for n, b in load if n == t)
            for t in rows}
    bare = StreamingPipeline(2, eps=EPS, policy=EveryKSteps(1), device="cpu")
    _register(bare)
    bare.ingest_many(load)
    router = ClusterRouter([PipelineCell(f"cell-{i}", 2, device="cpu", eps=EPS,
                                         policy=EveryKSteps(1)) for i in range(N_CELLS)])
    _register(router)
    router.ingest_many(load, parallel=True)
    queries = [(t, q) for t, q in _queries() if t in rows or t in ("hh-a", "qq-a")]
    want = bare.engine.query_packed([PackedRequest(t, q) for t, q in queries])
    _assert_close_answers(router.query_batch(queries), want, mass)
    for t in rows:
        a, b = router.cell_for(t).pipeline.stats(t), bare.stats(t)
        assert (a.steps, a.rows, a.latest_version) == (b.steps, b.rows, b.latest_version)
        got, ref = _leaves(router.cell_for(t).pipeline, t), _leaves(bare, t)
        for k in (k for k in ref if "n_seen" in k):
            np.testing.assert_array_equal(got[k], ref[k])
    router.close()


# ---------------------------------------------------------------------------
# migration, rebalance and replicas
# ---------------------------------------------------------------------------


def test_export_import_and_rebalance_round_trip_are_bit_identical():
    cells = _port_cells(2)
    router = ClusterRouter(cells)
    _build(router)
    before = router.query_batch(_queries())
    leaves = {t: _leaves(router.cell_for(t).pipeline, t) for t in router.tenants()}
    placement = router.placement()

    plan = router.scale_to(cells + _port_cells(3)[2:])
    assert plan.moves and all(m.dst == "cell-2" for m in plan.moves)
    mid = router.query_batch(_queries())
    for m in plan.moves:
        moved = _leaves(router.cell("cell-2").pipeline, m.tenant)
        assert moved.keys() == leaves[m.tenant].keys()
        for k, v in leaves[m.tenant].items():
            np.testing.assert_array_equal(moved[k], v)
    back = router.scale_to(cells)
    assert {m.tenant for m in back.moves} == {m.tenant for m in plan.moves}
    assert router.placement() == placement and router.rebalances == 2
    _same_answers(before, mid)
    _same_answers(before, router.query_batch(_queries()))
    # a moved tenant keeps ingesting and publishing after the round trip
    t = plan.moves[0].tenant
    snap = router.ingest(t, next(rows for n, rows in _load() if n == t))
    old = next(r.version for r in before if r.tenant == t)
    assert snap is not None and snap.version == old + 1
    router.close()


def test_replica_read_through_staleness_and_bound():
    cell = _port_cells(1)[0]
    cell.pipeline.add_tenant("t", D, eps=EPS, policy=EveryKSteps(1))
    batches = _matrix_batches(seed=6, n_batches=5)
    for b in batches[:2]:
        cell.ingest("t", b)
    replica = ServingReplica(cell)
    assert replica.engine.device.type == "cpu"  # the source's device
    x = np.ones((2, D), np.float32)
    res = replica.query_batch(x, tenant="t")  # cold: read-through, then answer
    assert replica.read_throughs == 1 and replica.pulled == 2
    assert res.versions_behind == 0 and res.owner_version == 2
    np.testing.assert_array_equal(
        res.result.estimates, cell.engine.query_batch(x, tenant="t").estimates)
    cell.ingest("t", batches[2])  # the owner moves ahead: served stale
    stale = replica.query_batch(x, tenant="t")
    assert stale.versions_behind == 1 and stale.result.version == 2
    assert replica.sync() == 1
    assert replica.query_batch(x, tenant="t").versions_behind == 0

    bounded = ServingReplica(cell, max_versions_behind=1)
    bounded.sync("t")
    for b in batches[3:]:
        cell.ingest("t", b)  # version 5, two ahead of the bounded replica
    pinned = bounded.query_batch(x, tenant="t", version=3)  # local; sees the owner at 5
    assert pinned.versions_behind == 2
    with pytest.raises(StalenessExceededError) as ei:
        bounded.query_degraded(x, tenant="t")
    assert (ei.value.behind, ei.value.bound) == (2, 1)
    fresh = bounded.query_batch(x, tenant="t")  # the bound forces a refresh
    assert fresh.versions_behind == 0 and fresh.result.version == 5
    cell.close()


# ---------------------------------------------------------------------------
# cell checkpoints across packages
# ---------------------------------------------------------------------------


def test_reference_cell_checkpoint_loads_in_the_port(reference):
    cell = PipelineCell.load(reference["cell_name"], reference["ckpt"], 1, device="cpu")
    assert cell.tenants() == reference["cell_tenants"]
    assert cell.dedup_state()["lev-a"] == {"site-0": 4}
    queries = [(t, q) for t, q in _queries() if t in cell.tenants()]
    want = [a for a in reference["answers"] if a.tenant in cell.tenants()]
    got = cell.engine.query_packed([PackedRequest(t, q) for t, q in queries])
    _assert_close_answers(got, want, _mass())
    cell.close()


def test_port_cell_checkpoint_loads_in_the_reference(reference, tmp_path):
    from repro.cluster import PipelineCell as RefCell

    router = ClusterRouter(_port_cells(N_CELLS))
    _build(router)
    cell = router.cell_for("mat-0")
    cell.restore_dedup({"mat-0": {"site-0": 4}})
    cell.save(str(tmp_path), step=2)
    loaded = RefCell.load(cell.name, str(tmp_path), reference["mesh"])
    assert loaded.tenants() == cell.tenants()
    assert loaded.dedup_state() == cell.dedup_state()
    queries = [(t, q) for t, q in _queries() if t in cell.tenants()]
    from repro.query import PackedRequest as RefRequest

    got = cell.engine.query_packed([PackedRequest(t, q) for t, q in queries])
    want = loaded.engine.query_packed([RefRequest(t, q) for t, q in queries])
    _assert_close_answers(got, want, _mass())
    router.close()
