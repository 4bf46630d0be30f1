"""The port's cluster under seeded transport faults and a crash-restart.

The reference's chaos property (``tests/test_chaos.py``), on the port's
cells on the CPU: under a seeded ``FaultPlan`` (drops, duplicates,
delay-reorders) the served answers of all four kinds and of a windowed
tenant fed with event times are byte-identical to the port's own
fault-free run, and every send is accounted for; a cell crashed
mid-stream, served degraded through the replica and recovered from its
checkpoint into a fresh cell holds the uninterrupted router's state and
answers bit for bit.  The router's clock and sleep are injected, so the
back-offs cost no wall time.
"""
import numpy as np
import pytest

from repro_torch.cluster import ClusterRouter, PipelineCell
from repro_torch.cluster import transport as tp
from repro_torch.core.leverage import score_query, subspace_query
from repro_torch.core.quantiles import quantile_query
from repro_torch.runtime import EveryKSteps
from repro_torch.runtime.policies import OnWindowClose, RetryPolicy

D = 8
EPS = 0.2
KINDS = ("m0", "h0", "q0", "v0", "w0")
N_MESSAGES = 160


def _router(*, plan=None, **kw):
    """A transported router over two fresh cells: back-offs of 0.01-0.04 s
    slept on an injected clock, so nothing waits."""
    clock = [0.0]

    def sleep(s):
        clock[0] += s

    cells = [PipelineCell(f"cell-{i}", 1, device="cpu", eps=EPS, policy=EveryKSteps(1))
             for i in range(2)]
    transport = tp.Transport(plan=plan)
    router = ClusterRouter(
        cells, transport=transport,
        retry=RetryPolicy(max_attempts=5, base_s=0.01, cap_s=0.04),
        breaker_threshold=2, breaker_cooldown_s=0.0, staleness_bound=64,
        clock=lambda: clock[0], sleep=sleep, **kw,
    )
    router.add_tenant("m0", D, eps=EPS, policy=EveryKSteps(1))
    router.add_hh_tenant("h0", eps=0.05, policy=EveryKSteps(1))
    router.add_quantile_tenant("q0", eps=0.05, policy=EveryKSteps(1))
    router.add_leverage_tenant("v0", D, eps=EPS, policy=EveryKSteps(1))
    router.add_windowed_tenant("w0", kind="matrix", d=D, window=4.0, buckets=4,
                               policy=OnWindowClose())
    return router, transport


def _script(n_rounds=6):
    """An interleaved stream over the five tenants; ``w0``'s batches carry
    their event time (one unit a round)."""
    rng = np.random.default_rng(7)
    out = []
    for r in range(n_rounds):
        out.append(("m0", rng.normal(size=(16, D)).astype(np.float32), None))
        out.append(("h0", np.stack([rng.integers(0, 20, 60), rng.uniform(0.5, 2.0, 60)],
                                   axis=1).astype(np.float32), None))
        vals = rng.normal(size=60).astype(np.float32)
        out.append(("q0", np.stack([vals, np.ones(60, np.float32)], axis=1), None))
        out.append(("v0", rng.normal(size=(16, D)).astype(np.float32), None))
        out.append(("w0", rng.normal(size=(16, D)).astype(np.float32), float(r)))
    return out


def _queries():
    rng = np.random.default_rng(99)
    x = rng.normal(size=(4, D)).astype(np.float32)
    return [
        ("m0", x),
        ("h0", np.arange(6, dtype=np.float32)[:, None]),
        ("q0", np.stack([quantile_query(0.25), quantile_query(0.9)])),
        ("v0", np.stack([subspace_query(x[0]), score_query(x[1])])),
        ("w0", x),
    ]


def _feed(router, script):
    for tenant, rows, ts in script:
        router.ingest(tenant, rows, ts=ts)


def _settle(router, transport, *, past=0):
    """Heartbeat until every cell is healthy, the replay queues are drained
    and the transport has used at least ``past`` message indices."""
    for _ in range(200):
        hb = router.heartbeat_all()
        pending = sum(v["replay_pending"] for k, v in router.stats().items()
                      if k != "_resilience")
        if all(s == "ok" for s in hb.values()) and pending == 0 and transport.sends >= past:
            return
    pytest.fail(f"cluster failed to settle: heartbeat={hb}, replay_pending={pending}")


def _same_state(a, b):
    """Steps, rows, versions, watermarks and every state leaf, bit for bit."""
    for t in KINDS:
        pa, pb = a.cell_for(t).pipeline, b.cell_for(t).pipeline
        sa, sb = pa.stats(t), pb.stats(t)
        assert (sa.steps, sa.rows, sa.latest_version) == (sb.steps, sb.rows, sb.latest_version), t
        la, lb = pa.export_tenant(t)["arrays"], pb.export_tenant(t)["arrays"]
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(la[k], lb[k])
    assert a.cell_for("w0").pipeline.tracker("w0").watermark() == \
        b.cell_for("w0").pipeline.tracker("w0").watermark()


def _same_answers(a, b):
    for x, y in zip(a.query_batch(_queries()), b.query_batch(_queries())):
        assert (x.tenant, x.version, x.error_bound) == (y.tenant, y.version, y.error_bound)
        np.testing.assert_array_equal(np.asarray(x.estimates), np.asarray(y.estimates))


def _accounted(transport):
    c = transport.counters
    return transport.sends == c["delivered"] + c["dropped"] + c["delayed"] + c["crashed"] + c["down"]


@pytest.mark.parametrize("seed", [1, 2])
def test_answers_identical_under_seeded_faults(seed):
    plan = tp.FaultPlan.seeded(seed, N_MESSAGES, p_drop=0.15, p_duplicate=0.1, p_delay=0.1)
    ref, ref_t = _router()
    cha, cha_t = _router(plan=plan)
    for router in (ref, cha):
        _feed(router, _script())
    _settle(ref, ref_t)
    while cha_t.sends < N_MESSAGES:  # burn through the plan, then settle
        cha.heartbeat_all()
    _settle(cha, cha_t, past=N_MESSAGES)

    assert cha_t.counters["dropped"] + cha_t.counters["delayed"] > 0
    assert cha_t.counters["duplicate_deliveries"] > 0
    _same_state(ref, cha)
    _same_answers(ref, cha)
    assert cha.cell_for("w0").pipeline.stats()["late_rows"] == 0
    assert _accounted(ref_t) and _accounted(cha_t)
    res = cha.stats()["_resilience"]
    assert res["attempts"] == res["messages"] + res["retries"] == cha_t.sends
    assert res["retries"] > 0 and res["backoff_s"] > 0.0
    ref.close()
    cha.close()


def test_crash_restart_recovers_bit_identical_state(tmp_path):
    script = _script(8)
    half, three_q = len(script) // 2, 3 * len(script) // 4
    ref, ref_t = _router()
    _feed(ref, script)
    _settle(ref, ref_t)

    router, transport = _router()
    _feed(router, script[:half])
    router.heartbeat_all()  # the replica syncs before the outage
    victim = router.placement()["m0"]
    router.checkpoint_cell(victim, str(tmp_path), step=1)
    _feed(router, script[half:three_q])  # applied, newer than the checkpoint
    transport.crash(victim)
    owned = sorted(t for t, c in router.placement().items() if c == victim)
    for tenant, rows, ts in script[three_q:]:
        ack = router.ingest(tenant, rows, ts=ts)
        if tenant in owned:
            assert ack is None  # parked for replay, not lost
    answers = router.query_batch(_queries())  # the victim's tenants degrade
    assert all(a is not None for a in answers)
    assert router.stats()["_resilience"]["degraded_queries"] >= len(owned)
    assert router.degraded_log and all(b <= 64 for _, b in router.degraded_log)

    fresh = PipelineCell(victim, 1, device="cpu", eps=EPS, policy=EveryKSteps(1))
    with pytest.raises(ValueError, match="expected"):
        router.recover_cell("no-such-cell", fresh, str(tmp_path), step=1)
    assert router.recover_cell(victim, fresh, str(tmp_path), step=1) > 0
    assert router.stats()["_resilience"]["recoveries"] == 1
    _settle(router, transport)
    _same_state(ref, router)
    _same_answers(ref, router)
    ref.close()
    router.close()
