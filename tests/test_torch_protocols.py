"""The port's super-step protocols against the reference's shard_map engine.

Matrix P1/P2 and leverage P1.  The port keeps the m sites on a tensor axis;
the reference keeps one site per device.  At m = 1 both run in this
process (a one-device mesh); the m = 4 reference runs once in a subprocess
with four fake CPU devices.  Held equal: ``CommReport`` units, exactly.
Held close: the coordinator's ``frob`` (or leverage ``f_hat``) estimate
(1e-6 relative, f32 sums in another order) and served answers — ``||B x||^2``,
leverage subspace and score answers — (1e-5 of the largest answer).

Threshold decisions (``send_scalar`` and the per-direction row mask) can
flip for a row within float noise of ``(eps/m) f_hat``; the seeds here keep
every decision away from that boundary, which the exact ``CommReport``
equality checks on every run.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import run_multidevice
from test_torch_leverage import spiky_stream

from repro.core import distributed as jdist
from repro.runtime.registry import create_protocol as ref_create
from repro.runtime.registry import get_spec as ref_get_spec
from repro.runtime.registry import protocol_names as ref_names
from repro_torch.core import distributed as tdist
from repro_torch.runtime import create_protocol, get_spec, protocol_names

D, EPS, L_SITE, L_COORD, BATCH = 24, 0.2, 6, 8, 64


def _stream(seed: int, n: int) -> np.ndarray:
    """A rank-4 stream with decaying scales plus noise (tests/test_distributed.py)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 4)) * (np.arange(4, 0, -1) ** 2)[None]
    return (u @ rng.normal(size=(4, D)) + 0.05 * rng.normal(size=(n, D))).astype(np.float32)


def _dirs(n: int = 16) -> np.ndarray:
    x = np.random.default_rng(99).normal(size=(n, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _mesh1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _pair(name: str, m: int = 1):
    ref = ref_create(name, engine="shard", mesh=_mesh1(), d=D, eps=EPS, axis="data",
                     l_site=L_SITE, l_coord=L_COORD)
    port = create_protocol(name, engine="shard", m=m, d=D, eps=EPS, l_site=L_SITE,
                           l_coord=L_COORD, device="cpu")
    return ref, port


def _assert_served_parity(port_answers, ref_answers, port_frob, ref_frob):
    ref_answers = np.asarray(ref_answers, np.float64)
    np.testing.assert_allclose(np.asarray(port_answers, np.float64), ref_answers, rtol=1e-5,
                               atol=1e-5 * np.abs(ref_answers).max())
    np.testing.assert_allclose(port_frob, ref_frob, rtol=1e-6)


@pytest.mark.parametrize("name", ["P1", "P2"])
def test_single_site_matches_one_device_mesh(name):
    a, x = _stream(0, 8 * BATCH), _dirs()
    ref, port = _pair(name)
    for s in range(8):
        rows = a[s * BATCH : (s + 1) * BATCH]
        ref.step(jnp.asarray(rows))
        port.step(rows)
    assert port.comm_report().as_dict() == ref.comm_report().as_dict()
    assert port.rows_seen == ref.rows_seen
    _assert_served_parity(port.query_batch(x), ref.query_batch(x),
                          port.frob_estimate(), ref.frob_estimate())
    b, rb = port.matrix().astype(np.float64), ref.matrix().astype(np.float64)
    want = rb.T @ rb
    np.testing.assert_allclose(b.T @ b, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


REF_M4 = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.runtime.registry import create_protocol
a, x, lev = np.load({a!r}), np.load({x!r}), np.load({lev!r})
mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
out = {{}}
for name in ("P1", "P2"):
    p = create_protocol(name, engine="shard", mesh=mesh, d={d}, eps={eps}, axis="data",
                        l_site={l_site}, l_coord={l_coord})
    for s in range({steps}):
        p.step(jnp.asarray(a[s * {rows}:(s + 1) * {rows}]))
    out[name] = dict(comm=p.comm_report().as_dict(), frob=p.frob_estimate(),
                     answers=p.query_batch(x).tolist())
p = create_protocol("P1", engine="shard", kind="leverage", mesh=mesh, d={d}, eps={eps})
for rows in lev:
    p.step(rows)
out["LP1"] = dict(comm=p.comm_report().as_dict(), frob=float(p.state.f_hat),
                  answers=p.subspace_query_batch(x).tolist(), scores=p.score_batch(x).tolist())
print("RESULT", json.dumps(out))
"""


def test_four_sites_match_four_device_mesh(tmp_path):
    """Matrix P1/P2 and leverage P1 at m = 4 against a four-device mesh."""
    m, steps = 4, 6
    a, x = _stream(7, steps * m * BATCH), _dirs()
    lev = np.stack(spiky_stream(8, 4, m=m, d=D))
    for name, arr in (("a", a), ("x", x), ("lev", lev)):
        np.save(tmp_path / f"{name}.npy", arr)
    out = run_multidevice(REF_M4.format(
        a=str(tmp_path / "a.npy"), x=str(tmp_path / "x.npy"), lev=str(tmp_path / "lev.npy"),
        d=D, eps=EPS, l_site=L_SITE, l_coord=L_COORD, steps=steps, rows=m * BATCH), n_devices=m)
    ref = json.loads(out.split("RESULT ", 1)[1])
    for name in ("P1", "P2"):
        port = create_protocol(name, engine="shard", m=m, d=D, eps=EPS, l_site=L_SITE,
                               l_coord=L_COORD, device="cpu")
        for s in range(steps):
            port.step(a[s * m * BATCH : (s + 1) * m * BATCH])
        assert port.comm_report().as_dict() == ref[name]["comm"], name
        _assert_served_parity(port.query_batch(x), ref[name]["answers"],
                              port.frob_estimate(), ref[name]["frob"])
    port = create_protocol("P1", engine="shard", kind="leverage", m=m, d=D, eps=EPS,
                           device="cpu")
    for rows in lev:
        port.step(rows)
    assert port.comm_report().as_dict() == ref["LP1"]["comm"]
    _assert_served_parity(port.subspace_query_batch(x), ref["LP1"]["answers"],
                          float(port.state.f_hat), ref["LP1"]["frob"])
    _assert_served_parity(port.score_batch(x), ref["LP1"]["scores"], 0.0, 0.0)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_state_payload_carries_across_packages(direction):
    """A P2 payload taken after three steps restores in the other package,
    and one more step on the same rows serves the same answers."""
    a, x = _stream(3, 4 * BATCH), _dirs()
    ref, port = _pair("P2")
    src, dst = (ref, port) if direction == "reference_to_port" else (port, ref)
    for s in range(3):
        rows = a[s * BATCH : (s + 1) * BATCH]
        src.step(jnp.asarray(rows) if src is ref else rows)
    arrays, meta = src.state_payload()
    assert sorted(arrays) == [f"leaf_{i:03d}" for i in range(14)]
    dst.restore_payload(arrays, meta)
    last = a[3 * BATCH :]
    ref.step(jnp.asarray(last))
    port.step(last)
    assert port.rows_seen == ref.rows_seen == 4 * BATCH
    assert port.comm_report().as_dict() == ref.comm_report().as_dict()
    _assert_served_parity(port.query_batch(x), ref.query_batch(x),
                          port.frob_estimate(), ref.frob_estimate())


def test_restore_rejects_a_payload_of_another_shape():
    _, port = _pair("P2")
    other = create_protocol("P2", engine="shard", m=2, d=D, eps=EPS, l_site=L_SITE,
                            l_coord=L_COORD, device="cpu")
    arrays, meta = other.state_payload()
    with pytest.raises(ValueError, match="shape"):
        port.restore_payload(arrays, meta)


def test_config_and_registry_surface():
    port = tdist.ProtocolConfig(eps=0.03, m=4, d=16).resolved()
    ref = jdist.ProtocolConfig(eps=0.03, m=4, d=16).resolved()
    for field in ("l_site", "l_coord", "s", "k", "q_cap", "lev_cap"):
        assert getattr(port, field) == getattr(ref, field), field
    # The port registers exactly the reference's specs, with the same
    # err_factors, shard P3 and the 16 windowed specs included.
    for kind in ("matrix", "hh", "quantile", "leverage"):
        for engine in ("event", "shard"):
            assert protocol_names(engine=engine, kind=kind) == ref_names(engine=engine, kind=kind)
            for name in ref_names(engine=engine, kind=kind):
                assert (get_spec(name, engine, kind).err_factor
                        == ref_get_spec(name, engine, kind).err_factor), (kind, engine, name)
    assert "P3" in protocol_names(engine="shard", kind="matrix")
    p3 = create_protocol("P3", engine="shard", m=1, d=4, eps=0.5, device="cpu")
    p3.step(np.ones((3, 4), np.float32))
    assert p3.matrix().shape == (jdist.ProtocolConfig(eps=0.5, m=1, d=4).resolved().s + 1, 4)
    p = create_protocol("P2", engine="shard", m=2, d=4, device="cpu")
    with pytest.raises(ValueError, match="super-step wants"):
        p.step(np.zeros((3, 4), np.float32))  # 3 rows do not split over 2 sites
    assert p.query_batch(np.ones((2, 4), np.float32)).tolist() == [0.0, 0.0]
    assert torch.equal(tdist.p2_query(p.state, torch.ones(4)), torch.zeros(()))
