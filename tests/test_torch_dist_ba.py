"""Parity of the port's `parallel/dist_ba.py` with the JAX reference.

The reference shards over the 8 virtual CPU devices of tests/conftest.py;
the port's counterpart is a mesh of CPU shards (`make_mesh(D, ["cpu"] * D)`).

Tolerances:
- route_factors_by_point: bit-exact (integers and copies);
- dist_ba_solve in float64 on tests/test_ba.py's bundle: the port's D = 8
  against its D = 1 within 1e-8 (the reference's own bar,
  tests/test_dist_ba.py); the port against the reference at the same D
  within 1e-9 in rotations and translations and 1e-8 in points (the two
  differ only in the order of float sums); the cameras solved within
  0.02 m;
- dist_global_ba on the reference test's MapState (float32): the
  reference's cost bars for D in {1, 8}, and the port's final cost within
  5% of the starting cost of the reference's at the same D.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import cameras as jcameras
from ms_slam_tpu.parallel import dist_ba as jdist
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.parallel import dist_ba

from test_ba import BF, PIN, make_bundle
from test_dist_ba import _total_chi2

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass


def _cpu_mesh(D):
    return dist_ba.make_mesh(D, ["cpu"] * D)


# ---------------------------------------------------------------------------
# Routing, meshes and shards
# ---------------------------------------------------------------------------

def _table(rng, F=301, Pn=50, crowd=False):
    """A factor table with invalid rows; `crowd` puts every valid row on the
    first few points, so that some shards own no observed point and receive
    only invalid rows."""
    f_pt = rng.integers(0, 5 if crowd else Pn, F).astype(np.int32)
    f_valid = rng.random(F) < 0.8
    f_pt[~f_valid] = rng.integers(-3, Pn + 7, (~f_valid).sum())
    f_uv = rng.normal(0, 1, (F, 2))
    f_cam = rng.integers(0, 6, F).astype(np.int32)
    return f_pt, f_valid, f_uv, f_cam


@pytest.mark.parametrize("crowd", [False, True], ids=["spread", "crowded"])
@pytest.mark.parametrize("D", [1, 3, 8])
def test_route_factors_by_point_bit_exact(D, crowd):
    """Pn = 50 is divisible by none of 3 and 8: the last shard owns a short
    range, and the padding must match the reference's row for row."""
    rng = np.random.default_rng(D)
    f_pt, f_valid, f_uv, f_cam = _table(rng, crowd=crowd)
    want = jdist.route_factors_by_point(D, 50, f_pt, f_valid, f_uv, f_cam)
    got = dist_ba.route_factors_by_point(D, 50, f_pt, f_valid, f_uv, f_cam)
    assert got[0] == want[0] == -(-50 // D)
    for a, b in zip(got[1:3] + tuple(got[3]), want[1:3] + tuple(want[3])):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # every valid row sits in the block of the shard that owns its point
    F_cap = got[1].shape[0] // D
    blocks = np.repeat(np.arange(D), F_cap)
    v = got[2]
    assert (got[1][v] // got[0] == blocks[v]).all()
    assert v.sum() == f_valid.sum()


def test_make_mesh_never_drops_to_the_cpu():
    """With no device list a mesh takes CUDA cards; this machine has fewer
    than asked for, so it raises instead of taking the CPU."""
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        dist_ba.make_mesh(n + 1)
    mesh = dist_ba.make_mesh(3, ["cpu"] * 8)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.places == (torch.device("cpu"),) and mesh.axis == "factors"
    with pytest.raises(ValueError):
        dist_ba.make_mesh(4, ["cpu"] * 2)


def test_devices_offered():
    """A CPU System may take up to 8 shards, as the reference's CPU tests
    see 8 devices; a card System takes the machine's cards."""
    assert dist_ba.devices_offered("cpu") == [torch.device("cpu")] * 8
    assert len(dist_ba.devices_offered("cuda")) == torch.cuda.device_count()


def test_shard_factors_and_replicate():
    mesh = _cpu_mesh(4)
    a = torch.arange(24).reshape(12, 2)
    (blocks,) = dist_ba.shard_factors(mesh, a)
    assert len(blocks) == 4
    for d, b in enumerate(blocks):
        assert torch.equal(b, a[3 * d:3 * d + 3])
    with pytest.raises(ValueError):
        dist_ba.shard_factors(mesh, torch.zeros(10))
    (rep,) = dist_ba.replicate(mesh, a)
    assert len(rep) == 1 and torch.equal(rep[0], a)


def test_psum_adds_in_shard_order():
    """The one exchange between shards: partials summed in shard order on
    the first device, one copy per distinct device."""
    parts = [torch.tensor([1e16, 1.0]), torch.tensor([1.0, 1e16]),
             torch.tensor([-1e16, -1e16])]
    out = dist_ba._psum(_cpu_mesh(3), parts)
    assert len(out) == 1
    want = (parts[0] + parts[1]) + parts[2]
    assert torch.equal(out[0], want)


# ---------------------------------------------------------------------------
# dist_ba_solve on tests/test_ba.py's bundle, float64
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bundle():
    """tests/test_dist_ba.py's problem: 5 cameras (2 fixed) and 120 points,
    the free cameras moved by 5 cm and the points by 2 cm; the factor table
    padded with invalid rows."""
    rng = np.random.default_rng(0)
    Rs, ts, P, f_cam, f_pt, f_uv, f_ur, F = make_bundle(rng, n_cams=5,
                                                        n_pts=120)
    pad = (-F) % 8
    f_cam = np.pad(f_cam, (0, pad))
    f_pt = np.pad(f_pt, (0, pad))
    f_uv = np.pad(f_uv, ((0, pad), (0, 0)))
    f_ur = np.pad(f_ur, (0, pad), constant_values=-1.0)
    f_valid = np.zeros(F + pad, bool)
    f_valid[:F] = True
    sigma2 = np.ones(F + pad)
    cam_opt = np.ones(5, bool)
    cam_opt[:2] = False
    tp = ts + np.concatenate([np.zeros((2, 3)),
                              rng.normal(0, 0.05, (3, 3))])
    Pp = P + rng.normal(0, 0.02, P.shape)
    return {"truth": ts, "args": (Rs, tp, cam_opt, Pp, np.ones(120, bool)),
            "fargs": (f_cam, f_pt, f_uv, f_ur, sigma2, f_valid)}


def _port_solve(bundle, D):
    args = [torch.from_numpy(a) for a in bundle["args"]]
    fargs = [torch.from_numpy(a) for a in bundle["fargs"]]
    return dist_ba.dist_ba_solve(_cpu_mesh(D), jcameras.PINHOLE,
                                 torch.tensor(np.asarray(PIN)), BF,
                                 *args, *fargs, n_iters=6)


def _ref_solve(bundle, D):
    return jdist.dist_ba_solve(
        jdist.make_mesh(D), jcameras.PINHOLE, PIN, BF,
        *[jnp.asarray(a) for a in bundle["args"]],
        *[jnp.asarray(a) for a in bundle["fargs"]], n_iters=6)


@pytest.fixture(scope="module")
def port_runs(bundle):
    return {D: _port_solve(bundle, D) for D in (1, 3, 8)}


def test_dist_ba_solve_shards_agree_and_solve(bundle, port_runs):
    R1, t1, P1, r1 = port_runs[1]
    R8, t8, P8, r8 = port_runs[8]
    assert R8.dtype == torch.float64 and r8.shape == (6,)
    np.testing.assert_allclose(R8.numpy(), R1.numpy(), atol=1e-8)
    np.testing.assert_allclose(t8.numpy(), t1.numpy(), atol=1e-8)
    np.testing.assert_allclose(P8.numpy(), P1.numpy(), atol=1e-8)
    for c in range(2, 5):
        err = np.linalg.norm(t8[c].numpy() - bundle["truth"][c])
        assert err < 0.02, (c, err)
    # the fixed cameras did not move
    np.testing.assert_array_equal(t8[:2].numpy(), bundle["args"][1][:2])


@pytest.mark.parametrize("D", [1, 3, 8])
def test_dist_ba_solve_matches_reference(bundle, port_runs, D):
    Rj, tj, Pj, rj = _ref_solve(bundle, D)
    Rt, tt, Pt, rt = port_runs[D]
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-9)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-8)
    # the CG converges to float64 precision in both
    assert rt.max() < 1e-12 and float(np.max(rj)) < 1e-12


def test_dist_ba_solve_in_float32_stays_float32(bundle):
    """On the card the map is float32: parameters follow kf_R's dtype."""
    args = [torch.from_numpy(a) for a in bundle["args"]]
    args = [a.float() if a.is_floating_point() else a for a in args]
    fargs = [torch.from_numpy(a) for a in bundle["fargs"]]
    R, t, P, r = dist_ba.dist_ba_solve(
        _cpu_mesh(3), jcameras.PINHOLE, torch.tensor(np.asarray(PIN)),
        BF, *args, *fargs, n_iters=6)
    assert R.dtype == t.dtype == P.dtype == r.dtype == torch.float32
    for c in range(2, 5):
        assert np.linalg.norm(t[c].numpy() - bundle["truth"][c]) < 0.02


# ---------------------------------------------------------------------------
# dist_global_ba on the reference test's MapState
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_map():
    """tests/test_dist_ba.py::test_pipeline_dist_global_ba_solves's map:
    4 cameras each observing 16 points at their exact projections, then
    the poses (but the first) and the points perturbed; built by the
    reference and converted."""
    from ms_slam_tpu.models import map_state as M
    from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
    from ms_slam_tpu.pipeline.frontend import Calib as JCalib
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline.frontend import Calib

    rng = np.random.default_rng(11)
    ms = M.empty_map(M.MapConfig(max_kf=8, max_mp=64, n_feat=16))
    fx, fy, cx, cy = 100.0, 100.0, 50.0, 50.0
    X = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    X[:, 2] += 8.0
    for k in range(4):
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.3 * k, 0.05 * k, 0.1 * k], np.float32)
        Xc = X @ R.T + t
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                       fy * Xc[:, 1] / Xc[:, 2] + cy], -1).astype(np.float32)
        dt_k = np.zeros(3) if k == 0 else rng.normal(0, 0.05, 3)
        ms = M.insert_keyframe(
            ms, jnp.asarray(k), jnp.asarray(R),
            jnp.asarray((t + dt_k).astype(np.float32)),
            jnp.asarray(uv), jnp.zeros(16, jnp.int32),
            jnp.asarray(rng.integers(0, 2**32, (16, 8), dtype=np.uint32)),
            jnp.full(16, -1.0), jnp.full(16, -1.0),
            jnp.ones(16, bool), jnp.arange(16, dtype=jnp.int32),
            jnp.asarray(k))
    ms = M.add_map_points(
        ms, jnp.arange(16), jnp.ones(16, bool),
        jnp.asarray(X + rng.normal(0, 0.03, X.shape).astype(np.float32)),
        jnp.asarray(rng.integers(0, 2**32, (16, 8), dtype=np.uint32)),
        jnp.zeros((16, 3)), jnp.zeros(16), jnp.full(16, 100.0),
        jnp.zeros(16, jnp.int32))
    kw = dict(model=0, params=(fx, fy, cx, cy), bf=15.0, width=100,
              height=100, th_depth=6.0, fps=10.0)
    d = {k: np.asarray(v) for k, v in ms._asdict().items()}
    return {"jms": ms, "d": d, "jcalib": JCalib(**kw), "calib": Calib(**kw),
            "jorb": JOrbConfig(n_features=16, n_levels=4),
            "orb": OrbConfig(n_features=16, n_levels=4)}


@pytest.mark.parametrize("D", [1, 8])
def test_dist_global_ba_cost_bars(small_map, D):
    """The reference test's bars (each sharding below 5% of the starting
    cost), the port's cost within 5% of the starting cost of the
    reference's at the same D, and the anchor keyframe left in place."""
    m = small_map
    c0 = _total_chi2(m["jms"], m["jcalib"], m["jorb"])
    mj = jdist.dist_global_ba(m["jms"], m["jcalib"], m["jorb"], 0,
                              jdist.make_mesh(D), n_iters=6)
    ms_t = TM.map_state_from_numpy(m["d"])
    mt = dist_ba.dist_global_ba(ms_t, m["calib"], m["orb"], 0, _cpu_mesh(D),
                                n_iters=6)
    cj = _total_chi2(mj, m["jcalib"], m["jorb"])
    ct = _total_chi2(mt, m["jcalib"], m["jorb"])
    assert cj < 0.05 * c0 and ct < 0.05 * c0, (cj, ct, c0)
    assert abs(ct - cj) < 0.05 * c0, (ct, cj, c0)
    assert mt.kf_R.dtype == torch.float32
    np.testing.assert_array_equal(mt.kf_t[0].numpy(), m["d"]["kf_t"][0])
    # the argument's tensors are left as they were
    np.testing.assert_array_equal(ms_t.mp_pos.numpy(), m["d"]["mp_pos"])


def test_dist_global_ba_shardings_agree(small_map):
    """The reference's last bar, on the port: D = 8 and D = 1 end at the
    same quality (|c8 - c1| < 2% of the starting cost)."""
    m = small_map
    c0 = _total_chi2(m["jms"], m["jcalib"], m["jorb"])
    costs = [_total_chi2(dist_ba.dist_global_ba(
        TM.map_state_from_numpy(m["d"]), m["calib"], m["orb"], 0,
        _cpu_mesh(D), n_iters=6), m["jcalib"], m["jorb"]) for D in (1, 8)]
    assert abs(costs[0] - costs[1]) < 0.02 * c0 + 1e-6, (costs, c0)


# ---------------------------------------------------------------------------
# The CG budget: too short for a weakly coupled chain, in both packages
# ---------------------------------------------------------------------------

def _weak_chain(rng, n_cams=40, step=1.5, n_pts=600):
    """40 cameras 1.5 m apart along x, looking along z at points 3-6 m
    away: a point is seen by two or three neighbouring cameras, so the
    chain is weakly coupled and its reduced camera system ill-conditioned.
    0.5 px noise, 30% of the observations stereo; the cameras but the
    first moved by 5 cm, the points by 3 cm."""
    P = np.stack([rng.uniform(-2, n_cams * step + 2, n_pts),
                  rng.uniform(-3, 3, n_pts), rng.uniform(3, 6, n_pts)], 1)
    ts = np.stack([[-c * step, 0.0, 0.0] for c in range(n_cams)])
    f_cam, f_pt, f_uv, f_ur = [], [], [], []
    for c in range(n_cams):
        Xc = P + ts[c]
        uv = np.stack([PIN[0] * Xc[:, 0] / Xc[:, 2] + PIN[2],
                       PIN[1] * Xc[:, 1] / Xc[:, 2] + PIN[3]], 1)
        vis = (uv[:, 0] > 0) & (uv[:, 0] < 640) & (uv[:, 1] > 0) \
            & (uv[:, 1] < 480)
        for p in np.flatnonzero(vis):
            f_cam.append(c)
            f_pt.append(p)
            f_uv.append(uv[p] + rng.normal(0, 0.5, 2))
            f_ur.append(uv[p, 0] - BF / Xc[p, 2] + rng.normal(0, 0.5)
                        if rng.random() > 0.7 else -1.0)
    F = len(f_cam)
    cam_opt = np.ones(n_cams, bool)
    cam_opt[0] = False
    tp = ts + np.concatenate([np.zeros((1, 3)),
                              rng.normal(0, 0.05, (n_cams - 1, 3))])
    return {"args": (np.repeat(np.eye(3)[None], n_cams, 0), tp, cam_opt,
                     P + rng.normal(0, 0.03, P.shape), np.ones(n_pts, bool)),
            "fargs": (np.asarray(f_cam, np.int32), np.asarray(f_pt, np.int32),
                      np.asarray(f_uv), np.asarray(f_ur), np.ones(F),
                      np.ones(F, bool))}


def test_cg_budget_under_converges_alike():
    """The reference's CG budget, min(6C, max(96, 6C // 8)) = 96 steps for
    C = 40 cameras, leaves the reduced camera solve of a weakly coupled
    chain above its own 1e-2 warning line in the later iterations; the port
    keeps the budget and ends each iteration at the reference's ratio
    (float64, rtol 1e-4). Given 6C steps both go below 1e-6: the budget
    is short, not the arithmetic."""
    b = _weak_chain(np.random.default_rng(3))
    args = [torch.from_numpy(a) for a in b["args"]]
    fargs = [torch.from_numpy(a) for a in b["fargs"]]
    pin = torch.tensor(np.asarray(PIN))
    jargs = [jnp.asarray(a) for a in b["args"] + b["fargs"]]
    ratios = {}
    for n_cg in (None, 240):
        rt = dist_ba.dist_ba_solve(_cpu_mesh(1), jcameras.PINHOLE, pin, BF,
                                   *args, *fargs, n_iters=4, n_cg=n_cg)[3]
        rj = jdist.dist_ba_solve(jdist.make_mesh(1), jcameras.PINHOLE, PIN,
                                 BF, *jargs, n_iters=4, n_cg=n_cg)[3]
        ratios[n_cg] = (rt.numpy(), np.asarray(rj))
    rt, rj = ratios[None]
    np.testing.assert_allclose(rt, rj, rtol=1e-4)
    assert rt[-1] > 1e-2 and rj[-1] > 1e-2, (rt, rj)
    rt, rj = ratios[240]
    assert rt.max() < 1e-6 and rj.max() < 1e-6, (rt, rj)
