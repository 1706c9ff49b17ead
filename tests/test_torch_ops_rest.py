"""Parity of the port's last functions with the reference, each on the
reference test's own inputs where it has one.

Tolerances and why:
- ba_solve on an arbitrary factor table (tests/test_ba.py's bundle, float64
  on both sides): poses and points within 1e-6 of the reference, the same
  inliers. The reference sums the per-point and per-camera blocks by
  one-hot matmuls, the port by `index_add_`: the same sums in another
  order. Duplicate factors add on both sides; the test's own bars hold;
- inertial_window_refine (tests/test_inertial_window.py's two windows,
  float64): states within 1e-6, the cost within 1e-6 relative. The
  reference differentiates with jacfwd, the port writes the Jacobian out
  (the rotation columns through J_l of the accumulated tangent), and the
  rotation is re-orthonormalized by another formula: the same
  Gauss-Newton steps to rounding;
- query_brute, triangulate_midpoint, the lie helpers, the robust weights:
  exact or within 1e-12 (float64), the same candidates and scores;
- cull_map_points and triangulate_with on a map the port's System made and
  loaded into both: every integer field exact, float fields within 1e-4
  absolute or 1e-3 relative. The DLT solves 3x3 normal equations in
  float32; on a low-parallax point they amplify last-bit differences of
  the two packages' unprojections (measured: 7 coordinates of 4096 points
  at up to 4.5e-4 relative);
- the result types: the reference's field names, returned by the solvers;
- MSSLAM_DUMP_WINDOWS: the same file names, the same arrays (exact) and
  scalars.
"""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.models import map_state as JM
from ms_slam_tpu.models import vocab as jvocab
from ms_slam_tpu.ops import ba as jba
from ms_slam_tpu.ops import cameras as jcam
from ms_slam_tpu.ops import imu as jimu
from ms_slam_tpu.ops import inertial_opt as jio
from ms_slam_tpu.ops import lie as jlie
from ms_slam_tpu.ops import pose_graph as jpg
from ms_slam_tpu.ops import robust as jrob
from ms_slam_tpu.ops import sim3 as jsim3
from ms_slam_tpu.ops import triangulate as jtri
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline import mapping_ops as jmo
from ms_slam_tpu.pipeline import sparsification as jsp
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.models import vocab as tvocab
from ms_slam_tpu_torch.models.map_state import MapConfig
from ms_slam_tpu_torch.ops import ba as tba
from ms_slam_tpu_torch.ops import imu as timu
from ms_slam_tpu_torch.ops import inertial_opt as tio
from ms_slam_tpu_torch.ops import lie as tlie
from ms_slam_tpu_torch.ops import pose_graph as tpg
from ms_slam_tpu_torch.ops import robust as trob
from ms_slam_tpu_torch.ops import sim3 as tsim3
from ms_slam_tpu_torch.ops import triangulate as ttri
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline import mapping_ops as tmo
from ms_slam_tpu_torch.pipeline import sparsification as tsp
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
from ms_slam_tpu_torch.utils import synth
from test_ba import BF as BA_BF
from test_ba import PIN, make_bundle
from test_imu import G, simulate

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass


def T(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# ba_solve without cam_blocked
# ---------------------------------------------------------------------------

def _perturbed_bundle(rng, dup):
    Rs, ts, P, f_cam, f_pt, f_uv, f_ur, F = make_bundle(rng)
    n_cams = Rs.shape[0]
    Rp, tp = Rs.copy(), ts.copy()
    for c in range(2, n_cams):
        dR, dt_ = jlie.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6)))
        Rp[c] = np.asarray(dR) @ Rs[c]
        tp[c] = np.asarray(dR) @ ts[c] + np.asarray(dt_)
    Pp = P + rng.normal(0, 0.05, P.shape)
    if dup:
        # every tenth factor twice, and the table in no particular order
        extra = np.arange(0, F, 10)
        order = rng.permutation(F + len(extra))
        f_cam, f_pt, f_uv, f_ur = (
            np.concatenate([a, a[extra]])[order]
            for a in (f_cam, f_pt, f_uv, f_ur))
        F = len(f_cam)
    cam_opt = np.ones(n_cams, bool)
    cam_opt[:2] = False
    args = (Rp, tp, cam_opt, Pp, np.ones(P.shape[0], bool), f_cam, f_pt,
            f_uv, f_ur, np.ones(F), np.ones(F, bool))
    return Rs, ts, P, args


@pytest.mark.parametrize("dup", [False, True])
def test_ba_solve_arbitrary_table(rng, dup):
    Rs, ts, P, args = _perturbed_bundle(rng, dup)
    rj = jba.ba_solve(jcam.PINHOLE, PIN, jnp.asarray(BA_BF),
                      *[jnp.asarray(a) for a in args], n_iters=15)
    rt = tba.ba_solve(jcam.PINHOLE, torch.from_numpy(np.array(PIN)),
                      BA_BF, *[T(a) for a in args], n_iters=15)
    for name in ("kf_R", "kf_t", "mp_pos"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(rt.f_inlier.numpy(),
                                  np.asarray(rj.f_inlier))
    # tests/test_ba.py's own bars, on the port
    for c in range(2, Rs.shape[0]):
        dR = rt.kf_R[c].numpy() @ Rs[c].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.1 and np.linalg.norm(rt.kf_t[c].numpy() - ts[c]) < 0.03
    assert np.median(np.linalg.norm(rt.mp_pos.numpy() - P, axis=1)) < 0.06


def test_ba_solve_arbitrary_table_fixed_unchanged(rng):
    Rs, ts, P, f_cam, f_pt, f_uv, f_ur, F = make_bundle(rng, n_cams=4)
    rt = tba.ba_solve(
        jcam.PINHOLE, torch.from_numpy(np.array(PIN)), BA_BF, T(Rs), T(ts),
        torch.zeros(4, dtype=torch.bool), T(P),
        torch.zeros(P.shape[0], dtype=torch.bool), T(f_cam), T(f_pt),
        T(f_uv), T(f_ur), torch.ones(F, dtype=torch.float64),
        torch.ones(F, dtype=torch.bool), n_iters=3)
    np.testing.assert_allclose(rt.kf_R.numpy(), Rs, atol=1e-12)
    np.testing.assert_allclose(rt.mp_pos.numpy(), P, atol=1e-12)


# ---------------------------------------------------------------------------
# inertial_window_refine
# ---------------------------------------------------------------------------

def _window_problem(rng, W, n_pts, tbc):
    """tests/test_inertial_window.py's window: a simulated body, its
    preintegrations, landmarks seen from every keyframe, all but the first
    keyframe perturbed."""
    seg = 40
    meas, Rs, vs, ps = simulate(rng, n=(W - 1) * seg, dt=0.005)
    kf_R = np.stack([Rs[i * seg] for i in range(W)])
    kf_p = np.stack([ps[i * seg] for i in range(W)])
    kf_v = np.stack([vs[i * seg] for i in range(W)])
    sts = [jimu.integrate(jnp.zeros(6), jnp.asarray(meas[i * seg:(i + 1)
                                                          * seg]),
                          jnp.ones(seg, bool), jnp.asarray(1e-3),
                          jnp.asarray(1e-2), jnp.asarray(1e-6),
                          jnp.asarray(1e-5)) for i in range(W - 1)]
    stack = jax.tree.map(lambda *a: jnp.stack(a), *sts)
    if tbc:
        R_bc = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.4, 0.1])))
        t_bc = np.array([0.1, -0.06, 0.02])
    else:
        R_bc, t_bc = np.eye(3), np.zeros(3)
    X = rng.uniform(-4, 4, (n_pts, 3))
    X[:, 2] += 10.0
    f_kf, f_uv, f_ur, ok = [], [], [], []
    for k in range(W):
        R_cw = (kf_R[k] @ R_bc).T
        t_cw = -R_cw @ (kf_R[k] @ t_bc + kf_p[k])
        Xc = (R_cw @ X.T).T + t_cw
        uv = np.array(jcam.pinhole_project(jcam.pad_params(
            [350.0, 350.0, 320.0, 240.0]), jnp.asarray(Xc)))
        uv += rng.normal(0, 0.3, uv.shape)
        for i in range(n_pts):
            f_kf.append(k)
            f_uv.append(uv[i])
            f_ur.append(uv[i, 0] - 50.0 / max(Xc[i, 2], 0.1))
            ok.append(Xc[i, 2] > 1)
    F = len(f_kf)
    Rp, pp, vp = kf_R.copy(), kf_p.copy(), kf_v.copy()
    for k in range(1, W):
        Rp[k] = np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, 3)))) @ kf_R[k]
        pp[k] = kf_p[k] + rng.normal(0, 0.05, 3)
        vp[k] = kf_v[k] + rng.normal(0, 0.1, 3)
    args = dict(R_wb=Rp, p_wb=pp, vels=vp, kf_mask=np.ones(W, bool),
                preint_valid=np.ones(W - 1, bool), bg0=np.zeros(3),
                ba0=np.zeros(3), g=G,
                X=np.stack([X[i % n_pts] for i in range(F)]),
                f_kf=np.asarray(f_kf, np.int32), f_uv=np.asarray(f_uv),
                f_ur=np.asarray(f_ur), f_sigma2=np.ones(F),
                f_valid=np.asarray(ok), walk_info=np.full(6, 1e6))
    ext = dict(R_bc=R_bc, t_bc=t_bc) if tbc else {}
    return stack, args, ext, (kf_R, kf_p, kf_v)


@pytest.mark.parametrize("W,n_pts,tbc", [(5, 150, False), (4, 120, True)])
def test_inertial_window_refine(rng, W, n_pts, tbc):
    stack, args, ext, (kf_R, kf_p, kf_v) = _window_problem(rng, W, n_pts,
                                                           tbc)
    pin = jcam.pad_params([350.0, 350.0, 320.0, 240.0])
    rj = jio.inertial_window_refine(
        jcam.PINHOLE, pin, jnp.asarray(50.0),
        **{k: jnp.asarray(v) for k, v in args.items()}, preints=stack,
        **{k: jnp.asarray(v) for k, v in ext.items()})
    pre_t = timu.preint_from_numpy(
        {k: np.asarray(v) for k, v in stack._asdict().items()})
    rt = tio.inertial_window_refine(
        jcam.PINHOLE, torch.from_numpy(np.array(pin)), 50.0,
        **{k: T(v) for k, v in args.items()}, preints=pre_t,
        **{k: T(v) for k, v in ext.items()})
    assert type(rt).__name__ == "WindowRefineResult"
    assert rt._fields == jio.WindowRefineResult._fields
    for name in ("R_wb", "p_wb", "vels", "bg", "ba"):
        np.testing.assert_allclose(getattr(rt, name).numpy(),
                                   np.asarray(getattr(rj, name)),
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-6)
    # tests/test_inertial_window.py's bars, on the port
    for k in range(1, W):
        dR = rt.R_wb[k].numpy() @ kf_R[k].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.15
        assert np.linalg.norm(rt.p_wb[k].numpy() - kf_p[k]) < 0.03
        if not tbc:
            assert np.linalg.norm(rt.vels[k].numpy() - kf_v[k]) < 0.05


# ---------------------------------------------------------------------------
# KeyFrameDatabase.query_brute
# ---------------------------------------------------------------------------

def test_query_brute(rng):
    """tests/test_loop_closing.py's revisit retrieval at 12 places: the same
    candidates and scores from both packages, with and without excluded
    slots; and an empty database answers nothing."""
    P, N = 12, 64
    dbj = jvocab.KeyFrameDatabase(n_words=512, max_kf=P)
    dbt = tvocab.KeyFrameDatabase(n_words=512, max_kf=P, device="cpu")
    assert dbt.query_brute(torch.zeros(P, N, 8, dtype=torch.int32),
                           torch.ones(P, N, dtype=torch.bool),
                           torch.zeros(N, 8, dtype=torch.int32),
                           torch.ones(N, dtype=torch.bool)) == ([], [])
    descs = [rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
             for _ in range(P)]
    for k, d in enumerate(descs):
        if k % 4:          # every fourth slot is no candidate
            dbj.add(k, jnp.asarray(d), jnp.ones(N, bool))
            dbt.add(k, torch.from_numpy(d.view(np.int32)),
                    torch.ones(N, dtype=torch.bool))
    kf_desc = np.stack(descs)
    for k in range(P):
        q = descs[k].copy()
        q[rng.random(N) < 0.25] = rng.integers(0, 2 ** 32, (1, 8),
                                                dtype=np.uint32)
        for exclude in (None, {k, 5}):
            cj, sj = dbj.query_brute(jnp.asarray(kf_desc),
                                     jnp.ones((P, N), bool), jnp.asarray(q),
                                     jnp.ones(N, bool), exclude=exclude)
            ct, st = dbt.query_brute(
                torch.from_numpy(kf_desc.view(np.int32)),
                torch.ones(P, N, dtype=torch.bool),
                torch.from_numpy(q.view(np.int32)),
                torch.ones(N, dtype=torch.bool), exclude=exclude)
            assert ct == cj
            np.testing.assert_allclose(st, sj, rtol=1e-6)
            if k % 4 and exclude is None:
                assert ct[0] == k


# ---------------------------------------------------------------------------
# small leaves
# ---------------------------------------------------------------------------

def test_triangulate_midpoint(rng):
    o1, d1, o2, d2 = (rng.normal(size=(50, 3)) for _ in range(4))
    d2[0] = d1[0]                           # parallel rays: the den guard
    out_j = np.asarray(jtri.triangulate_midpoint(
        *[jnp.asarray(a) for a in (o1, d1, o2, d2)]))
    out_t = ttri.triangulate_midpoint(*[T(a) for a in (o1, d1, o2, d2)])
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-12, atol=1e-12)
    # two rays through one point meet there
    X = np.array([0.3, -0.2, 5.0])
    a, b = np.zeros(3), np.array([0.5, 0.0, 0.0])
    m = ttri.triangulate_midpoint(T(a), T(X - a), T(b), T(2 * (X - b)))
    np.testing.assert_allclose(m.numpy(), X, atol=1e-12)


def test_lie_helpers(rng):
    q = rng.normal(size=(20, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = [1.0, 0.0, 0.0, 0.0]                       # identity branch
    np.testing.assert_allclose(tlie.quat_to_rot(T(q)).numpy(),
                               np.asarray(jlie.quat_to_rot(jnp.asarray(q))),
                               atol=1e-12)
    qp = q * np.where(q[:, :1] < 0, -1.0, 1.0)        # w >= 0 as rot_to_quat
    np.testing.assert_allclose(tlie.quat_log(T(qp)).numpy(),
                               np.asarray(jlie.quat_log(jnp.asarray(qp))),
                               atol=1e-12)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(5, 3)))))
    t = rng.normal(size=(5, 3))
    np.testing.assert_array_equal(
        tlie.se3_matrix(T(R), T(t)).numpy(),
        np.asarray(jlie.se3_matrix(jnp.asarray(R), jnp.asarray(t))))


@pytest.mark.parametrize("name", ["huber_weight", "cauchy_weight",
                                  "tukey_weight"])
def test_robust_weights(rng, name):
    chi2 = np.concatenate([[0.0, 5.991, 7.815], rng.uniform(0, 30, 40)])
    for d2 in (jrob.CHI2_2DOF, jrob.CHI2_3DOF):
        np.testing.assert_allclose(
            getattr(trob, name)(T(chi2), d2).numpy(),
            np.asarray(getattr(jrob, name)(jnp.asarray(chi2), d2)),
            rtol=1e-12, atol=1e-15)


def test_result_types(rng):
    """The solvers return the reference's named results, field for field."""
    assert tpg.Graph4DoFResult._fields == jpg.Graph4DoFResult._fields
    assert tsim3.Sim3RansacResult._fields == jsim3.Sim3RansacResult._fields
    assert tsim3.Sim3RefineResult._fields == jsim3.Sim3RefineResult._fields
    # a three-pose chain through the 4-DoF graph
    R = torch.eye(3, dtype=torch.float64).repeat(3, 1, 1)
    t = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0]],
                     dtype=torch.float64)
    e_R = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1)
    e_t = torch.tensor([[1.0, 0, 0], [1.0, 0, 0]], dtype=torch.float64)
    g = tpg.optimize_pose_graph_4dof(
        R, t, torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64),
        torch.tensor([True, False, False]), torch.tensor([0, 1]),
        torch.tensor([1, 2]), e_R, e_t, torch.ones(2, dtype=torch.float64),
        torch.ones(2, dtype=torch.bool))
    assert isinstance(g, tpg.Graph4DoFResult)
    # a Sim(3) between two views of 40 points
    X1 = rng.uniform(-2, 2, (40, 3)) + np.array([0, 0, 6.0])
    Rt = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.01])))
    X2 = (X1 - np.array([0.3, 0.0, 0.1])) @ Rt
    pin = torch.from_numpy(np.array(PIN))
    ones = torch.ones(40, dtype=torch.float64)
    gen = torch.Generator().manual_seed(7)
    r = tsim3.sim3_ransac(0, pin, T(X1), T(X2), ones, ones,
                          torch.ones(40, dtype=torch.bool), gen, n_hyp=16)
    assert isinstance(r, tsim3.Sim3RansacResult) and int(r.n_inliers) == 40
    uv1 = tcam_project(pin, T(X1))
    uv2 = tcam_project(pin, T(X2))
    f = tsim3.sim3_refine(0, pin, T(X1), T(X2), uv1, uv2, ones, ones,
                          torch.ones(40, dtype=torch.bool), r.s, r.R, r.t)
    assert isinstance(f, tsim3.Sim3RefineResult) and int(f.n_inliers) == 40


def tcam_project(pin, X):
    from ms_slam_tpu_torch.ops import cameras
    return cameras.project(0, pin, X)


# ---------------------------------------------------------------------------
# cull_map_points, triangulate_with and MSSLAM_DUMP_WINDOWS on one map
# ---------------------------------------------------------------------------

H, W, FX, BL = 240, 320, 260.0, 0.15


def _calibs():
    kw = dict(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL, width=W,
              height=H, th_depth=BL * 40, fps=10.0)
    return JCalib(**kw), Calib(**kw)


@pytest.fixture(scope="module")
def port_map():
    """A map from the port's System over 8 arc frames (a keyframe every
    other frame), as numpy."""
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    cfg = SystemConfig(
        calib=_calibs()[1], orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=16, max_mp=4096, n_feat=512, local_mp_cap=2048,
                      window_kf=6, grid_w=16, grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=2)
    slam = System(cfg, device="cpu")
    for i, Tw in enumerate(synth.make_trajectory(30, "arc")[:8]):
        slam.track_stereo(*world.render_stereo(K, Tw, BL, H, W), 0.1 * i)
    slam._flush_pipeline()
    assert len(slam.kf_order) >= 3
    return {"ms": TM.map_state_to_numpy(slam.ms), "kf_order": slam.kf_order,
            "kf_ord": slam.kf_ord}


def _maps(d):
    return (JM.MapState(**{k: jnp.asarray(v) for k, v in d.items()}),
            TM.map_state_from_numpy(d))


def _assert_maps(ms_t, ms_j):
    dj = {k: np.asarray(v) for k, v in ms_j._asdict().items()}
    dt = TM.map_state_to_numpy(ms_t)
    for k, a in dj.items():
        if a.dtype.kind == "f":
            np.testing.assert_allclose(dt[k], a, rtol=1e-3, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(dt[k], a.astype(dt[k].dtype),
                                          err_msg=k)


def test_cull_map_points(port_map):
    """On the map as it is, and with 40 points made young and rarely found
    (found 1 of 8 sightings: the ratio rule)."""
    d = {k: v.copy() for k, v in port_map["ms"].items()}
    live = np.flatnonzero(d["mp_valid"])[:40]
    d["mp_first_ord"][live] = port_map["kf_ord"] - 1
    d["mp_found"][live] = 1
    d["mp_visible"][live] = 8
    counts = []
    for ms_np in (port_map["ms"], d):
        for ord_ in (port_map["kf_ord"], port_map["kf_ord"] + 3):
            rj, nj = jmo.cull_map_points(_maps(ms_np)[0], jnp.asarray(ord_))
            rt, nt = tmo.cull_map_points(TM.map_state_from_numpy(ms_np),
                                         ord_)
            assert int(nt) == int(nj)
            _assert_maps(rt, rj)
            counts.append(int(nt))
    assert counts[2] >= 40


def test_triangulate_with(port_map):
    cj, ct = _calibs()
    oj, ot = JOrbConfig(n_features=512, n_levels=4), OrbConfig(
        n_features=512, n_levels=4)
    a, b = port_map["kf_order"][-1], port_map["kf_order"][-3]
    ms_j, ms_t = _maps(port_map["ms"])
    rj, nj = jmo.triangulate_with(ms_j, cj, oj, jnp.asarray(a),
                                  jnp.asarray(b), jnp.asarray(7))
    rt, nt = tmo.triangulate_with(ms_t, ct, ot, a, b, 7)
    assert int(nt) == int(nj) > 0
    _assert_maps(rt, rj)


def test_dump_windows(port_map, tmp_path, monkeypatch):
    """Each package's Sparsifier solves the same window with
    MSSLAM_DUMP_WINDOWS set: the same file, arrays and scalars."""
    cj, ct = _calibs()
    cfg = SimpleNamespace(
        nonlocal_kf=3, sparsify_window=4, sparsify_queue_min=2,
        sparsify_n=60, sparsify_lambda=500.0, sparsify_grid_lambda=10.0,
        map=SimpleNamespace(grid_w=16, grid_h=12, local_mp_cap=2048))
    batch = port_map["kf_order"][:3]
    out = {}
    for name, sp_mod, calib, ms in (
            ("ref", jsp, cj, _maps(port_map["ms"])[0]),
            ("port", tsp, ct, _maps(port_map["ms"])[1])):
        d = tmp_path / name
        monkeypatch.setenv("MSSLAM_DUMP_WINDOWS", str(d))
        fake = SimpleNamespace(cfg=cfg, calib=calib, ms=ms, kf_db=None,
                               device=torch.device("cpu"), kf_free=[],
                               n_kf=16, _obs_dirty=False)
        sp_mod.Sparsifier(fake)._sparsify(batch)
        out[name] = d
    files = sorted(os.listdir(out["ref"]))
    assert files == sorted(os.listdir(out["port"])) == ["window_000.npz"]
    zj = np.load(out["ref"] / files[0])
    zt = np.load(out["port"] / files[0])
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k].astype(zt[k].dtype),
                                      err_msg=k)
