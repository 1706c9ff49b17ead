"""Parity of the port's `pipeline/loop_closing.py` with the JAX reference on
a map from a short reference run, and the loop-closing slice as a whole
(the solvers underneath are held in test_torch_loop_closing.py; the
whole-slice fixture has this file to itself so that `--dist loadfile`
gives it a worker).

A 16-frame reference run on the BoxWorld orbit gives a map that is cut in
two and drifted in numpy; both packages verify, refine, correct a loop and
merge two maps from it. RANSAC index tables are injected into both sides
(the reference's `jax.random.choice` is patched under its unjitted
functions).

Tolerances:
- _verify_pair / detect_and_verify / refine_hypothesis: candidate slots,
  scores (rtol 1e-4) and integer counts within 2 (a reprojection at the
  chi2 gate can fall either side), s/R 1e-4, t 2e-3;
- _apply_window_correction, _reanchor_points, _apply_sim3_graph: 1e-5
  rotations, 1e-4 translations and points (closed-form float32);
- global_ba: R 1e-4, t and points 1e-3;
- the slice as a whole (_correct_loop, _merge_maps from one injected state):
  keyframe rotations 5e-4, translations 5e-3 (fusion, pose graph and two
  global-BA sweeps chained; the merge adds the weld BA); points 5e-3 for
  all but 0.5% of them, which stay within 5e-2; point validity differs on
  at most 2 points and the observation table on under 0.1% of its entries;
  kf_maps and loop_edges equal;
- the inertial correction (4-DoF graph, then the whole-chain inertial BA)
  is held on outcomes, stated in its tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ms_slam_tpu.models import map_state as JM
from ms_slam_tpu.ops import sim3 as jsim3
from ms_slam_tpu_torch.models import map_state as TM

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

PIN = np.asarray([300.0, 300.0, 160.0, 120.0, 0, 0, 0, 0], np.float32)


def _t(a):
    """numpy (or jax) -> torch, uint32 descriptor words as int32 bits."""
    a = np.array(a)                  # a private, writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _j(a):
    return jnp.asarray(a)


def _rot_close(Ra, Rb, tol):
    np.testing.assert_allclose(np.asarray(Ra), np.asarray(Rb), atol=tol)


# ---------------------------------------------------------------------------
# ops/sim3.py
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# pipeline/loop_closing.py on a map from a short reference run
# ---------------------------------------------------------------------------

from ms_slam_tpu.models import vocab as jv                      # noqa: E402
from ms_slam_tpu.models.map_state import MapConfig as JMapConfig  # noqa: E402
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig         # noqa: E402
from ms_slam_tpu.pipeline import loop_closing as jlc            # noqa: E402
from ms_slam_tpu.pipeline import mapping_ops as jmo             # noqa: E402
from ms_slam_tpu.pipeline.frontend import Calib as JCalib       # noqa: E402
from ms_slam_tpu.pipeline.system import System as JSystem       # noqa: E402
from ms_slam_tpu.pipeline.system import \
    SystemConfig as JSystemConfig                               # noqa: E402
from ms_slam_tpu_torch.ops.orb import OrbConfig                 # noqa: E402
from ms_slam_tpu_torch.pipeline import loop_closing as tlc      # noqa: E402
from ms_slam_tpu_torch.pipeline import mapping_ops as tmo       # noqa: E402
from ms_slam_tpu_torch.pipeline.frontend import Calib           # noqa: E402
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig  # noqa: E402
from ms_slam_tpu_torch.utils import synth                       # noqa: E402

H, W, FX, BL = 240, 320, 260.0, 0.15
N_EARLY = 6
DRIFT_R = Rotation.from_rotvec([0.01, 0.05, -0.01]).as_matrix()
DRIFT_T = np.array([0.25, -0.05, 0.15])


def _cfg(calib_t, orb_t, map_t, cfg_t, **kw):
    """tests/test_loop_closing.py's orbit configuration, with a smaller
    keyframe pool and a keyframe every other frame."""
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                    width=W, height=H, th_depth=BL * 45, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=24, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6, grid_w=16,
                           grid_h=12),
                 min_init_depth_points=100, max_frames_between_kf=2, **kw)


def _inject_drift(d, kf_order, n_early):
    """Cut the map in two and drift the later half, in numpy.

    Points that both the first `n_early` keyframes (in creation order) and
    the later ones observe are duplicated: the later keyframes' observations
    move to the copies, so the two groups share no point (covisibility 0
    across the cut, as between a revisit and the place it revisits). Then
    the later keyframes and every point they observe are moved rigidly by
    (DRIFT_R, DRIFT_T): X' = D X, T_cw' = T_cw D^-1. Reference-keyframe
    links are re-pointed to the oldest observer on the point's own side."""
    d = {k: np.array(v) for k, v in d.items()}
    early, late = kf_order[:n_early], kf_order[n_early:]
    obs = d["obs_mp"]
    Mc = d["mp_valid"].shape[0]

    def pts(kfs):
        o = obs[kfs]
        return np.unique(o[o >= 0])
    shared = np.intersect1d(pts(early), pts(late))
    free = np.flatnonzero(~d["mp_valid"] & (d["mp_quarantine"] <= 0))
    free = free[-len(shared):]
    remap = np.arange(Mc)
    remap[shared] = free
    for name in d:
        if name.startswith("mp_"):
            d[name][free] = d[name][shared]
    for k in late:
        obs[k] = np.where(obs[k] >= 0, remap[obs[k].clip(0)], obs[k])
    for side in (early, late):
        by_age = sorted(side, key=lambda k: d["kf_ord"][k], reverse=True)
        for k in by_age:                      # the oldest observer wins
            p = obs[k][obs[k] >= 0]
            d["mp_first_kf"][p] = k
            d["mp_first_ord"][p] = d["kf_ord"][k]
    moved = pts(late)
    d["mp_pos"][moved] = (d["mp_pos"][moved] @ DRIFT_R.T
                          + DRIFT_T).astype(np.float32)
    d["mp_normal"][moved] = (d["mp_normal"][moved]
                             @ DRIFT_R.T).astype(np.float32)
    for k in late:
        R_new = d["kf_R"][k] @ DRIFT_R.T
        d["kf_t"][k] = (d["kf_t"][k] - R_new @ DRIFT_T).astype(np.float32)
        d["kf_R"][k] = R_new.astype(np.float32)
    return d, early, late


@pytest.fixture(scope="module")
def loop_state():
    """A map from 16 frames of the reference System on the BoxWorld orbit
    (11 keyframes), cut and drifted by `_inject_drift`, as a numpy dict both
    packages start from; BoW rows for every keyframe from the reference's
    vocabulary (bit-exact between the packages)."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    world = synth.BoxWorld(np.random.default_rng(0), half=7.0)
    poses = synth.make_trajectory(80, "orbit")[:16]
    ref = JSystem(_cfg(JCalib, JOrbConfig, JMapConfig, JSystemConfig))
    for i, T in enumerate(poses):
        ref.track_stereo(*world.render_stereo(K, T, BL, H, W), 0.1 * i)
    ref._flush_pipeline()
    assert ref.state == "OK" and len(ref.kf_order) >= 9
    clean = {k: np.array(v) for k, v in ref.ms._asdict().items()}
    kf_order = [int(k) for k in ref.kf_order]
    d, early, late = _inject_drift(clean, kf_order, N_EARLY)
    cb = jv.make_codebook(2048)
    rows = np.zeros((d["kf_valid"].shape[0], 2048), np.float32)
    for k in kf_order:
        rows[k] = np.asarray(jv.bow_vector(cb, _j(d["kp_desc"][k]),
                                           _j(d["kp_valid"][k])))
    present = np.zeros(len(rows), bool)
    present[early] = True                 # the sparsified side
    has_row = np.zeros(len(rows), bool)
    has_row[kf_order] = True
    return {"clean": clean, "d": d, "kf_order": kf_order, "early": early,
            "late": late, "rows": rows, "present": present,
            "has_row": has_row, "n_kf": ref.n_kf}


def _jms(d):
    return JM.MapState(**{k: _j(v) for k, v in d.items()})


def _calibs():
    return (_cfg(JCalib, JOrbConfig, JMapConfig, JSystemConfig).calib,
            _cfg(Calib, OrbConfig, TM.MapConfig, SystemConfig).calib)


def _table(rng, d, a, b, n=128):
    """A RANSAC index table drawn over keyframe a's features that hold a
    map point (most of them pair up), for both packages."""
    ok = np.flatnonzero(d["kp_valid"][a] & (d["obs_mp"][a] >= 0))
    return rng.choice(ok, (n, 3)).astype(np.int32)


def _ref_verify_pair(monkeypatch, d, a, b, idx):
    """The reference's `_verify_pair_impl`, its RANSAC unjitted (so that no
    compiled program keeps the table) and drawing `idx`."""
    monkeypatch.setattr(jax.random, "choice", lambda *a_, **k: _j(idx))
    monkeypatch.setattr(jsim3, "sim3_ransac", jsim3.sim3_ransac.__wrapped__)
    cj, _ = _calibs()
    return jlc._verify_pair_impl(_jms(d), cj, _j(np.int32(a)),
                                 _j(np.int32(b)), jax.random.PRNGKey(0))


def _true_S_cm(st, cur, match):
    """(R, t) taking match-camera coords to cur-camera coords in the map
    before the drift was injected."""
    c = st["clean"]
    R = c["kf_R"][cur] @ c["kf_R"][match].T
    return R, c["kf_t"][cur] - R @ c["kf_t"][match]


def test_inject_drift_cuts_covisibility(loop_state):
    st = loop_state
    cov = TM.covisibility_matrix(TM.map_state_from_numpy(st["d"])).numpy()
    assert cov[np.ix_(st["early"], st["late"])].max() == 0
    assert cov[np.ix_(st["late"], st["late"])].max() > 100
    clean = TM.covisibility_matrix(
        TM.map_state_from_numpy(st["clean"])).numpy()
    assert clean[np.ix_(st["early"], st["late"])].max() > 100


def test_verify_pair(rng, monkeypatch, loop_state):
    st = loop_state
    d = st["d"]
    cur, match = st["late"][0], st["early"][-1]
    idx = _table(rng, d, cur, match)
    nj, sj, Rj, tj = _ref_verify_pair(monkeypatch, d, cur, match, idx)
    _, ct = _calibs()
    nt, s_t, Rt, tt = tlc._verify_pair(TM.map_state_from_numpy(d), ct, cur,
                                       match, idx=_t(idx))
    assert int(nj) >= 3 * tlc.MIN_RANSAC_INLIERS
    assert abs(int(nt) - int(nj)) <= 2
    assert float(s_t) == float(sj) == 1.0
    _rot_close(Rt, Rj, 1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=2e-3)
    # and it is the relative pose the drift hid
    R_true, t_true = _true_S_cm(st, cur, match)
    _rot_close(Rt, R_true, 5e-3)
    np.testing.assert_allclose(tt.numpy(), t_true, atol=5e-2)
    # the port's own draws reach the same pose
    g = torch.Generator().manual_seed(7)
    n2, _, R2, t2 = tlc._verify_pair(TM.map_state_from_numpy(d), ct, cur,
                                     match, g)
    assert int(n2) >= 3 * tlc.MIN_RANSAC_INLIERS
    _rot_close(R2, R_true, 5e-3)


def test_detect_and_verify(rng, monkeypatch, loop_state):
    """The query keyframe is the newest one; the candidates are the early
    (sparsified) keyframes, none covisible with it. Every candidate rank
    gets the same index table in both packages."""
    st = loop_state
    d = st["d"]
    cur = st["late"][0]
    idx = _table(rng, d, cur, None)
    monkeypatch.setattr(jax.random, "choice", lambda *a_, **k: _j(idx))
    monkeypatch.setattr(jsim3, "sim3_ransac", jsim3.sim3_ransac.__wrapped__)
    cj, ct = _calibs()
    pj, gj = jlc.detect_and_verify.__wrapped__(
        _jms(d), cj, _j(np.int32(cur)), _j(st["present"]), _j(st["has_row"]),
        _j(st["rows"]), jax.random.PRNGKey(0), _j(np.float32(0.05)),
        with_scale=False)
    pt, gt = tlc.detect_and_verify(
        TM.map_state_from_numpy(d), ct, cur, _t(st["present"]),
        _t(st["has_row"]), _t(st["rows"]), None, 0.05, with_scale=False,
        idx_tables=[_t(idx)] * 3)
    pj, pt = np.asarray(pj), pt.numpy()
    assert pt.shape == pj.shape == (3, 16) and pt.dtype == np.float32
    np.testing.assert_array_equal(pt[:, 0], pj[:, 0])        # candidates
    assert set(pt[:, 0].astype(int)) <= set(st["early"])
    np.testing.assert_allclose(pt[:, 1], pj[:, 1], rtol=1e-4)  # scores
    assert np.abs(pt[:, 2] - pj[:, 2]).max() <= 2              # inliers
    assert pj[:, 2].max() >= 3 * tlc.MIN_RANSAC_INLIERS
    ok = pj[:, 2] >= tlc.MIN_RANSAC_INLIERS
    np.testing.assert_allclose(pt[ok, 3], pj[ok, 3], atol=1e-4)
    np.testing.assert_allclose(pt[ok, 4:7], pj[ok, 4:7], atol=2e-3)
    np.testing.assert_allclose(pt[ok, 7:], pj[ok, 7:], atol=1e-4)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    # a floor above every score skips verification: (0, 1, 0, I) rows
    ps, _ = tlc.detect_and_verify(
        TM.map_state_from_numpy(d), ct, cur, _t(st["present"]),
        _t(st["has_row"]), _t(st["rows"]), None, 2.0, with_scale=False)
    np.testing.assert_array_equal(ps[:, 2:].numpy(), np.tile(
        np.r_[0, 1, 0, 0, 0, np.eye(3).ravel()].astype(np.float32), (3, 1)))
    np.testing.assert_array_equal(ps[:, 0].numpy(), pj[:, 0])


def _hypothesis(st, cur, match):
    """S_lw of a hypothesis anchored at `cur`: S_cw = S_cm * T_mw."""
    R_cm, t_cm = _true_S_cm(st, cur, match)
    Rm, tm = st["d"]["kf_R"][match], st["d"]["kf_t"][match]
    return (np.float32(1.0), (R_cm @ Rm).astype(np.float32),
            (R_cm @ tm + t_cm).astype(np.float32))


def test_refine_hypothesis(loop_state):
    st = loop_state
    d = st["d"]
    match, last_cur, cur = st["early"][-1], st["late"][0], st["late"][1]
    s0, R0, t0 = _hypothesis(st, last_cur, match)
    cj, ct = _calibs()
    pj = np.asarray(jlc.refine_hypothesis(
        _jms(d), cj, _j(np.int32(cur)), _j(np.int32(match)),
        _j(np.int32(last_cur)), _j(s0), _j(R0), _j(t0), with_scale=False,
        pt_cap=2048))
    pt = tlc.refine_hypothesis(TM.map_state_from_numpy(d), ct, cur, match,
                               last_cur, _t(s0), _t(R0), _t(t0),
                               with_scale=False, pt_cap=2048).numpy()
    assert pt.shape == pj.shape == (16,) and pt.dtype == np.float32
    assert pj[0] >= 30 and pj[1] >= 30 and pj[2] >= 30
    assert np.abs(pt[:3] - pj[:3]).max() <= 2
    np.testing.assert_allclose(pt[3], pj[3], atol=1e-4)
    np.testing.assert_allclose(pt[4:7], pj[4:7], atol=2e-3)
    np.testing.assert_allclose(pt[7:], pj[7:], atol=1e-4)


def test_apply_window_correction(loop_state):
    st = loop_state
    d = st["d"]
    cur = st["late"][-1]
    win = np.zeros(len(st["rows"]), bool)
    win[st["late"]] = True
    sc = np.float32(1.1)
    Rc = (Rotation.from_rotvec([0.02, -0.04, 0.01]).as_matrix()
          @ d["kf_R"][cur]).astype(np.float32)
    tc = (d["kf_t"][cur] + [0.2, -0.1, 0.3]).astype(np.float32)
    mj = jlc._apply_window_correction(_jms(d), _j(win), _j(sc), _j(Rc),
                                      _j(tc), _j(np.int32(cur)))
    mt = tlc._apply_window_correction(TM.map_state_from_numpy(d), _t(win),
                                      _t(sc), _t(Rc), _t(tc), cur)
    _rot_close(mt.kf_R, mj.kf_R, 1e-5)
    np.testing.assert_allclose(mt.kf_t.numpy(), np.asarray(mj.kf_t),
                               atol=1e-4)
    np.testing.assert_allclose(mt.mp_pos.numpy(), np.asarray(mj.mp_pos),
                               atol=1e-4)
    # the current keyframe lands on the corrected pose (t stored as t/s)
    _rot_close(mt.kf_R[cur], Rc, 1e-5)
    np.testing.assert_allclose(mt.kf_t[cur].numpy(), tc / sc, atol=1e-4)
    early = st["early"]
    np.testing.assert_array_equal(mt.kf_t[early].numpy(), d["kf_t"][early])


def _perturbed_poses(rng, d):
    K = d["kf_R"].shape[0]
    dR = Rotation.from_rotvec(rng.normal(0, 0.02, (K, 3))).as_matrix()
    return (np.einsum("kij,kjl->kil", dR, d["kf_R"]).astype(np.float32),
            (d["kf_t"] + rng.normal(0, 0.1, (K, 3))).astype(np.float32))


def test_reanchor_points(rng, loop_state):
    d = loop_state["d"]
    R_new, t_new = _perturbed_poses(rng, d)
    dn = dict(d, kf_R=R_new, kf_t=t_new)
    mj = jlc._reanchor_points(_jms(dn), _j(d["kf_R"]), _j(d["kf_t"]))
    mt = tlc._reanchor_points(TM.map_state_from_numpy(dn), _t(d["kf_R"]),
                              _t(d["kf_t"]))
    np.testing.assert_allclose(mt.mp_pos.numpy(), np.asarray(mj.mp_pos),
                               atol=1e-4)
    v = d["mp_valid"]
    assert np.abs(mt.mp_pos.numpy()[v] - d["mp_pos"][v]).max() > 0.05
    np.testing.assert_array_equal(mt.mp_pos.numpy()[~v], d["mp_pos"][~v])


def test_apply_sim3_graph(rng, loop_state):
    d = loop_state["d"]
    R_new, t_new = _perturbed_poses(rng, d)
    s_new = (1.0 + rng.normal(0, 0.05, len(t_new))).astype(np.float32)
    mj = jlc._apply_sim3_graph(_jms(d), _j(d["kf_R"]), _j(d["kf_t"]),
                               _j(s_new), _j(R_new), _j(t_new))
    mt = tlc._apply_sim3_graph(TM.map_state_from_numpy(d), _t(d["kf_R"]),
                               _t(d["kf_t"]), _t(s_new), _t(R_new),
                               _t(t_new))
    _rot_close(mt.kf_R, mj.kf_R, 1e-6)
    np.testing.assert_allclose(mt.kf_t.numpy(), np.asarray(mj.kf_t),
                               atol=1e-5)
    np.testing.assert_allclose(mt.mp_pos.numpy(), np.asarray(mj.mp_pos),
                               atol=1e-4)
    np.testing.assert_allclose(mt.kf_t.numpy(), t_new / s_new[:, None],
                               atol=1e-6)


def test_global_ba(loop_state):
    d = loop_state["clean"]
    match = loop_state["early"][0]
    cj, ct = _calibs()
    mj = jmo.global_ba(_jms(d), cj, JOrbConfig(n_features=512, n_levels=4),
                       _j(np.int32(match)), n_sweeps=2)
    ms_t = TM.map_state_from_numpy(d)
    mt = tmo.global_ba(ms_t, ct, OrbConfig(n_features=512, n_levels=4),
                       match, n_sweeps=2)
    v, kv = d["mp_valid"], d["kf_valid"]
    _rot_close(mt.kf_R[kv], np.asarray(mj.kf_R)[kv], 1e-4)
    np.testing.assert_allclose(mt.kf_t.numpy()[kv], np.asarray(mj.kf_t)[kv],
                               atol=1e-3)
    np.testing.assert_allclose(mt.mp_pos.numpy()[v],
                               np.asarray(mj.mp_pos)[v], atol=1e-3)
    np.testing.assert_allclose(mt.kf_t[match].numpy(), d["kf_t"][match],
                               atol=1e-6)
    assert np.abs(mt.mp_pos.numpy()[v] - d["mp_pos"][v]).max() > 1e-3
    # the argument's tensors are left as they were
    np.testing.assert_array_equal(ms_t.mp_pos.numpy(), d["mp_pos"])


# ---------------------------------------------------------------------------
# The slice as a whole: both Systems start from one injected state
# ---------------------------------------------------------------------------

def _both_systems(st, kf_maps=None, **kw):
    """A reference System and a port System (CPU) holding the drifted map,
    with the same host lists."""
    ref = JSystem(_cfg(JCalib, JOrbConfig, JMapConfig, JSystemConfig,
                       loop_closing=True, loop_covis_min=30, **kw))
    port = System(_cfg(Calib, OrbConfig, TM.MapConfig, SystemConfig,
                       loop_closing=True, loop_covis_min=30, **kw),
                  device="cpu")
    ref.ms = _jms(st["d"])
    port.ms = TM.map_state_from_numpy(st["d"])
    for slam in (ref, port):
        slam.kf_order = list(st["kf_order"])
        slam.n_kf = st["n_kf"]
        slam.kf_maps = list(kf_maps) if kf_maps is not None \
            else [0] * st["n_kf"]
        slam.active_map = slam.kf_maps[st["late"][-1]]
        slam.ref_kf = st["late"][-1]
        slam.state = "OK"
    return ref, port


def _compare_maps(ref, port):
    mj = {k: np.asarray(v) for k, v in ref.ms._asdict().items()}
    mt = TM.map_state_to_numpy(port.ms)
    kv = mj["kf_valid"]
    np.testing.assert_array_equal(mt["kf_valid"], kv)
    _rot_close(mt["kf_R"][kv], mj["kf_R"][kv], 5e-4)
    np.testing.assert_allclose(mt["kf_t"][kv], mj["kf_t"][kv], atol=5e-3)
    both = mj["mp_valid"] & mt["mp_valid"]
    assert (mj["mp_valid"] != mt["mp_valid"]).sum() <= 2
    gap = np.abs(mt["mp_pos"][both] - mj["mp_pos"][both]).max(1)
    assert (gap > 5e-3).mean() < 5e-3 and gap.max() < 5e-2, gap.max()
    assert (mt["obs_mp"] != mj["obs_mp"]).mean() < 1e-3
    return mj, mt


def _centre_err(ms_np, st, kfs):
    """Camera-centre distance of keyframes from their pose in the map
    before the drift."""
    c = st["clean"]
    got = -np.einsum("kji,kj->ki", ms_np["kf_R"][kfs], ms_np["kf_t"][kfs])
    want = -np.einsum("kji,kj->ki", c["kf_R"][kfs], c["kf_t"][kfs])
    return np.linalg.norm(got - want, axis=1)


def test_correct_loop_whole_slice(rng, monkeypatch, loop_state):
    """Both packages verify the same pair with the same draws, get the same
    (cur, match, S_cm), correct the loop from it and agree on the map."""
    st = loop_state
    d = st["d"]
    cur, match = st["late"][-1], st["early"][-1]
    idx = _table(rng, d, cur, match)
    nj, sj, Rj, tj = _ref_verify_pair(monkeypatch, d, cur, match, idx)
    monkeypatch.undo()
    ref, port = _both_systems(st)
    nt, s_t, Rt, tt = tlc._verify_pair(port.ms, port.calib, cur, match,
                                       idx=_t(idx))
    assert min(int(nj), int(nt)) >= tlc.MIN_RANSAC_INLIERS
    _rot_close(Rt, Rj, 1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=2e-3)
    S_cm = (1.0, np.asarray(Rj, np.float32), np.asarray(tj, np.float32))
    before = _centre_err(TM.map_state_to_numpy(port.ms), st, st["late"])
    ref._loop_closer._correct_loop(cur, match, *S_cm)
    port._loop_closer._correct_loop(cur, match, *S_cm)
    mj, mt = _compare_maps(ref, port)
    assert port._loop_closer.loop_edges == ref._loop_closer.loop_edges \
        == [(cur, match)]
    assert port._loop_closer.stats["loops"] == 1
    assert port.kf_maps == ref.kf_maps
    # most of the drift is gone: the drift moved the later keyframes 0.3 m
    # from where the clean map had them, the correction leaves under 0.1 m
    # (this pair is the widest apart, so its verified S_cm the coarsest)
    after = _centre_err(mt, st, st["late"])
    assert before.min() > 0.25 and after.max() < 0.1, (before, after)
    # tracking state was reset onto the corrected current keyframe
    assert port.vel is None and port._Rt_dev is None
    np.testing.assert_allclose(port.last_t, mt["kf_t"][cur], atol=1e-6)
    np.testing.assert_allclose(port.last_t, ref.last_t, atol=5e-3)


def test_merge_maps_whole_slice(loop_state):
    """The later keyframes form a second Atlas map; the merge moves all of
    them by the weld transform, relabels them and optimizes the joint
    graph. Both packages agree on the result."""
    st = loop_state
    cur, match = st["late"][0], st["early"][-1]
    kf_maps = [0] * st["n_kf"]
    for k in st["late"]:
        kf_maps[k] = 1
    ref, port = _both_systems(st, kf_maps)
    assert port.active_map == 1
    R_cm, t_cm = _true_S_cm(st, cur, match)
    S_cm = (1.0, R_cm.astype(np.float32), t_cm.astype(np.float32))
    ref._loop_closer._merge_maps(cur, match, *S_cm)
    port._loop_closer._merge_maps(cur, match, *S_cm)
    _, mt = _compare_maps(ref, port)
    assert port.kf_maps == ref.kf_maps == [0] * st["n_kf"]
    assert port.active_map == ref.active_map == 0
    assert port._loop_closer.stats["merges"] == 1
    assert port._loop_closer.loop_edges == ref._loop_closer.loop_edges
    assert _centre_err(mt, st, st["late"]).max() < 0.1   # 0.3 m before


def test_confirm_routes_by_map_label(loop_state):
    """_confirm turns the held S_cw back into S_cm and takes the loop or
    the merge path by the two keyframes' map labels."""
    st = loop_state
    cur, match = st["late"][0], st["early"][-1]
    for labels, want in (([0, 0], "loop"), ([0, 1], "merge")):
        kf_maps = [0] * st["n_kf"]
        for k in st["late"]:
            kf_maps[k] = labels[1]
        _, port = _both_systems(st, kf_maps)
        lc = port._loop_closer
        calls = []
        lc._correct_loop = lambda *a: calls.append(("loop",) + a)
        lc._merge_maps = lambda *a: calls.append(("merge",) + a)
        lc._hyp = {"match": match, "last_cur": cur,
                   "S_lw": _hypothesis(st, cur, match), "n_coin": 3,
                   "n_notfound": 0}
        lc._confirm(cur)
        assert lc._hyp is None and len(calls) == 1
        kind, c, m, s, R_cm, t_cm = calls[0]
        assert (kind, c, m, float(s)) == (want, cur, match, 1.0)
        R_true, t_true = _true_S_cm(st, cur, match)
        _rot_close(R_cm, R_true, 1e-5)
        np.testing.assert_allclose(t_cm, t_true, atol=1e-4)


# ---------------------------------------------------------------------------
# A loop correction in inertial mode: the 4-DoF essential graph (yaw about
# gravity and translation), then the whole-chain inertial BA
# ---------------------------------------------------------------------------

def _inertial_state_by_hand(st):
    """The inertial host state the drifted map would carry had the run been
    stereo-inertial: IMU rows synthesized along the true orbit and cut at
    the keyframes' frames, velocities by central differences of the true
    camera centres (camera = body), gravity along +y, zero bias, stage 2."""
    poses = synth.make_trajectory(80, "orbit")[:16]
    imu = synth.make_imu(poses, 0.1, imu_rate=200)
    fid = [int(st["d"]["kf_frame_id"][k]) for k in st["kf_order"]]
    centres = np.stack([T[:3, 3] for T in poses])
    vel = np.gradient(centres, 0.1, axis=0)
    kf_vel = np.zeros((st["d"]["kf_valid"].shape[0], 3), np.float32)
    kf_vel[st["kf_order"]] = vel[fid]
    segs = [np.zeros((0, 7), np.float32)] + [
        np.concatenate(imu[a:b]).astype(np.float32)
        for a, b in zip(fid[:-1], fid[1:])]
    return {"imu_initialized": True, "_imu_stage": 2,
            "_last_gravity_refit": 15.0,
            "gravity": np.array([0.0, 9.81, 0.0], np.float32),
            "imu_bias": np.zeros(6, np.float32),
            "vel_w": kf_vel[st["kf_order"][-1]].copy(),
            "kf_velocities": kf_vel, "_kf_imu_segments": segs,
            "_kf_times": [0.1 * f for f in fid], "_imu_accum": [],
            "_last_ts": 0.1 * fid[-1], "_prev_completed_ts": 0.1 * fid[-1]}


def _angle_deg(a, b):
    return np.degrees(np.arccos(np.clip(
        np.float64(a) @ np.float64(b) / np.linalg.norm(a)
        / np.linalg.norm(b), -1, 1)))


@pytest.fixture(scope="module")
def corrected(loop_state):
    """The port corrects a loop from the drifted map in inertial mode: the
    inertial state is set by hand (stage 2: gravity observed), the loop's
    relative pose is the true one. (Parity with the reference is held piece
    by piece: the 4-DoF graph in test_torch_loop_closing.py, `vi_full_ba`
    and `_full_inertial_ba` in test_torch_inertial_ba.py and
    test_torch_inertial_system.py; the reference's own run of this
    correction would cost this file another 20 s.)"""
    from ms_slam_tpu_torch.pipeline.system import inertial_state_from_numpy
    st = loop_state
    cur, match = st["late"][-1], st["early"][-1]
    port = System(_cfg(Calib, OrbConfig, TM.MapConfig, SystemConfig,
                       loop_closing=True, loop_covis_min=30, use_imu=True),
                  device="cpu")
    port.ms = TM.map_state_from_numpy(st["d"])
    port.kf_order = list(st["kf_order"])
    port.n_kf = st["n_kf"]
    port.kf_maps = [0] * st["n_kf"]
    port.ref_kf = cur
    port.state = "OK"
    inertial_state_from_numpy(port, _inertial_state_by_hand(st))
    assert port._loop_closer._inertial_ready()
    R_cm, t_cm = _true_S_cm(st, cur, match)
    before = _centre_err(TM.map_state_to_numpy(port.ms), st, st["late"])
    yaw_before = port.ms.kf_R[cur].clone()
    port._loop_closer._correct_loop(cur, match, 1.0, R_cm.astype(np.float32),
                                    t_cm.astype(np.float32))
    return {"port": port, "before": before, "st": st, "pair": (cur, match),
            "R_before": yaw_before.numpy(),
            "mt": TM.map_state_to_numpy(port.ms)}


def test_inertial_correction_keeps_gravity(corrected):
    """The graph may only redistribute yaw and translation, and the inertial
    BA that follows refines the direction by a small angle: gravity stays
    within 2 degrees of +y at its norm."""
    g = corrected["port"].gravity
    assert np.isfinite(g).all()
    assert _angle_deg(g, [0.0, 1.0, 0.0]) < 2.0, g
    assert abs(np.linalg.norm(g) - 9.81) < 1e-2


def test_inertial_correction_turns_about_gravity(corrected):
    """The current keyframe's world rotation changed by a turn that is
    nearly all yaw (the injected drift is 0.05 rad of yaw and 0.014 rad of
    pitch and roll; the 4-DoF graph cannot take the latter out, the BAs that
    follow may)."""
    cur = corrected["pair"][0]
    dR = corrected["R_before"].T @ corrected["mt"]["kf_R"][cur]
    w = Rotation.from_matrix(dR).as_rotvec()
    assert abs(w[1]) > 0.03 and np.hypot(w[0], w[2]) < 0.03, w


def test_inertial_correction_chain_finite(corrected):
    port, mt = corrected["port"], corrected["mt"]
    assert np.isfinite(port.kf_velocities).all()
    assert np.isfinite(port.imu_bias).all()
    assert np.abs(port.imu_bias[:3]).max() < 0.05
    assert np.isfinite(mt["kf_t"]).all() and np.isfinite(mt["mp_pos"]).all()
    # the chain's velocities stay near the orbit's (0.63 m/s at most)
    assert np.abs(port.kf_velocities).max() < 1.5


def test_inertial_correction_removes_the_drift(corrected):
    """The drift moved the later keyframes 0.3 m from where the clean map
    had them; the correction leaves under 0.15 m."""
    after = _centre_err(corrected["mt"], corrected["st"],
                        corrected["st"]["late"])
    assert corrected["before"].min() > 0.25 and after.max() < 0.15, after
    assert corrected["port"]._loop_closer.loop_edges == [corrected["pair"]]
    assert corrected["port"]._loop_closer.stats["loops"] == 1
    # tracking restarts from the corrected current keyframe
    port = corrected["port"]
    assert port.vel is None and port._Rt_dev is None and port._v_dev is None
