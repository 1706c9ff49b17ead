"""Parity of the port's map pools, tracking step, window BA and keyframe
step with the JAX reference.

The reference initialises a map from frame 0 of the synthetic arc
(tests/test_e2e.py geometry: 240x320, 512 features) exactly as
System._stereo_initialization does; its MapState and FrameData cross over
as numpy arrays (map_state_from_numpy / frame_data_from_numpy), so both
sides start every step from identical state.

Tolerances and why:
- map-pool bookkeeping (counts, masks, compaction, slot allocation):
  exact — integer scatter/gather with the reference's tie rules.
- geometry written into the pools: rtol 1e-5 (float32 rounding).
- track_full on frame 1: n_inliers within ±2, R and t within 1e-4 — 60 LM
  iterations of float32 sums in another order, with chi2 gates between
  rounds that can flip a marginal observation.
- ba_solve (cam_blocked=True): rtol 1e-4 on a duplicate-free problem —
  the reference accumulates the point blocks through a bf16 hi/lo split
  (~1e-5 relative), the port in plain f32.
- keyframe_step: new stereo points and window slots exact; triangulated
  points, BA factors, outliers, culled points and tracked observations
  within 2% (+2): descriptor ties in mutual matching and float32 BA
  residuals at the chi2 gates can flip single observations; BA-refined
  point positions within 0.1% (far points are weakly constrained along
  their rays by a two-keyframe window).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.models import map_state as JM
from ms_slam_tpu.ops import ba as jba
from ms_slam_tpu.ops import cameras as jcam
from ms_slam_tpu.ops import lie as jlie
from ms_slam_tpu.ops import orb as jorb
from ms_slam_tpu.pipeline import frontend as jfe
from ms_slam_tpu.pipeline import mapping_ops as jmo
from ms_slam_tpu.pipeline import tracking_ops as jto
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.ops import ba as tba
from ms_slam_tpu_torch.ops import orb as torb
from ms_slam_tpu_torch.pipeline import frontend as tfe
from ms_slam_tpu_torch.pipeline import mapping_ops as tmo
from ms_slam_tpu_torch.pipeline import tracking_ops as tto
from ms_slam_tpu_torch.utils import synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BASELINE = 240, 320, 260.0, 0.15
CJ = jfe.Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
               width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
CT = tfe.Calib(*CJ)
OJ = jorb.OrbConfig(n_features=512, n_levels=4)
OT = torb.OrbConfig(*OJ)
MJ = JM.MapConfig(max_kf=64, max_mp=8192, n_feat=512, local_mp_cap=2048,
                  window_kf=6)
MT = TM.MapConfig(*MJ)
KF_ARGS = dict(n_tri=4, window_kf=6, n_fixed=4, pt_cap=2048, ba_iters=8)


def ms_np(ms):
    return {k: np.asarray(v) for k, v in ms._asdict().items()}


def fd_np(f):
    d = {k: np.asarray(v) for k, v in f.feats._asdict().items()}
    d.update(u_right=np.asarray(f.u_right), depth=np.asarray(f.depth),
             sigma2=np.asarray(f.sigma2))
    return d


def assert_state_close(d_t, d_j, rtol=1e-5, atol=1e-5, skip=()):
    for k, a in d_j.items():
        if k in skip:
            continue
        b = d_t[k]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.fixture(scope="module")
def ref():
    """Reference run: frontend on frames 0-1, stereo initialisation,
    track_full on frame 1, keyframe_step on frame 1 — every state as
    numpy."""
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(30, "arc")
    frames = []
    for T in poses[:2]:
        l, r = (np.clip(im, 0, 255).astype(np.uint8)
                for im in world.render_stereo(K, T, BASELINE, H, W))
        frames.append(jfe.process_stereo(jnp.asarray(l), jnp.asarray(r),
                                         CJ, OJ))
    out = {"f0": fd_np(frames[0]), "f1": fd_np(frames[1])}
    eye, zero = jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)
    ms, n_new = jmo.create_keyframe(
        JM.empty_map(MJ), CJ, jnp.asarray(0), frames[0], eye, zero,
        jnp.full((512,), -1, jnp.int32), jnp.asarray(0), jnp.asarray(0),
        jnp.asarray(1e9))
    out["ms0"], out["n_new0"] = ms_np(ms), int(n_new)
    tr = jto.track_full(ms, CJ, OJ, frames[1], eye, zero, eye, zero,
                        jnp.asarray(False), ms.obs_mp[0], jnp.asarray(0),
                        MJ.local_mp_cap, JM.mp_obs_count(ms),
                        JM.observer_mask(ms))
    out["tr"] = {k: np.asarray(getattr(tr, k))
                 for k in ("R", "t", "matched_mp", "stats")}
    out["ms1"] = ms_np(tr.ms)
    ko = jmo.keyframe_step(
        tr.ms, CJ, OJ, jnp.asarray(1), frames[1], tr.R, tr.t, tr.matched_mp,
        jnp.asarray(1), jnp.asarray(1), jnp.asarray(CJ.th_depth), **KF_ARGS)
    out["ko"] = {"info": np.asarray(ko.info), "n_obs": np.asarray(ko.n_obs),
                 "obs_mask": np.asarray(ko.obs_mask)}
    out["ms2"] = ms_np(ko.ms)
    return out


def test_map_state_numpy_roundtrip(ref):
    ms = TM.map_state_from_numpy(ref["ms0"])
    assert ms.kp_desc.dtype == torch.int32
    assert_state_close(TM.map_state_to_numpy(ms), ref["ms0"], rtol=0, atol=0)


def test_create_keyframe_parity(ref):
    ms, n_new = tmo.create_keyframe(
        TM.empty_map(MT), CT, 0, tfe.frame_data_from_numpy(ref["f0"]),
        torch.eye(3), torch.zeros(3), torch.full((512,), -1,
                                                 dtype=torch.int32), 0, 0, 1e9)
    assert int(n_new) == ref["n_new0"] > 300
    assert_state_close(TM.map_state_to_numpy(ms), ref["ms0"])


def test_track_full_parity(ref):
    ms = TM.map_state_from_numpy(ref["ms0"])
    eye, zero = torch.eye(3), torch.zeros(3)
    out = tto.track_full(ms, CT, OT, tfe.frame_data_from_numpy(ref["f1"]),
                         eye, zero, eye, zero, False, ms.obs_mp[0].clone(), 0,
                         MT.local_mp_cap, TM.mp_obs_count(ms),
                         TM.observer_mask(ms))
    s_t, s_j = out.stats.numpy(), ref["tr"]["stats"]
    n_inl_j = s_j[15]
    assert n_inl_j > 150
    assert abs(s_t[15] - n_inl_j) <= 2, (s_t[12:21], s_j[12:21])
    # motion-model stage (2x5 LM, chi2 re-gate): within 3% (+2)
    assert abs(s_t[12] - s_j[12]) <= 0.03 * s_j[12] + 2
    np.testing.assert_array_equal(s_t[13:15], s_j[13:15])   # branches taken
    np.testing.assert_allclose(out.R.numpy(), ref["tr"]["R"], atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), ref["tr"]["t"], atol=1e-4)
    agree = (out.matched_mp.numpy() == ref["tr"]["matched_mp"]).mean()
    assert agree >= 0.99, agree
    # point statistics were updated in place, as the reference's donated ms
    d = TM.map_state_to_numpy(ms)
    for k in ("mp_visible", "mp_found"):
        assert np.abs(d[k] - ref["ms1"][k]).sum() <= 4, k


def test_local_keyframes_paths_agree(ref):
    ms = TM.map_state_from_numpy(ref["ms1"])
    matched = torch.from_numpy(ref["tr"]["matched_mp"].copy())
    i1, m1 = tto.local_keyframes(ms, matched, 10,
                                 obs_mask=TM.observer_mask(ms))
    ij, mj = jto.local_keyframes(JM.MapState(**{
        k: jnp.asarray(v) for k, v in ref["ms1"].items()}),
        jnp.asarray(ref["tr"]["matched_mp"]), 10,
        obs_mask=jnp.asarray(JM.observer_mask(JM.MapState(**{
            k: jnp.asarray(v) for k, v in ref["ms1"].items()}))))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(mj))


def test_keyframe_step_parity(ref):
    ms = TM.map_state_from_numpy(ref["ms1"])
    tr = ref["tr"]
    ko = tmo.keyframe_step(
        ms, CT, OT, 1, tfe.frame_data_from_numpy(ref["f1"]),
        torch.from_numpy(tr["R"]), torch.from_numpy(tr["t"]),
        torch.from_numpy(tr["matched_mp"]), 1, 1, CT.th_depth, **KF_ARGS)
    it, ij = ko.info.numpy(), ref["ko"]["info"]
    assert it.shape == ij.shape == (18 + 2 * 6,)
    assert it[0] == ij[0]                          # new stereo points
    for i in range(1, 6):                          # tri, factors, outliers,
        assert abs(it[i] - ij[i]) <= 0.02 * abs(ij[i]) + 2, (i, it, ij)
    np.testing.assert_allclose(it[6:18], ij[6:18], atol=1e-4)   # KF pose
    np.testing.assert_array_equal(it[18:], ij[18:])             # slots
    assert ij[2] > 500                                          # BA ran
    d = TM.map_state_to_numpy(ko.ms)
    valid_j, valid_t = ref["ms2"]["mp_valid"], d["mp_valid"]
    assert (valid_j != valid_t).sum() <= 0.02 * valid_j.sum() + 2
    both = valid_j & valid_t
    # BA-refined points within 0.1% of their ~13 m depth: a two-keyframe
    # window constrains far points weakly along their viewing rays
    np.testing.assert_allclose(d["mp_pos"][both], ref["ms2"]["mp_pos"][both],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fn", ["mp_obs_count", "observer_mask",
                                "covisibility_counts", "local_map_mask",
                                "gather_local_points", "alloc_map_slots",
                                "refresh_mp_refs",
                                "recompute_mp_descriptors", "best_covisible",
                                "keyframe_redundancy"])
def test_map_pool_functions_exact(ref, fn):
    """Pool bookkeeping on the post-keyframe map, bit for bit."""
    d = ref["ms2"]
    mj = JM.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    mt = TM.map_state_from_numpy(d)
    K = d["kf_valid"].shape[0]
    sel = np.zeros(K, bool)
    sel[:2] = True
    new_mask = np.arange(512) % 3 == 0
    calls = {
        "mp_obs_count": lambda M, m, a: M.mp_obs_count(m),
        "observer_mask": lambda M, m, a: M.observer_mask(m),
        "covisibility_counts": lambda M, m, a: M.covisibility_counts(m, 1),
        "local_map_mask": lambda M, m, a: M.local_map_mask(
            m, a(np.arange(K)), a(sel)),
        "gather_local_points": lambda M, m, a: M.gather_local_points(
            m, a(d["mp_valid"]), 2048),
        "alloc_map_slots": lambda M, m, a: M.alloc_map_slots(m, a(new_mask)),
        "refresh_mp_refs": lambda M, m, a: M.refresh_mp_refs(m).mp_first_kf,
        "recompute_mp_descriptors": lambda M, m, a: tuple(
            M.recompute_mp_descriptors(m, None)[1:3]),
        "best_covisible": lambda M, m, a: M.best_covisible(m, 1, 3),
        "keyframe_redundancy": lambda M, m, a: (
            tmo if M is TM else jmo).keyframe_redundancy(m, 1, OJ.n_levels),
    }
    oj = calls[fn](JM, mj, jnp.asarray)
    ot = calls[fn](TM, mt, lambda a: torch.from_numpy(np.asarray(a)))
    oj = oj if isinstance(oj, tuple) else (oj,)
    ot = ot if isinstance(ot, tuple) else (ot,)
    for a, b in zip(oj, ot):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a)


def make_blocked_bundle(rng, n_cams=6, n_pts=120, noise=0.2, dup=False):
    """tests/test_ba.py's arc of cameras around a point cloud, as a
    camera-blocked (C, P) factor table, float32."""
    pin = np.asarray([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)
    bf = 40.0
    P = rng.uniform(-5, 5, size=(n_pts, 3))
    P[:, 2] += 12.0
    Rs, ts = [], []
    for c in range(n_cams):
        xi = np.array([0.8 * c, 0.05 * c, 0.02 * c,
                       0.01 * c, 0.03 * c, -0.01 * c]) * 0.3
        R, t = jlie.se3_exp(jnp.asarray(xi))
        Rs.append(np.asarray(R))
        ts.append(np.asarray(t))
    Rs, ts = np.stack(Rs), np.stack(ts)
    f_cam = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    f_pt = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    Xc = np.einsum("cij,pj->cpi", Rs, P) + ts[:, None]
    uv = np.asarray(jcam.pinhole_project(jnp.asarray(pin, jnp.float64),
                                         jnp.asarray(Xc)))
    f_valid = ((Xc[..., 2] > 1) & (uv[..., 0] > 0) & (uv[..., 0] < 640)
               & (uv[..., 1] > 0) & (uv[..., 1] < 480)).reshape(-1)
    f_uv = uv.reshape(-1, 2) + rng.normal(0, noise, (n_cams * n_pts, 2))
    f_ur = (uv[..., 0] - bf / Xc[..., 2]).reshape(-1) \
        + rng.normal(0, noise, n_cams * n_pts)
    if dup:
        # point 1's observation in camera 2 repeated in point 7's row
        a, b = 2 * n_pts + 1, 2 * n_pts + 7
        f_pt[b], f_valid[b] = 1, f_valid[a]
        f_uv[b], f_ur[b] = f_uv[a], f_ur[a]
    Rp, tp = Rs.copy(), ts.copy()
    for c in range(2, n_cams):
        dR, dt_ = jlie.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6)))
        Rp[c] = np.asarray(dR) @ Rs[c]
        tp[c] = np.asarray(dR) @ ts[c] + np.asarray(dt_)
    Pp = P + rng.normal(0, 0.05, P.shape)
    cam_opt = np.arange(n_cams) >= 2
    f32 = np.float32
    return [pin, np.float32(bf), Rp.astype(f32), tp.astype(f32), cam_opt,
            Pp.astype(f32), np.ones(n_pts, bool), f_cam, f_pt,
            f_uv.astype(f32), f_ur.astype(f32), np.ones(n_cams * n_pts, f32),
            f_valid]


@pytest.mark.parametrize("dup", [False, True])
def test_ba_solve_parity(rng, dup):
    """Duplicate-free problem at rtol 1e-4; with one duplicated (point,
    camera) factor both sides keep the LAST occurrence (the reference's
    CPU scatter) and flag the other as an outlier."""
    args = make_blocked_bundle(rng, dup=dup)
    rj = jba.ba_solve(0, *[jnp.asarray(a) for a in args], n_iters=8,
                      cam_blocked=True)
    rt = tba.ba_solve(0, *[torch.from_numpy(np.asarray(a)) for a in args],
                      n_iters=8, cam_blocked=True)
    np.testing.assert_allclose(rt.kf_R.numpy(), np.asarray(rj.kf_R),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rt.kf_t.numpy(), np.asarray(rj.kf_t),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rt.mp_pos.numpy(), np.asarray(rj.mp_pos),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(rt.f_inlier.numpy(), np.asarray(rj.f_inlier))
    if dup:
        n = 120
        inl = rt.f_inlier.numpy()
        assert not inl[2 * n + 1] and inl[2 * n + 7]
