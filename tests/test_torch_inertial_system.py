"""The port's stereo-inertial System against the reference's.

One whole-System run of both packages: 30 frames of tests/test_inertial_
system.py's scene (PlaneWorld, 320x240, 512 features, the "arc" path at
10 Hz, `synth.make_imu` at 200 Hz, `imu_init_kfs=6, imu_init_time=0.5`).
Bars: both end OK and initialized; each gravity within the reference test's
bars (|g| within 0.5 of 9.81, cos to +y above 0.95) and the two within 1.5
degrees of each other; both ATEs under 2.5% of the path and the RMS gap
between the two trajectories under 2% of it; the inertial step taken on
the frames after initialization (both initialize at about frame 19, so 30
frames hold about ten inertial frames and one gravity refresh; measured:
gravity 0.06 degrees apart, ATE 0.84% both, gap 0.45%). The 65-frame run to
stage 2 and the blackout run are `slow` cases.

Then the reference's final state (map, host lists, inertial state) is
carried into fresh Systems of both packages, which run the same step from
it: `track_full_imu` on the next rendered frame (the reference's own
FrameData on both sides), `_inertial_window_ba` and `_full_inertial_ba`.
Tolerances (float32, five Schur steps or 4 x 64 CG steps on a real map):
window BA rotations 2e-4, translations 2e-3, velocities 4e-3, gravity 2e-3
rad, biases 2e-3, points within 5e-3 for 99% of them; full BA rotations
1e-3, translations 1e-2, gravity 1e-2 rad; `track_full_imu` R 2e-4, t 2e-3,
v 2e-2, bias 2e-3, inliers within 3. (One file for all of it: the
reference's inertial run is the costliest fixture of the port's tests, so
it is made once.)
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.models import map_state as JM
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline import tracking_ops as jto
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu.pipeline.system import System as JSystem
from ms_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline import frontend as tfe
from ms_slam_tpu_torch.pipeline import tracking_ops as tto
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.system import (System, SystemConfig,
                                               inertial_state_from_numpy,
                                               inertial_state_to_numpy)
from ms_slam_tpu_torch.utils import evaluate, synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BL = 240, 320, 260.0, 0.15
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
DT = 0.1


def _cfg(calib_t, orb_t, map_t, cfg_t):
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                    width=W, height=H, th_depth=BL * 40, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=64, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6),
                 min_init_depth_points=100, max_frames_between_kf=3,
                 use_imu=True, imu_init_kfs=6, imu_init_time=0.5)


def _systems():
    return (JSystem(_cfg(JCalib, JOrbConfig, JM.MapConfig, JSystemConfig)),
            System(_cfg(Calib, OrbConfig, TM.MapConfig, SystemConfig),
                   device="cpu"))


def _drive(slam, frames, imu, blank_from=None, blank_to=None):
    states = []
    for i, (l, r) in enumerate(frames):
        if blank_from is not None and blank_from <= i < blank_to:
            l = r = np.zeros((H, W), np.uint8)
        if i == 0:
            slam.track_stereo(l, r, 0.0)
        else:
            slam.track_stereo_imu(l, r, DT * i, imu[i - 1])
        states.append(slam.state)
    slam._flush_pipeline()
    return states


def _scene(n):
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    poses = synth.make_trajectory(n, "arc")
    frames = [world.render_stereo(K, T, BL, H, W) for T in poses]
    return world, poses, frames, synth.make_imu(poses, DT, imu_rate=200)


def _ate(slam, poses, skip=None):
    gt_by_ts = {round(DT * i, 6): T for i, T in enumerate(poses)}
    rows = [(ts, T) for ts, T in slam.poses_wc()
            if skip is None or not skip[0] - 1e-6 <= ts < skip[1] + 1e-6]
    est = np.stack([T[:3, 3] for _, T in rows])
    gt = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    return evaluate.ate_rmse(est, gt), path, {round(ts, 6): T[:3, 3]
                                              for ts, T in rows}


def _gravity_ok(g):
    return abs(np.linalg.norm(g) - 9.81) < 0.5 and g[1] / np.linalg.norm(g) \
        > 0.95


def _angle(a, b):
    a, b = np.float64(a), np.float64(b)
    return float(np.arccos(np.clip(a @ b / np.linalg.norm(a)
                                   / np.linalg.norm(b), -1, 1)))


@pytest.fixture(scope="module")
def runs():
    n = 30
    world, poses, frames, imu = _scene(n + 1)
    ref, port = _systems()
    _drive(ref, frames[:n], imu)
    _drive(port, frames[:n], imu)
    snap = {"ms": {k: np.array(v) for k, v in ref.ms._asdict().items()},
            "inertial": inertial_state_to_numpy(ref),
            "host": {k: getattr(ref, k) for k in HOST_FIELDS},
            "last": (ref.last_R.copy(), ref.last_t.copy())}
    return {"ref": ref, "port": port, "poses": poses, "frames": frames,
            "imu": imu, "snap": snap, "n": n}


# The checks below are small and separate, so that a failure names what
# broke (and the file, which holds one of the suite's longest fixtures, has
# enough cases for xdist's loadfile to schedule it early).

@pytest.mark.parametrize("name", ["ref", "port"])
def test_ends_ok_and_initialized(runs, name):
    slam = runs[name]
    assert slam.state == "OK" and slam.active_map == 0
    assert slam.imu_initialized and slam._imu_stage >= 1


@pytest.mark.parametrize("name", ["ref", "port"])
def test_gravity_within_the_reference_bars(runs, name):
    assert _gravity_ok(runs[name].gravity), runs[name].gravity


@pytest.mark.parametrize("name", ["ref", "port"])
def test_every_frame_has_a_pose(runs, name):
    assert len(runs[name].poses_wc()) == runs["n"]


@pytest.mark.parametrize("name", ["ref", "port"])
def test_imu_segment_bookkeeping(runs, name):
    """One IMU segment and one time per keyframe in temporal order, the
    first segment empty, every later one holding whole frames of 20 rows."""
    slam = runs[name]
    assert len(slam._kf_imu_segments) == len(slam.kf_order) \
        == len(slam._kf_times)
    assert len(slam._kf_imu_segments[0]) == 0
    assert all(len(seg) > 0 and len(seg) % 20 == 0
               for seg in slam._kf_imu_segments[1:])
    assert all(b > a for a, b in zip(slam._kf_times, slam._kf_times[1:]))


@pytest.mark.parametrize("name", ["ref", "port"])
def test_ate_under_the_reference_bar(runs, name):
    rmse, path, _ = _ate(runs[name], runs["poses"])
    assert rmse < 0.025 * path, (rmse, path)


def test_gravities_agree(runs):
    assert _angle(runs["ref"].gravity, runs["port"].gravity) < np.deg2rad(1.5)


def test_keyframe_counts_agree(runs):
    assert abs(len(runs["port"].kf_order) - len(runs["ref"].kf_order)) <= 2


def test_inertial_steps_after_initialization(runs):
    """The first stage was solved once, and the frames dispatched after it
    took the inertial step."""
    port = runs["port"]
    assert len(port.timing["imu_init_stage0"]) == 1
    assert port.imu_frames >= 8
    assert len(port.timing["inertial_window_ba"]) >= 2


def test_biases_agree(runs):
    """(The window BA parks up to 0.04 rad/s of gyro bias about the vertical
    on this path, in both packages.)"""
    ref, port = runs["ref"], runs["port"]
    np.testing.assert_allclose(port.imu_bias[:3], ref.imu_bias[:3], atol=0.02)
    np.testing.assert_allclose(port.imu_bias[3:], ref.imu_bias[3:], atol=0.05)


def test_velocities_agree(runs):
    ref, port = runs["ref"], runs["port"]
    np.testing.assert_allclose(port.vel_w, ref.vel_w, atol=0.05)
    assert np.isfinite(port.kf_velocities).all()


def test_trajectories_agree(runs):
    _, path, pos_r = _ate(runs["ref"], runs["poses"])
    _, _, pos_p = _ate(runs["port"], runs["poses"])
    gap = np.stack([pos_p[t] - pos_r[t] for t in sorted(pos_r)])
    assert np.sqrt(np.mean(np.sum(gap ** 2, 1))) < 0.02 * path


# ---------------------------------------------------------------------------
# Single steps from one carried state: the reference's final state (map, host
# lists, inertial state) goes into fresh Systems of both packages, which run
# the same step from it.
# ---------------------------------------------------------------------------

HOST_FIELDS = ("kf_order", "n_kf", "kf_ord", "kf_maps", "kf_free", "ref_kf",
               "frame_id", "last_kf_frame", "n_inliers_ref", "active_map")


def _from_snapshot(snap):
    """Fresh Systems of both packages holding the reference's final state."""
    ref, port = _systems()
    ref.ms = JM.MapState(**{k: jnp.asarray(v) for k, v in snap["ms"].items()})
    port.ms = TM.map_state_from_numpy(snap["ms"])
    for slam in (ref, port):
        for k, v in snap["host"].items():
            setattr(slam, k, list(v) if isinstance(v, list) else v)
        inertial_state_from_numpy(slam, snap["inertial"])
        slam.last_R, slam.last_t = (a.copy() for a in snap["last"])
        slam.state = "OK"
    return ref, port


def _rot_gap(Ra, Rb):
    """Largest rotation angle between two stacks, from ||Ra Rb^T - I||_F
    (an arccos of a float32 trace resolves no better than 5e-4)."""
    d = np.float64(Ra) @ np.swapaxes(np.float64(Rb), -1, -2) - np.eye(3)
    return float(np.max(np.linalg.norm(d, axis=(-2, -1))) / np.sqrt(2.0))


def _maps(ref, port):
    return ({k: np.asarray(v) for k, v in ref.ms._asdict().items()},
            TM.map_state_to_numpy(port.ms))


@pytest.fixture(scope="module", params=["window", "full"])
def ba(request, runs):
    """Both packages after `_inertial_window_ba` (the last six keyframes)
    or `_full_inertial_ba` (the whole chain) from the carried state, with
    the tolerances (rotation, translation, gravity angle) of each."""
    ref, port = _from_snapshot(runs["snap"])
    if request.param == "window":
        slots = ref.kf_order[-6:]
        ref._inertial_window_ba(slots[-1])
        port._inertial_window_ba(slots[-1])
        tols = (2e-4, 2e-3, 2e-3)
    else:
        slots = list(ref.kf_order)
        ref._full_inertial_ba()
        port._full_inertial_ba()
        tols = (1e-3, 1e-2, 1e-2)
    mj, mt = _maps(ref, port)
    return {"ref": ref, "port": port, "slots": slots, "tols": tols, "mj": mj,
            "mt": mt, "kind": request.param,
            "before": runs["snap"]["ms"]["kf_t"]}


def test_ba_keyframe_poses_agree(ba):
    rot, tr, _ = ba["tols"]
    sl = ba["slots"]
    assert _rot_gap(ba["mt"]["kf_R"][sl], ba["mj"]["kf_R"][sl]) < rot
    np.testing.assert_allclose(ba["mt"]["kf_t"][sl], ba["mj"]["kf_t"][sl],
                               atol=tr)
    # and the solve moved them
    assert np.abs(ba["mt"]["kf_t"][sl] - ba["before"][sl]).max() > 1e-5


def test_ba_velocities_agree(ba):
    tr, sl = ba["tols"][1], ba["slots"]
    np.testing.assert_allclose(ba["port"].kf_velocities[sl],
                               ba["ref"].kf_velocities[sl], atol=tr * 2)
    np.testing.assert_allclose(ba["port"].vel_w, ba["ref"].vel_w, atol=tr * 2)


def test_ba_gravity_and_bias_agree(ba):
    ref, port = ba["ref"], ba["port"]
    assert _angle(port.gravity, ref.gravity) < ba["tols"][2]
    assert _gravity_ok(port.gravity)
    np.testing.assert_allclose(port.imu_bias, ref.imu_bias, atol=2e-3)
    # the device-side inertial chain restarts from the new estimates
    assert port._v_dev is None and port._bias_dev is None


def test_ba_points_agree(ba):
    ok = ba["mj"]["mp_valid"]
    gap = np.abs(ba["mt"]["mp_pos"][ok] - ba["mj"]["mp_pos"][ok]).max(1)
    assert (gap > 2.5 * ba["tols"][1]).mean() < 0.01, np.sort(gap)[-5:]
    assert np.isfinite(ba["mt"]["mp_pos"]).all()


def test_ba_leaves_the_other_keyframes(ba):
    """The window BA writes its six keyframes only (the rest are fixed
    anchors); the full BA writes the whole chain and nothing else."""
    port = ba["port"]
    others = np.setdiff1d(np.arange(ba["before"].shape[0]), ba["slots"])
    np.testing.assert_array_equal(ba["mt"]["kf_t"][others],
                                  ba["before"][others])
    assert np.isfinite(ba["mt"]["kf_t"]).all()
    assert len(port.kf_order) == len(ba["ref"].kf_order)


def test_full_inertial_ba_skips_a_cut_chain(runs):
    """The chain is the active map's suffix: cut to fewer than three
    keyframes by a map switch, it is left alone."""
    port = _from_snapshot(runs["snap"])[1]
    port.kf_maps = [0] * len(port.kf_maps)
    port.kf_maps[port.kf_order[-2]] = 1
    port.active_map = 0
    t0 = port.ms.kf_t.clone()
    port._full_inertial_ba()
    assert torch.equal(port.ms.kf_t, t0)


@pytest.fixture(scope="module")
def imu_step(runs):
    """One inertial tracking step on the next frame, both packages from the
    same state and the same FrameData (the reference's)."""
    from ms_slam_tpu.pipeline import frontend as jfe
    snap, n = runs["snap"], runs["n"]
    ref, port = _from_snapshot(snap)
    l, r = runs["frames"][n]
    fj = jfe.process_stereo_stacked(
        jnp.asarray(np.stack([ref._as_uint8(l), ref._as_uint8(r)])),
        ref.calib, ref.orb)
    fd = {k: np.asarray(v) for k, v in fj.feats._asdict().items()}
    fd.update(u_right=np.asarray(fj.u_right), depth=np.asarray(fj.depth),
              sigma2=np.asarray(fj.sigma2))
    ft = tfe.frame_data_from_numpy(fd)
    rows, valid = System._pad_imu_rows(
        np.asarray(runs["imu"][n - 1], np.float32))
    cfg = port.cfg
    noise = (cfg.imu_noise_gyro, cfg.imu_noise_acc, cfg.imu_gyro_walk,
             cfg.imu_acc_walk)
    last = snap["ms"]["obs_mp"][ref.ref_kf]
    f32 = np.float32
    oj = jto.track_full_imu(
        ref.ms, ref.calib, ref.orb, fj, jnp.asarray(ref.last_R),
        jnp.asarray(ref.last_t), jnp.asarray(ref.vel_w),
        jnp.asarray(ref.imu_bias), jnp.asarray(rows), jnp.asarray(valid),
        jnp.asarray(ref.gravity), jnp.asarray(noise, f32),
        jnp.eye(3, dtype=f32), jnp.zeros(3, f32), jnp.asarray(last),
        jnp.asarray(ref.ref_kf), cfg.map.local_mp_cap,
        JM.mp_obs_count(ref.ms), JM.observer_mask(ref.ms))
    ot = tto.track_full_imu(
        port.ms, port.calib, port.orb, ft, torch.from_numpy(port.last_R),
        torch.from_numpy(port.last_t), torch.from_numpy(port.vel_w),
        torch.from_numpy(port.imu_bias), torch.from_numpy(rows),
        torch.from_numpy(valid), torch.from_numpy(port.gravity), noise,
        torch.eye(3), torch.zeros(3), torch.from_numpy(last), port.ref_kf,
        cfg.map.local_mp_cap, TM.mp_obs_count(port.ms),
        TM.observer_mask(port.ms), n_rows=int(valid.sum()))
    return {"oj": oj, "ot": ot, "sj": np.asarray(oj.stats),
            "st": ot.stats.numpy()}


def test_track_full_imu_stats_pack(imu_step):
    sj, st, ot = imu_step["sj"], imu_step["st"], imu_step["ot"]
    assert st.shape == sj.shape == (42,)
    np.testing.assert_array_equal(st[13:15], sj[13:15])     # branches taken
    np.testing.assert_allclose(st[33:36], ot.v.numpy(), atol=1e-6)
    np.testing.assert_allclose(st[36:42], ot.bias.numpy(), atol=1e-6)


def test_track_full_imu_inliers_and_matches(imu_step):
    sj, st = imu_step["sj"], imu_step["st"]
    assert sj[15] > 100 and abs(st[15] - sj[15]) <= 3, (st[12:21], sj[12:21])
    agree = (imu_step["ot"].matched_mp.numpy()
             == np.asarray(imu_step["oj"].matched_mp)).mean()
    assert agree > 0.98, agree


def test_track_full_imu_pose(imu_step):
    oj, ot = imu_step["oj"], imu_step["ot"]
    assert _rot_gap(ot.R.numpy(), oj.R) < 2e-4
    np.testing.assert_allclose(ot.t.numpy(), oj.t, atol=2e-3)


def test_track_full_imu_velocity_and_bias(imu_step):
    oj, ot = imu_step["oj"], imu_step["ot"]
    np.testing.assert_allclose(ot.v.numpy(), oj.v, atol=2e-2)
    np.testing.assert_allclose(ot.bias.numpy(), oj.bias, atol=2e-3)


def test_track_full_imu_follows_the_truth(runs, imu_step):
    """The step's camera motion is the rendered one, within 5 cm."""
    ot, snap, n = imu_step["ot"], runs["snap"], runs["n"]
    c = -ot.R.numpy().T @ ot.t.numpy()
    c_prev = -snap["last"][0].T @ snap["last"][1]
    step = runs["poses"][n][:3, 3] - runs["poses"][n - 1][:3, 3]
    assert np.linalg.norm((c - c_prev) - step) < 0.05


@pytest.mark.slow
@pytest.mark.parametrize("case", ["stage2", "blackout"])
def test_long_inertial_runs(case):
    """tests/test_inertial_system.py's two long cases through the port: 65
    frames reach stage 2 with the ATE under 2.5% of the path; an 8-frame
    blackout after initialization is bridged on IMU propagation
    (RECENTLY_LOST seen, OK and the same map at the end, ATE over the
    visible frames under 6%)."""
    n = 65 if case == "stage2" else 70
    _, poses, frames, imu = _scene(n)
    port = _systems()[1]
    if case == "stage2":
        _drive(port, frames, imu)
        skip, bar = None, 0.025
    else:
        states = _drive(port, frames, imu, 45, 53)
        assert "RECENTLY_LOST" in states
        skip, bar = (4.5, 5.3), 0.06
    assert port.state == "OK" and port.active_map == 0
    assert port.imu_initialized and port._imu_stage >= 2
    assert _gravity_ok(port.gravity)
    rmse, path, _ = _ate(port, poses, skip)
    assert rmse < bar * path, (rmse, path)
