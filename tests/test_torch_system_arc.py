"""The port's System against the reference System over the synthetic arc.

Scenario: tests/test_e2e.py's synthetic arc as it stands (PlaneWorld,
240x320, 512 features, make_trajectory(30, "arc"), noise-free renders),
through both Systems. All 30 frames: the 2% ATE gate is defined on the
whole arc, and on a shorter prefix the reference itself misses it
(measured: 2.1% of the 1.19 m path after 12 frames, 2.4% after 16).

Bars and what was measured (CPU, both packages):
- both end OK with every frame recorded;
- keyframe counts within +-1 and map points within 5% (6 and 6 keyframes,
  512 and 522 points; both create keyframes on the same frames);
- both ATEs under 2% of the 3.20 m path, test_e2e.py's gate (0.97% and
  1.36%);
- RMS of the per-frame position gap between the two under 2% of the path
  (1.09%).

A per-frame bar of 0.5% of the path holds only for the first 7 frames
(gaps 0-6 mm, then 15-70 mm). The frontends agree on >= 99% of keypoints,
not all, and each frame's pose is recorded relative to a keyframe whose
BA-refined pose moves as the window slides. So the two trajectories
separate by about each one's own scatter around ground truth (2-7 cm per
frame), not by float32 rounding.

The whole-System fixture has this file to itself, so that `--dist loadfile`
gives it a worker of its own.
"""

import numpy as np
import pytest
import torch

from ms_slam_tpu.models.map_state import MapConfig as JMapConfig
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu.pipeline.system import System as JSystem
from ms_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from ms_slam_tpu_torch.models.map_state import MapConfig
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline.frontend import Calib, process_stereo_stacked
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
from ms_slam_tpu_torch.utils import evaluate, synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BASELINE = 240, 320, 260.0, 0.15
N_FRAMES = 30


def _cfg(calib_t, orb_t, map_t, cfg_t):
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                    width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=64, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6),
                 min_init_depth_points=100, max_frames_between_kf=8)


def _run(slam, frames):
    for i, (l, r) in enumerate(frames):
        slam.track_stereo(l, r, 0.1 * i)
    return {round(ts, 6): Twc[:3, 3] for ts, Twc in slam.poses_wc()}


@pytest.fixture(scope="module")
def runs():
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(N_FRAMES, "arc")
    frames = [[np.clip(im, 0, 255).astype(np.uint8)
               for im in world.render_stereo(K, T, BASELINE, H, W)]
              for T in poses]
    ref = JSystem(_cfg(JCalib, JOrbConfig, JMapConfig, JSystemConfig))
    port = System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig),
                  device="cpu")
    return {"poses": poses, "frames": frames, "ref": ref, "port": port,
            "pos_ref": _run(ref, frames), "pos_port": _run(port, frames)}


def test_both_track_to_the_end(runs):
    for name in ("ref", "port"):
        slam = runs[name]
        assert slam.state == "OK", name
        assert len(runs["pos_" + name]) == N_FRAMES, name


@pytest.mark.parametrize("name", ["ref", "port"])
def test_every_frame_recorded_in_order(runs, name):
    traj = runs[name].trajectory
    assert [e.frame_id for e in traj] == list(range(N_FRAMES))
    assert not any(e.lost for e in traj)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_ate_under_two_percent(runs, name):
    gt = np.stack([T[:3, 3] for T in runs["poses"]])
    pos = runs["pos_" + name]
    est = np.stack([pos[t] for t in sorted(pos)])
    assert evaluate.ate_rmse(est, gt) < 0.02 * _path_length(runs["poses"])


def test_map_size_agrees(runs):
    ref, port = runs["ref"], runs["port"]
    assert ref.keyframes_in_map() >= 3
    assert abs(port.keyframes_in_map() - ref.keyframes_in_map()) <= 1
    n_ref, n_port = ref.map_points_in_map(), port.map_points_in_map()
    assert n_ref > 150
    assert abs(n_port - n_ref) <= 0.05 * n_ref, (n_port, n_ref)


def test_trajectories_agree(runs):
    gt = np.stack([T[:3, 3] for T in runs["poses"]])
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    ts = sorted(runs["pos_ref"])
    est_ref = np.stack([runs["pos_ref"][t] for t in ts])
    est_port = np.stack([runs["pos_port"][t] for t in ts])
    gap = np.linalg.norm(est_port - est_ref, axis=1)
    assert np.sqrt(np.mean(gap ** 2)) < 0.02 * path, (gap, path)
    for est in (est_ref, est_port):
        assert evaluate.ate_rmse(est, gt) < 0.02 * path


def test_trajectory_export(runs, tmp_path):
    port = runs["port"]
    port.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    port.save_trajectory_tum(str(tmp_path / "tum.txt"))
    rows = np.loadtxt(tmp_path / "kitti.txt")
    assert rows.shape == (N_FRAMES, 12)
    tum = np.loadtxt(tmp_path / "tum.txt")
    np.testing.assert_allclose(tum[:, 1:4], rows[:, [3, 7, 11]], atol=1e-6)
    assert port.memory_stats()["mp_live"] == port.map_points_in_map()


def _path_length(poses):
    gt = np.stack([T[:3, 3] for T in poses])
    return float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))


def test_relocalize_brute_sweep(runs):
    """Without a KFDB (sparsify off) relocalization sweeps every valid
    keyframe: frame 20, re-rendered, relocalizes with >= 15 inliers within
    2% of the path of its ground-truth camera centre, after the Horn
    alignment of the System's own trajectory that test_e2e's ATE applies
    (the map's drift sets the floor: unaligned, the port's tracked frame 20
    is 7.5 cm from the truth and the reference's 2.4 cm)."""
    port = runs["port"]
    assert port.kf_db is None
    frame = process_stereo_stacked(
        torch.from_numpy(np.stack(runs["frames"][20])), port.calib, port.orb)
    saved = (port.ref_kf, port.vel, port.active_map)
    try:
        out = port._relocalize(frame)
    finally:
        port.ref_kf, port.vel, port.active_map = saved
    assert out is not None and int(out.n_inliers) >= 15
    ts = sorted(runs["pos_port"])
    est = np.stack([runs["pos_port"][t] for t in ts])
    gt = np.stack([T[:3, 3] for T in runs["poses"]])
    R_a, t_a, _, _ = evaluate.horn_align(est.T, gt.T)
    c = R_a @ (-out.R.numpy().T @ out.t.numpy()) + t_a[:, 0]
    err = np.linalg.norm(c - gt[20])
    assert err < 0.02 * _path_length(runs["poses"]), err


def test_loss_path_blank_frame(runs):
    """A blank frame fails tracking: with no relocalization candidate and
    fewer than 11 keyframes the System is LOST and records the frame as
    lost; the next real frame relocalizes and tracking resumes."""
    slam = System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig),
                  device="cpu")
    frames = runs["frames"]
    for i in range(3):
        slam.track_stereo(*frames[i], 0.1 * i)
    blank = np.zeros_like(frames[0][0])
    slam.track_stereo(blank, blank, 0.3)
    slam.shutdown()                  # the pipeline completes the blank frame
    assert slam.state == "LOST"
    last = slam.trajectory[-1]
    assert (last.frame_id, last.lost) == (3, True)
    slam.track_stereo(*frames[4], 0.4)
    assert slam.state == "OK"
    assert (slam.trajectory[-1].frame_id, slam.trajectory[-1].lost) == (4,
                                                                        False)
