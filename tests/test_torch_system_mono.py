"""The port's monocular System against the reference's over the synthetic arc.

Scenario: tests/test_mono_rgbd.py's mono case as it stands (PlaneWorld with
the wall at 14 m and the floor at 2 m, 240x320, 512 features, 4 levels,
make_trajectory(30, "arc"), noise-free renders, its `build()` calibration
with bf = fx * 0.15), through `track_monocular` of both Systems. Both
draw their two-view RANSAC tables from their own streams, so the runs are
held to outcomes.

Bars: both initialize, on the same frame or one apart; both end OK with at
least 2 keyframes; the scale-free ATE (Horn with scale) of each under 12%
of the path, test_mono_rgbd.py's bar; and the RMS gap between the two
Systems' trajectories, each Horn-aligned with scale to the ground truth,
under 5% of the path.

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
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
from ms_slam_tpu_torch.utils import evaluate, synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BL = 240, 320, 260.0, 0.15
N_FRAMES = 30


def _cfg(calib_t, orb_t, map_t, cfg_t):
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                    width=W, height=H, th_depth=BL * 40, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=64, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6),
                 min_init_depth_points=100, max_frames_between_kf=8)


def _aligned(rows, gt_by_ts):
    """The trajectory Horn-aligned with scale to the ground truth, and the
    ground truth at the same stamps."""
    est = np.stack([T[:3, 3] for _, T in rows])
    gt = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    R, t, s, _ = evaluate.horn_align(est.T, gt.T, True)
    return (s * R @ est.T + t).T, gt


@pytest.fixture(scope="module")
def runs():
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(N_FRAMES, "arc")
    frames = [world.render(K, T, H, W) for T in poses]
    out = {"poses": poses,
           "gt": {round(0.1 * i, 6): T for i, T in enumerate(poses)}}
    for name, slam in (
            ("ref", JSystem(_cfg(JCalib, JOrbConfig, JMapConfig,
                                 JSystemConfig))),
            ("port", System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig),
                            device="cpu"))):
        for i, img in enumerate(frames):
            slam.track_monocular(img, 0.1 * i)
        slam._flush_pipeline()
        out[name] = slam
        out["rows_" + name] = slam.poses_wc()
    return out


def _init_frame(slam):
    return next(e.frame_id for e in slam.trajectory if not e.lost)


def test_both_initialize_together(runs):
    fj, ft = _init_frame(runs["ref"]), _init_frame(runs["port"])
    assert abs(fj - ft) <= 1, (fj, ft)
    # frames before the initialization are recorded lost and not saved
    for name in ("ref", "port"):
        slam = runs[name]
        assert all(e.lost for e in slam.trajectory
                   if e.frame_id < _init_frame(slam))
        assert len(runs["rows_" + name]) == sum(
            not e.lost for e in slam.trajectory)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_tracks_to_the_end(runs, name):
    slam = runs[name]
    assert slam.state == "OK"
    assert slam.keyframes_in_map() >= 2
    assert slam.trajectory[-1].frame_id == N_FRAMES - 1


@pytest.mark.parametrize("name", ["ref", "port"])
def test_scale_free_ate(runs, name):
    est, gt = _aligned(runs["rows_" + name], runs["gt"])
    path = np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))
    rmse = np.sqrt(np.mean(np.sum((est - gt) ** 2, 1)))
    assert rmse < 0.12 * path, (rmse, path)


def test_trajectories_agree(runs):
    """On the frames both recorded, the two scale-aligned trajectories lie
    within 5% of the path of each other (RMS)."""
    ref, port = (dict(zip((round(ts, 6) for ts, _ in runs["rows_" + n]),
                          _aligned(runs["rows_" + n], runs["gt"])[0]))
                 for n in ("ref", "port"))
    common = sorted(set(ref) & set(port))
    assert len(common) >= N_FRAMES - 4
    gap = np.stack([ref[t] - port[t] for t in common])
    gt = np.stack([runs["gt"][t][:3, 3] for t in common])
    path = np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))
    assert np.sqrt(np.mean(np.sum(gap ** 2, 1))) < 0.05 * path


def test_map_sizes(runs):
    """Both maps hold points; the counts are printed beside each other."""
    n = {k: (runs[k].keyframes_in_map(), runs[k].map_points_in_map())
         for k in ("ref", "port")}
    print("keyframes, map points:", n)
    assert min(n["ref"][1], n["port"][1]) > 100, n
