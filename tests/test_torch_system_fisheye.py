"""The port's stereo-fisheye System against the reference's.

Scenario: tests/test_fisheye.py's end-to-end case as it stands (BoxWorld of
half size 6 m, two Kannala-Brandt8 cameras of fx 150 px with the test's
distortion, 240x320, a pure 0.4 m x-baseline rig, lapping over the whole
width, 512 features, 4 levels, make_trajectory(25, "arc")), through
`track_stereo` of both Systems: the unrectified pair goes through
`process_stereo_fisheye` and no residual downstream is a stereo (3-row)
one (u_right = -1); the port adds its right keypoints as 2-row residuals
through the second lens.

Bars: both end OK with at least 2 keyframes and every frame recorded; the
ATE of each under 3% of the path (test_fisheye.py's bar); keyframe counts
within one of each other; the port's path length within 5% of the truth's
(the port observes each right keypoint through the second lens, which the
reference does not, so their maps' sizes no longer agree).

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

H, W, FX, BL = 240, 320, 150.0, 0.4
KB8P = (FX, FX, W / 2, H / 2, 0.02, -0.005, 0.001, -0.0002)
N_FRAMES = 25


def _cfg(calib_t, orb_t, map_t, cfg_t):
    calib = calib_t(model=1, params=KB8P, bf=FX * BL, width=W, height=H,
                    th_depth=BL * 40, fps=10.0, params2=KB8P,
                    T_rl=(1.0, 0.0, 0.0, -BL, 0.0, 1.0, 0.0, 0.0,
                          0.0, 0.0, 1.0, 0.0),
                    lapping=(0, W - 1, 0, W - 1))
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=64, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6),
                 min_init_depth_points=100, max_frames_between_kf=8)


@pytest.fixture(scope="module")
def runs():
    world = synth.BoxWorld(np.random.default_rng(0), half=6.0)
    poses = synth.make_trajectory(N_FRAMES, "arc")
    frames = [world.render_fisheye_stereo(KB8P, T, BL, H, W) for T in poses]
    out = {"poses": poses}
    for name, slam in (
            ("ref", JSystem(_cfg(JCalib, JOrbConfig, JMapConfig,
                                 JSystemConfig))),
            ("port", System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig),
                            device="cpu"))):
        for i, (l, r) in enumerate(frames):
            slam.track_stereo(l, r, 0.1 * i)
        slam._flush_pipeline()
        out[name] = slam
        out["rows_" + name] = slam.poses_wc()
    return out


@pytest.mark.parametrize("name", ["ref", "port"])
def test_tracks_every_frame(runs, name):
    slam = runs[name]
    assert slam.state == "OK"
    assert slam.keyframes_in_map() >= 2
    assert [e.frame_id for e in slam.trajectory] == list(range(N_FRAMES))
    assert not any(e.lost for e in slam.trajectory)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_ate_under_three_percent(runs, name):
    gt = np.stack([T[:3, 3] for T in runs["poses"]])
    est = np.stack([T[:3, 3] for _, T in runs["rows_" + name]])
    path = np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))
    assert evaluate.ate_rmse(est, gt) < 0.03 * path


def test_map_size_agrees(runs):
    """Keyframe counts within one of the reference's. The points per
    keyframe are no longer compared: the port's solvers observe each right
    keypoint through the second lens and keep the map's scale, which the
    reference leaves free, so its map keeps more points (94.2 against 80.3
    a keyframe, measured on the CPU). In their place a port-only bar: the
    tracked path's length within 5% of the truth's."""
    ref, port = runs["ref"], runs["port"]
    assert abs(port.keyframes_in_map() - ref.keyframes_in_map()) <= 1
    gt = np.stack([T[:3, 3] for T in runs["poses"]])
    est = np.stack([T[:3, 3] for _, T in runs["rows_port"]])
    lengths = [np.linalg.norm(np.diff(p, axis=0), axis=1).sum()
               for p in (est, gt)]
    assert abs(lengths[0] / lengths[1] - 1.0) < 0.05, lengths


def test_fisheye_map_has_no_stereo_rows(runs):
    """The fisheye frontend leaves u_right at -1: no keyframe feature of
    either map carries a right coordinate."""
    for name in ("ref", "port"):
        ms = runs[name].ms
        ur = np.asarray(ms.kp_uright if name == "ref"
                        else ms.kp_uright.numpy())
        kv = np.asarray(ms.kf_valid if name == "ref" else ms.kf_valid.numpy())
        assert (ur[kv] == -1.0).all(), name
