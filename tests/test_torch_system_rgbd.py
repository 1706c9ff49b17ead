"""The port's RGB-D System against the reference's, and localization mode.

Scenario: tests/test_mono_rgbd.py's RGB-D case as it stands (PlaneWorld with
the wall at 14 m and the floor at 2 m, 240x320, 512 features, 4 levels,
make_trajectory(25, "arc"), depth from `render_rgbd`), through
`track_rgbd` of both Systems.

Bars: both end OK with every frame recorded; the ATE of each under 2% of
the path (test_mono_rgbd.py's bar); keyframe and map-point counts within
10% of each other.

Localization mode, on the first 20 frames of the same renders: 9 frames
mapped, then `activate_localization_mode()` for 6 frames, during which both
Systems stay OK, create no keyframe and keep their map-point count; then
`deactivate_localization_mode()` and 5 more frames, in which keyframes
resume. The pipeline is flushed at each switch, so the frame in flight
there is decided under the mode it was tracked in.

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
N_FRAMES = 25
LOC = (9, 15, 20)     # mapping until frame 9, localization until 15, then 5


def _cfg(calib_t, orb_t, map_t, cfg_t):
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                    width=W, height=H, th_depth=BL * 40, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=64, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6),
                 min_init_depth_points=100, max_frames_between_kf=8)


def _both():
    return (("ref", JSystem(_cfg(JCalib, JOrbConfig, JMapConfig,
                                 JSystemConfig))),
            ("port", System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig),
                            device="cpu")))


def _localization_leg(slam, frames):
    """The mapped / localization / resumed leg; returns what it saw."""
    a, b, c = LOC
    seen = {}
    for i in range(a):
        slam.track_rgbd(*frames[i], 0.1 * i)
    slam._flush_pipeline()
    seen["before"] = (slam.kf_ord, slam.map_points_in_map())
    slam.activate_localization_mode()
    states = []
    for i in range(a, b):
        slam.track_rgbd(*frames[i], 0.1 * i)
        states.append(slam.state)
    slam._flush_pipeline()
    states.append(slam.state)
    seen["states"] = states
    seen["during"] = (slam.kf_ord, slam.map_points_in_map())
    seen["lost"] = [e.frame_id for e in slam.trajectory if e.lost]
    slam.deactivate_localization_mode()
    for i in range(b, c):
        slam.track_rgbd(*frames[i], 0.1 * i)
    slam._flush_pipeline()
    seen["after"] = (slam.kf_ord, slam.state)
    return seen


@pytest.fixture(scope="module")
def runs():
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(N_FRAMES, "arc")
    frames = [world.render_rgbd(K, T, H, W) for T in poses]
    out = {"poses": poses}
    for name, slam in _both():
        for i, (img, depth) in enumerate(frames):
            slam.track_rgbd(img, depth, 0.1 * i)
        slam._flush_pipeline()
        out[name] = slam
        out["rows_" + name] = slam.poses_wc()
    for name, slam in _both():
        out["loc_" + name] = _localization_leg(slam, frames)
    return out


@pytest.mark.parametrize("name", ["ref", "port"])
def test_tracks_every_frame(runs, name):
    slam = runs[name]
    assert slam.state == "OK"
    assert [e.frame_id for e in slam.trajectory] == list(range(N_FRAMES))
    assert not any(e.lost for e in slam.trajectory)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_ate_under_two_percent(runs, name):
    gt = np.stack([T[:3, 3] for T in runs["poses"]])
    est = np.stack([T[:3, 3] for _, T in runs["rows_" + name]])
    path = np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))
    assert evaluate.ate_rmse(est, gt) < 0.02 * path


def test_map_size_agrees(runs):
    ref, port = runs["ref"], runs["port"]
    for fn in ("keyframes_in_map", "map_points_in_map"):
        n_ref, n_port = getattr(ref, fn)(), getattr(port, fn)()
        assert n_ref >= 2
        assert abs(n_port - n_ref) <= 0.1 * n_ref, (fn, n_ref, n_port)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_localization_mode_freezes_the_map(runs, name):
    seen = runs["loc_" + name]
    assert all(s == "OK" for s in seen["states"]), seen["states"]
    assert seen["lost"] == []
    assert seen["during"] == seen["before"]          # no keyframe, no point
    n_kf, state = seen["after"]
    assert state == "OK"
    assert n_kf > seen["before"][0]                  # keyframes resume


def test_localization_mode_same_in_both(runs):
    """Both Systems mapped the same number of keyframes before the switch
    and both resumed after it."""
    sj, st = runs["loc_ref"], runs["loc_port"]
    assert sj["before"][0] == st["before"][0]
    assert abs(sj["before"][1] - st["before"][1]) <= 0.1 * sj["before"][1]
    assert runs["port"].cfg.localization_only is False
