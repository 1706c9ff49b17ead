"""The port's mono-inertial System against the reference's, as far as the IMU
initialization.

Scenario: tests/test_inertial_system.py's mono-inertial case (PlaneWorld with
the wall at 14 m and the floor at 2 m, 240x320, 512 features, 4 levels,
bf = 0, make_trajectory(70, "arc_excited"), `synth.make_imu` at 200 Hz,
max_frames_between_kf=3, its imu_init_time=1.0), frame 0 through
`track_monocular` and every later frame through `track_monocular_imu`,
with `imu_init_kfs=6` instead of 8 so that the initialization comes after
about a second; each System stops at the frame after which it is
initialized (at most MAX_FRAMES). The 70-frame metric-scale run is held on
the card (chip_smoke.py phase 12).

Bars: both initialize; the metric scale each estimates agrees within 10%,
read as the Horn scale of each System's trajectory against the ground truth
right after its initialization (the map and the recorded trajectory are
rescaled there; measured on the CPU: 1.70 and 1.72, both initialized at
frame 11, applying 4.757 and 3.832 to maps whose monocular scales
differed); the gravity of each within 0.6 of 9.81 m/s^2 with
g_y / |g| > 0.9 (the reference test's bars); and the first IMU segment
after the monocular initialization holds exactly the rows of the frames
between the two initial keyframes.

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

H, W, FX = 240, 320, 260.0
N_POSES = 70
MAX_FRAMES = 40
DT = 0.1


def _cfg(calib_t, orb_t, map_t, cfg_t):
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=0.0,
                    width=W, height=H, th_depth=0.0, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=64, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6),
                 max_frames_between_kf=3, use_imu=True, imu_init_kfs=6,
                 imu_init_time=1.0)


def _run(slam, frame, imu, poses):
    scales, segs = [], {}
    apply = slam._apply_map_scale

    def recorded(s):
        scales.append(float(s))
        return apply(s)
    slam._apply_map_scale = recorded
    n = 0
    for i in range(MAX_FRAMES):
        img = frame(i)
        if i == 0:
            slam.track_monocular(img, 0.0)
        else:
            slam.track_monocular_imu(img, DT * i, imu[i - 1])
        n = i + 1
        if "fid0" not in segs and slam.state == "OK":
            segs["fid0"] = slam._mono_init_fid
            segs["fid1"] = slam.frame_id
            segs["seg1"] = np.array(slam._kf_imu_segments[1])
        if slam.imu_initialized:
            break
    slam._flush_pipeline()
    rows = slam.poses_wc()
    est = np.stack([T[:3, 3] for _, T in rows])
    gt = np.stack([poses[int(round(ts / DT))][:3, 3] for ts, _ in rows])
    horn = evaluate.horn_align(est.T, gt.T, True)[2]
    return {"slam": slam, "scales": scales, "frames": n, "horn": horn,
            **segs}


@pytest.fixture(scope="module")
def runs():
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(N_POSES, "arc_excited")
    imu = synth.make_imu(poses, DT, imu_rate=200)
    cache = {}

    def frame(i):
        if i not in cache:
            cache[i] = world.render(K, poses[i], H, W)
        return cache[i]
    return {"imu": imu,
            "ref": _run(JSystem(_cfg(JCalib, JOrbConfig, JMapConfig,
                                     JSystemConfig)), frame, imu, poses),
            "port": _run(System(_cfg(Calib, OrbConfig, MapConfig,
                                     SystemConfig), device="cpu"),
                         frame, imu, poses)}


@pytest.mark.parametrize("name", ["ref", "port"])
def test_initializes(runs, name):
    r = runs[name]
    assert r["slam"].imu_initialized, r["frames"]
    assert r["slam"].state == "OK"


def test_scales_agree(runs):
    sj, st = runs["ref"]["scales"], runs["port"]["scales"]
    assert sj and st, (sj, st)           # both rescaled their map
    hj, ht = runs["ref"]["horn"], runs["port"]["horn"]
    assert abs(ht - hj) <= 0.1 * hj, (hj, ht, sj, st)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_gravity(runs, name):
    g = np.asarray(runs[name]["slam"].gravity, np.float64)
    n = np.linalg.norm(g)
    assert abs(n - 9.81) < 0.6, g
    assert g[1] / n > 0.9, g


@pytest.mark.parametrize("name", ["ref", "port"])
def test_first_segment_spans_the_initial_baseline(runs, name):
    """The segment between the two initial keyframes holds the rows tagged
    (fid0, fid1]: frame f's rows are imu[f - 1]."""
    r = runs[name]
    want = np.concatenate([runs["imu"][f - 1]
                           for f in range(r["fid0"] + 1, r["fid1"] + 1)])
    np.testing.assert_array_equal(r["seg1"], want.astype(np.float32))


def test_both_initialize_from_the_same_first_view(runs):
    assert runs["port"]["fid0"] == runs["ref"]["fid0"]
    assert abs(runs["port"]["fid1"] - runs["ref"]["fid1"]) <= 1
