"""The port's System against the reference System on the same frames, plus
the port's import boundary and entry-point contracts.

Scenario: tests/test_e2e.py's synthetic arc as it stands (PlaneWorld,
240x320, 512 features, make_trajectory(30, "arc"), noise-free renders),
through both Systems. All 30 frames: the 2% ATE gate is defined on the
whole arc, and on a shorter prefix the reference itself misses it
(measured: 2.1% of the 1.19 m path after 12 frames, 2.4% after 16).

Bars and what was measured (CPU, both packages):
- both end OK with every frame recorded;
- keyframe counts within ±1 and map points within 5% (6 and 6 keyframes,
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
"""
import os
import subprocess
import sys

import numpy as np
import pytest

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    return {"poses": poses, "ref": ref, "port": port,
            "pos_ref": _run(ref, frames), "pos_port": _run(port, frames)}


def test_both_track_to_the_end(runs):
    for name in ("ref", "port"):
        slam = runs[name]
        assert slam.state == "OK", name
        assert len(runs["pos_" + name]) == N_FRAMES, name


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


@pytest.mark.parametrize("flag", ["sparsify", "loop_closing", "use_imu"])
def test_out_of_slice_config_raises(flag):
    cfg = _cfg(Calib, OrbConfig, MapConfig, SystemConfig)
    setattr(cfg, flag, True)
    with pytest.raises(NotImplementedError):
        System(cfg, device="cpu")


def test_tracking_failure_is_loud():
    slam = System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="relocalization"):
        slam._relocalize(None)


def test_port_imports_no_jax():
    """Every module of the port imports without jax or ms_slam_tpu."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import ms_slam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from ms_slam_tpu_torch.utils import synth, evaluate\n"
        "assert len(mods) >= 15, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ms_slam_tpu' or m.startswith('ms_slam_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py has no CPU path: without a card it exits non-zero and
    prints no result line."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
