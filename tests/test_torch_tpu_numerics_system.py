"""Whole Systems under the reference's TPU numerics
(MSSLAM_FORCE_TPU_NUMERICS=1): the bf16 canvas in every frame's frontend.

Scenario: test_torch_system_arc.py's, which is tests/test_e2e.py's
synthetic arc as it stands (PlaneWorld, 240x320, 512 features, 4 levels,
make_trajectory(30, "arc"), noise-free renders), through the reference's
System and the port's under the switch, and through the port's without it.
All 30 frames: the 2% ATE gate is defined on the whole arc. Shorter or
narrower runs miss it in both packages, with the switch and without (the
port on the CPU: the first 12 frames at 256 features 4.6-5.3% of the path,
all 30 frames at 256 features 1.69% without the switch and 2.15% with
it). The reference's Pallas kernel is replaced by its plain gather, which
tests/test_torch_tpu_numerics.py holds bit for bit against the kernel on a
bf16 canvas (the interpreted kernel costs ~16 s a frame at this size);
JAX's caches are cleared before the switch is set and after it is unset,
because the reference reads the switch when its frontends are traced.

Bars (outcome bars: the two Systems' RANSAC streams cannot match):
- every frame's tracking state the same in both packages, every frame OK;
- keyframe counts within 1;
- ATE of each run under 2% of the path (test_e2e.py's gate), and the RMS
  of the per-frame position gap between the two packages under 2% of the
  path (test_torch_system_arc.py's bars);
- the port without the switch: every frame OK, its keyframe count within 1
  of the run under the switch, its ATE under the same bar.
Then the port's RGB-D and monocular Systems for a few frames under the
switch, and its stereo-fisheye frontend, with a spy on detection: each
frontend hands the bf16 canvas to detection.

The whole-System fixture has this file to itself, so that `--dist loadfile`
gives it a worker of its own.
"""
import jax
import numpy as np
import pytest
import torch

from ms_slam_tpu.models.map_state import MapConfig as JMapConfig
from ms_slam_tpu.ops import orb as jorb
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu.pipeline.system import System as JSystem
from ms_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from ms_slam_tpu_torch.models.map_state import MapConfig
from ms_slam_tpu_torch.ops import orb as torb
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline import frontend as tfe
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
from ms_slam_tpu_torch.utils import evaluate, synth
from test_torch_tpu_numerics import FLAG, _reference_plain_pallas

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
    slam.shutdown()
    return {round(ts, 6): Twc[:3, 3] for ts, Twc in slam.poses_wc()}


def _watch_detection(monkeypatch):
    """Record the canvas dtype of every port detection call."""
    seen = []
    detect = torb.detect_canvas

    def spy(canvas, *a, **k):
        seen.append(canvas.dtype)
        return detect(canvas, *a, **k)
    monkeypatch.setattr(torb, "detect_canvas", spy)
    return seen


@pytest.fixture(scope="module")
def runs():
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(N_FRAMES, "arc")
    frames = [[np.clip(im, 0, 255).astype(np.uint8)
               for im in world.render_stereo(K, T, BASELINE, H, W)]
              for T in poses]
    out = {"poses": poses}
    with pytest.MonkeyPatch.context() as mp:
        out["port_f32"] = System(_cfg(Calib, OrbConfig, MapConfig,
                                      SystemConfig), device="cpu")
        seen_f32 = _watch_detection(mp)
        out["pos_port_f32"] = _run(out["port_f32"], frames)
        out["seen_f32"] = set(seen_f32)
    jax.clear_caches()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(FLAG, "1")
            mp.setattr(jorb, "extract_patches_canvas_pallas",
                       _reference_plain_pallas)
            out["ref"] = JSystem(_cfg(JCalib, JOrbConfig, JMapConfig,
                                      JSystemConfig))
            out["pos_ref"] = _run(out["ref"], frames)
            out["port"] = System(_cfg(Calib, OrbConfig, MapConfig,
                                      SystemConfig), device="cpu")
            seen = _watch_detection(mp)
            out["pos_port"] = _run(out["port"], frames)
            out["seen"] = set(seen)
    finally:
        jax.clear_caches()
    return out


def _path(poses):
    gt = np.stack([T[:3, 3] for T in poses])
    return float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))


def _ate(runs, name):
    gt = np.stack([T[:3, 3] for T in runs["poses"]])
    pos = runs["pos_" + name]
    est = np.stack([pos[t] for t in sorted(pos)])
    return evaluate.ate_rmse(est, gt)


def test_port_ran_on_the_bf16_canvas(runs):
    assert runs["seen"] == {torch.bfloat16}
    assert runs["seen_f32"] == {torch.float32}


def test_every_frame_state_same(runs):
    ref, port = runs["ref"].trajectory, runs["port"].trajectory
    assert [e.frame_id for e in ref] == list(range(N_FRAMES))
    assert [(e.frame_id, e.lost) for e in port] == [(e.frame_id, e.lost)
                                                    for e in ref]
    assert not any(e.lost for e in ref)
    assert runs["ref"].state == runs["port"].state == "OK"


def test_keyframes_within_one(runs):
    n_ref = runs["ref"].keyframes_in_map()
    assert n_ref >= 3
    assert abs(runs["port"].keyframes_in_map() - n_ref) <= 1


@pytest.mark.parametrize("name", ["ref", "port", "port_f32"])
def test_ate(runs, name):
    assert _ate(runs, name) < 0.02 * _path(runs["poses"]), _ate(runs, name)


def test_trajectories_agree(runs):
    ts = sorted(runs["pos_ref"])
    gap = np.linalg.norm(np.stack([runs["pos_port"][t] for t in ts])
                         - np.stack([runs["pos_ref"][t] for t in ts]), axis=1)
    assert np.sqrt(np.mean(gap ** 2)) < 0.02 * _path(runs["poses"]), gap


def test_without_the_switch(runs):
    f32 = runs["port_f32"]
    assert f32.state == "OK"
    assert [(e.frame_id, e.lost) for e in f32.trajectory] == [
        (i, False) for i in range(N_FRAMES)]
    assert abs(f32.keyframes_in_map() - runs["port"].keyframes_in_map()) <= 1


def _sensor_cfg(bf=FX * BASELINE, th_depth=BASELINE * 40):
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=bf,
                  width=W, height=H, th_depth=th_depth, fps=10.0)
    return SystemConfig(calib=calib, orb=OrbConfig(n_features=256,
                                                   n_levels=4),
                        map=MapConfig(max_kf=16, max_mp=2048, n_feat=256,
                                      local_mp_cap=1024, window_kf=6),
                        min_init_depth_points=60, max_frames_between_kf=8)


def test_rgbd_and_mono_frontends_take_the_bf16_canvas(monkeypatch):
    """track_rgbd over 4 frames (every one OK) and track_monocular over 3,
    under the switch: every detection reads a bf16 canvas."""
    monkeypatch.setenv(FLAG, "1")
    seen = _watch_detection(monkeypatch)
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(30, "arc")[:4]
    rgbd = System(_sensor_cfg(), device="cpu")
    for i, T in enumerate(poses):
        img, depth = world.render_rgbd(K, T, H, W)
        rgbd.track_rgbd(np.clip(img, 0, 255).astype(np.uint8),
                        depth.astype(np.float32), 0.1 * i)
    rgbd.shutdown()
    assert [e.lost for e in rgbd.trajectory] == [False] * 4
    n_rgbd = len(seen)
    assert n_rgbd == 4
    mono = System(_sensor_cfg(bf=0.0, th_depth=0.0), device="cpu")
    for i, T in enumerate(poses[:3]):
        mono.track_monocular(np.clip(world.render(K, T, H, W), 0, 255)
                             .astype(np.uint8), 0.1 * i)
    mono.shutdown()
    assert len(seen) == n_rgbd + 3
    assert set(seen) == {torch.bfloat16}


def test_fisheye_frontend_takes_the_bf16_canvas(monkeypatch):
    """process_stereo_fisheye under the switch (tests/test_fisheye.py's rig
    and test_torch_frontend_sensors.py's view): detection reads the bf16
    canvas and the pair still triangulates."""
    from test_torch_frontend_sensors import FBL, KB8P, _fisheye_calib
    monkeypatch.setenv(FLAG, "1")
    seen = _watch_detection(monkeypatch)
    world = synth.BoxWorld(np.random.default_rng(0), half=6.0)
    T = synth.make_trajectory(25, "arc")[5]
    ims = world.render_fisheye_stereo(KB8P, T, FBL, H, W)
    pair = torch.from_numpy(np.stack([np.clip(im, 0, 255).astype(np.uint8)
                                      for im in ims]))
    fd = tfe.process_stereo_fisheye(pair, _fisheye_calib(tfe),
                                    OrbConfig(n_features=256, n_levels=4))
    assert seen == [torch.bfloat16]
    assert int((fd.depth > 0).sum()) > 50
