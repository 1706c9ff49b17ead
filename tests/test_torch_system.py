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

The whole slice with the selector live runs tests/test_pnp.py's
relocalization scenario (BoxWorld orbit, 25 frames, sparsify_n=60, window
4, queue 2, nonlocal_kf 3, 16x12 grid) through both Systems, then
relocalizes a query pose 25 degrees and ~0.47 m off frame 12 from the
KFDB. Bars: windows before and after shutdown() within +-1 (measured 2/5
port, 2/4 reference), memory reduction within 5 points (0.827 both), kept
points within 10% (564 and 522), both relocalize OK under test_pnp's
0.35 m (0.19 and 0.22 m).

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
import torch
from scipy.spatial.transform import Rotation

from ms_slam_tpu.models.map_state import MapConfig as JMapConfig
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu.pipeline.system import System as JSystem
from ms_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from ms_slam_tpu_torch.models.map_state import MapConfig
from ms_slam_tpu_torch.models.vocab import KeyFrameDatabase
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline.frontend import Calib, process_stereo_stacked
from ms_slam_tpu_torch.pipeline.loop_closing import LoopCloser
from ms_slam_tpu_torch.pipeline.sparsification import Sparsifier
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
    return {"poses": poses, "frames": frames, "ref": ref, "port": port,
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


@pytest.mark.parametrize("case", ["grace_expires", "new_map"])
def test_track_lost_transitions(case):
    """_track_lost against the reference's on the same scripted state, with
    relocalization failing: the RECENTLY_LOST window runs out into LOST
    after t_recently_lost with the pose carried forward at constant
    velocity, and more than 2*fps lost frames with >= 5 keyframes start a
    fresh Atlas map (active_map + 1, NOT_INIT)."""
    vel = np.eye(4)
    vel[:3, 3] = [0.0, 0.0, -0.1]
    traces = []
    for *types, cls, kw in (
            (JCalib, JOrbConfig, JMapConfig, JSystemConfig, JSystem, {}),
            (Calib, OrbConfig, MapConfig, SystemConfig, System,
             {"device": "cpu"})):
        slam = cls(_cfg(*types), **kw)
        slam._relocalize = lambda frame: None
        slam._ref_pose_np = (np.eye(3, dtype=np.float32),
                             np.zeros(3, np.float32))
        slam.n_kf = 6
        if case == "grace_expires":
            slam.state, slam._lost_ts, slam.vel = "RECENTLY_LOST", 0.0, vel
            stamps = [1.0, 3.0, 5.5, 6.0]
        else:
            slam.state = "LOST"
            slam._lost_frames = int(2 * slam.calib.fps) - 1
            stamps = [1.0, 1.1, 1.2]
        trace = []
        for i, ts in enumerate(stamps):
            slam._track_lost(None, ts, frame_id=i)
            e = slam.trajectory[-1]
            trace.append((slam.state, slam.active_map, slam._lost_frames,
                          e.frame_id, e.lost,
                          np.round(slam.current_pose()[:3, 3], 6).tolist()))
        traces.append(trace)
    assert traces[0] == traces[1]
    states = [t[0] for t in traces[1]]
    if case == "grace_expires":
        assert states == ["RECENTLY_LOST", "RECENTLY_LOST", "LOST", "LOST"]
        assert traces[1][-1][5] == [0.0, 0.0, -0.3]   # three extrapolations
    else:
        assert states == ["LOST", "NOT_INIT", "NOT_INIT"]
        assert traces[1][-1][1] == 1


def test_system_without_card_needs_device(monkeypatch):
    """With no card and no device the System refuses to start; it never
    moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig))


def _sparsify_cfg():
    cfg = _cfg(Calib, OrbConfig, MapConfig, SystemConfig)
    cfg.sparsify = True
    return cfg


def test_sparsify_constructs_stage():
    slam = System(_sparsify_cfg(), device="cpu")
    assert isinstance(slam._sparsifier, Sparsifier)
    assert isinstance(slam.kf_db, KeyFrameDatabase)
    assert slam.kf_db.rows.device == slam.device


def test_memory_stats_counts_selector_removals():
    """memory_stats adds the selector's deleted points (80 B) and freed
    feature slots (56 B) to the live bytes, as the reference does."""
    slam = System(_sparsify_cfg(), device="cpu")
    slam._sparsifier._pending_counts.append(torch.tensor([10, 5, 100]))
    st = slam.memory_stats()
    assert st["mp_selector_killed"] == 10
    assert st["without_sparsification_bytes"] == 10 * 80 + 100 * 56
    assert st["reduction"] == 1.0 and st["mp_compressed"] == 0
    assert slam.compressed_map_points_in_map() == 0


@pytest.mark.parametrize("flag", ["use_imu"])
def test_out_of_slice_config_raises(flag):
    cfg = _cfg(Calib, OrbConfig, MapConfig, SystemConfig)
    setattr(cfg, flag, True)
    with pytest.raises(NotImplementedError):
        System(cfg, device="cpu")


@pytest.mark.parametrize("sparsify", [False, True])
def test_loop_closing_constructs_stage(sparsify):
    """loop_closing=True builds a LoopCloser that shares the System's
    keyframe database (which exists with sparsification off too), with the
    reference's defaults for the loop keys."""
    cfg = _cfg(Calib, OrbConfig, MapConfig, SystemConfig)
    cfg.loop_closing = True
    cfg.sparsify = sparsify
    slam = System(cfg, device="cpu")
    assert isinstance(slam._loop_closer, LoopCloser)
    assert isinstance(slam.kf_db, KeyFrameDatabase)
    assert slam._loop_closer.db is slam.kf_db
    assert (slam._sparsifier is not None) == sparsify
    assert slam._loop_closer.gen.device == slam.device
    ref = JSystemConfig()
    assert (cfg.loop_covis_min, cfg.loop_pitchroll_tol, cfg.loop_yaw_tol) \
        == (ref.loop_covis_min, ref.loop_pitchroll_tol, ref.loop_yaw_tol)
    assert System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig),
                  device="cpu")._loop_closer is None


def _slice_cfg(calib_t, orb_t, map_t, cfg_t):
    """tests/test_pnp.py's relocalization configuration."""
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2),
                    bf=FX * BASELINE, width=W, height=H,
                    th_depth=BASELINE * 45, fps=10.0)
    return cfg_t(
        calib=calib, orb=orb_t(n_features=512, n_levels=4),
        map=map_t(max_kf=64, max_mp=8192, n_feat=512, local_mp_cap=2048,
                  window_kf=6, grid_w=16, grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=4, sparsify=True,
        sparsify_n=60, sparsify_window=4, sparsify_queue_min=2,
        nonlocal_kf=3, loop_closing=False)


@pytest.fixture(scope="module")
def slice_runs():
    """Both Systems over the orbit with the selector live, then the
    relocalization query from the KFDB."""
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    world = synth.BoxWorld(np.random.default_rng(0), half=7.0)
    poses = synth.make_trajectory(80, "orbit")[:25]
    frames = [world.render_stereo(K, T, BASELINE, H, W) for T in poses]
    T_q = poses[12].copy()
    T_q[:3, :3] = T_q[:3, :3] @ Rotation.from_euler(
        "y", np.deg2rad(25)).as_matrix()
    T_q[:3, 3] += np.array([0.35, -0.1, 0.3])
    query = world.render_stereo(K, T_q, BASELINE, H, W)
    out = {}
    for name, slam in (
            ("ref", JSystem(_slice_cfg(JCalib, JOrbConfig, JMapConfig,
                                       JSystemConfig))),
            ("port", System(_slice_cfg(Calib, OrbConfig, MapConfig,
                                       SystemConfig), device="cpu"))):
        for i, (l, r) in enumerate(frames):
            slam.track_stereo(l, r, 0.1 * i)
        slam._flush_pipeline()
        r = {"state": slam.state,
             "windows_before": slam._sparsifier.stats["windows"]}
        slam.shutdown()
        r.update(stats=dict(slam._sparsifier.stats),
                 memory=slam.memory_stats(),
                 compressed=slam.compressed_map_points_in_map(),
                 n_kf=slam.keyframes_in_map(),
                 candidates=int(slam.kf_db.present.sum()),
                 sparsified=int(np.asarray(slam.ms.kf_sparsified).sum()))
        slam.state = "LOST"
        slam._lost_frames = 0
        slam.vel = None
        slam.track_stereo(*query, 99.0)
        c_est = np.linalg.inv(slam.current_pose())[:3, 3]
        r.update(reloc_state=slam.state,
                 reloc_err=float(np.linalg.norm(c_est - T_q[:3, 3])))
        out[name] = r
    return out


def test_slice_windows_agree(slice_runs):
    ref, port = slice_runs["ref"], slice_runs["port"]
    assert ref["state"] == port["state"] == "OK"
    assert ref["windows_before"] >= 1
    assert abs(port["windows_before"] - ref["windows_before"]) <= 1
    assert abs(port["stats"]["windows"] - ref["stats"]["windows"]) <= 1


def test_slice_memory_reduction_agrees(slice_runs):
    ref, port = slice_runs["ref"], slice_runs["port"]
    assert ref["memory"]["reduction"] > 0.5
    assert abs(port["memory"]["reduction"]
               - ref["memory"]["reduction"]) <= 0.05
    kept_r, kept_p = ref["stats"]["kept"], port["stats"]["kept"]
    assert abs(kept_p - kept_r) <= 0.10 * kept_r, (kept_p, kept_r)
    assert port["compressed"] > 0 and port["memory"]["mp_selector_killed"] > 0
    # every keyframe left is sparsified and a retrieval candidate
    assert port["candidates"] == port["sparsified"] == port["n_kf"]


def test_slice_relocalizes(slice_runs):
    for name in ("ref", "port"):
        r = slice_runs[name]
        assert r["reloc_state"] == "OK", name
        assert r["reloc_err"] < 0.35, (name, r["reloc_err"])


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
