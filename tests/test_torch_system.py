"""The port's System: entry-point contracts, the loss-path state machine
against the reference's, stage construction, and the port's import
boundary. None of these tests runs a whole sequence: the whole-System runs
against the reference are in test_torch_system_arc.py (the 30-frame arc),
test_torch_system_slice.py (the selector live, then relocalization) and
test_torch_inertial_system.py (stereo-inertial), one fixture a file so
that `--dist loadfile` spreads them over the workers.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ms_slam_tpu.models.map_state import MapConfig as JMapConfig
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu.pipeline.system import System as JSystem
from ms_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from ms_slam_tpu_torch.models.map_state import MapConfig
from ms_slam_tpu_torch.models.vocab import KeyFrameDatabase
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.loop_closing import LoopCloser
from ms_slam_tpu_torch.pipeline.sparsification import Sparsifier
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FX, BASELINE = 240, 320, 260.0, 0.15


def _cfg(calib_t, orb_t, map_t, cfg_t, fx=FX):
    calib = calib_t(model=0, params=(fx, fx, W / 2, H / 2), bf=fx * BASELINE,
                    width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=64, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6),
                 min_init_depth_points=100, max_frames_between_kf=8)


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


def test_facade_has_every_public_method_of_the_reference():
    """Every public method of the reference's System exists on the port's
    and is callable."""
    names = [n for n in dir(JSystem)
             if not n.startswith("_") and callable(getattr(JSystem, n))]
    assert {"track_monocular", "track_rgbd", "track_monocular_imu",
            "save_trajectory_euroc"} <= set(names)
    missing = [n for n in names if not callable(getattr(System, n, None))]
    assert not missing, missing


def _saver_state(rng):
    """A map of 5 valid keyframes among 8 slots (random poses, frame ids
    2, 5, 9, 12, 20) and a 24-frame trajectory: entries anchored to those
    keyframes, two absolute entries (reference slot -1) and three lost ones,
    EuRoC-size timestamps."""
    from scipy.spatial.transform import Rotation
    from ms_slam_tpu_torch.models import map_state as TM
    cfg = _cfg(Calib, OrbConfig, MapConfig, SystemConfig)
    d = TM.map_state_to_numpy(TM.empty_map(cfg.map, "cpu"))
    slots = [0, 1, 3, 4, 6]
    d["kf_valid"][slots] = True
    d["kf_R"][slots] = Rotation.random(5, random_state=1).as_matrix()
    d["kf_t"][slots] = rng.normal(0, 2.0, (5, 3))
    d["kf_frame_id"][slots] = [2, 5, 9, 12, 20]
    t0 = 1403636579.763555584
    entries = []
    for i in range(24):
        Rr = Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix()
        T_cr = np.eye(4)
        T_cr[:3, :3], T_cr[:3, 3] = Rr, rng.normal(0, 0.5, 3)
        ref_kf = -1 if i in (7, 15) else slots[i % 5]
        entries.append((i, t0 + 0.05 * i, ref_kf, T_cr, i in (0, 1, 17)))
    return d, entries


def test_trajectory_savers_match_the_reference(rng, tmp_path):
    """Both Systems hold one map state and one trajectory; all five savers
    of each are read back as numbers: timestamps exact, the rest within
    1e-6 relative (1e-6 absolute for entries near zero)."""
    import jax.numpy as jnp

    from ms_slam_tpu.models import map_state as JM
    from ms_slam_tpu.pipeline.system import TrajectoryEntry as JEntry
    from ms_slam_tpu_torch.models import map_state as TM
    from ms_slam_tpu_torch.pipeline.system import TrajectoryEntry
    d, entries = _saver_state(rng)
    ref = JSystem(_cfg(JCalib, JOrbConfig, JMapConfig, JSystemConfig))
    port = System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig),
                  device="cpu")
    ref.ms = JM.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    port.ms = TM.map_state_from_numpy(d)
    ref.trajectory = [JEntry(f, ts, r, T.copy(), lost)
                      for f, ts, r, T, lost in entries]
    port.trajectory = [TrajectoryEntry(f, ts, r, T.copy(), lost)
                       for f, ts, r, T, lost in entries]
    savers = ("save_trajectory_kitti", "save_trajectory_tum",
              "save_trajectory_euroc", "save_keyframe_trajectory_tum",
              "save_keyframe_trajectory_euroc")
    n_rows = {"save_trajectory_kitti": 21, "save_trajectory_tum": 21,
              "save_trajectory_euroc": 21, "save_keyframe_trajectory_tum": 5,
              "save_keyframe_trajectory_euroc": 5}
    for name in savers:
        a, b = tmp_path / f"ref_{name}.txt", tmp_path / f"port_{name}.txt"
        getattr(ref, name)(str(a))
        getattr(port, name)(str(b))
        ra, rb = np.loadtxt(a, ndmin=2), np.loadtxt(b, ndmin=2)
        assert ra.shape == rb.shape == (n_rows[name], ra.shape[1]), name
        first = 0 if name.endswith("kitti") else 1
        if first:
            np.testing.assert_array_equal(rb[:, 0], ra[:, 0])
            assert [r.split()[0] for r in b.read_text().splitlines()] == \
                [r.split()[0] for r in a.read_text().splitlines()]
        np.testing.assert_allclose(rb[:, first:], ra[:, first:], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # and the keyframe rows themselves (the keyframe savers' source)
    rows_j, rows_t = ref._keyframe_traj_rows(), port._keyframe_traj_rows()
    assert [r[0] for r in rows_t] == [r[0] for r in rows_j]
    for (_, tj, qj), (_, tt, qt) in zip(rows_j, rows_t):
        np.testing.assert_allclose(tt, np.asarray(tj), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(qt, np.asarray(qj), rtol=1e-6, atol=1e-6)


def _full_rate_circuit(n, radius=9.0, lap=120):
    """Phase 7's circuit of chip_smoke.py at its full rate from frame 0:
    3 degrees and 0.47 m a frame, driven facing forward."""
    from scipy.spatial.transform import Rotation
    poses = []
    for i in range(n):
        a = 2 * np.pi / lap * i
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", a).as_matrix()
        T[:3, 3] = [radius * np.sin(a), 0.0, radius * (1 - np.cos(a))]
        poses.append(T)
    return poses


def test_full_rate_start_frame_one():
    """Both packages on the first 4 frames of phase 7's circuit at full rate
    (BoxWorld(half=24) at 0.07 m a texel, 320x240 at phase 7's focal length
    718.856 px, so that the first step moves features ~37 px as at full
    width): the state after frame 1 and whether frame 1 was recorded lost.
    With no velocity model at frame 1, both track it from frame 0's pose (3
    degrees and 0.47 m away); the two packages must agree (measured: both
    track it, OK and not lost; at fx 260 px too)."""
    from ms_slam_tpu_torch.utils import synth
    fx = 718.856
    world = synth.BoxWorld(np.random.default_rng(0), half=24.0,
                           tex_scale=0.07)
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
    frames = [world.render_stereo(K, T, BASELINE, H, W)
              for T in _full_rate_circuit(4)]
    seen = {}
    for name, slam in (
            ("ref", JSystem(_cfg(JCalib, JOrbConfig, JMapConfig,
                                 JSystemConfig, fx))),
            ("port", System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig,
                                 fx), device="cpu"))):
        states = []
        for i, (l, r) in enumerate(frames):
            slam.track_stereo(l, r, 0.1 * i)
            if i == 2:              # frame 1 completes behind frame 2
                states.append(slam.state)
        slam._flush_pipeline()
        states.append(slam.state)
        seen[name] = (states, [e.lost for e in slam.trajectory
                               if e.frame_id == 1])
    assert seen["port"] == seen["ref"], seen
    print("state after frame 1, at the end; frame 1 lost:", seen)
