"""The port's whole slice with the selector live against the reference.

tests/test_pnp.py's relocalization scenario (BoxWorld orbit, 25 frames,
sparsify_n=60, window 4, queue 2, nonlocal_kf 3, 16x12 grid) goes through
both Systems, which then relocalize a query pose 25 degrees and ~0.47 m
off frame 12 from the KFDB. Bars: windows before and after shutdown()
within +-1 (measured 2/5 port, 2/4 reference), memory reduction within 5
points (0.827 both), kept points within 10% (564 and 522), both relocalize
OK under test_pnp's 0.35 m (0.19 and 0.22 m).

The fixture has this file to itself, so that `--dist loadfile` gives it a
worker of its own.
"""
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
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
from ms_slam_tpu_torch.utils import synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BASELINE = 240, 320, 260.0, 0.15


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


# Per-package checks of the same two runs, small and separate, so that a
# failure names the package and the stage.

@pytest.mark.parametrize("name", ["ref", "port"])
def test_slice_ends_ok(slice_runs, name):
    assert slice_runs[name]["state"] == "OK"


@pytest.mark.parametrize("name", ["ref", "port"])
def test_slice_selector_ran(slice_runs, name):
    r = slice_runs[name]
    assert r["windows_before"] >= 1
    assert r["stats"]["windows"] >= r["windows_before"]   # shutdown() adds
    assert r["stats"]["killed"] > 0 and r["stats"]["kept"] > 0
    assert r["compressed"] > 0


@pytest.mark.parametrize("name", ["ref", "port"])
def test_slice_memory_accounting(slice_runs, name):
    """memory_stats reports what the selector counted, and a reduction
    between 0 and 1."""
    r = slice_runs[name]
    assert r["memory"]["mp_selector_killed"] == r["stats"]["killed"]
    assert 0.0 < r["memory"]["reduction"] < 1.0
    assert r["memory"]["without_sparsification_bytes"] \
        > r["memory"]["live_bytes"] > 0


@pytest.mark.parametrize("name", ["ref", "port"])
def test_slice_every_keyframe_left_is_a_candidate(slice_runs, name):
    r = slice_runs[name]
    assert r["candidates"] == r["sparsified"] == r["n_kf"] >= 3


@pytest.mark.parametrize("name", ["ref", "port"])
def test_slice_relocalization_within_bar(slice_runs, name):
    r = slice_runs[name]
    assert r["reloc_state"] == "OK", name
    assert r["reloc_err"] < 0.35, (name, r["reloc_err"])
