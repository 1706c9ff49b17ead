"""Both Systems at bench.py's pipeline settings: MSSLAM_PIPELINE_DEPTH=4
(so three frames in flight, completed two at a time) with `next_images`
on every frame, over tests/test_e2e.py's arc (PlaneWorld, 320x240, 512
features, all 30 frames: the 2% ATE gate is defined on the whole arc).

At depth 4 the keyframe decision of frame N lags up to three dispatched
frames, so the trajectory is not the depth-2 one in either package: each
is held to the other at depth 4. Bars: both end OK with every frame
recorded; keyframe counts within 1 (measured 12 and 12, against 6 at
depth 2); each ATE under 2% of the path (measured 1.03% reference, 0.66%
port); both fetch the stats two frames at a time (16 fetches for 29
tracked frames); the port took 28 frames from its prefetch (all but the
first two: frame 0 initializes, and only a frame tracked in OK
prefetches).

The whole-System fixture has this file to itself.
"""
import os

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

H, W, FX, BASELINE = 240, 320, 260.0, 0.15
N_FRAMES = 30


def _cfg(calib_t, orb_t, map_t, cfg_t):
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                    width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=64, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6),
                 min_init_depth_points=100, max_frames_between_kf=8)


def _run(slam, frames, poses):
    for i, (l, r) in enumerate(frames):
        nxt = frames[i + 1] if i + 1 < len(frames) else None
        slam.track_stereo(l, r, 0.1 * i, next_images=nxt)
    slam.shutdown()
    est = np.stack([T[:3, 3] for _, T in slam.poses_wc()])
    gt = np.stack([T[:3, 3] for T in poses])
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    return {"state": slam.state, "n_rec": len(slam.trajectory),
            "lost": sum(e.lost for e in slam.trajectory),
            "n_kf": int(np.asarray(slam.ms.kf_valid).sum()),
            "ate": evaluate.ate_rmse(est, gt) / path,
            "fetches": len(slam.timing["stats_fetch"]),
            "hits": getattr(slam, "prefetch_hits", None)}


@pytest.fixture(scope="module")
def runs():
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(N_FRAMES, "arc")
    frames = [[np.clip(im, 0, 255).astype(np.uint8)
               for im in world.render_stereo(K, T, BASELINE, H, W)]
              for T in poses]
    saved = {k: os.environ.pop(k, None) for k in (
        "MSSLAM_PIPELINE_DEPTH", "MSSLAM_FETCH_BATCH",
        "MSSLAM_SYNC_PREFETCH", "MSSLAM_OBS_EVERY_FRAME")}
    os.environ["MSSLAM_PIPELINE_DEPTH"] = "4"
    try:
        ref = JSystem(_cfg(JCalib, JOrbConfig, JMapConfig, JSystemConfig))
        port = System(_cfg(Calib, OrbConfig, MapConfig, SystemConfig),
                      device="cpu")
    finally:
        os.environ.pop("MSSLAM_PIPELINE_DEPTH")
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    assert port._pipeline_depth == 4 and port._fetch_batch == 2
    return {"ref": _run(ref, frames, poses), "port": _run(port, frames, poses)}


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_every_frame_tracked(runs, pkg):
    r = runs[pkg]
    assert r["state"] == "OK"
    assert r["n_rec"] == N_FRAMES and r["lost"] == 0


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_ate_under_two_percent(runs, pkg):
    assert runs[pkg]["ate"] < 0.02, runs[pkg]["ate"]


def test_keyframe_counts_agree(runs):
    assert abs(runs["port"]["n_kf"] - runs["ref"]["n_kf"]) <= 1


def test_stats_fetched_two_frames_at_a_time(runs):
    assert runs["port"]["fetches"] == runs["ref"]["fetches"]
    assert runs["port"]["fetches"] <= (N_FRAMES + 3) // 2


def test_port_took_its_frames_from_the_prefetch(runs):
    assert runs["port"]["hits"] == N_FRAMES - 2
