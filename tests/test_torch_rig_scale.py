"""The stereo-fisheye map keeps its scale: a whole `System` on a small
unrectified Kannala-Brandt8 pair, visual only, through `track_stereo`.

Scenario: the benchmark's KB8 renderer (`bench_port/scenes/fisheye.py`) in
its corridor, a 256x256 rig with TUM-VI's lenses at half the focal length,
the right camera 0.2 m along x and turned 3 degrees about y and 1 about x
(bench_port/tests/test_bench_port_fisheye.py's rig without its IMU), 512
features on 4 levels, going straight at 0.05 m a frame for 40 frames.

Bars: the first keyframe's points at a median depth ratio (their camera
distance over the ray-cast truth's) within 0.95-1.05, and the tracked
path's length within 5% of the truth's. Before the right keypoints were
solver rows every residual after a keyframe's creation was monocular, the
local BA left the scale free and these read 0.81 and 20% short.

Tracing on the same run: the span `frontend.kb8_pair` once a frame, nested
in its frame's `frontend`; the counter `rig.right_rows` once a completed
frame, its events summing to the right rows that the tracking solves kept.

The whole-System fixture has this file to itself, so that `--dist loadfile`
gives it a worker of its own.
"""
import os
import sys

import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import pose_opt
from ms_slam_tpu_torch.pipeline import frontend
from ms_slam_tpu_torch.pipeline.system import System

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from bench_port.harness import inputs  # noqa: E402
from bench_port.reference import judge  # noqa: E402
from bench_port.scenes import fisheye, motion, world  # noqa: E402

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

N_FRAMES = 40
FPS = 20.0
YAML = """%YAML:1.0
---
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: 95.5
Camera1.fy: 95.5
Camera1.cx: 127.4
Camera1.cy: 128.4
Camera1.k1: 0.0034823894022493434
Camera1.k2: 0.0007150348452162257
Camera1.k3: -0.0020532361418706202
Camera1.k4: 0.00020293673591811182
Camera1.overlappingBegin: 0
Camera1.overlappingEnd: 255
Camera2.fx: 95.2
Camera2.fy: 95.2
Camera2.cx: 126.3
Camera2.cy: 127.4
Camera2.k1: 0.0034003170790442797
Camera2.k2: 0.001766278153469831
Camera2.k3: -0.00266312569781606
Camera2.k4: 0.0003299517423931039
Camera2.overlappingBegin: 0
Camera2.overlappingEnd: 255
Camera.width: 256
Camera.height: 256
Camera.fps: 20.0
Stereo.ThDepth: 40.0
Stereo.T_c1_c2: [0.99862953, 0.0, 0.05233596, 0.2,
  0.00091339, 0.9998477, -0.01742849, -0.002,
  -0.05232799, 0.01745241, 0.99847747, 0.001,
  0.0, 0.0, 0.0, 1.0]
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
loopClosing: 1
"""
SCENE = {"half_w": 3.0, "y_floor": 1.6, "y_ceil": -2.2, "tex_scale": 0.05,
         "tex_size": 4096, "rect_max": 128, "n_rects": 11378}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    path = tmp_path_factory.mktemp("rig") / "kb8.yaml"
    path.write_text(YAML)
    sc = inputs.system_config({"yaml_path": str(path), "system_config": {
        "max_kf": 64, "max_mp": 8192, "local_cap": 2048}})
    cam = inputs.camera(sc.calib)
    poses = motion.poses(N_FRAMES, {"speed_m_per_frame": 0.05}, FPS)
    wd = world.CorridorWorld.from_seed(7, "cpu", **SCENE)
    frames = fisheye.render_sequence(wd, poses, cam, "cpu")
    slam = System(sc, device="cpu")
    solved, parents = [], []
    optimize, span = pose_opt.pose_optimize, frontend.span

    def optimize_spy(*a, **k):
        out = optimize(*a, **k)
        solved.append(int(out.n_right))
        return out

    def span_spy(timing, name, frame=None):
        if timing is not None and name == "frontend.kb8_pair":
            parents.append((timing.open[-1], slam.frame_id))
        return span(timing, name, frame)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pose_opt, "pose_optimize", optimize_spy)
        mp.setattr(frontend, "span", span_spy)
        for i, (left, right) in enumerate(frames):
            slam.track_stereo(left, right, i / FPS)
        slam._flush_pipeline()
    assert slam.state == "OK"
    return dict(slam=slam, poses=poses, cam=cam, solved=solved,
                parents=parents, timing={k: list(v)
                                         for k, v in slam.timing.items()})


def test_first_keyframe_points_at_true_depth(run):
    slam, poses = run["slam"], run["poses"]
    ms = slam.ms
    k = slam.kf_order[0]
    row = ms.obs_mp[k].numpy()
    n = np.flatnonzero(row >= 0)
    p = row[n]
    mine = ms.mp_valid.numpy()[p] & (ms.mp_first_kf.numpy()[p] == k)
    n, p = n[mine], p[mine]
    Xc = ms.mp_pos.numpy()[p] @ ms.kf_R[k].numpy().T + ms.kf_t[k].numpy()
    rays = judge.keypoint_rays(run["cam"],
                               ms.kp_xy[k].numpy()[n].astype(np.float64))
    T = poses[int(ms.kf_frame_id[k])]
    X_gt = judge.ray_cast(SCENE, np.repeat(T[None], len(p), 0), rays)
    d_gt = np.linalg.norm(X_gt - T[:3, 3], axis=1)
    ok = np.isfinite(d_gt)
    assert ok.sum() > 50
    ratio = float(np.median(np.linalg.norm(Xc[ok], axis=1) / d_gt[ok]))
    assert 0.95 <= ratio <= 1.05, ratio


def test_path_length_within_five_percent(run):
    rows = run["slam"].poses_wc()
    ids = [int(round(ts * FPS)) for ts, _ in rows]
    est = np.stack([T[:3, 3] for _, T in rows])
    gt = run["poses"][ids, :3, 3]
    lengths = [np.linalg.norm(np.diff(p, axis=0), axis=1).sum()
               for p in (est, gt)]
    assert lengths[1] > 1.0
    assert abs(lengths[0] / lengths[1] - 1.0) < 0.05, lengths


def test_map_keeps_right_keypoints_and_no_stereo_rows(run):
    ms = run["slam"].ms
    kv = ms.kf_valid.numpy()
    right = ms.kp_right.numpy()[kv]
    assert (right[..., 0] >= 0).sum(1).min() > 50
    assert (ms.kp_uright.numpy()[kv] == -1.0).all()


def test_kb8_pair_span_nests_under_frontend(run):
    timing, parents = run["timing"], run["parents"]
    assert len(timing["frontend.kb8_pair"]) == N_FRAMES
    assert [p for p, _ in parents] == [("frontend", f)
                                       for _, f in parents]
    assert [f for _, f in parents] == list(range(N_FRAMES))
    assert all(a <= b for a, b in zip(timing["frontend.kb8_pair"],
                                      timing["frontend"]))


def test_right_row_counter_equals_rows_solved(run):
    timing = run["timing"]
    counts = timing["rig.right_rows"]
    assert len(counts) == len(timing["track_dispatch"])
    assert sum(counts) == sum(run["solved"]) > 100 * len(counts)
    assert all(c == int(c) for c in counts)
    assert not any(k.startswith("sync.rig") for k in timing)
