"""The harness's unrectified Kannala-Brandt8 (KB8) rig on the CPU at small
sizes: the rays against the port's projection, the plain fisheye frontend
against the port's on a rendered pair whose right camera is rotated, the
map's error under a KB8 lens, and a stereo-inertial rehearsal through the
harness's own run with a descriptor fault planted.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)

from bench_port.harness import inputs, registry, run_cell  # noqa: E402
from bench_port.reference import fisheye as ref_fisheye  # noqa: E402
from bench_port.reference import judge  # noqa: E402
from bench_port.scenes import fisheye, world  # noqa: E402
import faults  # noqa: E402
import rehearse_kb8  # noqa: E402

# configs/TUM-VI-Fisheye.yaml's lenses
TUMVI_1 = (190.97847715128717, 190.9733070521226, 254.93170605935475,
           256.8974428996504, 0.0034823894022493434, 0.0007150348452162257,
           -0.0020532361418706202, 0.00020293673591811182)
TUMVI_2 = (190.44236969414825, 190.4344384721956, 252.59949716835982,
           254.91723064636983, 0.0034003170790442797, 0.001766278153469831,
           -0.00266312569781606, 0.0003299517423931039)

# a 256x256 rig with TUM-VI's lenses at half the focal length, the right
# camera 0.2 m along x and turned 3 degrees about y and 1 about x
TINY_KB8_YAML = """%YAML:1.0
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
IMU.NoiseGyro: 1.7e-04
IMU.NoiseAcc: 2.0e-03
IMU.GyroWalk: 1.9393e-05
IMU.AccWalk: 3.0e-03
IMU.Frequency: 200.0
IMU.T_b_c1: [0.0148655429818, -0.999880929698, 0.00414029679422,
  -0.0216401454975, 0.999557249008, 0.0149672133247, 0.025715529948,
  -0.064676986768, -0.0257744366974, 0.00375618835797, 0.999660727178,
  0.00981073058949, 0.0, 0.0, 0.0, 1.0]
loopClosing: 1
Sparsification.N: 75
Sparsification.Lambda: 500
Sparsification.GridLambda: 10
Sparsification.WindowLength: 30
Sparsification.NonLocalKF: 15
"""

@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """(cell, config, traffic) of the rehearsal on a tiny KB8 rig, held
    here and not in a file of the benchmark."""
    path = tmp_path_factory.mktemp("kb8") / "kb8.yaml"
    path.write_text(TINY_KB8_YAML)
    cell, cfg, traffic = rehearse_kb8.rehearsal(str(path))
    cfg["system_config"] = {"max_kf": 64, "max_mp": 8192, "local_cap": 2048}
    return cell, cfg, traffic


@pytest.mark.parametrize("params", [TUMVI_1, TUMVI_2])
def test_rays_round_trip_through_the_ports_projection(params):
    """Every pixel of the 512x512 lens, corners past 90 degrees included,
    projects back onto itself within 1e-3 px."""
    from ms_slam_tpu_torch.ops import cameras
    rays = fisheye.kb8_rays(params, 512, 512, "cpu")
    norm = torch.linalg.norm(rays, dim=-1)
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-12)
    assert float(rays[..., 2].min()) < 0          # the corners look back
    uv = cameras.kb8_project(torch.tensor(params, dtype=torch.float64), rays)
    vs, us = torch.meshgrid(torch.arange(512, dtype=torch.float64),
                            torch.arange(512, dtype=torch.float64),
                            indexing="ij")
    err = torch.linalg.norm(uv - torch.stack([us, vs], -1), dim=-1)
    assert float(err.max()) < 1e-3


def test_pixels_past_the_monotonic_range_have_no_ray():
    """A lens whose polynomial turns at 48 degrees: the pixels past the
    turn get a zero ray (and render 0); those inside round-trip."""
    from ms_slam_tpu_torch.ops import cameras
    params = (40.0, 40.0, 31.7, 31.7, 0.0, -0.4, 0.0, 0.0)
    th_max = fisheye.monotonic_range(params[4:])
    assert abs(th_max - 0.5 ** 0.25) < 1e-4      # 1 + 5 k2 t^4 = 0
    rays = fisheye.kb8_rays(params, 64, 64, "cpu")
    live = torch.linalg.norm(rays, dim=-1) > 0
    assert 0 < int(live.sum()) < 64 * 64
    uv = cameras.kb8_project(torch.tensor(params, dtype=torch.float64),
                             rays[live])
    vs, us = torch.meshgrid(torch.arange(64, dtype=torch.float64),
                            torch.arange(64, dtype=torch.float64),
                            indexing="ij")
    px = torch.stack([us, vs], -1)[live]
    assert float(torch.linalg.norm(uv - px, dim=-1).max()) < 1e-3
    wd = world.CorridorWorld.from_seed(3, "cpu", tex_size=768, n_rects=400)
    img = fisheye.render_pair_u8(
        wd, torch.eye(4, dtype=torch.float64)[None], rays, rays,
        torch.eye(4, dtype=torch.float64))[0, 0]
    assert bool((img[~live] == 0).all()) and bool((img[live] > 0).all())


def _pair(rig, seed=7):
    """A rendered pair of the tiny rig, its calibration and camera dict."""
    cell, cfg, traffic = rig
    cfg_sys = inputs.system_config(cfg)
    calib = cfg_sys.calib
    cam = inputs.camera(calib)
    assert cam["model"] == "kb8" and calib.is_fisheye_stereo
    wd = world.CorridorWorld.from_seed(seed, "cpu", **cfg["scene"])
    T = np.eye(4)
    T[2, 3] = 3.0
    left, right = fisheye.render_sequence(wd, T[None], cam, "cpu")[0]
    return cfg_sys, cam, left, right, T


def test_plain_fisheye_frontend_equals_the_ports_and_the_scene(rig):
    """Slot by slot against `process_stereo_fisheye` on a pair whose right
    camera is rotated: no slot differs. The depths against the ray-cast
    scene, as a disparity error bf |1/z - 1/z_true| in pixels of the
    keypoint's level: median under 0.7 and 75% under 1.5 (test_fisheye.py's
    bars of 7% and 15% at its 10 px disparity)."""
    from ms_slam_tpu_torch.pipeline import frontend as port
    cfg_sys, cam, left, right, T = _pair(rig)
    fd = port.process_stereo_fisheye(torch.from_numpy(np.stack([left,
                                                                right])),
                                     cfg_sys.calib, cfg_sys.orb)
    ref = ref_fisheye.stereo_fisheye_frontend(
        left, right, run_cell.reference_orb(cfg_sys), cam, "cpu")
    prog = {"valid": fd.feats.valid.numpy(), "xy": fd.feats.xy.numpy(),
            "octave": fd.feats.octave.numpy(),
            "angle": fd.feats.angle.numpy(), "desc": fd.feats.desc.numpy(),
            "depth": fd.depth.numpy()}
    bad, used = judge.frontend_mismatch(prog, ref)
    assert bad == 0 and used > 300
    assert np.array_equal(prog["depth"], ref["depth"])
    assert (ref["u_right"] == -1).all()

    ok = ref["depth"] > 0
    assert ok.sum() > 150
    rays = judge.keypoint_rays(cam, ref["xy"][ok].astype(np.float64))
    X = judge.ray_cast(rig[1]["scene"],
                       np.repeat(T[None], len(rays), 0), rays)
    z = ((X - T[:3, 3]) @ T[:3, :3])[:, 2]
    level = 1.2 ** ref["octave"][ok]
    disp = cam["bf"] * np.abs(1 / ref["depth"][ok] - 1 / z) / level
    assert np.median(disp) < 0.7 and (disp < 1.5).mean() > 0.75


def test_map_error_reads_zero_at_the_truth_under_kb8(rig):
    """Map points placed where each keypoint's KB8 ray meets the scene read
    ~0; moved 10% along their rays they read 10%."""
    cfg_sys, cam, left, right, T = _pair(rig)
    rng = np.random.default_rng(0)
    n = 200
    xy = rng.uniform(10, 246, (n, 2)).astype(np.float32)
    scene = rig[1]["scene"]
    rays = judge.keypoint_rays(cam, xy.astype(np.float64))
    X = judge.ray_cast(scene, np.repeat(T[None], n, 0), rays)
    inp = type("Inp", (), {"camera": cam, "world": scene,
                           "poses": T[None]})()

    def run(pos):
        return {"map": {"kf_valid": np.array([True]),
                        "obs_mp": np.arange(n)[None],
                        "mp_valid": np.ones(n, bool),
                        "mp_first_kf": np.zeros(n, int),
                        "mp_first_ord": np.zeros(n, int),
                        "kf_ord": np.zeros(1, int),
                        "kf_frame_id": np.zeros(1, int),
                        "kp_xy": xy[None], "mp_pos": pos.astype(np.float32)}}

    err = judge.map_error(run(X), inp, np.eye(4))
    assert len(err) == n and err.max() < 1e-4
    far = T[:3, 3] + 1.1 * (X - T[:3, 3])
    np.testing.assert_allclose(judge.map_error(run(far), inp, np.eye(4)),
                               10.0, atol=1e-3)


def _rehearse(rig):
    cell, cfg, traffic = rig
    return run_cell.run(cell, 2 ** 31 + 29, 8.0, False, "cpu",
                        time.perf_counter(), n_frames=160, cfg=cfg,
                        traffic=traffic)


def test_stereo_inertial_rehearsal_is_judged(rig):
    """The whole run on the KB8 rig: the stored features of the sampled
    keyframes equal the plain fisheye frontend's, no frame is lost, and
    every number of an inertial cell is read."""
    res = _rehearse(rig)
    n = res["numbers"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert n["frontend_kfs"] >= 1 and n["frontend_mismatch_pct"] == 0.0
    assert n["lost_frames"] == 0 and n["map_points_checked"] > 100
    assert n["velocity_kfs"] >= 1 and n["gravity_log"]
    for name in rehearse_kb8.LIMITS:
        assert np.isfinite(n[name]), name


def test_stereo_inertial_rehearsal_descriptor_flip_is_not_correct(
        rig, monkeypatch):
    faults.plant("descriptor_flip", monkeypatch.setattr)
    res = _rehearse(rig)
    assert res["numbers"]["frontend_mismatch_pct"] > 50.0
    assert not run_cell.result_line(res)["correct"]
