"""The TUM-VI walk cell's files on the CPU: the configuration as the System
runs it, its yaml against the two settings files it is made of, the mix,
the two per-layer readers and the "right rows off" fault.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

from bench_port.harness import inputs, registry  # noqa: E402

import faults  # noqa: E402
import rig_faults  # noqa: E402,F401

CELL = "tumvi-stereo-inertial.walk"


def test_configuration_as_run():
    cell = registry.cell(CELL)
    cfg = registry.config(cell["config"])
    sc = inputs.system_config(cfg)
    calib = sc.calib
    assert calib.is_fisheye_stereo and calib.model == 1
    assert (calib.width, calib.height, calib.fps) == (512, 512, 20.0)
    assert calib.lapping == (0, 511, 0, 511)
    assert (sc.orb.n_features, sc.orb.n_levels, sc.orb.scale_factor) == \
        (1024, 8, 1.2)
    assert sc.use_imu and sc.loop_closing
    assert (sc.nonlocal_kf, sc.sparsify_queue_min) == (3, 11)
    T12 = np.eye(4)
    T12[:3] = np.linalg.inv(np.vstack([np.reshape(calib.T_rl, (3, 4)),
                                       [0, 0, 0, 1]]))[:3]
    assert abs(np.linalg.norm(T12[:3, 3]) - 0.1011) < 1e-3
    assert cfg["reduced"] == {"Sparsification.NonLocalKF": {
        "field": "nonlocal_kf", "value": 3, "published": 15}}


def test_yaml_is_the_rig_and_the_euroc_imu_block():
    from ms_slam_tpu_torch.utils.config import Settings
    mine = Settings(registry.config("tumvi-stereo-inertial")["yaml_path"])
    rig = Settings(os.path.join(REPO, "configs", "TUM-VI-Fisheye.yaml"))
    imu = Settings(os.path.join(REPO, "configs", "EuRoC-Inertial.yaml"))
    for key, value in rig.flat.items():
        assert np.array_equal(np.asarray(mine.flat[key]),
                              np.asarray(value)), key
    imu_keys = [k for k in imu.flat if k.startswith("IMU.")]
    assert len(imu_keys) >= 6
    for key in imu_keys:
        assert np.array_equal(np.asarray(mine.flat[key]),
                              np.asarray(imu.flat[key])), key
    assert set(mine.flat) == set(rig.flat) | set(imu_keys)


def test_walk_mix():
    t = registry.traffic("walk")
    m = t["motion"]
    assert m["speed_m_per_frame"] == 0.05
    assert m["lateral_m"] == {"amp": 0.08, "hz": 0.8, "phase": 1.0}
    assert m["vertical_m"] == {"amp": 0.05, "hz": 1.7}
    assert m["yaw_rad"] == {"amp": 0.1, "hz": 0.25}
    assert m["pitch_rad"] == {"amp": 0.05, "hz": 0.4, "phase": 0.5}
    assert m["roll_rad"] == {"amp": 0.04, "hz": 0.3, "phase": 2.0}
    assert t["imu"] == {"rate_hz": 200, "bias_gyro": 0.005,
                        "bias_acc": 0.05}
    assert t["max_fps"] == 15
    assert t["warmup"] == {"rule": "imu_initialized", "max_frames": 200}
    assert t["trace"] == {"skip_frames": 2, "frames": 12}


def test_readers():
    assert [n for n, _ in registry.per_layer_for(CELL)
            if n.startswith("rig.")] == ["rig.kb8_pair_ms",
                                          "rig.right_rows_per_frame"]
    for other in ("kitti00-02-stereo.drive",
                  "euroc-stereo-inertial.corridor"):
        assert not any(n.startswith("rig.")
                       for n, _ in registry.per_layer_for(other))
    pair = registry.metric_reader("rig.kb8_pair_ms")
    rows = registry.metric_reader("rig.right_rows_per_frame")
    empty = {"frames": 4, "timing": {}}
    assert pair(empty) is None and rows(empty) is None
    rec = {"frames": 4, "timing": {"frontend.kb8_pair": [0.004] * 4,
                                   "rig.right_rows": [900.0, 1100.0]}}
    assert abs(pair(rec) - 4.0) < 1e-9
    assert rows(rec) == 1000.0


def test_right_rows_off_fault(monkeypatch):
    from ms_slam_tpu_torch.pipeline import frontend, system
    from ms_slam_tpu_torch.ops.orb import OrbConfig

    class Frame:
        right = torch.tensor([[10.0, 20.0, 1.0], [-1.0, -1.0, -1.0]])

        def _replace(self, **k):
            out = Frame()
            out.right = k["right"]
            return out

    monkeypatch.setattr(system, "process_stereo_fisheye",
                        lambda *a, **k: Frame())
    faults.plant("right_rows_off", monkeypatch.setattr)
    fr = system.process_stereo_fisheye(None, frontend.Calib(
        model=1, params=(1.0,) * 8, bf=0.0, width=4, height=4),
        OrbConfig())
    assert (fr.right == -1.0).all()
    with pytest.raises(KeyError):
        faults.plant("no_such_fault", monkeypatch.setattr)
