"""A small rehearsal of whole runs on the CPU through the harness's own
functions (not the measuring entry point, which refuses to run without a
card): the sound run of each cell comes out correct; the control (the
port's bf16 canvas, `MSSLAM_FORCE_TPU_NUMERICS=1`) and each fault of
`faults.py` planted in the timed path come out not correct. 320x240, 512
features, 4 levels, small pools, a sparsification window of 1 keyframe.

    python -m pytest bench_port/tests -q

The card-marked test runs the entry point itself for a short window and
skips, with its reason, where no card is present.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REPO = os.path.dirname(ROOT)
sys.path.insert(0, REPO)
torch.set_num_threads(4)

from bench_port.harness import registry, run_cell  # noqa: E402

sys.path.insert(0, HERE)
import faults  # noqa: E402

TINY_YAML = """Camera.type: "PinHole"
Camera.fx: 200.0
Camera.fy: 200.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.width: 320
Camera.height: 240
Camera.fps: 10.0
Camera.bf: 107.4
ThDepth: 35.0
ORBextractor.nFeatures: 512
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
loopClosing: 1
Sparsification.N: 100
Sparsification.Lambda: 500
Sparsification.GridLambda: 10
Sparsification.WindowLength: 30
Sparsification.NonLocalKF: 30
"""

TINY_IMU_YAML = """Camera.type: "PinHole"
Camera.fx: 200.0
Camera.fy: 200.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.width: 320
Camera.height: 240
Camera.fps: 20.0
Camera.bf: 22.0
ThDepth: 60.0
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
def tiny(tmp_path_factory):
    """The drive cell at 320x240 on the CPU: (cell, config, traffic)."""
    path = tmp_path_factory.mktemp("tiny") / "tiny.yaml"
    path.write_text(TINY_YAML)
    cfg = registry.config("kitti00-02-stereo")
    cfg["yaml_path"] = str(path)
    cfg["system_config"] = {"max_kf": 64, "max_mp": 8192, "local_cap": 2048}
    cfg["settings"]["sparsify_queue_min"]["value"] = 1
    cell = registry.cell("kitti00-02-stereo.drive")
    traffic = registry.traffic("drive")
    traffic["warmup"] = {"rule": "keyframe_steps", "count": 2,
                         "max_frames": 40}
    return cell, cfg, traffic


@pytest.fixture(scope="module")
def tiny_imu(tmp_path_factory):
    """The corridor cell at 320x240 on the CPU: (cell, config, traffic)."""
    path = tmp_path_factory.mktemp("tiny_imu") / "tiny_imu.yaml"
    path.write_text(TINY_IMU_YAML)
    cfg = registry.config("euroc-stereo-inertial")
    cfg["yaml_path"] = str(path)
    cfg["system_config"] = {"max_kf": 64, "max_mp": 8192, "local_cap": 2048}
    return (registry.cell("euroc-stereo-inertial.corridor"), cfg,
            registry.traffic("corridor"))


def _run(tiny, trace=False, seconds=8.0, seed=2 ** 31 + 17, n_frames=80):
    cell, cfg, traffic = tiny
    return run_cell.run(cell, seed, seconds, trace, "cpu",
                        time.perf_counter(), n_frames=n_frames, cfg=cfg,
                        traffic=traffic)


def _line(res) -> dict:
    return run_cell.result_line(res)


def test_sound_run_is_correct(tiny):
    res = _run(tiny)
    line = _line(res)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert res["numbers"]["frontend_mismatch_pct"] == 0.0
    assert res["numbers"]["frontend_kfs"] >= 1
    assert res["numbers"]["select_windows"] >= 1
    assert res["numbers"]["select_diff_pct"] == 0.0
    m = line["metrics"]
    assert m["frames_per_s"]["value"] > 0 and m["setup_s"]["value"] > 0


def test_traced_run_reads_layers(tiny):
    res = _run(tiny, trace=True, seconds=6.0)
    assert res["per_layer"]["track.host_ms"] > 0
    assert res["per_layer"]["frontend.host_ms"] > 0
    assert res["slice"]["frames"] > 0 and res["slice"]["window_s"] > 0
    names = dict(res["slice"]["idle_gaps"])
    assert "call" in names or "track_full" in names
    # no device on the CPU: nothing read as a device number
    assert "patch_gather_roofline" not in res["per_layer"]


def test_control_bf16_canvas_is_not_correct(tiny, monkeypatch):
    faults.plant("control", monkeypatch.setattr, monkeypatch.setenv)
    res = _run(tiny)
    assert res["numbers"]["frontend_mismatch_pct"] > 1.0
    assert not _line(res)["correct"]


def test_fault_state_unchanged(tiny, monkeypatch):
    faults.plant("track_frozen", monkeypatch.setattr)
    res = _run(tiny)
    assert res["numbers"]["ate_pct"] > 2.0
    assert not _line(res)["correct"]


def test_fault_answer_altered(tiny, monkeypatch):
    faults.plant("descriptor_flip", monkeypatch.setattr)
    res = _run(tiny)
    assert res["numbers"]["frontend_mismatch_pct"] > 50.0
    assert not _line(res)["correct"]


def test_fault_half_batch_left_out(tiny, monkeypatch):
    faults.plant("right_dropped", monkeypatch.setattr)
    res = _run(tiny)
    assert not _line(res)["correct"]


def test_fault_selection_first_n(tiny, monkeypatch):
    faults.plant("select_first_n", monkeypatch.setattr)
    res = _run(tiny)
    assert res["numbers"]["select_windows"] >= 1
    assert res["numbers"]["select_diff_pct"] > 5.0
    assert not _line(res)["correct"]


def test_inertial_sound_run_is_correct(tiny_imu):
    res = _run(tiny_imu, seconds=6.0, n_frames=160)
    line = _line(res)
    assert line["correct"], line["checks"]
    n = res["numbers"]
    assert n["velocity_kfs"] >= 1 and n["gravity_log"]


def test_inertial_fault_rows_left_out(tiny_imu, monkeypatch):
    faults.plant("imu_rows_halved", monkeypatch.setattr)
    res = _run(tiny_imu, seconds=6.0, n_frames=160)
    assert not _line(res)["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the entry point measures the "
                    "card only")


@pytest.mark.cuda
def test_entry_point_on_the_card(card):
    cmd = [sys.executable, os.path.join(ROOT, "run.py"), "--workload",
           "kitti00-02-stereo.drive", "--seed", str(2 ** 31 + 5),
           "--seconds", "5", "--trace", "0"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
