"""The verify skill's recipe through the port's CLI: the fabricated EuRoC
dataset (`examples/gen_fake_euroc.write` at the skill's defaults: 40
stereo frames of 320x240 at 10 Hz, IMU at 200 Hz, 512 features), then
`examples/stereo_inertial_euroc` with `--device cpu` and
`examples/evaluate_ate`. The skill's bars: state OK, `imu initialized:
True`, ATE under 0.1 m against gt.txt.

The reference's driver on the same directory is the `slow` case beside it
(its JAX System takes several minutes on the CPU): the same bars, and the
two ATEs within 0.1 m of each other.
"""
import importlib.util
import os
import sys

import pytest
import torch

from ms_slam_tpu_torch.examples import (evaluate_ate, gen_fake_euroc,
                                        stereo_inertial_euroc)

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fake_euroc"))
    gen_fake_euroc.write(d)
    return d


@pytest.fixture(scope="module")
def port_run(dataset, tmp_path_factory):
    traj = str(tmp_path_factory.mktemp("port") / "traj.txt")
    slam = stereo_inertial_euroc.main([
        os.path.join(dataset, "settings.yaml"), os.path.join(dataset, "mav0"),
        "--out", traj, "--device", "cpu"])
    return slam, traj


def test_port_driver_meets_the_skill_bars(dataset, port_run, capsys):
    slam, traj = port_run
    assert slam.state == "OK"
    assert slam.imu_initialized
    assert len(slam.trajectory) == 40
    ate = evaluate_ate.main([os.path.join(dataset, "gt.txt"), traj,
                             "--max-dt", "0.05"])
    out = capsys.readouterr().out
    assert "compared_pose_pairs 40 pairs" in out
    assert ate < 0.1, ate


def _reference_module(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_reference_driver_on_the_same_directory(dataset, port_run, tmp_path,
                                                capsys, monkeypatch):
    traj = str(tmp_path / "ref_traj.txt")
    monkeypatch.setattr(sys, "argv", [
        "stereo_inertial_euroc.py", os.path.join(dataset, "settings.yaml"),
        os.path.join(dataset, "mav0"), "--out", traj])
    _reference_module("stereo_inertial_euroc").main()
    assert "imu initialized: True" in capsys.readouterr().out
    gt = os.path.join(dataset, "gt.txt")
    ates = []
    for est in (traj, port_run[1]):
        ates.append(evaluate_ate.main([gt, est, "--max-dt", "0.05"]))
    assert ates[0] < 0.1 and abs(ates[0] - ates[1]) < 0.1, ates
