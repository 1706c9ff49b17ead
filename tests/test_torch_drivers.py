"""The port's CLI drivers (`ms_slam_tpu_torch/examples/`).

- gen_fake_euroc.write with its defaults writes the same files, byte for
  byte, as the verify skill's gen_fake_euroc.py (a copy of that script's
  source executed with its output directory set to a temporary one; the
  script itself is not edited);
- stereo_kitti, stereo_euroc and stereo_inertial_4season run with
  `--device cpu` over 10 frames of that dataset (320x240, 512 features; its
  frames copied into each dataset's layout): state OK, every frame saved,
  the reference's trajectory formats (KITTI: 12 numbers in %.9e a line;
  TUM: %.6f time and 7 numbers in %.7f) and its report lines;
- evaluate_ate prints what the reference's prints on the same files, with
  and without --scale;
- every driver's --device defaults to cuda.
"""
import importlib.util
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.examples import (evaluate_ate, gen_fake_euroc,
                                        stereo_euroc,
                                        stereo_inertial_4season,
                                        stereo_inertial_euroc, stereo_kitti)

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKILL_SCRIPT = os.path.join(REPO, ".claude", "skills", "verify",
                            "gen_fake_euroc.py")
N_DRIVE = 10
KITTI_LINE = re.compile(r"^(-?\d\.\d{9}e[+-]\d\d ){11}-?\d\.\d{9}e[+-]\d\d$")
TUM_LINE = re.compile(r"^\d+\.\d{6}( -?\d+\.\d{7}){7}$")


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    """The port's dataset, and the skill script's in another directory."""
    root = tmp_path_factory.mktemp("fake")
    port_dir = str(root / "port")
    frames, poses = gen_fake_euroc.write(port_dir)
    src = open(SKILL_SCRIPT).read()
    line = 'OUT = "/tmp/fake_euroc"'
    assert src.count(line) == 1
    skill_dir = str(root / "skill")
    exec(compile(src.replace(line, f"OUT = {skill_dir!r}"), SKILL_SCRIPT,
                 "exec"), {"__name__": "gen_fake_euroc_skill"})
    return {"port": port_dir, "skill": skill_dir, "frames": frames,
            "poses": poses, "root": root}


def _tree(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def test_gen_fake_euroc_writes_the_skill_files(fake):
    got, ref = _tree(fake["port"]), _tree(fake["skill"])
    assert sorted(got) == sorted(ref)
    assert len([k for k in ref if k.endswith(".png")]) == 80
    bad = [k for k in ref if got[k] != ref[k]]
    assert not bad, bad


def _stereo_settings(fake):
    """The dataset's settings without the IMU block (a stereo run)."""
    path = os.path.join(str(fake["root"]), "stereo.yaml")
    text = open(os.path.join(fake["port"], "settings.yaml")).read()
    with open(path, "w") as f:
        f.write("".join(ln for ln in text.splitlines(True)
                        if not ln.startswith("IMU.")))
    return path


def _check_run(slam, capsys, out, line_re, report):
    assert slam.state == "OK"
    assert slam.device == torch.device("cpu")
    lines = open(out).read().splitlines()
    assert len(lines) == N_DRIVE
    bad = [ln for ln in lines if not line_re.match(ln)]
    assert not bad, bad[:2]
    assert np.isfinite(np.loadtxt(out)).all()
    printed = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in printed] == report, printed


def test_stereo_kitti_driver(fake, tmp_path, capsys):
    seq = tmp_path / "seq"
    for cam, kitti in (("cam0", "image_0"), ("cam1", "image_1")):
        (seq / kitti).mkdir(parents=True)
        for i, name in enumerate(sorted(
                os.listdir(os.path.join(fake["port"], "mav0", cam, "data")),
                key=lambda n: int(n[:-4]))):
            shutil.copy(os.path.join(fake["port"], "mav0", cam, "data", name),
                        seq / kitti / f"{i:06d}.png")
    (seq / "times.txt").write_text(
        "\n".join(f"{0.1 * i:e}" for i in range(40)) + "\n")
    out = str(tmp_path / "traj.txt")
    slam = stereo_kitti.main([_stereo_settings(fake), str(seq), "--out", out,
                              "--max-frames", str(N_DRIVE), "--max-kf", "64",
                              "--device", "cpu"])
    _check_run(slam, capsys, out, KITTI_LINE, [
        "-------", "mean tracking time", "median tracking time",
        "max memory usage", "map points", "compressed map points",
        "map memory reduction (measured)", "trajectory saved to " + out])


def test_stereo_euroc_driver(fake, tmp_path, capsys):
    out = str(tmp_path / "traj.txt")
    slam = stereo_euroc.main([_stereo_settings(fake),
                              os.path.join(fake["port"], "mav0"), "--out",
                              out, "--max-frames", str(N_DRIVE), "--device",
                              "cpu"])
    _check_run(slam, capsys, out, TUM_LINE,
               ["mean tracking time", "trajectory saved to " + out])


def test_stereo_inertial_4season_driver(fake, tmp_path, capsys):
    """4Seasons layout: undistorted_images/cam{0,1}/<id>.png, times.txt
    (id t_s) and imu.txt (t_ns gx gy gz ax ay az), the IMU rows taken from
    the EuRoC csv."""
    seq = tmp_path / "seq"
    times = []
    for cam in ("cam0", "cam1"):
        (seq / "undistorted_images" / cam).mkdir(parents=True)
        for name in os.listdir(os.path.join(fake["port"], "mav0", cam,
                                            "data")):
            shutil.copy(os.path.join(fake["port"], "mav0", cam, "data", name),
                        seq / "undistorted_images" / cam / name)
    for name in sorted(os.listdir(seq / "undistorted_images" / "cam0"),
                       key=lambda n: int(n[:-4])):
        times.append(f"{name[:-4]} {int(name[:-4]) * 1e-9:.6f} 0.0")
    (seq / "times.txt").write_text("#id t\n" + "\n".join(times) + "\n")
    csv = open(os.path.join(fake["port"], "mav0", "imu0", "data.csv"))
    (seq / "imu.txt").write_text("".join(
        ln.replace(",", " ") for ln in csv if not ln.startswith("#")))
    out = str(tmp_path / "traj.txt")
    slam = stereo_inertial_4season.main([
        os.path.join(fake["port"], "settings.yaml"), str(seq), "--out", out,
        "--max-frames", str(N_DRIVE), "--device", "cpu"])
    assert slam.cfg.use_imu
    _check_run(slam, capsys, out, TUM_LINE,
               ["mean tracking time", "trajectory saved to " + out])


def _reference_evaluate_ate():
    spec = importlib.util.spec_from_file_location(
        "ref_evaluate_ate", os.path.join(REPO, "examples", "evaluate_ate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scale", [False, True])
def test_evaluate_ate_prints_the_reference_report(fake, tmp_path, capsys,
                                                  monkeypatch, scale):
    gt = os.path.join(fake["port"], "gt.txt")
    rng = np.random.default_rng(2)
    est = str(tmp_path / "est.txt")
    with open(est, "w") as f:
        for i, T in enumerate(fake["poses"][::2]):
            t = T[:3, 3] * 1.3 + rng.normal(scale=0.01, size=3)
            f.write(f"{0.2 * i + 0.004:.6f} {t[0]:.7f} {t[1]:.7f} "
                    f"{t[2]:.7f} 0 0 0 1\n")
    args = [gt, est, "--max-dt", "0.05"] + (["--scale"] if scale else [])
    rmse = evaluate_ate.main(args)
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["evaluate_ate.py"] + args)
    _reference_evaluate_ate().main()
    assert got == capsys.readouterr().out
    assert got.startswith("compared_pose_pairs 20 pairs\n")
    assert (rmse < 0.05) == scale


@pytest.mark.parametrize("mod", [stereo_kitti, stereo_euroc,
                                 stereo_inertial_euroc,
                                 stereo_inertial_4season])
def test_device_defaults_to_cuda(mod, monkeypatch):
    """With no --device the driver asks for the card: without one, the
    System refuses to start before any frame is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen = {}

    class Refused(Exception):
        pass

    def fake_system(cfg, device=None):
        seen["device"] = device
        raise Refused
    monkeypatch.setattr(mod, "System", fake_system)
    for reader in ("KittiOdometry", "EurocStereo"):      # no data is read
        if hasattr(mod, reader):
            monkeypatch.setattr(mod, reader, lambda *a, **k: None)
    if hasattr(mod, "load_4season"):
        monkeypatch.setattr(mod, "load_4season", lambda seq: ([], None))
    with pytest.raises(Refused):
        mod.main([os.path.join(REPO, "configs", "EuRoC-Inertial.yaml"),
                  os.path.join(REPO, "configs")])
    assert seen["device"] == "cuda"
