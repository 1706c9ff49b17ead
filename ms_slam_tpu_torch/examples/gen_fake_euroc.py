"""Fabricate a small EuRoC-layout dataset from the synthetic renderer:
mav0/cam{0,1}/data PNGs + data.csv, mav0/imu0/data.csv, a settings yaml
and the TUM-format ground truth gt.txt.

The port's copy of the verify skill's gen_fake_euroc.py (which renders with
the JAX package's `utils.synth`), on the port's own `utils.synth`; `write`
with its defaults writes the same files. PNGs are written with cv2.

Usage: python -m ms_slam_tpu_torch.examples.gen_fake_euroc [OUT_DIR]
(default /tmp/fake_euroc, the skill's directory), then

    python -m ms_slam_tpu_torch.examples.stereo_inertial_euroc \\
        OUT_DIR/settings.yaml OUT_DIR/mav0 --out traj.txt
    python -m ms_slam_tpu_torch.examples.evaluate_ate OUT_DIR/gt.txt \\
        traj.txt --max-dt 0.05
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..utils import synth

# the skill's IMU block, as yaml scalars (written verbatim)
SKILL_IMU_NOISE = ("1.0e-3", "1.0e-2", "1.0e-6", "1.0e-4")


def scene(width=320, height=240, fx=260.0, fps=10.0, n=40, seed=3):
    """The skill's scene: PlaneWorld(z_wall=14, y_floor=2) from the seed,
    n poses of the "arc" path at fps, IMU rows at 200 Hz (noise-free);
    returns (world, K, poses, imu rows per interval)."""
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    poses = synth.make_trajectory(n, "arc")
    imu = synth.make_imu(poses, 1.0 / fps, imu_rate=200)
    return world, K, poses, imu


def render(world, K, poses, baseline, width, height):
    """The uint8 (left, right) pair at each pose, as the skill writes it."""
    return [tuple(np.asarray(im, np.uint8) for im in
                  world.render_stereo(K, T_wc, baseline, height, width))
            for T_wc in poses]


def settings_text(width, height, fx, baseline, fps, n_features, n_levels,
                  imu_noise=SKILL_IMU_NOISE) -> str:
    """The skill's settings yaml for these arguments; imu_noise is
    (NoiseGyro, NoiseAcc, GyroWalk, AccWalk) as yaml scalars."""
    ng, na, gw, aw = imu_noise
    return f"""Camera.type: "PinHole"
Camera.fx: {fx}
Camera.fy: {fx}
Camera.cx: {width / 2}
Camera.cy: {height / 2}
Camera.width: {width}
Camera.height: {height}
Camera.fps: {fps}
Camera.bf: {fx * baseline}
ThDepth: {baseline * 40}

ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: {n_levels}
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7

loopClosing: 1

Sparsification.N: 40
Sparsification.Lambda: 500
Sparsification.GridLambda: 10
Sparsification.WindowLength: 4
Sparsification.NonLocalKF: 3

IMU.NoiseGyro: {ng}
IMU.NoiseAcc: {na}
IMU.GyroWalk: {gw}
IMU.AccWalk: {aw}
"""


def write_text(out_dir, poses, imu, fps, settings: str) -> None:
    """Everything but the images: the camera and IMU csv files, gt.txt and
    settings.yaml."""
    for c in ("cam0", "cam1"):
        os.makedirs(f"{out_dir}/mav0/{c}/data", exist_ok=True)
    os.makedirs(f"{out_dir}/mav0/imu0", exist_ok=True)
    cam_rows, imu_rows, gt_rows = [], [], []
    for i, T_wc in enumerate(poses):
        t_ns = int(round(i / fps * 1e9))
        cam_rows.append(f"{t_ns},{t_ns}.png")
        gt_rows.append("%.6f %f %f %f 0 0 0 1"
                       % ((i / fps,) + tuple(T_wc[:3, 3])))
        if i > 0:
            # make_imu rows: [dt, ax, ay, az, gx, gy, gz] for interval i-1->i
            tacc = (i - 1) / fps
            for r in imu[i - 1]:
                tacc += float(r[0])
                imu_rows.append(
                    "%d,%.9f,%.9f,%.9f,%.9f,%.9f,%.9f"
                    % ((int(round(tacc * 1e9)),)
                       + tuple(r[4:7]) + tuple(r[1:4])))
    for c in ("cam0", "cam1"):
        with open(f"{out_dir}/mav0/{c}/data.csv", "w") as f:
            f.write("#t,fn\n" + "\n".join(cam_rows) + "\n")
    with open(f"{out_dir}/mav0/imu0/data.csv", "w") as f:
        f.write("#t,gx,gy,gz,ax,ay,az\n" + "\n".join(imu_rows) + "\n")
    with open(f"{out_dir}/gt.txt", "w") as f:
        f.write("\n".join(gt_rows) + "\n")
    with open(f"{out_dir}/settings.yaml", "w") as f:
        f.write(settings)


def write(out_dir, width=320, height=240, fx=260.0, baseline=0.15, fps=10.0,
          n=40, n_features=512, n_levels=4, seed=3,
          imu_noise=SKILL_IMU_NOISE):
    """Render and write the dataset; returns the rendered (left, right)
    uint8 pairs and the ground-truth camera-to-world poses."""
    import cv2
    world, K, poses, imu = scene(width, height, fx, fps, n, seed)
    frames = render(world, K, poses, baseline, width, height)
    write_text(out_dir, poses, imu, fps,
               settings_text(width, height, fx, baseline, fps, n_features,
                             n_levels, imu_noise))
    for i, (im_l, im_r) in enumerate(frames):
        t_ns = int(round(i / fps * 1e9))
        cv2.imwrite(f"{out_dir}/mav0/cam0/data/{t_ns}.png", im_l)
        cv2.imwrite(f"{out_dir}/mav0/cam1/data/{t_ns}.png", im_r)
    return frames, poses


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/fake_euroc"
    write(out)
    print("fabricated", out)
