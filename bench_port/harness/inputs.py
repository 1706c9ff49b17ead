"""A cell's inputs, made from the seed: the System's configuration, the
rendered stereo pairs (on the device, copied to host uint8 before the
window, as a camera delivers them), the ground-truth poses and, for an
inertial configuration, the IMU rows with their true bias."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..scenes import motion, world


@dataclasses.dataclass
class Inputs:
    frames: list            # (left, right) uint8 arrays
    poses: np.ndarray       # (n, 4, 4) ground-truth T_wc
    fps: float
    imu: list | None        # rows before frame i at imu[i - 1]
    bias: np.ndarray | None  # true [bg, ba]
    T_bc: np.ndarray | None
    world: dict             # the scene's parameters (for the judge)
    camera: dict            # fx, fy, cx, cy, width, height, bf


def seed64(seed: int) -> int:
    return int(seed) % (2 ** 63)


def system_config(cfg: dict):
    """The configuration the cell runs: the settings file through
    `Settings.system_config`, then the upstream settings that reader does
    not set, then the keys the configuration cuts."""
    from ms_slam_tpu_torch.utils.config import Settings
    st = Settings(cfg["yaml_path"])
    sc = st.system_config(**cfg.get("system_config", {}))
    fields = {}
    for group in ("settings", "reduced"):
        fields.update({v["field"]: v["value"]
                       for v in cfg.get(group, {}).values()})
    return dataclasses.replace(sc, **fields)


def frame_count(traffic: dict, seconds: float) -> int:
    """Frames to render: the warm-up's cap, the window at the mix's highest
    rate, a traced run's profiler slice after it, and the lookahead."""
    tr = traffic.get("trace", {})
    return (int(traffic["warmup"]["max_frames"])
            + int(math.ceil(float(traffic["max_fps"]) * seconds))
            + int(tr.get("skip_frames", 2)) + int(tr.get("frames", 12)) + 4)


def make(cfg_sys, cfg: dict, traffic: dict, seed: int, seconds: float,
         device, n_frames: int | None = None) -> Inputs:
    calib = cfg_sys.calib
    fx, fy, cx, cy = calib.params[:4]
    h, w = calib.height, calib.width
    fps = float(calib.fps)
    n = n_frames or frame_count(traffic, seconds)
    scene = dict(cfg["scene"])
    period = float(scene.get("tex_scale", 0.05)) * int(scene.get("tex_size",
                                                                 4096))
    travel = float(traffic["motion"]["speed_m_per_frame"]) * (n - 1)
    if travel >= period:
        raise ValueError(f"{n} frames travel {travel:.1f} m, past the "
                         f"texture's period of {period:.1f} m")
    poses = motion.poses(n, traffic["motion"], fps)
    wd = world.CorridorWorld.from_seed(seed64(seed), device, **scene)
    rays = world.pinhole_rays(fx, fy, cx, cy, h, w, device)
    frames = world.render_sequence(wd, poses, rays, calib.bf / fx)
    del wd, rays
    imu = bias = T_bc = None
    if cfg_sys.use_imu:
        T_bc = (np.eye(4) if cfg_sys.Tbc is None
                else np.asarray(cfg_sys.Tbc, np.float64).reshape(4, 4))
        noise = dict(traffic["imu"])
        noise.update(gyro=cfg_sys.imu_noise_gyro, acc=cfg_sys.imu_noise_acc)
        imu, bias = motion.imu_rows(poses, T_bc, fps,
                                    float(traffic["imu"]["rate_hz"]), noise,
                                    seed64(seed) ^ 0x1A2B)
    return Inputs(frames=frames, poses=poses, fps=fps, imu=imu, bias=bias,
                  T_bc=T_bc, world=scene,
                  camera=dict(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h,
                              bf=calib.bf))
