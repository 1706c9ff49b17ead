"""A cell's inputs, made from the seed: the System's configuration, the
rendered stereo pairs (on the device, copied to host uint8 before the
window, as a camera delivers them), the ground-truth poses and, for an
inertial configuration, the IMU rows with their true bias.

The rig is the configuration's own, as the port's settings reader builds
its `Calib`: an unrectified Kannala-Brandt8 pair (`scenes/fisheye.py`)
where the calibration is a KB8 stereo-fisheye one, and a rectified pinhole
pair (`scenes/world.py`) for anything else."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..scenes import fisheye, motion, world


@dataclasses.dataclass
class Inputs:
    frames: list            # (left, right) uint8 arrays
    poses: np.ndarray       # (n, 4, 4) ground-truth T_wc
    fps: float
    imu: list | None        # rows before frame i at imu[i - 1]
    bias: np.ndarray | None  # true [bg, ba]
    T_bc: np.ndarray | None
    world: dict             # the scene's parameters (for the judge)
    camera: dict            # the rig: see `camera`


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


def camera(calib) -> dict:
    """The rig the harness renders and the judge reads: `model` "kb8" (an
    unrectified KB8 pair: `params`, `params2` of 8, `T_rl` of 12, right
    from left, `lapping` columns) or "pinhole" (a rectified pair, the right
    camera bf / fx along +x), with fx, fy, cx, cy, width, height, bf."""
    from ms_slam_tpu_torch.ops import cameras
    kb8 = calib.model == cameras.KB8 and calib.is_fisheye_stereo
    fx, fy, cx, cy = calib.params[:4]
    return dict(model="kb8" if kb8 else "pinhole", fx=fx, fy=fy, cx=cx,
                cy=cy, width=calib.width, height=calib.height, bf=calib.bf,
                params=tuple(calib.params), params2=tuple(calib.params2),
                T_rl=tuple(calib.T_rl), lapping=tuple(calib.lapping))


def frame_count(traffic: dict, seconds: float) -> int:
    """Frames to render: the warm-up's cap, the window at the mix's highest
    rate, a traced run's profiler slice after it, and the lookahead."""
    tr = traffic.get("trace", {})
    return (int(traffic["warmup"]["max_frames"])
            + int(math.ceil(float(traffic["max_fps"]) * seconds))
            + int(tr.get("skip_frames", 2)) + int(tr.get("frames", 12)) + 4)


def distinct_length(scene: dict) -> float:
    """Metres of corridor before its walls repeat: the texture's period,
    times the strips that `wrap_shift` visits before it comes round, where
    no rectangle reaches from one strip into the next."""
    size = int(scene.get("tex_size", 4096))
    scale = float(scene.get("tex_scale", 0.05))
    shift = int(scene.get("wrap_shift", 0))
    if not shift:
        return scale * size
    band = max(scene.get("y_floor", 1.6) - scene.get("y_ceil", -2.2),
               2 * scene.get("half_w", 3.0)) / scale
    rect = int(scene.get("rect_max") or size // 6)
    gap = math.gcd(size, shift)
    if gap < band + rect:
        raise ValueError(f"wrap_shift {shift} leaves strips {gap} rows "
                         f"apart, under the {band:.0f} rows in view and "
                         f"the {rect}-row rectangles")
    return scale * size * (size // gap)


def view_depth(scene: dict, cam: dict, move: dict) -> float:
    """The farthest depth at which the camera resolves the walls: where the
    longest rectangle, on the plane farthest from the camera, still spans
    one pixel along the corridor, f m (1/z - 1/(z + s)) = 1."""
    amp = {k: abs(float(move.get(k, {}).get("amp", 0.0)))
           for k in ("lateral_m", "vertical_m")}
    m = max(scene.get("half_w", 3.0) + amp["lateral_m"],
            scene.get("y_floor", 1.6) + amp["vertical_m"],
            -scene.get("y_ceil", -2.2) + amp["vertical_m"])
    f = max(cam["fx"], cam["fy"])
    rect = int(scene.get("rect_max") or int(scene.get("tex_size", 4096)) // 6)
    s = float(scene.get("tex_scale", 0.05)) * rect
    return 0.5 * (-s + math.sqrt(s * s + 4.0 * f * m * s))


def seen_length(scene: dict, cam: dict, move: dict, n: int) -> float:
    """Metres of corridor that n frames see: the travel, the view ahead of
    the last frame and, for a lens that sees past 90 degrees, the view
    behind the first."""
    view = view_depth(scene, cam, move)
    back = view if cam["model"] == "kb8" else 0.0
    return float(move["speed_m_per_frame"]) * (n - 1) + view + back


def make(cfg_sys, cfg: dict, traffic: dict, seed: int, seconds: float,
         device, n_frames: int | None = None) -> Inputs:
    calib = cfg_sys.calib
    cam = camera(calib)
    fps = float(calib.fps)
    n = n_frames or frame_count(traffic, seconds)
    scene = dict(cfg["scene"])
    seen = seen_length(scene, cam, traffic["motion"], n)
    if seen >= distinct_length(scene):
        raise ValueError(f"{n} frames see {seen:.1f} m of corridor, past "
                         f"the {distinct_length(scene):.1f} m before its "
                         "walls repeat")
    poses = motion.poses(n, traffic["motion"], fps)
    wd = world.CorridorWorld.from_seed(seed64(seed), device, **scene)
    if cam["model"] == "kb8":
        frames = fisheye.render_sequence(wd, poses, cam, device)
    else:
        rays = world.pinhole_rays(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                  cam["height"], cam["width"], device)
        frames = world.render_sequence(wd, poses, rays, calib.bf / cam["fx"])
        del rays
    del wd
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
                  T_bc=T_bc, world=scene, camera=cam)
