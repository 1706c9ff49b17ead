"""Ground-truth motion and IMU rows from a traffic mix's parameters.

`poses` is the one general trajectory generator: a forward run along +z
at a fixed speed a frame, with optional lateral (x) and vertical (y)
sinusoids and a sinusoidal yaw, pitch and roll, all functions of time
(frame / fps), so that the excitation does not stretch with the frame
count. With every amplitude 0 it is `ms_slam_tpu_torch/utils/synth.py`'s
`make_trajectory(n, "forward")` at that speed.

`make_imu` is a frozen copy of the same module's `make_imu`, evaluated for
every row at once: body-frame specific force and angular rate at
`imu_rate` between consecutive frames, from a cubic spline of the body
positions and a slerp of its rotations, gravity (0, g, 0) in the y-down
world. `imu_rows` adds a constant bias and white noise from the seed, and
`body_velocity` is the first derivative of the same spline.
"""
from __future__ import annotations

import numpy as np


def _rotation(axis: int, a: np.ndarray) -> np.ndarray:
    """(n, 3, 3) rotations by the angles a about +x, +y or +z (axis 0, 1,
    2), as `Rotation.from_euler("xyz"[axis], a)`."""
    i, j = (axis + 1) % 3, (axis + 2) % 3
    c, s = np.cos(a), np.sin(a)
    R = np.zeros((len(a), 3, 3))
    R[:, axis, axis] = 1.0
    R[:, i, i] = c
    R[:, i, j] = -s
    R[:, j, i] = s
    R[:, j, j] = c
    return R


def _yaw(a: np.ndarray) -> np.ndarray:
    """(n, 3, 3) rotations about +y."""
    return _rotation(1, a)


def poses(n: int, motion: dict, fps: float) -> np.ndarray:
    """(n, 4, 4) float64 camera-to-world poses T_wc. The rotation is
    yaw (about y), then pitch (about x), then roll (about z), in the
    camera's frame; a mix without a pitch or a roll wave gets the yaw
    alone, with no product taken, so its poses keep their bits."""
    i = np.arange(n, dtype=np.float64)
    t = i / fps

    def wave(key):
        w = motion.get(key) or {}
        amp = float(w.get("amp", 0.0))
        if amp == 0.0:
            return np.zeros(n)
        return amp * np.sin(2 * np.pi * float(w["hz"]) * t
                            + float(w.get("phase", 0.0)))

    T = np.tile(np.eye(4), (n, 1, 1))
    T[:, 0, 3] = wave("lateral_m")
    T[:, 1, 3] = wave("vertical_m")
    T[:, 2, 3] = float(motion["speed_m_per_frame"]) * i
    R = _yaw(wave("yaw_rad"))
    for key, axis in (("pitch_rad", 0), ("roll_rad", 2)):
        if key in motion:
            R = R @ _rotation(axis, wave(key))
    T[:, :3, :3] = R
    return T


def make_imu(poses_wb: np.ndarray, frame_dt: float, imu_rate: int = 20,
             g: float = 9.81) -> list:
    """Per frame interval i (1 .. n-1), an (M, 7) array of rows
    [dt, ax, ay, az, gx, gy, gz] of the body whose world poses are given."""
    from scipy.interpolate import CubicSpline
    from scipy.spatial.transform import Rotation, Slerp
    n = len(poses_wb)
    ts = np.arange(n) * frame_dt
    pos_sp = CubicSpline(ts, poses_wb[:, :3, 3])
    slerp = Slerp(ts, Rotation.from_matrix(poses_wb[:, :3, :3]))
    g_w = np.array([0.0, g, 0.0])
    sub = max(int(round(imu_rate * frame_dt)), 2)
    tt = np.linspace(ts[:-1], ts[1:], sub + 1, axis=1)        # (n-1, sub+1)
    dt = np.repeat((tt[:, 1] - tt[:, 0])[:, None], sub, 1)
    tm = np.clip(tt[:, :sub], ts[0] + 1e-6, ts[-1] - 1e-6).reshape(-1)
    t2 = np.clip(tm + dt.reshape(-1), ts[0] + 1e-6, ts[-1] - 1e-6)
    a_w = pos_sp(tm, 2)
    R = slerp(tm).as_matrix()
    R2 = slerp(t2).as_matrix()
    rel = np.stack([R[k].T @ R2[k] for k in range(len(tm))])
    omega = Rotation.from_matrix(rel).as_rotvec() / dt.reshape(-1, 1)
    acc = np.stack([R[k].T @ (a_w[k] - g_w) for k in range(len(tm))])
    rows = np.concatenate([dt.reshape(-1, 1), acc, omega], 1)
    return list(rows.reshape(n - 1, sub, 7))


def imu_rows(poses_wc: np.ndarray, T_bc: np.ndarray, fps: float,
             rate: float, noise: dict, seed: int):
    """Rows of an IMU at T_bc (camera to body) on the camera's trajectory,
    with a constant bias [bg, ba] drawn from the seed inside the mix's
    `bias_gyro` / `bias_acc` bounds and white noise at the configuration's
    densities (sigma = density * sqrt(rate)). Returns (rows, bias)."""
    T_cb = np.linalg.inv(T_bc)
    rows = make_imu(poses_wc @ T_cb, 1.0 / fps, imu_rate=int(rate))
    rng = np.random.default_rng(seed)
    bias = np.concatenate([
        rng.uniform(-1, 1, 3) * float(noise["bias_gyro"]),
        rng.uniform(-1, 1, 3) * float(noise["bias_acc"])])
    sg = float(noise["gyro"]) * np.sqrt(rate)
    sa = float(noise["acc"]) * np.sqrt(rate)
    out = []
    for r in rows:
        r = r.copy()
        r[:, 1:4] += bias[3:] + rng.normal(0.0, sa, (len(r), 3))
        r[:, 4:7] += bias[:3] + rng.normal(0.0, sg, (len(r), 3))
        out.append(r.astype(np.float32))
    return out, bias



def body_velocity(poses_wc: np.ndarray, T_bc: np.ndarray, fps: float,
                  frames: np.ndarray) -> np.ndarray:
    """(len(frames), 3) world velocity of the body at T_bc at those frames:
    the derivative of the cubic spline of body positions that `make_imu`
    takes its accelerations from."""
    from scipy.interpolate import CubicSpline
    p_wb = (poses_wc @ np.linalg.inv(T_bc))[:, :3, 3]
    ts = np.arange(len(poses_wc)) / fps
    return CubicSpline(ts, p_wb)(np.asarray(frames) / fps, 1)
