"""An unrectified Kannala-Brandt8 (KB8) stereo pair, rendered on the device.

Each camera's rays come from its own KB8 parameters [fx, fy, cx, cy, k1..k4]
(the settings file's `Camera1.*` and `Camera2.*`): the pixel's distorted
angle theta_d = |((u - cx) / fx, (v - cy) / fy)| is inverted through
theta_d = theta (1 + k1 theta^2 + k2 theta^4 + k3 theta^6 + k4 theta^8) by
Newton steps, as `ms_slam_tpu_torch/utils/synth.py`'s `kb8_rays` does, but
in torch on the device and to unit bearings instead of z = 1 rays: a wide
lens (TUM-VI's) sees past 90 degrees at the image's corners, where a z = 1
ray does not exist. A pixel whose theta_d lies past the polynomial's
monotonic range (theta up to pi, or the first turn of the polynomial) has no
ray and renders 0.

The right camera's pose is T_wr = T_wl T_rl^-1, with the rig's full T_rl
(right from left, rotation included). `world.CorridorWorld.cast` takes the
rays as they are.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .world import F64, CorridorWorld

NEWTON_STEPS = 20


def _poly(theta, k):
    """theta_d(theta) and its derivative, for k = (k1, k2, k3, k4)."""
    t2 = theta * theta
    f = theta * (1 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    df = 1 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2]
                                                     + 9 * t2 * k[3])))
    return f, df


def monotonic_range(k) -> float:
    """The largest theta in [0, pi] up to which theta_d(theta) rises."""
    th = np.linspace(0.0, math.pi, 200_001)
    _, df = _poly(th, [float(v) for v in k])
    turn = np.flatnonzero(df <= 0)
    return float(th[turn[0] - 1]) if len(turn) else math.pi


def kb8_bearings(params, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3) float64 unit bearings of the pixels (u, v) of a KB8 camera;
    zero where a pixel lies past the lens's monotonic range."""
    fx, fy, cx, cy = (float(p) for p in params[:4])
    k = [float(p) for p in params[4:8]]
    th_max = monotonic_range(k)
    d_max = float(_poly(th_max, k)[0])
    mx = (u.to(F64) - cx) / fx
    my = (v.to(F64) - cy) / fy
    theta_d = torch.sqrt(mx * mx + my * my)
    th = torch.clamp(theta_d, max=th_max)
    for _ in range(NEWTON_STEPS):
        f, df = _poly(th, k)
        th = torch.clamp(th - (f - theta_d) / torch.clamp(df, min=1e-9),
                         0.0, th_max)
    s = torch.where(theta_d > 1e-12, torch.sin(th)
                    / torch.clamp(theta_d, min=1e-12), torch.ones_like(th))
    rays = torch.stack([mx * s, my * s, torch.cos(th)], -1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)
    return torch.where((theta_d <= d_max)[..., None], rays,
                       torch.zeros_like(rays))


def kb8_rays(params, h: int, w: int, device) -> torch.Tensor:
    """(h, w, 3) `kb8_bearings` of every pixel, on the device."""
    vs, us = torch.meshgrid(torch.arange(h, dtype=F64, device=device),
                            torch.arange(w, dtype=F64, device=device),
                            indexing="ij")
    return kb8_bearings(params, us, vs)


def left_from_right(T_rl) -> np.ndarray:
    """(4, 4) left-from-right, from the 12 floats of right-from-left."""
    T = np.eye(4)
    T[:3, :4] = np.asarray(T_rl, np.float64).reshape(3, 4)
    return np.linalg.inv(T)


def render_pair_u8(world: CorridorWorld, T_wl: torch.Tensor, rays_l, rays_r,
                   T_lr: torch.Tensor) -> torch.Tensor:
    """(B, 2, h, w) uint8 unrectified pairs from the left poses (B, 4, 4);
    values clipped to 0..255 and truncated, as `world.render_stereo_u8`."""
    left = world.cast(T_wl, rays_l)[0]
    right = world.cast(T_wl @ T_lr, rays_r)[0]
    out = torch.stack([left, right], 1).to(torch.float32)
    return out.clamp(0, 255).to(torch.uint8)


def render_sequence(world: CorridorWorld, poses: np.ndarray, camera: dict,
                    device, batch: int = 16) -> list:
    """Every pose's KB8 pair rendered on the device and copied to host
    uint8 arrays: a list of (left, right). `camera` holds the rig's
    `params`, `params2`, `T_rl`, `width` and `height`."""
    h, w = camera["height"], camera["width"]
    rays_l = kb8_rays(camera["params"], h, w, device)
    rays_r = kb8_rays(camera["params2"], h, w, device)
    T_lr = torch.as_tensor(left_from_right(camera["T_rl"]), dtype=F64,
                           device=device)
    frames = []
    for s in range(0, len(poses), batch):
        T = torch.as_tensor(poses[s:s + batch], dtype=F64, device=device)
        pairs = render_pair_u8(world, T, rays_l, rays_r, T_lr).cpu().numpy()
        frames.extend((p[0], p[1]) for p in pairs)
    return frames
