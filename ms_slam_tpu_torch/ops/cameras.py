"""Batched camera models: pinhole and Kannala-Brandt8 (fisheye).

Port of `ms_slam_tpu/ops/cameras.py`. Each model is a set of functions over
a flat parameter vector padded to length 8 (pinhole [fx, fy, cx, cy], KB8
[fx, fy, cx, cy, k0, k1, k2, k3]); `model` is a Python int that picks one.
Projection Jacobians are analytic.
"""
from __future__ import annotations

import math

import torch

PINHOLE = 0
KB8 = 1

_Z_MIN = 1e-6


def pinhole_project(params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (...,3) -> pixels (...,2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = torch.clamp(Xc[..., 2], min=_Z_MIN)
    return torch.stack([fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy],
                       dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (...,2) -> unit-depth bearing (...,3) with z=1."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(Xc): (...,2,3)."""
    fx, fy = params[0], params[1]
    x, y = Xc[..., 0], Xc[..., 1]
    z = torch.clamp(Xc[..., 2], min=_Z_MIN)
    zi = 1.0 / z
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    row1 = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _poly(theta, k0, k1, k2, k3):
    """theta_d = theta (1 + k0 t^2 + k1 t^4 + k2 t^6 + k3 t^8) and its
    derivative in theta."""
    t2 = theta * theta
    f = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    df = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + 9 * t2 * k3)))
    return f, df


def kb8_project(params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (...,3) -> pixels (...,2); a point on the optical
    axis (r <= 1e-8) takes the radial scale 1."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=0.0))
    theta_d, _ = _poly(torch.atan2(r, z), *params[4:8])
    inv_r = 1.0 / torch.clamp(r, min=1e-8)
    scale = torch.where(r > 1e-8, theta_d * inv_r, torch.ones_like(r))
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor,
                  iters: int = 10) -> torch.Tensor:
    """Pixels -> bearing with z=1: a fixed count of Newton steps on theta
    from theta_d clipped to +-pi/2."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, -math.pi / 2, math.pi / 2)
    theta = theta_d_c
    for _ in range(iters):
        f, df = _poly(theta, *params[4:8])
        theta = theta - (f - theta_d_c) / torch.where(
            torch.abs(df) > 1e-8, df, torch.ones_like(df))
    scale = torch.where(theta_d > 1e-8,
                        torch.tan(theta) / torch.clamp(theta_d, min=1e-8),
                        torch.ones_like(theta_d))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Analytic d(uv)/d(Xc): (...,2,3); r is floored at 1e-6 (r^2 at
    1e-12)."""
    fx, fy = params[0], params[1]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r2 = torch.clamp(x * x + y * y, min=1e-12)
    r = torch.sqrt(r2)
    R2 = r2 + z * z
    f, fp = _poly(torch.atan2(r, z), *params[4:8])
    dth_dx = x * z / (R2 * r)
    dth_dy = y * z / (R2 * r)
    dth_dz = -r / R2
    g = f / r                                     # radial scale
    dg_dx = (fp * dth_dx * r - f * (x / r)) / r2
    dg_dy = (fp * dth_dy * r - f * (y / r)) / r2
    dg_dz = fp * dth_dz / r
    row0 = torch.stack([fx * (g + x * dg_dx), fx * x * dg_dy,
                        fx * x * dg_dz], dim=-1)
    row1 = torch.stack([fy * y * dg_dx, fy * (g + y * dg_dy),
                        fy * y * dg_dz], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def project(model: int, params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    if model == PINHOLE:
        return pinhole_project(params, Xc)
    return kb8_project(params, Xc)


def unproject(model: int, params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    if model == PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(model: int, params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    if model == PINHOLE:
        return pinhole_project_jac(params, Xc)
    return kb8_project_jac(params, Xc)


def pad_params(p) -> torch.Tensor:
    """Camera parameters as a float32 vector zero-padded to length 8."""
    p = torch.as_tensor(p, dtype=torch.float32)
    return torch.nn.functional.pad(p, (0, 8 - p.shape[0]))
