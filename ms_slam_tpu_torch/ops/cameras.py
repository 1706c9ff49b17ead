"""Batched camera models: pinhole and Kannala-Brandt8 (fisheye).

Port of `ms_slam_tpu/ops/cameras.py`. Each model is a set of functions over
a flat parameter vector padded to length 8 (pinhole [fx, fy, cx, cy], KB8
[fx, fy, cx, cy, k0, k1, k2, k3]), or one such vector per point (..., 8);
`model` is a Python int that picks one. Projection Jacobians are analytic.

An unrectified stereo pair adds a second lens: `Rig` holds it and the
right-from-left transform; the solvers project left-camera points through
both into the right image (the observation model of upstream's
`EdgeSE3ProjectXYZ[OnlyPose]ToBody`), each row with its own lens.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

PINHOLE = 0
KB8 = 1

_Z_MIN = 1e-6


def pinhole_project(params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (...,3) -> pixels (...,2)."""
    fx, fy, cx, cy = (params[..., k] for k in range(4))
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
    fx, fy = params[..., 0], params[..., 1]
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
    fx, fy, cx, cy = (params[..., k] for k in range(4))
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=0.0))
    theta_d, _ = _poly(torch.atan2(r, z), *(params[..., k]
                                            for k in range(4, 8)))
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
    fx, fy = params[..., 0], params[..., 1]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r2 = torch.clamp(x * x + y * y, min=1e-12)
    r = torch.sqrt(r2)
    R2 = r2 + z * z
    f, fp = _poly(torch.atan2(r, z), *(params[..., k] for k in range(4, 8)))
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


class Rig(NamedTuple):
    """The second camera of an unrectified pair: its lens parameters
    (padded to 8, the first camera's model) and T_rl = [R_rl | t_rl],
    which maps left-camera coordinates into right-camera ones."""

    params2: torch.Tensor   # (8,)
    T: torch.Tensor         # (3,4), contiguous

    @property
    def R_rl(self) -> torch.Tensor:
        return self.T[:, :3]

    @property
    def t_rl(self) -> torch.Tensor:
        return self.T[:, 3]

    def to(self, dtype) -> "Rig":
        return Rig(self.params2.to(dtype), self.T.to(dtype))


def rig_project(model: int, params: torch.Tensor, rig: Rig, Xc: torch.Tensor,
                jac: bool = True):
    """Left-camera points (F,3) seen by both cameras of an unrectified
    pair: the camera points of 2F rows (the left camera's, then the right
    camera's through T_rl), their pixels (2F,2), each row through its own
    lens, and with `jac` d(pixel)/d(Xc) (2F,2,3), the right rows chained
    through R_rl (else None)."""
    F = Xc.shape[0]
    Xs = torch.cat([Xc, Xc @ rig.R_rl.T + rig.t_rl])
    p_rows = torch.cat([params.expand(F, 8), rig.params2.expand(F, 8)])
    uv = project(model, p_rows, Xs)
    if not jac:
        return Xs, uv, None
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(F, 3, 3)
    return Xs, uv, project_jac(model, p_rows, Xs) @ torch.cat(
        [eye, rig.R_rl.expand(F, 3, 3)])


def right_info(right: torch.Tensor, valid: torch.Tensor):
    """The right rows' information and validity, from each factor's right
    keypoint (F,3) [u, v, sigma2] (u < 0: none): 1 / sigma2 where a valid
    factor has one, else 0."""
    has = valid & (right[:, 0] >= 0.0)
    return torch.where(has, 1.0 / torch.clamp(right[:, 2], min=1e-12),
                       torch.zeros_like(right[:, 2])), has


def pad_params(p) -> torch.Tensor:
    """Camera parameters as a float32 vector zero-padded to length 8."""
    p = torch.as_tensor(p, dtype=torch.float32)
    return torch.nn.functional.pad(p, (0, 8 - p.shape[0]))
