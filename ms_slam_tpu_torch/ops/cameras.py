"""Batched camera models (pinhole).

Port of `ms_slam_tpu/ops/cameras.py`. Parameters are a flat vector padded
to length 8, [fx, fy, cx, cy, ...]. The Kannala-Brandt8 fisheye model is
not ported yet: the `project`/`unproject`/`project_jac` dispatch raises for
it.
"""
from __future__ import annotations

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


def _pinhole_only(model: int):
    if model != PINHOLE:
        raise NotImplementedError("Kannala-Brandt8 fisheye is not ported yet")


def project(model: int, params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    _pinhole_only(model)
    return pinhole_project(params, Xc)


def unproject(model: int, params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    _pinhole_only(model)
    return pinhole_unproject(params, uv)


def project_jac(model: int, params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    _pinhole_only(model)
    return pinhole_project_jac(params, Xc)
