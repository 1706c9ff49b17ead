"""Batched two-view DLT triangulation (port of
`ms_slam_tpu/ops/triangulate.py::triangulate_dlt`)."""
from __future__ import annotations

import torch

from .lie import solve3x3


def triangulate_dlt(xn1: torch.Tensor, xn2: torch.Tensor,
                    P1: torch.Tensor, P2: torch.Tensor) -> torch.Tensor:
    """xn1, xn2: (...,3) normalized bearings; P1, P2: (...,3,4) [R|t].
    Returns (...,3) world points. The homogeneous weight is fixed to 1, so
    the 4x4 DLT becomes a 4x3 least squares via 3x3 normal equations."""
    def two_rows(x, P):
        r0 = x[..., 0:1] * P[..., 2, :] - x[..., 2:3] * P[..., 0, :]
        r1 = x[..., 1:2] * P[..., 2, :] - x[..., 2:3] * P[..., 1, :]
        return r0, r1

    a0, a1 = two_rows(xn1, P1)
    a2, a3 = two_rows(xn2, P2)
    A4 = torch.stack([a0, a1, a2, a3], dim=-2)  # (...,4,4)
    A = A4[..., :3]
    b = -A4[..., 3]
    AtA = A.transpose(-1, -2) @ A
    Atb = (A.transpose(-1, -2) @ b[..., None])[..., 0]
    AtA = AtA + 1e-12 * torch.eye(3, dtype=A.dtype, device=A.device)
    return solve3x3(AtA, Atb)
