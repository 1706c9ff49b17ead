"""Batched two-view triangulation (port of `ms_slam_tpu/ops/triangulate.py`):
DLT from two projection matrices, and the midpoint of two rays."""
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


def triangulate_midpoint(o1, d1, o2, d2):
    """Midpoint of the closest points of two rays (origin, direction),
    (...,3) each: [d1 -d2][s;t] = o2 - o1 in least squares."""
    b = o2 - o1
    d11 = torch.sum(d1 * d1, -1)
    d12 = torch.sum(d1 * d2, -1)
    d22 = torch.sum(d2 * d2, -1)
    bd1 = torch.sum(b * d1, -1)
    bd2 = torch.sum(b * d2, -1)
    den = d11 * d22 - d12 * d12
    den = torch.where(torch.abs(den) > 1e-12, den, torch.full_like(den, 1e-12))
    s = (bd1 * d22 - bd2 * d12) / den
    t = (bd1 * d12 - bd2 * d11) / den
    return 0.5 * ((o1 + s[..., None] * d1) + (o2 + t[..., None] * d2))
