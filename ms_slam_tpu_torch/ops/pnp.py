"""Prior-free PnP RANSAC for relocalization.

Port of `ms_slam_tpu/ops/pnp.py` (the MLPnPsolver analog): a fixed budget
of 6-point DLT hypotheses solved as one batched eigendecomposition of the
per-hypothesis 12x12 normal matrix, orthonormalized by Procrustes, scored
by batched reprojection chi2. No data-dependent iteration.

The function is split in two: `pnp_ransac` draws the (n_hyp, 6) index
table from a `torch.Generator` (JAX's PRNG stream cannot be reproduced),
and `pnp_from_hypotheses` does everything after the draw, so a test can
hand both packages the same table.

The smallest eigenvector's sign is whatever the eigensolver returns
(LAPACK in the reference, LAPACK or cuSOLVER here; measured on the CPU,
torch and JAX disagree on 44% of 256 random 12x12 problems), and with the
negative sign the Procrustes reflection fix yields a wrong rotation. The
port fixes the sign so that det(P[:, :3]) > 0, the sign of a DLT solution
lambda*[R|t] with lambda > 0; the reference keeps whichever it got, so
about half of its hypotheses are spent.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, robust

CHI2_GATE = robust.CHI2_2DOF  # 5.991 (ref MLPnP RANSAC chi2)


class PnPResult(NamedTuple):
    R: torch.Tensor         # (3,3) world->camera
    t: torch.Tensor         # (3,)
    inlier: torch.Tensor    # (N,)
    n_inliers: torch.Tensor
    ok: torch.Tensor        # () bool: enough inliers to trust


def draw_hypotheses(valid: torch.Tensor, n_hyp: int,
                    generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, 6) sample indices drawn with replacement, uniformly over the
    valid matches (the reference's `jax.random.choice(..., p=valid/sum)`).
    With no valid match every index is equally likely, so the draw never
    sees an all-zero distribution; every hypothesis then scores 0."""
    p = valid.to(torch.float32)
    p = torch.where(p.sum() > 0, p, torch.ones_like(p))
    idx = torch.multinomial(p, n_hyp * 6, replacement=True,
                            generator=generator)
    return idx.reshape(n_hyp, 6)


def pnp_from_hypotheses(model: int, params, X, uv, sigma2, valid,
                        idx: torch.Tensor,
                        min_inliers: int = 10) -> PnPResult:
    """Solve, orthonormalize and score the hypotheses of the (H, 6) index
    table `idx` into the N matches; return the best one."""
    dt = X.dtype
    params = params.to(dt)
    xn = cameras.unproject(model, params, uv)        # (N,3) rays
    xn = xn / torch.clamp(xn[..., 2:3], min=1e-9)
    idx = idx.long()
    Xs = X[idx]                                      # (H,6,3)
    xs = xn[idx][..., :2]                            # (H,6,2)

    # conditioning: center + scale the 3D points per hypothesis
    c = Xs.mean(1, keepdim=True)
    s = torch.linalg.norm(Xs - c, dim=-1).mean(1) + 1e-9
    Xc = (Xs - c) / s[:, None, None]

    # DLT rows for P = [R|t]: u*(p3.Xh) - p1.Xh = 0, v*(p3.Xh) - p2.Xh = 0
    Xh = torch.cat([Xc, torch.ones_like(Xc[..., :1])], -1)   # (H,6,4)
    z4 = torch.zeros_like(Xh)
    u, v = xs[..., 0:1], xs[..., 1:2]
    A = torch.cat([torch.cat([-Xh, z4, u * Xh], -1),
                   torch.cat([z4, -Xh, v * Xh], -1)], 1)     # (H,12,12)

    # smallest eigenvector of A^T A (batched)
    AtA = torch.einsum("hij,hik->hjk", A, A)
    _, V = torch.linalg.eigh(AtA)
    P = V[..., 0].reshape(-1, 3, 4)
    P = torch.where((torch.linalg.det(P[:, :, :3]) < 0)[:, None, None],
                    -P, P)

    # Procrustes orthonormalization of M = P[:, :3]
    Um, Sm, Vmt = torch.linalg.svd(P[:, :, :3])
    detUV = torch.linalg.det(Um @ Vmt)
    D = torch.stack([torch.ones_like(detUV), torch.ones_like(detUV),
                     detUV], -1)
    R = Um @ (D[..., None] * Vmt)                    # (H,3,3) det=+1
    scale = Sm.mean(-1) * torch.sign(detUV)
    scale = torch.where(scale.abs() > 1e-12, scale,
                        torch.full_like(scale, 1e-12))
    t = P[:, :, 3] / scale[:, None]

    # cheirality: most sample points in front, else flip; then keep det +1
    Xcam = torch.einsum("hij,hnj->hni", R, Xc) + t[:, None, :]
    neg = (Xcam[..., 2] < 0).sum(1) > 3
    R = torch.where(neg[:, None, None], -R, R)
    t = torch.where(neg[:, None], -t, t)
    R = torch.where((torch.linalg.det(R) < 0)[:, None, None], -R, R)

    # undo conditioning: X_cam = R (X - c)/s + t  =>  metric T_cw on raw X
    t_raw = s[:, None] * t - torch.einsum("hij,hj->hi", R, c[:, 0, :])

    # score every hypothesis on all matches
    Xc_all = torch.einsum("hij,nj->hni", R, X) + t_raw[:, None, :]
    uvp = cameras.project(model, params, Xc_all)
    chi2 = torch.sum((uv - uvp) ** 2, -1) / torch.clamp(sigma2, min=1e-9)
    inl = valid & (chi2 < CHI2_GATE) & (Xc_all[..., 2] > 0.05)   # (H,N)
    best = torch.argmax(inl.sum(1))
    n = inl[best].sum().to(torch.int32)
    return PnPResult(R=R[best].to(dt), t=t_raw[best].to(dt),
                     inlier=inl[best], n_inliers=n, ok=n >= min_inliers)


def pnp_ransac(model: int, params, X, uv, sigma2, valid,
               generator: torch.Generator, n_hyp: int = 256,
               min_inliers: int = 10) -> PnPResult:
    """Estimate T_cw from N putative 2D-3D matches. X: (N,3) world points;
    uv: (N,2) pixels; sigma2: per-match variance; valid: (N,) mask."""
    idx = draw_hypotheses(valid, n_hyp, generator)
    return pnp_from_hypotheses(model, params, X, uv, sigma2, valid, idx,
                               min_inliers)
