"""Monocular two-view reconstruction (map initialization).

Port of `ms_slam_tpu/ops/twoview.py`: every RANSAC hypothesis at once, an
8-point essential matrix AND an 8-point homography per hypothesis on
unprojected bearings (any camera model), truncated symmetric-transfer
scores of every hypothesis against every match, the reference's model
selection (H when SH / (SH + SF) > 0.5), then the 4 (R, t) of the refitted
E and the 8 Faugeras (R, t) of the refitted H, resolved by cheirality,
reprojection and parallax counts over all 12 candidates in one pass.

The random draw is split from the solve, as in `pnp.py` and `sim3.py`:
`draw_hypotheses` draws the (n_hyp, 8) index table from a
`torch.Generator` (JAX's PRNG stream cannot be reproduced),
`reconstruct_from_hypotheses` does everything after the draw, and
`reconstruct` composes the two.

The null vector of an SVD has no fixed sign (LAPACK's or cuSOLVER's choice),
so E and H are defined up to sign and scale; the scores and the candidate
sets do not depend on it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, lie, triangulate


class TwoViewResult(NamedTuple):
    ok: torch.Tensor        # () bool
    R: torch.Tensor         # (3,3) cam2-from-cam1
    t: torch.Tensor         # (3,) unit norm
    X1: torch.Tensor        # (N,3) points in cam1 frame
    inlier: torch.Tensor    # (N,) bool (triangulated + cheirality-clean)
    n_good: torch.Tensor


def _null_vector(a: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of each
    (..., S, 9) matrix; with fewer than 9 rows it needs the full V."""
    _, _, Vt = torch.linalg.svd(a, full_matrices=a.shape[-2] < a.shape[-1])
    return Vt[..., -1, :]


def _essential_8pt(x1, x2, w=None):
    """x1, x2: (..., S, 3) bearings (z=1). Returns E (..., 3, 3), projected
    onto the essential manifold (singular values 1, 1, 0). w: optional
    (..., S) row weights (the inlier refit zeroes the outlier rows)."""
    a = torch.stack([
        x2[..., 0] * x1[..., 0], x2[..., 0] * x1[..., 1],
        x2[..., 0] * x1[..., 2], x2[..., 1] * x1[..., 0],
        x2[..., 1] * x1[..., 1], x2[..., 1] * x1[..., 2],
        x2[..., 2] * x1[..., 0], x2[..., 2] * x1[..., 1],
        x2[..., 2] * x1[..., 2]], dim=-1)             # rows a_i . e = 0
    if w is not None:
        a = a * w[..., None]
    E = _null_vector(a).reshape(*a.shape[:-2], 3, 3)
    U, _, Vt2 = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * d) @ Vt2


def _epi_errs2(E, x1, x2, f2):
    """Squared point-to-epipolar-line distances in each image (px^2), the
    two directions scored apart: (d_in_2, d_in_1). E may carry leading
    hypothesis axes."""
    l2 = x1 @ E.transpose(-1, -2)                 # epipolar lines in cam 2
    l1 = x2 @ E
    num = torch.sum(x2 * l2, -1) ** 2
    d2 = num / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = num / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    return d2 * f2 * f2, d1 * f2 * f2


def _homography_dlt(x1, x2, w=None):
    """x1, x2: (..., S, 3) bearings (z=1). H (..., 3, 3) with x2 ~ H x1 by
    DLT. w: optional (..., S) row weights."""
    z = torch.zeros_like(x1)
    r1 = torch.cat([z, -x1, x2[..., 1:2] * x1], -1)           # (..., S, 9)
    r2 = torch.cat([x1, z, -x2[..., 0:1] * x1], -1)
    if w is not None:
        r1 = r1 * w[..., None]
        r2 = r2 * w[..., None]
    a = torch.cat([r1, r2], -2)                               # (..., 2S, 9)
    return _null_vector(a).reshape(*a.shape[:-2], 3, 3)


def _dehom(y):
    z = y[..., 2:3]
    return y / torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))


def _h_errs(H, x1, x2, f2):
    """Squared symmetric homography transfer distances (px^2): (d12, d21).
    H may carry leading hypothesis axes."""
    Hi = lie.inv3x3(H)
    y2 = _dehom(x1 @ H.transpose(-1, -2))
    y1 = _dehom(x2 @ Hi.transpose(-1, -2))
    d21 = torch.sum((y2[..., :2] - x2[..., :2]) ** 2, -1)
    d12 = torch.sum((y1[..., :2] - x1[..., :2]) ** 2, -1)
    return d12 * f2 * f2, d21 * f2 * f2


def _decompose_homography(H):
    """Faugeras SVD decomposition of a calibrated homography into 8 motion
    hypotheses: the d' = +d2 and d' = -d2 cases with four sign combinations
    each. Returns (8,3,3) rotations and (8,3) unit translations."""
    dt, dev = H.dtype, H.device
    U, S, Vt = torch.linalg.svd(H)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = S[0], S[1], S[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    num = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                 min=0.0))
    zero = torch.zeros(4, dtype=dt, device=dev)
    one = torch.ones(4, dtype=dt, device=dev)

    def case(sign):
        # d' = +d2: rotation about y by theta; d' = -d2: by phi, composed
        # with diag(1, -1, -1)
        den = torch.clamp((d1 + sign * d3) * d2, min=1e-12)
        sn = e1 * e3 * num / den
        if sign > 0:
            cs = (d2 * d2 + d1 * d3) / den * one
            Rp = torch.stack([torch.stack([cs, zero, -sn], -1),
                              torch.stack([zero, one, zero], -1),
                              torch.stack([sn, zero, cs], -1)], -2)
            tp = (d1 - d3) * torch.stack([e1 * aux1, zero, -e3 * aux3], -1)
        else:
            cs = (d1 * d3 - d2 * d2) / den * one
            Rp = torch.stack([torch.stack([cs, zero, sn], -1),
                              torch.stack([zero, -one, zero], -1),
                              torch.stack([sn, zero, -cs], -1)], -2)
            tp = (d1 + d3) * torch.stack([e1 * aux1, zero, e3 * aux3], -1)
        R = s * U @ Rp @ Vt
        t = tp @ U.T
        return R, t / torch.clamp(torch.linalg.norm(t, dim=-1,
                                                    keepdim=True), min=1e-12)

    Rp_, tp_ = case(+1)
    Rn_, tn_ = case(-1)
    return torch.cat([Rp_, Rn_], 0), torch.cat([tp_, tn_], 0)


def draw_hypotheses(valid: torch.Tensor, n_hyp: int,
                    generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, 8) sample indices drawn with replacement, uniformly over the
    valid matches (the reference's `jax.random.choice(..., p=valid/sum)`).
    With no valid match every index is equally likely; every hypothesis then
    scores 0."""
    p = valid.to(torch.float32)
    p = torch.where(p.sum() > 0, p, torch.ones_like(p))
    idx = torch.multinomial(p, n_hyp * 8, replacement=True,
                            generator=generator)
    return idx.reshape(n_hyp, 8)


def reconstruct_from_hypotheses(model: int, params, xy1, xy2, valid,
                                idx: torch.Tensor,
                                min_parallax_cos: float = 0.99995
                                ) -> TwoViewResult:
    """Relative pose and structure from matched features, the hypotheses
    given as an (n_hyp, 8) index table into the N matches.

    xy1/xy2: (N,2) matched pixel coords (pairs aligned); valid: (N,)."""
    N = xy1.shape[0]
    dt, dev = xy1.dtype, xy1.device
    params = params.to(dt)
    x1 = cameras.unproject(model, params, xy1)
    x2 = cameras.unproject(model, params, xy2)
    f = params[0]
    idx = idx.long()

    # essential hypotheses, truncated-score like the reference's
    # CheckFundamental (gate 3.841 a direction, score cap 5.991)
    Es = _essential_8pt(x1[idx], x2[idx])                     # (Hn,3,3)

    def f_score(E):
        e2, e1 = _epi_errs2(E, x1, x2, f)
        zero = torch.zeros((), dtype=dt, device=dev)
        sc = torch.sum(torch.where((e2 < 3.841) & valid, 5.991 - e2, zero)
                       + torch.where((e1 < 3.841) & valid, 5.991 - e1, zero),
                       -1)
        return sc, (e2 < 3.841) & (e1 < 3.841) & valid

    f_sc, f_inl_all = f_score(Es)
    best = torch.argmax(f_sc)
    # refit on all inliers of the best hypothesis
    E = _essential_8pt(x1, x2, f_inl_all[best].to(dt))
    SF, e_inl = f_score(E)

    # homography hypotheses, truncated-score like CheckHomography (5.991)
    Hs = _homography_dlt(x1[idx], x2[idx])

    def h_score(Hh):
        d12, d21 = _h_errs(Hh, x1, x2, f)
        zero = torch.zeros((), dtype=dt, device=dev)
        sc = torch.sum(torch.where((d12 < 5.991) & valid, 5.991 - d12, zero)
                       + torch.where((d21 < 5.991) & valid, 5.991 - d21,
                                     zero), -1)
        return sc, (d12 < 5.991) & (d21 < 5.991) & valid

    h_sc, h_inl_all = h_score(Hs)
    h_best = torch.argmax(h_sc)
    Hm = _homography_dlt(x1, x2, h_inl_all[h_best].to(dt))
    SH, h_inl = h_score(Hm)

    # model selection (ref Reconstruct: RH = SH/(SH+SF), H when RH > 0.5)
    use_H = SH / torch.clamp(SH + SF, min=1e-9) > 0.5

    # E: 4 hypotheses (R1,t), (R1,-t), (R2,t), (R2,-t)
    U, _, Vt = torch.linalg.svd(E)
    d = torch.linalg.det(U) * torch.linalg.det(Vt)
    U = U * torch.where(d < 0, -1.0, 1.0).to(dt)
    Wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=dt, device=dev)
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    tu = U[:, 2]
    tu = tu / (torch.linalg.norm(tu) + 1e-12)
    Rs_e = torch.stack([R1, R1, R2, R2])
    ts_e = torch.stack([tu, -tu, tu, -tu])

    # H: 8 Faugeras hypotheses
    Rs_h, ts_h = _decompose_homography(Hm)
    R_cand = torch.cat([Rs_e, Rs_h], 0)                       # (12,3,3)
    t_cand = torch.cat([ts_e, ts_h], 0)                       # (12,3)
    is_h = torch.cat([torch.zeros(4, dtype=torch.bool, device=dev),
                      torch.ones(8, dtype=torch.bool, device=dev)])
    # each family's candidates are checked against ITS model's inliers
    inl_cand = torch.where(is_h[:, None], h_inl[None, :], e_inl[None, :])

    # all 12 candidates at once: triangulate, cheirality, reprojection in
    # both views (ref CheckRT's 4 sigma^2 gate), parallax
    C = R_cand.shape[0]
    P1 = torch.cat([torch.eye(3, dtype=dt, device=dev),
                    torch.zeros((3, 1), dtype=dt, device=dev)], 1)
    P2 = torch.cat([R_cand, t_cand[:, :, None]], 2)           # (12,3,4)
    X = triangulate.triangulate_dlt(x1, x2, P1.expand(C, N, 3, 4),
                                    P2[:, None].expand(C, N, 3, 4))
    z1 = X[..., 2]
    Xc2 = torch.einsum("cij,cnj->cni", R_cand, X) + t_cand[:, None, :]
    z2 = Xc2[..., 2]
    r1 = X[..., :2] / torch.clamp(z1[..., None], min=1e-9) - x1[:, :2]
    r2 = Xc2[..., :2] / torch.clamp(z2[..., None], min=1e-9) - x2[:, :2]
    rep_ok = ((torch.sum(r1 * r1, -1) * f * f < 4.0)
              & (torch.sum(r2 * r2, -1) * f * f < 4.0))
    o2 = -torch.einsum("cji,cj->ci", R_cand, t_cand)          # cam-2 centre
    v2 = X - o2[:, None, :]
    cosp = torch.sum(X * v2, -1) / (
        torch.linalg.norm(X, dim=-1) * torch.linalg.norm(v2, dim=-1) + 1e-12)
    good = inl_cand & (z1 > 0) & (z2 > 0) & rep_ok
    counts = good.sum(-1)
    npar = (good & (cosp < min_parallax_cos)).sum(-1)
    goods = good & (cosp < 0.99999)

    def family_pick(fam: bool):
        c = torch.where(is_h == fam, counts, -1)
        bi = torch.argmax(c)
        n_best = c[bi]
        # duplicate candidates (degenerate decompositions collapse sign
        # branches into numerically identical (R, t)) must not defeat the
        # dominance check
        dup = ((torch.sum((R_cand - R_cand[bi]) ** 2, (-2, -1)) < 1e-6)
               & (torch.abs(t_cand @ t_cand[bi]) > 0.9999))
        second = torch.max(torch.where(dup, -1, c))
        n_model = (h_inl if fam else e_inl).sum()
        ok_ = ((n_best >= 50) & (n_best > 0.75 * n_model)
               & (second < 0.8 * n_best) & (npar[bi] > 30))
        return bi, ok_

    bi_f, ok_f = family_pick(False)
    bi_h, ok_h = family_pick(True)
    # prefer the score-selected family; the other only when the selected
    # one fails its gates
    pick_h = torch.where(use_H, ok_h | ~ok_f, ok_h & ~ok_f)
    bi = torch.where(pick_h, bi_h, bi_f)
    ok = torch.where(pick_h, ok_h, ok_f)
    return TwoViewResult(ok=ok, R=R_cand[bi], t=t_cand[bi], X1=X[bi],
                         inlier=goods[bi], n_good=counts[bi])


def reconstruct(model: int, params, xy1, xy2, valid,
                generator: torch.Generator, n_hyp: int = 256,
                min_parallax_cos: float = 0.99995) -> TwoViewResult:
    """Relative pose and structure from matched features, `n_hyp` RANSAC
    hypotheses drawn from `generator`."""
    idx = draw_hypotheses(valid, n_hyp, generator)
    return reconstruct_from_hypotheses(model, params, xy1, xy2, valid, idx,
                                       min_parallax_cos)
