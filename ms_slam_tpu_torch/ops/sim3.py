"""Batched Horn alignment, RANSAC and Gauss-Newton refinement of Sim(3) for
loop-closure geometric verification.

Port of `ms_slam_tpu/ops/sim3.py`: every RANSAC hypothesis is a 3-point Horn
alignment solved at once, inliers are counted by masked reprojection in both
cameras for all hypotheses together, and the best one is refined on its
inliers. Scale is fixed to 1 for stereo (`with_scale=False`) and free for
monocular maps.

As with PnP, the draw is split from the solve: `sim3_ransac` draws the
(n_hyp, 3) index table from a `torch.Generator` (JAX's PRNG stream cannot be
reproduced) and `sim3_from_hypotheses` does everything after the draw, so a
test can hand both packages the same table. Sampling is with replacement: a
triple that repeats an index gives Horn a rank <= 1 matrix whose rotation
depends on the SVD's arbitrary vectors; such a hypothesis scores whatever it
scores in either package and only triples of distinct points are comparable
one by one.

The reference takes the Jacobians of the two refinements from `jax.jacfwd`.
Here they are written out (`_proj_res_jac`, `_inv_proj_res_jac`): through
`torch.func.jacfwd` one `sim3_refine` took ~250 ms on an H100, nearly all of
it the transform's per-operation host overhead. A test holds them against
`torch.func.jacfwd`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, hamming, lie


def horn(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor,
         with_scale: bool = False):
    """Weighted closed-form alignment Y ~ s R X + t.

    X, Y: (...,N,3); w: (...,N) weights. Returns (s, R, t)."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    wn = w / wsum
    mx = torch.sum(X * wn[..., None], dim=-2, keepdim=True)
    my = torch.sum(Y * wn[..., None], dim=-2, keepdim=True)
    sq = torch.sqrt(wn)[..., None]
    Xc = (X - mx) * sq
    Yc = (Y - my) * sq
    Hm = Yc.transpose(-1, -2) @ Xc
    # sync: the batched 3x3 SVD goes through the library solver
    U, S, Vt = torch.linalg.svd(Hm)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    R = U @ (D[..., :, None] * Vt)
    if with_scale:
        num = torch.sum(S * D, dim=-1)
        den = torch.clamp(torch.sum(Xc * Xc, dim=(-1, -2)), min=1e-12)
        s = num / den
    else:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    t = my[..., 0, :] - s[..., None] * (R @ mx[..., 0, :, None])[..., 0]
    return s, R, t


class Sim3RansacResult(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor


class Sim3RefineResult(NamedTuple):
    s: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor


def draw_hypotheses(valid: torch.Tensor, n_hyp: int,
                    generator: torch.Generator) -> torch.Tensor:
    """(n_hyp, 3) sample indices drawn with replacement, uniformly over the
    valid pairs (the reference's `jax.random.choice(..., p=valid/sum)`).
    With no valid pair every index is equally likely; every hypothesis then
    scores 0."""
    p = valid.to(torch.float32)
    p = torch.where(p.sum() > 0, p, torch.ones_like(p))
    idx = torch.multinomial(p, n_hyp * 3, replacement=True,
                            generator=generator)
    return idx.reshape(n_hyp, 3)


def sim3_from_hypotheses(model: int, params, Xc1, Xc2, sigma2_1, sigma2_2,
                         valid, idx: torch.Tensor, with_scale: bool = False,
                         chi2_th: float = 9.21) -> Sim3RansacResult:
    """Everything of the RANSAC after the draw: Horn on each row of the
    (H, 3) index table `idx`, reprojection inliers of every hypothesis in
    both cameras, and one Horn refit on the best hypothesis' inliers (kept
    if it has at least as many)."""
    idx = idx.long()
    n_hyp = idx.shape[0]
    w = torch.ones((n_hyp, 3), dtype=Xc1.dtype, device=Xc1.device)
    s, R, t = horn(Xc2[idx], Xc1[idx], w, with_scale)   # cam2 -> cam1

    uv1 = cameras.project(model, params, Xc1)           # observed proxies
    uv2 = cameras.project(model, params, Xc2)

    def count(s_h, R_h, t_h):
        """(...,) hypotheses -> (...,N) inlier masks."""
        X2in1 = s_h[..., None, None] * (Xc2 @ R_h.transpose(-1, -2)) \
            + t_h[..., None, :]
        e1 = torch.sum((cameras.project(model, params, X2in1) - uv1) ** 2,
                       -1) / sigma2_1
        X1in2 = ((Xc1 - t_h[..., None, :]) @ R_h) / s_h[..., None, None]
        e2 = torch.sum((cameras.project(model, params, X1in2) - uv2) ** 2,
                       -1) / sigma2_2
        return valid & (e1 < chi2_th) & (e2 < chi2_th) \
            & (X2in1[..., 2] > 0) & (X1in2[..., 2] > 0)

    ok_all = count(s, R, t)                             # (H,N)
    scores = ok_all.sum(1)
    best = torch.argmax(scores)                         # first max
    inl = ok_all[best]
    s_f, R_f, t_f = horn(Xc2, Xc1, inl.to(Xc1.dtype), with_scale)
    inl_f = count(s_f, R_f, t_f)
    better = inl_f.sum() >= scores[best]
    inl_o = torch.where(better, inl_f, inl)
    return Sim3RansacResult(s=torch.where(better, s_f, s[best]),
                            R=torch.where(better, R_f, R[best]),
                            t=torch.where(better, t_f, t[best]),
                            inliers=inl_o,
                            n_inliers=inl_o.sum().to(torch.int32))


def sim3_ransac(model: int, params, Xc1, Xc2, sigma2_1, sigma2_2, valid,
                generator: torch.Generator, n_hyp: int = 128,
                with_scale: bool = False,
                chi2_th: float = 9.21) -> Sim3RansacResult:
    """Estimate S12 mapping camera-2-frame points into camera 1's frame.

    Xc1/Xc2: (N,3) the same landmarks in each keyframe's camera frame.
    Inliers are gated by reprojection in both cameras (chi2 9.21, 2 dof
    99%)."""
    idx = draw_hypotheses(valid, n_hyp, generator)
    return sim3_from_hypotheses(model, params, Xc1, Xc2, sigma2_1, sigma2_2,
                                valid, idx, with_scale, chi2_th)


def _unpack(x, s0, R0, t0, with_scale: bool):
    """State [omega(3), dt(3), dlog s] around (s0, R0, t0). (`lie` gets a
    leading axis of 1 here and below: under `torch.func`, which the tests
    run these functions through, a 0-d tensor combined with a Python number
    can come out in float64.)"""
    R = lie.normalize_rotation(lie.so3_exp(x[None, :3]) @ R0)[0]
    t = t0 + x[3:6]
    s = s0 * torch.exp(x[6]) if with_scale else s0
    return s, R, t


def _proj_res_jac(model, params, x, X, uv, sd, s0, R0, t0, with_scale):
    """Residual of projecting Xc = s R X + t, with (s, R, t) the state x
    around (s0, R0, t0): e = (project(Xc) - uv) / sd, (N,2); its Jacobian
    with respect to x, (N,2,D); and Xc's depth.

    With Y = R X: dXc/domega = -s hat(Y) J_l(omega) (a left perturbation of
    exp(omega) R0), dXc/ddt = I, dXc/dlog s = s Y."""
    s, R, t = _unpack(x, s0, R0, t0, with_scale)
    Y = X @ R.T
    Xc = s * Y + t
    e = (cameras.project(model, params, Xc) - uv) / sd
    cols = [-s * (lie.hat(Y) @ lie.so3_left_jacobian(x[None, :3])[0]),
            torch.eye(3, dtype=X.dtype, device=X.device).expand(
                X.shape[0], 3, 3)]
    if with_scale:
        cols.append((s * Y)[..., None])
    J = cameras.project_jac(model, params, Xc) @ torch.cat(cols, -1)
    return e, J / sd[..., None], Xc[:, 2]


def _inv_proj_res_jac(model, params, x, X, uv, sd, s0, R0, t0, with_scale):
    """The same for the inverse direction, Xc = R^T (X - t) / s.

    R^T = R0^T exp(-omega), so with Z = R^T (X - t):
    dXc/domega = hat(Z) R0^T J_l(-omega) / s, dXc/ddt = -R^T / s,
    dXc/dlog s = -Xc."""
    s, R, t = _unpack(x, s0, R0, t0, with_scale)
    Z = (X - t) @ R
    Xc = Z / s
    e = (cameras.project(model, params, Xc) - uv) / sd
    N = X.shape[0]
    Jr = lie.so3_left_jacobian(-x[None, :3])[0]
    cols = [lie.hat(Z) @ (R0.T @ Jr) / s, (-R.T / s).expand(N, 3, 3)]
    if with_scale:
        cols.append(-Xc[..., None])
    J = cameras.project_jac(model, params, Xc) @ torch.cat(cols, -1)
    return e, J / sd[..., None], Xc[:, 2]


def _huber_sqrt_w(chi, th2: float):
    """IRLS weight on the residual for a Huber loss with delta^2 = th2."""
    return torch.where(chi > th2,
                       torch.sqrt(th2 / torch.clamp(chi, min=1e-9)),
                       torch.ones_like(chi))


def _refine(res_jacs, mask, with_scale: bool, n_iters: int, th2: float,
            s0, R0, t0) -> Sim3RefineResult:
    """Huber-weighted Gauss-Newton over the state x from 0:
    x <- x - (J^T W J + 1e-6 I)^-1 J^T W r, the weights recomputed at each x
    and held constant in the step; then the chi2 inlier count. res_jacs:
    functions x -> (e (N,2), J (N,2,D), depth (N,)), one per direction of
    projection; a point counts where every depth exceeds 0.05."""
    D = 7 if with_scale else 6
    x = torch.zeros(D, dtype=R0.dtype, device=R0.device)
    eye = 1e-6 * torch.eye(D, dtype=R0.dtype, device=R0.device)

    def evaluate(x):
        parts = [f(x) for f in res_jacs]
        e = torch.stack([p[0] for p in parts], 1)            # (N,M,2)
        J = torch.stack([p[1] for p in parts], 1)            # (N,M,2,D)
        cheir = torch.stack([p[2] > 0.05 for p in parts]).all(0)
        return e, J, torch.sum(e * e, -1), mask & cheir

    for _ in range(n_iters):
        e, J, chi, ok = evaluate(x)
        sw = _huber_sqrt_w(chi, th2) * ok[:, None].to(e.dtype)
        r = (e * sw[..., None]).reshape(-1)
        Jw = (J * sw[..., None, None]).reshape(-1, D)
        # sync: the DxD solve goes through the library solver
        x = x + torch.linalg.solve(Jw.T @ Jw + eye, -(Jw.T @ r))
    _, _, chi, ok = evaluate(x)
    inl = ok & (chi < th2).all(1)
    s, R, t = _unpack(x, s0, R0, t0, with_scale)
    return Sim3RefineResult(s=s, R=R, t=t, inliers=inl,
                            n_inliers=inl.sum().to(torch.int32))


def sim3_refine(model: int, params, Xc1, Xc2, uv1, uv2, sigma2_1, sigma2_2,
                mask, s0, R0, t0, with_scale: bool = False,
                n_iters: int = 10, th2: float = 10.0) -> Sim3RefineResult:
    """Iterative Sim(3) Gauss-Newton refinement (ref Optimizer::OptimizeSim3:
    bidirectional reprojection edges with Huber delta sqrt(th2), th2 = 10).
    State [omega(3), dt(3), dlog s] around (s0, R0, t0) mapping camera-2
    coords into camera-1 coords; Huber-weighted IRLS with a final chi2
    inlier count in both directions."""
    sd1 = torch.sqrt(sigma2_1)[:, None]
    sd2 = torch.sqrt(sigma2_2)[:, None]
    ctx = (s0, R0, t0, with_scale)
    return _refine(
        [lambda x: _proj_res_jac(model, params, x, Xc2, uv1, sd1, *ctx),
         lambda x: _inv_proj_res_jac(model, params, x, Xc1, uv2, sd2, *ctx)],
        mask, with_scale, n_iters, th2, s0, R0, t0)


def sim3_refine_world(model: int, params, Xw, uv, sigma2, mask, s0, R0, t0,
                      with_scale: bool = False, n_iters: int = 10,
                      th2: float = 10.0) -> Sim3RefineResult:
    """Forward-only Sim(3) refinement of S_cw (world -> camera) from
    landmark -> feature correspondences: the matched side gives a landmark
    pool rather than per-feature pairs, so only the projection into the
    current camera exists (ref DetectAndReffineSim3FromLastKF). Huber-
    weighted IRLS, state [omega(3), dt(3), dlog s]."""
    sd = torch.sqrt(sigma2)[:, None]
    return _refine(
        [lambda x: _proj_res_jac(model, params, x, Xw, uv, sd, s0, R0, t0,
                                 with_scale)],
        mask, with_scale, n_iters, th2, s0, R0, t0)


def sim3_guided_match(model: int, params, s, R, t, Xc2, valid2, desc2,
                      xy1, octave1, desc1, valid1, img_w: float,
                      img_h: float, th_radius: float = 7.5,
                      scale_factor: float = 1.2,
                      max_dist: int = 100) -> torch.Tensor:
    """Sim3-guided projection search one way (ref ORBmatcher::SearchBySim3):
    project keyframe-2 landmarks into keyframe 1's image under S12 and match
    descriptors within a scale-aware radius, up to TH_HIGH: this harvests
    the viewpoint-changed matches that the mutual TH_LOW/ratio matcher
    drops.

    Returns (N2,) int32: the best keyframe-1 feature per keyframe-2
    landmark (the first index on a tie), -1 if none."""
    X2in1 = s * (Xc2 @ R.T) + t
    uv = cameras.project(model, params, X2in1)
    vis = valid2 & (X2in1[:, 2] > 0.05) \
        & (uv[:, 0] >= 0) & (uv[:, 0] < img_w) \
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_h)
    radius = th_radius * scale_factor ** octave1.to(torch.float32)
    d = hamming.hamming_matrix(desc2, desc1)            # (N2,N1)
    du = torch.abs(uv[:, 0:1] - xy1[None, :, 0])
    dv = torch.abs(uv[:, 1:2] - xy1[None, :, 1])
    near = (du <= radius[None, :]) & (dv <= radius[None, :])
    ok = near & vis[:, None] & valid1[None, :]
    d = torch.where(ok, d, 1 << 15)
    best1 = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best1[:, None])[:, 0]
    return torch.where(best_d <= max_dist, best1, -1).to(torch.int32)
