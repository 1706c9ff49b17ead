"""Motion-only pose optimization (batched Levenberg-Marquardt).

Port of `ms_slam_tpu/ops/pose_opt.py`: all residuals at once, 6x6 normal
equations by batched Jacobian contraction, `lie.solve_psd6`, a left
update exp(xi) * T_cw, Huber weights and the chi2 outlier re-gate between
rounds. The carried-residual LM and its `where`-based accept/reject are
kept as they are: no host sync inside the loops.

Given the second camera of an unrectified pair (`rig`) and each match's
right keypoint, every match that has one adds a 2-row residual through the
right lens (upstream's `EdgeSE3ProjectXYZOnlyPoseToBody`): the left row's
Jacobian chained through R_rl, its own variance, the monocular gate and
Huber weight, and an inlier flag of its own. The right rows follow the left
ones in the same tensors, each row projected through its own lens, so they
add rows to the solve's operations, not operations; without a rig the
solve is the left rows' alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, lie, robust

MONO_CHI2 = robust.CHI2_2DOF    # 5.991
STEREO_CHI2 = robust.CHI2_3DOF  # 7.815


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inlier: torch.Tensor
    n_inliers: torch.Tensor
    chi2: torch.Tensor
    n_right: torch.Tensor = None   # right rows inlier at the end (rig only)


def _residuals_jac(model, params, bf, R, t, X, uv, u_right, is_stereo):
    """Residuals (N,3) [du, dv, duR] + Jacobian (N,3,6) wrt [v,w]."""
    Xc = lie.se3_apply(R, t, X)
    uv_pred = cameras.project(model, params, Xc)
    z = torch.clamp(Xc[..., 2], min=1e-6)
    ur_pred = uv_pred[..., 0] - bf / z
    r2 = uv - uv_pred
    r3 = torch.where(is_stereo, u_right - ur_pred, torch.zeros_like(z))
    res = torch.cat([r2, r3[..., None]], dim=-1)
    Jproj = cameras.project_jac(model, params, Xc)
    zero = torch.zeros_like(z)
    dur = Jproj[:, 0, :] + torch.stack([zero, zero, bf / (z * z)], dim=-1)
    J3 = torch.cat([Jproj, dur[:, None, :]], dim=1)
    dXc = torch.cat([torch.eye(3, dtype=X.dtype, device=X.device)
                     .expand(*Xc.shape[:-1], 3, 3), -lie.hat(Xc)], dim=-1)
    J = -(J3 @ dXc)
    mono = torch.tensor([1.0, 1.0, 0.0], dtype=J.dtype, device=J.device)
    J = torch.where(is_stereo[..., None, None], J, J * mono[None, :, None])
    return res, J


def _rig_rows(model, params, rig, R, t, X, obs):
    """The left rows and the right rows of an unrectified pair in one pass
    (`cameras.rig_project`): residual (2N,2) = obs - proj and its Jacobian
    (2N,2,6) wrt [v,w] of the left pose."""
    Xc = lie.se3_apply(R, t, X)
    dXc = torch.cat([torch.eye(3, dtype=X.dtype, device=X.device)
                     .expand(*Xc.shape[:-1], 3, 3), -lie.hat(Xc)], dim=-1)
    _, proj, J = cameras.rig_project(model, params, rig, Xc)
    return obs - proj, -(J @ dXc.repeat(2, 1, 1))


def _depths(rig, R, t, X):
    """Left-camera depths, then right-camera ones with a rig."""
    Xc = lie.se3_apply(R, t, X)
    if rig is None:
        return Xc[..., 2]
    return torch.cat([Xc[..., 2], (Xc @ rig.R_rl.T + rig.t_rl)[..., 2]])


def pose_optimize(model: int, params, bf, R0, t0, X, uv, u_right, sigma2,
                  mask, n_rounds: int = 4, n_iters: int = 10, *, rig=None,
                  right=None) -> PoseOptResult:
    """LM motion-only BA. X (N,3) world points; uv (N,2) observations;
    u_right (N,) (<0 => mono); sigma2 (N,) per-octave variance; mask (N,).
    rig (`cameras.Rig`) with right (N,3) [u, v, sigma2] of each match's
    right keypoint (u < 0: none): the right-camera rows (and u_right is
    not read: every left row is monocular)."""
    dt = R0.dtype
    params = params.to(dt)
    bf = torch.as_tensor(bf, dtype=dt, device=R0.device)
    t0 = t0.to(dt)
    X = X.to(dt)
    uv = uv.to(dt)
    u_right = u_right.to(dt)
    sigma2 = sigma2.to(dt)
    is_stereo = u_right >= 0.0
    w_info = 1.0 / torch.clamp(sigma2, min=1e-12)
    hub_d2 = torch.where(is_stereo, STEREO_CHI2, MONO_CHI2).to(dt)
    eye6 = torch.eye(6, dtype=dt, device=R0.device)

    def chi2_of(res):
        return torch.sum(res * res, dim=-1) * w_info

    def robust_cost(res, inlier):
        chi2 = chi2_of(res)
        w_rob = robust.huber_weight(chi2, hub_d2)
        return torch.sum(torch.minimum(chi2, hub_d2 * 10) * w_rob * inlier)

    def resid(R, t, stereo=is_stereo):
        return _residuals_jac(model, params, bf, R, t, X, uv, u_right,
                              stereo)

    N = X.shape[0]
    if rig is not None:
        # an unrectified pair: every left row is monocular (it has no
        # u_right), and each match's right keypoint adds a row after them
        rig = rig.to(dt)
        right = right.to(dt)
        obs = torch.cat([uv, right[:, :2]])

        def resid(R, t):
            return _rig_rows(model, params, rig, R, t, X, obs)

        w_r, has = cameras.right_info(right, mask)
        w_info = torch.cat([w_info, w_r])
        is_stereo = torch.zeros(2 * N, dtype=torch.bool, device=R0.device)
        hub_d2 = torch.full((2 * N,), MONO_CHI2, dtype=dt, device=R0.device)
        mask = torch.cat([mask, has])

    R, t, inlier = R0, t0, mask
    for _ in range(n_rounds):
        # carried-residual LM: `res` is evaluated at the current accepted
        # pose; the candidate's residuals become the next `res` on accept
        res, _ = resid(R, t)
        cost = robust_cost(res, inlier)
        lam = torch.tensor(1e-3, dtype=dt, device=R0.device)
        for _ in range(n_iters):
            _, J = resid(R, t)
            chi2 = chi2_of(res)
            w = robust.huber_weight(chi2, hub_d2) * w_info * inlier
            JW = J * w[:, None, None]
            H = torch.einsum("nij,nik->jk", JW, J)
            g = -torch.einsum("nij,ni->j", JW, res)
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
            xi = lie.solve_psd6(Hd, g)
            Rn, tn = lie.se3_compose(*lie.se3_exp(xi), R, t)
            Rn = lie.normalize_rotation(Rn)
            res_n, _ = resid(Rn, tn)
            c_new = robust_cost(res_n, inlier)
            good = c_new < cost
            R = torch.where(good, Rn, R)
            t = torch.where(good, tn, t)
            res = torch.where(good, res_n, res)
            cost = torch.where(good, c_new, cost)
            lam = torch.where(good, lam * 0.5, lam * 4.0)
        # re-gate outliers for the next round
        res, _ = resid(R, t)
        gate = torch.where(is_stereo, STEREO_CHI2, MONO_CHI2).to(dt)
        inlier = mask & (chi2_of(res) <= gate) \
            & (_depths(rig, R, t, X) > 0)
    res, _ = resid(R, t)
    chi2 = torch.sum(chi2_of(res) * inlier)
    n_right = None
    if rig is not None:
        n_right = inlier[N:].sum().to(torch.int32)
        inlier = inlier[:N]
    return PoseOptResult(R=R, t=t, inlier=inlier,
                         n_inliers=inlier.sum().to(torch.int32), chi2=chi2,
                         n_right=n_right)
