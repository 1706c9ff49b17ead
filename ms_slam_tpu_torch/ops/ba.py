"""Batched Schur-complement bundle adjustment (camera-blocked factor table).

Port of `ms_slam_tpu/ops/ba.py::ba_solve` with `cam_blocked=True`, the path
the window BA takes: Levenberg-damped Gauss-Newton over SE(3) camera
blocks and 3D point blocks with Huber weights, a two-stage schedule (half
the iterations, drop chi2 outliers, the rest), fixed cameras/points by
Jacobian masking, and a dense reduced camera system.

The per-(point, camera) accumulation is one f32 `index_add_` over the
(point, camera) key instead of the reference's bf16 hi/lo one-hot matmul
(ba.py:199-233), a TPU device for riding the MXU. After the duplicate
pass below every (point, camera) key holds at most one factor, so the
accumulation is a placement and its result does not depend on the order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cameras, lie, robust
from .indexing import set_at_


class BAResult(NamedTuple):
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    mp_pos: torch.Tensor
    f_chi2: torch.Tensor    # (F,) final per-factor chi2
    f_inlier: torch.Tensor  # (F,) bool


def _factor_res_jac(model, params, bf, R_all, t_all, P_all,
                    f_cam, f_pt, f_uv, f_ur, is_stereo):
    """Residual (F,3), Jacobians wrt camera tangent (F,3,6) and point
    (F,3,3), camera-frame depth (F,)."""
    R = R_all[f_cam]
    t = t_all[f_cam]
    X = P_all[f_pt]
    Xc = lie.se3_apply(R, t, X)
    uv_pred = cameras.project(model, params, Xc)
    z = torch.clamp(Xc[..., 2], min=1e-6)
    ur_pred = uv_pred[..., 0] - bf / z
    r2 = f_uv - uv_pred
    r3 = torch.where(is_stereo, f_ur - ur_pred, torch.zeros_like(z))
    res = torch.cat([r2, r3[..., None]], dim=-1)
    Jproj = cameras.project_jac(model, params, Xc)
    zero = torch.zeros_like(z)
    dur = Jproj[:, 0, :] + torch.stack([zero, zero, bf / (z * z)], dim=-1)
    J3 = torch.cat([Jproj, dur[:, None, :]], dim=1)
    mono = torch.tensor([1.0, 1.0, 0.0], dtype=J3.dtype,
                        device=J3.device).view(1, 3, 1)
    J3 = J3 * torch.where(is_stereo[:, None, None], torch.ones_like(mono),
                          mono)
    dXc_dxi = torch.cat([torch.eye(3, dtype=Xc.dtype, device=Xc.device)
                         .expand(*Xc.shape[:-1], 3, 3), -lie.hat(Xc)], dim=-1)
    Jc = -(J3 @ dXc_dxi)
    Jp = -(J3 @ R)
    return res, Jc, Jp, Xc[..., 2]


def _diag_damp(H, lam, eps):
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    return H + lam * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
        + eps * eye


def ba_solve(model: int, params, bf, kf_R, kf_t, cam_opt, mp_pos, pt_opt,
             f_cam, f_pt, f_uv, f_ur, f_sigma2, f_valid, n_iters: int = 10,
             lam: float = 1e-4, cam_blocked: bool = False) -> BAResult:
    """Bundle adjust C cameras and P points over F factors.

    cam_opt (C,) / pt_opt (P,): False = fixed. The factor table must be
    camera-block-ordered (f_cam == repeat(arange(C), F//C), the (C,N)
    observation layout); a duplicate (point, camera) factor keeps only its
    LAST occurrence, as the reference's CPU scatter does, and the others are
    zero-weighted and reported as outliers."""
    if not cam_blocked:
        raise NotImplementedError("only the camera-blocked factor table "
                                  "(the window BA's) is ported")
    C = kf_R.shape[0]
    P = mp_pos.shape[0]
    F_ = f_cam.shape[0]
    dev = kf_R.device
    dt = kf_R.dtype
    params = params.to(dt)
    bf = torch.as_tensor(bf, dtype=dt, device=dev)
    f_cam = f_cam.long()
    f_pt = f_pt.long()
    is_stereo = f_ur >= 0.0
    w_info = torch.where(f_valid, 1.0 / torch.clamp(f_sigma2, min=1e-12),
                         torch.zeros_like(f_sigma2))
    hub_d2 = torch.where(is_stereo, robust.CHI2_3DOF,
                         robust.CHI2_2DOF).to(dt)

    # inverse observation table: the factor row of point p in camera c
    # (F_ = none); duplicate keys resolve to the last write
    pc = f_pt.clamp(0, P - 1)
    cc = f_cam.clamp(0, C - 1)
    arangeF = torch.arange(F_, device=dev)
    inv_f = set_at_(torch.full((P, C), F_, dtype=torch.int64, device=dev),
                    (torch.where(f_valid, pc, P), cc), arangeF)
    dup_keep = inv_f[pc, cc] == arangeF
    w_info = torch.where(dup_keep, w_info, torch.zeros_like(w_info))
    f_valid = f_valid & dup_keep
    key = torch.where(f_valid, pc * C + cc, torch.full_like(pc, P * C))

    def pt_accumulate(x_f):
        """sum_f x[f] grouped by (point, camera): (F,k) -> (P,C,k)."""
        acc = torch.zeros((P * C + 1, x_f.shape[1]), dtype=dt, device=dev)
        acc.index_add_(0, key, x_f)
        return acc[:P * C].view(P, C, -1)

    def iteration(state, keep):
        R_all, t_all, P_all = state
        res, Jc, Jp, z = _factor_res_jac(model, params, bf, R_all, t_all,
                                         P_all, f_cam, f_pt, f_uv, f_ur,
                                         is_stereo)
        chi2 = torch.sum(res * res, dim=-1) * w_info
        # behind-camera factors sit out this iteration
        active = (z > 1e-2) & keep
        w = robust.huber_weight(chi2, hub_d2) * w_info * active
        Jc = torch.where(cam_opt[f_cam][:, None, None], Jc,
                         torch.zeros_like(Jc))
        Jp = torch.where(pt_opt[f_pt][:, None, None], Jp,
                         torch.zeros_like(Jp))
        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]

        outer_c = (JcW.transpose(1, 2) @ Jc).reshape(F_, 36)
        gc = -(JcW.transpose(1, 2) @ res[..., None])[..., 0]
        Hcc = outer_c.reshape(C, F_ // C, 36).sum(1).reshape(C, 6, 6)
        bc = gc.reshape(C, F_ // C, 6).sum(1)
        outer_p = (JpW.transpose(1, 2) @ Jp).reshape(F_, 9)
        gp = -(JpW.transpose(1, 2) @ res[..., None])[..., 0]
        Wcp = JcW.transpose(1, 2) @ Jp                      # (F,6,3)
        acc = pt_accumulate(torch.cat([outer_p, gp, Wcp.reshape(F_, 18)], 1))
        Hpp = acc[..., :9].sum(1).reshape(P, 3, 3)
        bp = acc[..., 9:12].sum(1)
        W = acc[..., 12:].reshape(P, C * 6, 3)

        Hcc = _diag_damp(Hcc, lam, 1e-8)
        Hpp_inv = lie.inv3x3(_diag_damp(Hpp, lam, 1e-8))
        # Schur reduction onto the cameras
        Hcc_big = torch.block_diag(*Hcc)
        Y = W @ Hpp_inv                                     # (P,6C,3)
        Yr = Y.transpose(0, 1).reshape(C * 6, P * 3)
        Wr = W.transpose(0, 1).reshape(C * 6, P * 3)
        S = Hcc_big - Yr @ Wr.T
        v = bc.reshape(C * 6) - Yr @ bp.reshape(P * 3)
        dxc = torch.linalg.solve(
            S + 1e-8 * torch.eye(C * 6, dtype=dt, device=dev), v)
        dxp = (Hpp_inv @ (bp - (W.transpose(1, 2) @ dxc))[..., None])[..., 0]

        dxc = dxc.reshape(C, 6) * cam_opt[:, None]
        dxp = dxp * pt_opt[:, None]
        dR, dtc = lie.se3_exp(dxc)
        R_new, t_new = lie.se3_compose(dR, dtc, R_all, t_all)
        return lie.normalize_rotation(R_new), t_new, P_all + dxp

    # two-stage schedule (ref LocalBundleAdjustment: iterate, drop chi2
    # outliers, iterate again)
    state = (kf_R, kf_t, mp_pos)
    keep_all = torch.ones_like(f_valid)
    for _ in range(max(n_iters // 2, 1)):
        state = iteration(state, keep_all)
    R_all, t_all, P_all = state
    res, _, _, z = _factor_res_jac(model, params, bf, R_all, t_all, P_all,
                                   f_cam, f_pt, f_uv, f_ur, is_stereo)
    mid_chi2 = torch.sum(res * res, dim=-1) * w_info
    keep = (mid_chi2 <= 2.0 * hub_d2) & (z > 1e-2)
    for _ in range(max(n_iters - n_iters // 2, 1)):
        state = iteration(state, keep)
    R_all, t_all, P_all = state
    res, _, _, _ = _factor_res_jac(model, params, bf, R_all, t_all, P_all,
                                   f_cam, f_pt, f_uv, f_ur, is_stereo)
    chi2 = torch.sum(res * res, dim=-1) * torch.where(
        f_valid, 1.0 / torch.clamp(f_sigma2, min=1e-12),
        torch.zeros_like(f_sigma2))
    Xc_z = lie.se3_apply(R_all[f_cam], t_all[f_cam], P_all[f_pt])[..., 2]
    inlier = f_valid & (chi2 <= hub_d2) & (Xc_z > 0)
    return BAResult(kf_R=R_all, kf_t=t_all, mp_pos=P_all, f_chi2=chi2,
                    f_inlier=inlier)
