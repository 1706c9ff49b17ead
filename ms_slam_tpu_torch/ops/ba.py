"""Batched bundle adjustment: the Schur-complement window BA
(camera-blocked factor table) and the alternating whole-map BA.

`ba_alternate` is the resection-intersection BA run over the whole map after
a loop closure or a merge. `ba_solve` is the port of
`ms_slam_tpu/ops/ba.py::ba_solve`: Levenberg-damped Gauss-Newton over SE(3)
camera blocks and 3D point blocks with Huber weights, a two-stage schedule
(half the iterations, drop chi2 outliers, the rest), fixed cameras/points
by Jacobian masking, and a dense reduced camera system. With
`cam_blocked=True` (the window BA's camera-block-ordered table) duplicate
(point, camera) factors are resolved first; without it the factor table is
in any order and duplicates add, as the reference's one-hot sums do.

The per-(point, camera) accumulation is one f32 `index_add_` over the
(point, camera) key instead of the reference's bf16 hi/lo one-hot matmul
(ba.py:199-233), a TPU device for riding the MXU; per-camera sums of an
arbitrary table are an `index_add_` over the camera. After the duplicate
pass of the blocked table every (point, camera) key holds at most one
factor, so that accumulation is a placement and its result does not depend
on the order.

An unrectified stereo pair's keyframes also hold each keypoint's right
keypoint: given the second camera (`rig`) and those (`f_right`, one row
per factor), both solvers add a 2-row right-camera residual to each factor
that has one (upstream's `EdgeSE3ProjectXYZToBody`), weighted by its own
variance under the monocular gate and Huber weight. A factor's left and
right rows are evaluated in one pass over 2F rows, each through its own
lens (`_rig_res_jac`), and the right rows' normal-equation terms go where
their factors' go, so the table's layout and the duplicate pass stay as
they are; without a rig nothing is added.
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


def _rig_tables(rig, f_uv, f_right, f_valid, dt):
    """What a solve with right rows adds to its table: the rig in the
    solve's precision, the observations of its 2F rows (the left pixels,
    then the right keypoints) and the right rows' information (0 where a
    factor has no right keypoint)."""
    w, _ = cameras.right_info(f_right, f_valid)
    return rig.to(dt), torch.cat([f_uv, f_right[:, :2]]).to(dt), w.to(dt)


def _rig_res_jac(model, params, rig, R_all, t_all, P_all, f_cam, f_pt, obs):
    """The left and the right rows of an unrectified pair's factors in one
    pass (`cameras.rig_project`): residual (2F,2), Jacobians wrt the camera
    tangent (2F,2,6) and the point (2F,2,3), and each row's camera depth
    (2F,)."""
    R = R_all[f_cam]
    Xc = lie.se3_apply(R, t_all[f_cam], P_all[f_pt])
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand_as(R)
    Xs, proj, J = cameras.rig_project(model, params, rig, Xc)
    dXc_dxi = torch.cat([eye, -lie.hat(Xc)], dim=-1).repeat(2, 1, 1)
    return (obs - proj, -(J @ dXc_dxi), -(J @ R.repeat(2, 1, 1)), Xs[:, 2])


def _diag_damp(H, lam, eps):
    n = H.shape[-1]
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    return H + lam * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) \
        + eps * eye


def ba_alternate(model: int, params, bf, kf_R, kf_t, cam_opt, mp_pos, pt_opt,
                 f_cam, f_pt, f_uv, f_ur, f_sigma2, f_valid,
                 n_sweeps: int = 3, n_iters: int = 2, lam: float = 1e-3, *,
                 rig=None, f_right=None):
    """Resection-intersection bundle adjustment: alternate point-only and
    camera-only Gauss-Newton passes. Each pass needs only block-diagonal
    Hessians (per-point 3x3, per-camera 6x6 scatter-adds), so it scales to
    the whole map: the global BA after a loop closure (ref
    Optimizer::GlobalBundleAdjustemnt). Returns (kf_R, kf_t, mp_pos).

    The per-point and per-camera sums are float `index_add_`s with many
    factors per target; on CUDA their order differs from run to run. rig /
    f_right (F,3) [u, v, sigma2] (u < 0: none): the right-camera rows."""
    C = kf_R.shape[0]
    P = mp_pos.shape[0]
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
    pt_free = pt_opt[f_pt][:, None, None]
    cam_free = cam_opt[f_cam][:, None, None]

    def weights(res, z, w_info=w_info, hub_d2=hub_d2):
        chi2 = torch.sum(res * res, dim=-1) * w_info
        return robust.huber_weight(chi2, hub_d2) * w_info * (z > 1e-2)

    def block_sums(J, w, res, idx, n):
        """sum_f J^T W J and -J^T W r grouped by idx: (n,d,d), (n,d)."""
        d = J.shape[-1]
        JW = J * w[:, None, None]
        Hs = torch.zeros((n, d, d), dtype=dt, device=dev).index_add_(
            0, idx, JW.transpose(1, 2) @ J)
        bs = torch.zeros((n, d), dtype=dt, device=dev).index_add_(
            0, idx, -(JW.transpose(1, 2) @ res[..., None])[..., 0])
        return _diag_damp(Hs, lam, 1e-8), bs

    def rows(R_all, t_all, P_all):
        """(residual, camera Jacobian, point Jacobian, depth) of every row
        and the rows' weights; with a rig, the left then the right rows."""
        if rig is None:
            res, Jc, Jp, z = _factor_res_jac(model, params, bf, R_all, t_all,
                                             P_all, f_cam, f_pt, f_uv, f_ur,
                                             is_stereo)
            return res, Jc, Jp, weights(res, z)
        res, Jc, Jp, z = _rig_res_jac(model, params, rig_, R_all, t_all,
                                      P_all, f_cam, f_pt, obs)
        return res, Jc, Jp, weights(res, z, w2, robust.CHI2_2DOF)

    f_cam_rows, f_pt_rows, free_pt, free_cam = f_cam, f_pt, pt_free, cam_free
    if rig is not None:
        rig_, obs, w_r = _rig_tables(rig, f_uv, f_right, f_valid, dt)
        w2 = torch.cat([w_info, w_r])
        f_cam_rows, f_pt_rows = f_cam.repeat(2), f_pt.repeat(2)
        free_pt, free_cam = pt_free.repeat(2, 1, 1), cam_free.repeat(2, 1, 1)

    R_all, t_all, P_all = kf_R, kf_t, mp_pos
    for _ in range(n_sweeps):
        for _ in range(n_iters):                       # point pass
            res, _, Jp, w = rows(R_all, t_all, P_all)
            Jp = torch.where(free_pt, Jp, torch.zeros_like(Jp))
            Hpp, bp = block_sums(Jp, w, res, f_pt_rows, P)
            P_all = P_all + lie.solve3x3(Hpp, bp) * pt_opt[:, None]
        for _ in range(n_iters):                       # camera pass
            res, Jc, _, w = rows(R_all, t_all, P_all)
            Jc = torch.where(free_cam, Jc, torch.zeros_like(Jc))
            Hcc, bc = block_sums(Jc, w, res, f_cam_rows, C)
            # sync: the batched 6x6 solve goes through the library solver
            dxc = torch.linalg.solve(Hcc, bc[..., None])[..., 0] \
                * cam_opt[:, None]
            dR, dtc = lie.se3_exp(dxc)
            R_all, t_all = lie.se3_compose(dR, dtc, R_all, t_all)
            R_all = lie.normalize_rotation(R_all)
    return R_all, t_all, P_all


def ba_solve(model: int, params, bf, kf_R, kf_t, cam_opt, mp_pos, pt_opt,
             f_cam, f_pt, f_uv, f_ur, f_sigma2, f_valid, n_iters: int = 10,
             lam: float = 1e-4, cam_blocked: bool = False, *, rig=None,
             f_right=None) -> BAResult:
    """Bundle adjust C cameras and P points over F factors.

    cam_opt (C,) / pt_opt (P,): False = fixed. cam_blocked: the factor
    table is camera-block-ordered (f_cam == repeat(arange(C), F//C), the
    (C,N) observation layout); a duplicate (point, camera) factor then
    keeps only its LAST occurrence, as the reference's CPU scatter does,
    and the others are zero-weighted and reported as outliers. Otherwise
    the factors may come in any order and every one counts.

    rig / f_right (F,3) [u, v, sigma2] (u < 0: none): the right-camera
    rows. A factor's right row follows its factor through the duplicate
    pass and has its own outlier gate; `f_inlier` reports the left rows."""
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

    pc = f_pt.clamp(0, P - 1)
    cc = f_cam.clamp(0, C - 1)
    if cam_blocked:
        # inverse observation table: the factor row of point p in camera c
        # (F_ = none); duplicate keys resolve to the last write
        arangeF = torch.arange(F_, device=dev)
        inv_f = set_at_(torch.full((P, C), F_, dtype=torch.int64,
                                   device=dev),
                        (torch.where(f_valid, pc, P), cc), arangeF)
        dup_keep = inv_f[pc, cc] == arangeF
        w_info = torch.where(dup_keep, w_info, torch.zeros_like(w_info))
        f_valid = f_valid & dup_keep
        key = torch.where(f_valid, pc * C + cc, torch.full_like(pc, P * C))
    else:
        # an invalid factor carries zero weight, so it adds nothing
        key = pc * C + cc

    def cam_accumulate(x_f):
        """sum_f x[f] grouped by camera: (F,k) -> (C,k)."""
        if cam_blocked:
            return x_f.reshape(C, F_ // C, -1).sum(1)
        return torch.zeros((C, x_f.shape[1]), dtype=dt,
                           device=dev).index_add_(0, cc, x_f)

    def pt_accumulate(x_f):
        """sum_f x[f] grouped by (point, camera): (F,k) -> (P,C,k)."""
        acc = torch.zeros((P * C + 1, x_f.shape[1]), dtype=dt, device=dev)
        acc.index_add_(0, key, x_f)
        return acc[:P * C].view(P, C, -1)

    if rig is not None:
        # after the duplicate pass: a right row lives with its factor
        rig, obs, w_r = _rig_tables(rig, f_uv, f_right, f_valid, dt)
        w2 = torch.cat([w_info, w_r])
        cam_m2 = cam_opt[f_cam].repeat(2)
        pt_m2 = pt_opt[f_pt].repeat(2)

        def rig_rows(state):
            res, Jc, Jp, z = _rig_res_jac(model, params, rig, *state, f_cam,
                                          f_pt, obs)
            return res, Jc, Jp, z, torch.sum(res * res, dim=-1) * w2

    def terms(res, Jc, Jp, w, cam_m, pt_m):
        """Each row's J^T W J and -J^T W r blocks: (n,36), (n,6), (n,9),
        (n,3), (n,6,3)."""
        n = res.shape[0]
        Jc = torch.where(cam_m[:, None, None], Jc, torch.zeros_like(Jc))
        Jp = torch.where(pt_m[:, None, None], Jp, torch.zeros_like(Jp))
        JcW = Jc * w[:, None, None]
        JpW = Jp * w[:, None, None]
        return ((JcW.transpose(1, 2) @ Jc).reshape(n, 36),
                -(JcW.transpose(1, 2) @ res[..., None])[..., 0],
                (JpW.transpose(1, 2) @ Jp).reshape(n, 9),
                -(JpW.transpose(1, 2) @ res[..., None])[..., 0],
                JcW.transpose(1, 2) @ Jp)

    def iteration(state, keep):
        R_all, t_all, P_all = state
        if rig is None:
            res, Jc, Jp, z = _factor_res_jac(model, params, bf, R_all, t_all,
                                             P_all, f_cam, f_pt, f_uv, f_ur,
                                             is_stereo)
            chi2 = torch.sum(res * res, dim=-1) * w_info
            # behind-camera factors sit out this iteration
            active = (z > 1e-2) & keep
            w = robust.huber_weight(chi2, hub_d2) * w_info * active
            outer_c, gc, outer_p, gp, Wcp = terms(
                res, Jc, Jp, w, cam_opt[f_cam], pt_opt[f_pt])
        else:
            # the left and the right rows of each factor, summed into it
            res, Jc, Jp, z, chi2 = rig_rows(state)
            w = robust.huber_weight(chi2, robust.CHI2_2DOF) * w2 \
                * ((z > 1e-2) & keep)
            outer_c, gc, outer_p, gp, Wcp = (
                a[:F_] + a[F_:] for a in terms(res, Jc, Jp, w, cam_m2, pt_m2))

        Hcc = cam_accumulate(outer_c).reshape(C, 6, 6)
        bc = cam_accumulate(gc)
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
    keep_all = torch.ones_like(f_valid if rig is None else w2, dtype=bool)
    for _ in range(max(n_iters // 2, 1)):
        state = iteration(state, keep_all)
    R_all, t_all, P_all = state
    if rig is None:
        res, _, _, z = _factor_res_jac(model, params, bf, R_all, t_all,
                                       P_all, f_cam, f_pt, f_uv, f_ur,
                                       is_stereo)
        mid_chi2 = torch.sum(res * res, dim=-1) * w_info
        keep = (mid_chi2 <= 2.0 * hub_d2) & (z > 1e-2)
    else:
        _, _, _, z, mid_chi2 = rig_rows(state)
        keep = (mid_chi2 <= 2.0 * robust.CHI2_2DOF) & (z > 1e-2)
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
