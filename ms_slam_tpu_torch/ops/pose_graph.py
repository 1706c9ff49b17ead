"""Batched pose-graph optimization: SE(3), 4-DoF (yaw + translation) and
Sim(3) essential graphs.

Port of `ms_slam_tpu/ops/pose_graph.py`. Edges carry measured relatives
Z_ij = T_i T_j^-1 (camera-from-world poses). The residual is
r = log(Z_ij^-1 T_i T_j^-1); its Jacobians with respect to the
left-multiplicative tangents of both endpoints come from
`torch.func.vmap(jacrev(...))` at a zero tangent, as the reference's come
from `jax.vmap(jax.jacrev(...))`; the (K*D)^2 normal system is
scatter-assembled and solved densely. Fixed poses (the loop keyframe) are
masked.

The three graphs share one Gauss-Newton template, `_optimize`, and differ
in their residual, tangent size and update.

The block accumulation is one `index_add_` over the flattened (i, j) block
index. Many edges hit one block (every padding edge hits (0, 0) with weight
0), and on CUDA the order of a float sum into one target differs from run to
run: results agree with the CPU's to rounding, not bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacrev, vmap

from . import lie


class PoseGraphResult(NamedTuple):
    R: torch.Tensor   # (K,3,3)
    t: torch.Tensor   # (K,3)
    final_cost: torch.Tensor


class Graph4DoFResult(NamedTuple):
    R: torch.Tensor   # (K,3,3)
    t: torch.Tensor   # (K,3)
    final_cost: torch.Tensor


class Sim3GraphResult(NamedTuple):
    s: torch.Tensor   # (K,)
    R: torch.Tensor   # (K,3,3)
    t: torch.Tensor   # (K,3)
    final_cost: torch.Tensor


def relative_pose(Ri, ti, Rj, tj):
    """Z_ij = T_i * T_j^-1 for edge construction."""
    Rji, tji = lie.se3_inv(Rj, tj)
    return lie.se3_compose(Ri, ti, Rji, tji)


def _optimize(residual, update, D: int, state: tuple, fixed, e_i, e_j,
              meas: tuple, e_w, e_valid, n_iters: int, lam: float):
    """Gauss-Newton over K poses and E relative edges.

    residual(x_i, x_j, *state_i, *state_j, *meas_e) -> (D_r,) for one edge;
    update(dx (K,D), *state) -> the new state; state: per-pose tensors
    (leading axis K); meas: per-edge measurements (leading axis E). Returns
    (state, cost at the start of the last iteration)."""
    K = state[0].shape[0]
    dt = state[1].dtype
    dev = state[1].device
    e_i = e_i.long()
    e_j = e_j.long()
    zero = torch.zeros(D, dtype=dt, device=dev)
    in_dims = (None, None) + (0,) * (2 * len(state) + len(meas))

    def one_edge(*args):
        # a leading axis of 1 through `lie`: under torch.func transforms a
        # 0-d tensor combined with a Python number can come out in float64
        return residual(*[a[None] for a in args])[0]
    res_fn = vmap(one_edge, in_dims=in_dims)
    jac_fn = vmap(jacrev(one_edge, argnums=(0, 1)), in_dims=in_dims)
    free = (~fixed).to(dt)
    w_e = e_w * e_valid.to(dt)
    w = w_e[:, None, None]
    blk = torch.cat([e_i * K + e_i, e_j * K + e_j, e_i * K + e_j,
                     e_j * K + e_i])
    diag = torch.repeat_interleave(fixed, D).to(dt) * 1e6 + lam + 1e-8
    cost = torch.zeros((), dtype=dt, device=dev)
    for _ in range(n_iters):
        args = tuple(a[e_i] for a in state) + tuple(a[e_j] for a in state) \
            + meas
        r = res_fn(zero, zero, *args)                       # (E,Dr)
        Ji, Jj = jac_fn(zero, zero, *args)                  # (E,Dr,D)
        Ji = Ji * free[e_i][:, None, None]
        Jj = Jj * free[e_j][:, None, None]
        JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
        H = torch.zeros((K * K, D, D), dtype=dt, device=dev)
        H.index_add_(0, blk, torch.cat([w * (JiT @ Ji), w * (JjT @ Jj),
                                        w * (JiT @ Jj), w * (JjT @ Ji)]))
        b = torch.zeros((K, D), dtype=dt, device=dev)
        b.index_add_(0, torch.cat([e_i, e_j]),
                     -torch.cat([((Ji * w).transpose(1, 2) @ r[..., None]),
                                 ((Jj * w).transpose(1, 2) @ r[..., None])]
                                )[..., 0])
        Hb = H.view(K, K, D, D).permute(0, 2, 1, 3).reshape(K * D, K * D)
        # fixed poses: identity rows
        Hb = Hb + torch.diag(diag)
        # sync: the dense (K*D)^2 solve goes through the library solver
        dx = torch.linalg.solve(Hb, b.reshape(K * D)).reshape(K, D)
        state = update(dx * free[:, None], *state)
        cost = torch.sum(torch.sum(r * r, -1) * w_e)
    return state, cost


def _edge_residual(xi_i, xi_j, Ri, ti, Rj, tj, Rz, tz):
    """r = log(Z^-1 * exp(xi_i) T_i * (exp(xi_j) T_j)^-1)."""
    dRi, dti = lie.se3_exp(xi_i)
    dRj, dtj = lie.se3_exp(xi_j)
    Ri2, ti2 = lie.se3_compose(dRi, dti, Ri, ti)
    Rj2, tj2 = lie.se3_compose(dRj, dtj, Rj, tj)
    return _se3_edge_log(Ri2, ti2, Rj2, tj2, Rz, tz)


def _se3_edge_log(Ri, ti, Rj, tj, Rz, tz):
    Rrel, trel = relative_pose(Ri, ti, Rj, tj)
    Rzi, tzi = lie.se3_inv(Rz, tz)
    return lie.se3_log(*lie.se3_compose(Rzi, tzi, Rrel, trel))


def _se3_update(dx, R_all, t_all):
    dR, dtv = lie.se3_exp(dx)
    R_new, t_new = lie.se3_compose(dR, dtv, R_all, t_all)
    return lie.normalize_rotation(R_new), t_new


def optimize_pose_graph(kf_R, kf_t, fixed, e_i, e_j, e_R, e_t, e_w, e_valid,
                        n_iters: int = 12,
                        lam: float = 1e-6) -> PoseGraphResult:
    """Optimize K SE(3) poses over E relative edges.

    fixed: (K,) bool, poses excluded from updates (gauge / loop keyframe);
    e_i/e_j: (E,) endpoint indices; e_R/e_t: (E,3,3),(E,3) measured
    Z_ij = T_i T_j^-1; e_w: (E,) edge weight; e_valid: (E,) bool."""
    (R, t), cost = _optimize(_edge_residual, _se3_update, 6, (kf_R, kf_t),
                             fixed, e_i, e_j, (e_R, e_t), e_w, e_valid,
                             n_iters, lam)
    return PoseGraphResult(R=R, t=t, final_cost=cost)


# ---------------------------------------------------------------------------
# 4-DoF variant: the inertial essential graph (ref
# Optimizer::OptimizeEssentialGraph4DoF). Once the IMU has observed gravity,
# pitch and roll are globally observable, so the correction may only
# redistribute yaw about the gravity axis and translation.
# ---------------------------------------------------------------------------

def _apply_4dof(x4, up, R, t):
    """World-frame 4-DoF update of camera-from-world poses: T_wc' = DT T_wc
    with DT = (exp(yaw*up), dt_world), i.e. T_cw' = T_cw DT^-1. `up` is the
    unit gravity-up axis in world coordinates; x4: (...,4) [dt(3), yaw]."""
    Rzi = lie.so3_exp(x4[..., 3:4] * up).transpose(-1, -2)
    dti = -lie._mv(Rzi, x4[..., :3])
    return R @ Rzi, lie._mv(R, dti) + t


def optimize_pose_graph_4dof(kf_R, kf_t, up, fixed, e_i, e_j, e_R, e_t, e_w,
                             e_valid, n_iters: int = 12,
                             lam: float = 1e-6) -> Graph4DoFResult:
    """4-DoF (yaw about `up` + translation) pose-graph optimization. The
    residual is still the full se(3) log, so pitch/roll disagreements cost,
    but the update can only move yaw and translation (ref VertexPose4DoF)."""
    up = up / torch.clamp(torch.linalg.norm(up), min=1e-9)

    def residual(x_i, x_j, Ri, ti, Rj, tj, Rz, tz):
        Ri2, ti2 = _apply_4dof(x_i, up, Ri, ti)
        Rj2, tj2 = _apply_4dof(x_j, up, Rj, tj)
        return _se3_edge_log(Ri2, ti2, Rj2, tj2, Rz, tz)

    def update(dx, R_all, t_all):
        R_new, t_new = _apply_4dof(dx, up, R_all, t_all)
        return lie.normalize_rotation(R_new), t_new

    (R, t), cost = _optimize(residual, update, 4, (kf_R, kf_t), fixed, e_i,
                             e_j, (e_R, e_t), e_w, e_valid, n_iters, lam)
    return Graph4DoFResult(R=R, t=t, final_cost=cost)


# ---------------------------------------------------------------------------
# Sim(3) variant: the monocular essential graph (ref OptimizeEssentialGraph
# with bFixScale=false); a monocular loop closure must absorb scale drift,
# so vertices are 7-DoF.
# ---------------------------------------------------------------------------

def _edge_residual_sim3(xi_i, xi_j, si, Ri, ti, sj, Rj, tj, sz, Rz, tz):
    """r = log(Z^-1 * exp(xi_i) S_i * (exp(xi_j) S_j)^-1) in sim(3)."""
    Si = lie.sim3_compose(*lie.sim3_exp(xi_i), si, Ri, ti)
    Sj = lie.sim3_compose(*lie.sim3_exp(xi_j), sj, Rj, tj)
    Srel = lie.sim3_compose(*Si, *lie.sim3_inv(*Sj))
    return lie.sim3_log(*lie.sim3_compose(*lie.sim3_inv(sz, Rz, tz), *Srel))


def _sim3_update(dx, s_all, R_all, t_all):
    s_new, R_new, t_new = lie.sim3_compose(*lie.sim3_exp(dx), s_all, R_all,
                                           t_all)
    return s_new, lie.normalize_rotation(R_new), t_new


def optimize_pose_graph_sim3(kf_s, kf_R, kf_t, fixed, e_i, e_j, e_s, e_R,
                             e_t, e_w, e_valid, n_iters: int = 12,
                             lam: float = 1e-6) -> Sim3GraphResult:
    """7-DoF pose-graph optimization over E relative Sim(3) edges; edge
    measurements Z_ij = S_i S_j^-1 carry scale (1 for odometry edges built
    before drift, s_loop for the closing edge)."""
    (s, R, t), cost = _optimize(_edge_residual_sim3, _sim3_update, 7,
                                (kf_s, kf_R, kf_t), fixed, e_i, e_j,
                                (e_s, e_R, e_t), e_w, e_valid, n_iters, lam)
    return Sim3GraphResult(s=s, R=R, t=t, final_cost=cost)
