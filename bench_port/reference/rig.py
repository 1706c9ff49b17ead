"""The two-camera Kannala-Brandt8 observation model in plain float64 torch,
independent of the port: a world point seen by the left camera of an
unrectified pair and, through T_rl (right from left) and the second lens,
by the right one (upstream's `EdgeSE3ProjectXYZ[OnlyPose]ToBody`).

- `left_residual`, `right_residual`: uv - pi1(R X + t) and
  xy_r - pi2(R_rl (R X + t) + t_rl);
- `pose_jacobian`, `body_jacobian`, `point_jacobian`: their Jacobians by
  automatic differentiation, with respect to a left perturbation
  [dt, dtheta] of the camera pose (Xc' = Exp(dtheta) Xc + dt), to
  [dp, dtheta] of a body pose carrying the camera (R_wb' = Exp(dtheta)
  R_wb, p' = p + dp, T_wc = T_wb T_bc) and to the world point;
- `pose_lm`: a plain Levenberg-Marquardt motion-only refinement over both
  rows, with per-row variances, Huber weights and the chi2 re-gate of
  upstream's PoseOptimization between rounds;
- `ba_rows`: a BA factor table with right rows evaluated row by row.

Nothing here imports the port or JAX; TF32 is off.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F64 = torch.float64
CHI2_MONO = 5.991


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(a).to(F64)


def kb8_project(params, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) to pixels: theta_d = theta (1 + k1 t^2
    + k2 t^4 + k3 t^6 + k4 t^8), u = fx theta_d x / r + cx."""
    fx, fy, cx, cy, k1, k2, k3, k4 = [params[i] for i in range(8)]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r = torch.sqrt(x * x + y * y)
    th = torch.atan2(r, z)
    t2 = th * th
    thd = th * (1 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3 + k4 * t2 ** 4)
    s = thd / r
    return torch.stack([fx * x * s + cx, fy * y * s + cy], -1)


def pinhole_project(params, Xc: torch.Tensor) -> torch.Tensor:
    return torch.stack([params[0] * Xc[..., 0] / Xc[..., 2] + params[2],
                        params[1] * Xc[..., 1] / Xc[..., 2] + params[3]], -1)


def project(model: str, params, Xc):
    return (kb8_project if model == "kb8" else pinhole_project)(params, Xc)


def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues, with its series near 0 (differentiable at 0)."""
    th2 = (w * w).sum(-1)
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    a = torch.where(small, 1 - th2 / 6, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(th)) / (th * th))
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def left_residual(model, params, R, t, X, uv):
    """(n, 2): uv - pi1(R X + t)."""
    return uv - project(model, params, X @ R.transpose(-1, -2) + t)


def right_residual(model, params2, T_rl, R, t, X, xy_r):
    """(n, 2): xy_r - pi2(R_rl (R X + t) + t_rl)."""
    Xc = X @ R.transpose(-1, -2) + t
    Xr = Xc @ T_rl[:3, :3].T + T_rl[:3, 3]
    return xy_r - project(model, params2, Xr)


def _per_point(fn, *args):
    """fn applied to one point at a time (vmap over the leading axis)."""
    return torch.func.vmap(fn)(*args)


def pose_jacobian(res_fn, R, t, X, obs):
    """(n, 2, 6) d res / d [dt, dtheta] of the left camera pose, per point;
    res_fn(R, t, X, obs) -> (n, 2) for the batch (R, t shared)."""
    def one(Xi, oi):
        def f(d):
            Rp = exp_so3(d[3:]) @ R
            tp = exp_so3(d[3:]) @ t + d[:3]
            return res_fn(Rp, tp, Xi[None], oi[None])[0]
        return torch.func.jacfwd(f)(torch.zeros(6, dtype=F64))
    return _per_point(one, X, obs)


def point_jacobian(res_fn, R, t, X, obs):
    """(n, 2, 3) d res / d X, per point."""
    def one(Xi, oi):
        return torch.func.jacfwd(
            lambda x: res_fn(R, t, x[None], oi[None])[0])(Xi)
    return _per_point(one, X, obs)


def camera_of_body(R_wb, p_wb, R_bc, t_bc):
    """(R_cw, t_cw) of the camera riding on the body: (T_wb T_bc)^-1."""
    R_wc = R_wb @ R_bc
    p_wc = R_wb @ t_bc + p_wb
    return R_wc.T, -R_wc.T @ p_wc


def body_jacobian(res_fn, R_wb, p_wb, R_bc, t_bc, X, obs):
    """(n, 2, 6) d res / d [dp, dtheta] of the body pose, per point."""
    def one(Xi, oi):
        def f(d):
            R_cw, t_cw = camera_of_body(exp_so3(d[3:]) @ R_wb, p_wb + d[:3],
                                        R_bc, t_bc)
            return res_fn(R_cw, t_cw, Xi[None], oi[None])[0]
        return torch.func.jacfwd(f)(torch.zeros(6, dtype=F64))
    return _per_point(one, X, obs)


def huber_weight(chi2, d2):
    c = torch.clamp(chi2, min=1e-12)
    return torch.where(c <= d2, torch.ones_like(c), torch.sqrt(d2 / c))


def pose_lm(model, params, params2, T_rl, R0, t0, X, uv, sigma2, right,
            mask, n_rounds: int = 4, n_iters: int = 20):
    """Motion-only Levenberg-Marquardt over left rows and, where right[:,
    0] >= 0, right rows (right (n, 3) [u, v, sigma2]): Huber weights at
    chi2 5.991, 1/sigma2 information, a chi2 re-gate after each round, as
    upstream's PoseOptimization. Returns (R, t, left inliers, right
    inliers)."""
    params, params2, T_rl = _f64(params), _f64(params2), _f64(T_rl)
    R, t, X, uv = _f64(R0), _f64(t0), _f64(X), _f64(uv)
    right, sigma2 = _f64(right), _f64(sigma2)
    mask = torch.as_tensor(mask, dtype=torch.bool)
    has_r = mask & (right[:, 0] >= 0)
    w_l, w_r = 1.0 / sigma2, 1.0 / torch.clamp(right[:, 2], min=1e-12)

    def lres(R, t, X, o):
        return left_residual(model, params, R, t, X, o)

    def rres(R, t, X, o):
        return right_residual(model, params2, T_rl, R, t, X, o)

    def rows(R, t):
        return lres(R, t, X, uv), rres(R, t, X, right[:, :2])

    def cost(R, t, in_l, in_r):
        rl, rr = rows(R, t)
        out = 0.0
        for r, w, inl in ((rl, w_l, in_l), (rr, w_r, in_r)):
            c2 = (r * r).sum(-1) * w
            # the Huber loss: c2 inside, 2 d sqrt(c2) - d^2 outside
            rho = torch.where(c2 <= CHI2_MONO, c2,
                              2 * (CHI2_MONO * c2).sqrt() - CHI2_MONO)
            out = out + (rho * inl).sum()
        return out

    in_l, in_r = mask.clone(), has_r.clone()
    for _ in range(n_rounds):
        lam = 1e-3
        c = cost(R, t, in_l, in_r)
        for _ in range(n_iters):
            rl, rr = rows(R, t)
            H = torch.zeros(6, 6, dtype=F64)
            g = torch.zeros(6, dtype=F64)
            for r, w, inl, fn, o in ((rl, w_l, in_l, lres, uv),
                                     (rr, w_r, in_r, rres, right[:, :2])):
                J = pose_jacobian(fn, R, t, X, o)
                c2 = (r * r).sum(-1) * w
                wt = huber_weight(c2, CHI2_MONO) * w * inl
                H += torch.einsum("n,nij,nik->jk", wt, J, J)
                g += torch.einsum("n,nij,ni->j", wt, J, r)
            d = torch.linalg.solve(H + lam * torch.diag(torch.diag(H)), -g)
            Rn = exp_so3(d[3:]) @ R
            tn = exp_so3(d[3:]) @ t + d[:3]
            cn = cost(Rn, tn, in_l, in_r)
            if cn < c:
                R, t, c, lam = Rn, tn, cn, lam * 0.5
            else:
                lam *= 4.0
        rl, rr = rows(R, t)
        Xc = X @ R.T + t
        in_l = mask & ((rl * rl).sum(-1) * w_l <= CHI2_MONO) & (Xc[:, 2] > 0)
        in_r = has_r & ((rr * rr).sum(-1) * w_r <= CHI2_MONO) \
            & ((Xc @ T_rl[:3, :3].T + T_rl[:3, 3])[:, 2] > 0)
    return R, t, in_l, in_r


def ba_rows(model, params, params2, T_rl, R_all, t_all, P_all, f_cam, f_pt,
            f_uv, f_right):
    """A BA factor table with right rows: per factor the left residual
    (F, 2), the right residual (F, 2; 0 where f_right[:, 0] < 0), and each
    row's Jacobians with respect to its camera's [dt, dtheta] and its
    point: (F, 2, 6), (F, 2, 3) for the left and the right rows."""
    params, params2, T_rl = _f64(params), _f64(params2), _f64(T_rl)
    R_all, t_all, P_all = _f64(R_all), _f64(t_all), _f64(P_all)
    f_uv, f_right = _f64(f_uv), _f64(f_right)
    has = f_right[:, 0] >= 0
    out = {"left": [], "right": []}
    for f in range(len(f_cam)):
        R, t = R_all[f_cam[f]], t_all[f_cam[f]]
        X = P_all[f_pt[f]][None]
        for side, o, fn in (
                ("left", f_uv[f][None],
                 lambda R, t, X, o: left_residual(model, params, R, t, X, o)),
                ("right", f_right[f, :2][None],
                 lambda R, t, X, o: right_residual(model, params2, T_rl, R,
                                                   t, X, o))):
            if side == "right" and not has[f]:
                out[side].append((torch.zeros(2, dtype=F64),
                                  torch.zeros(2, 6, dtype=F64),
                                  torch.zeros(2, 3, dtype=F64)))
                continue
            out[side].append((fn(R, t, X, o)[0],
                              pose_jacobian(fn, R, t, X, o)[0],
                              point_jacobian(fn, R, t, X, o)[0]))
    return {k: tuple(torch.stack(a) for a in zip(*v))
            for k, v in out.items()}
