"""Batched SO(3)/SE(3)/Sim(3) operations on stacked tensors.

Port of `ms_slam_tpu/ops/lie.py`. Rotations are (...,3,3) matrices; SE(3)
tangents are 6-vectors ordered [upsilon(3), omega(3)] (translation first,
Sophus' SE3::log convention), Sim(3) tangents 7-vectors [v, w, sigma].
Taylor fallbacks below `_SMALL2` keep float32 finite at the identity.

No function branches in Python on tensor values or writes in place, so
`torch.func.jacrev/jacfwd/vmap` trace through all of them (the pose graphs
and the Sim(3) refinements differentiate `se3_log`/`sim3_log`).
"""
from __future__ import annotations

import torch

_EPS = 1e-8
_SMALL2 = 1e-8  # theta^2 threshold for Taylor branches


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_theta(theta2):
    small = theta2 < _SMALL2
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return small, theta


def _sinc_t2(theta2):
    small, th = _safe_theta(theta2)
    return torch.where(small, 1.0 - theta2 / 6.0, torch.sin(th) / th)


def _cosc_t2(theta2):
    small, th = _safe_theta(theta2)
    return torch.where(small, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(th))
                       / torch.where(small, torch.ones_like(theta2), theta2))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (...,3) tangent -> (...,3,3) rotation."""
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    W2 = W @ W
    a = _sinc_t2(theta2)[..., None, None]
    b = _cosc_t2(theta2)[..., None, None]
    return _eye(3, w).expand(W.shape) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix logarithm (...,3,3) -> (...,3), via the quaternion."""
    return quat_log(rot_to_quat(R))


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> unit quaternion (...,4) ordered (w,x,y,z), w>=0
    (Shepperd's method: the numerically largest pivot is taken)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _ssqrt(v):
        ok = v > 1e-8
        return torch.where(ok, torch.sqrt(torch.where(ok, v, torch.ones_like(v))),
                           torch.zeros_like(v))

    def _safe(d):
        return torch.where(torch.abs(d) > 1e-6, d, torch.ones_like(d))

    qw0 = _ssqrt(1.0 + tr) / 2.0
    c0 = torch.stack([qw0, (m21 - m12) / _safe(4.0 * qw0),
                      (m02 - m20) / _safe(4.0 * qw0),
                      (m10 - m01) / _safe(4.0 * qw0)], dim=-1)
    qx1 = _ssqrt(1.0 + m00 - m11 - m22) / 2.0
    c1 = torch.stack([(m21 - m12) / _safe(4.0 * qx1), qx1,
                      (m01 + m10) / _safe(4.0 * qx1),
                      (m02 + m20) / _safe(4.0 * qx1)], dim=-1)
    qy2 = _ssqrt(1.0 - m00 + m11 - m22) / 2.0
    c2 = torch.stack([(m02 - m20) / _safe(4.0 * qy2),
                      (m01 + m10) / _safe(4.0 * qy2), qy2,
                      (m12 + m21) / _safe(4.0 * qy2)], dim=-1)
    qz3 = _ssqrt(1.0 - m00 - m11 + m22) / 2.0
    c3 = torch.stack([(m10 - m01) / _safe(4.0 * qz3),
                      (m02 + m20) / _safe(4.0 * qz3),
                      (m12 + m21) / _safe(4.0 * qz3), qz3], dim=-1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)           # first max, as jnp.argmax
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (...,4cand,4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(...,4) (w,x,y,z) -> (...,3,3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation vector (...,3)."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn2 = torch.sum(v * v, dim=-1)
    small = vn2 < _EPS * _EPS
    vn = torch.sqrt(torch.where(small, torch.ones_like(vn2), vn2))
    theta = 2.0 * torch.atan2(vn, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), theta / vn)
    return v * scale[..., None]


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3): (...,3) -> (...,3,3) (se3_exp's V)."""
    theta2 = torch.sum(w * w, dim=-1)
    small, th = _safe_theta(theta2)
    W = hat(w)
    W2 = W @ W
    b = _cosc_t2(theta2)[..., None, None]
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (th - torch.sin(th))
                    / torch.where(small, torch.ones_like(theta2),
                                  theta2 * th))[..., None, None]
    return _eye(3, w).expand(W.shape) + b * W + c * W2


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(w) = J_l(-w) (IMU::IntegratedRotation's rightJ)."""
    return so3_left_jacobian(-w)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian, closed form."""
    theta2 = torch.sum(w * w, dim=-1)
    small, th = _safe_theta(theta2)
    W = hat(w)
    W2 = W @ W
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        1.0 / torch.where(small, torch.ones_like(theta2), theta2)
        - (1.0 + torch.cos(th)) / (2.0 * th * torch.sin(th)))[..., None, None]
    return _eye(3, w).expand(W.shape) + 0.5 * W + coef * W2


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det,
                                torch.full_like(det, 1e-30))
    adj = torch.stack([torch.stack([A11, A12, A13], -1),
                       torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], -2)
    return adj * inv_det[..., None, None]


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve via the closed-form inverse."""
    return _mv(inv3x3(A), b)


def solve_psd6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """6x6 SPD solve by a 2x2-block Schur on closed-form 3x3 inverses:
    [[P, Q], [Q^T, S]] x = [u, v]; S' = S - Q^T P^-1 Q;
    x2 = S'^-1 (v - Q^T P^-1 u); x1 = P^-1 (u - Q x2)."""
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    S = A[..., 3:, 3:]
    u = b[..., :3]
    v = b[..., 3:]
    Pi = inv3x3(P)
    PiQ = Pi @ Q
    Sp = S - Q.transpose(-1, -2) @ PiQ
    Piu = _mv(Pi, u)
    x2 = _mv(inv3x3(Sp), v - _mv(PiQ.transpose(-1, -2), u))
    x1 = Piu - _mv(PiQ, x2)
    return torch.cat([x1, x2], dim=-1)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) by a quaternion round trip."""
    return quat_to_rot(rot_to_quat(R))


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """One Newton step of the polar decomposition, R (3 I - R^T R) / 2. For
    a product of rotations (orthonormal to rounding e) the result is
    orthonormal to e^2, in 4 small operations where `normalize_rotation`'s
    quaternion round trip takes about 150: the solvers that re-project a
    rotation inside every iteration use this one."""
    return 0.5 * (R @ (3.0 * _eye(3, R) - R.transpose(-1, -2) @ R))


def se3_exp(xi: torch.Tensor):
    """(...,6) [v, w] -> (R, t)."""
    v, w = xi[..., :3], xi[..., 3:]
    return so3_exp(w), _mv(so3_left_jacobian(w), v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> (...,6) [v, w]."""
    w = so3_log(R)
    return torch.cat([solve3x3(so3_left_jacobian(w), t), w], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """T_a * T_b."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_apply(R, t, X):
    """Transform points X (...,3)."""
    return _mv(R, X) + t


# ---------------------------------------------------------------------------
# Sim(3): (s: (...,), R: (...,3,3), t: (...,3)); tangent [v, w, sigma]. Loop
# closing and the 7-DoF essential graph use it.
# ---------------------------------------------------------------------------

def se3_matrix(R, t):
    """(R,t) -> (...,4,4) homogeneous matrix."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(*R.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def sim3_apply(s, R, t, X):
    return s[..., None] * _mv(R, X) + t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    return sa * sb, Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta


def sim3_inv(s, R, t):
    si = 1.0 / s
    Rt = R.transpose(-1, -2)
    return si, Rt, -si[..., None] * _mv(Rt, t)


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The W of the Sim(3) exponential (t = W v): W = C I + A hat(w) +
    B hat(w)^2, closed form with Taylor fallbacks in the four
    (sigma small?, theta small?) regimes."""
    theta2 = torch.sum(w * w, dim=-1)
    small_t, theta = _safe_theta(theta2)
    Om = hat(w)
    Om2 = Om @ Om
    es = torch.exp(sigma)
    one = torch.ones_like(theta)

    small_s = torch.abs(sigma) < 1e-5
    ss = torch.where(small_s, one, sigma)        # safe sigma
    th = torch.where(small_t, one, theta)        # safe theta

    # sigma ~ 0
    A_s0 = torch.where(small_t, 0.5 - theta * theta / 24.0,
                       (1.0 - torch.cos(th)) / (th * th))
    B_s0 = torch.where(small_t, 1.0 / 6.0 - theta * theta / 120.0,
                       (th - torch.sin(th)) / (th * th * th))
    # sigma != 0
    C_s = (es - 1.0) / ss
    A_s_t0 = ((ss - 1.0) * es + 1.0) / (ss * ss)
    B_s_t0 = (es * (0.5 * ss * ss - ss + 1.0) - 1.0) / (ss * ss * ss)
    a = es * torch.sin(th)
    b = es * torch.cos(th)
    c = th * th + ss * ss
    A_s_t = (a * ss + (1.0 - b) * th) / (th * c)
    B_s_t = (C_s - ((b - 1.0) * ss + a * th) / c) / (th * th)

    A = torch.where(small_s, A_s0, torch.where(small_t, A_s_t0, A_s_t))
    B = torch.where(small_s, B_s0, torch.where(small_t, B_s_t0, B_s_t))
    C = torch.where(small_s, one, C_s)
    return (C[..., None, None] * _eye(3, w).expand(Om.shape)
            + A[..., None, None] * Om + B[..., None, None] * Om2)


def sim3_exp(xi: torch.Tensor):
    """(...,7) [v, w, sigma] -> (s, R, t)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return torch.exp(sigma), so3_exp(w), _mv(_sim3_W(w, sigma), v)


def sim3_log(s, R, t) -> torch.Tensor:
    """(s, R, t) -> (...,7) [v, w, sigma]."""
    sigma = torch.log(s)
    w = so3_log(R)
    return torch.cat([solve3x3(_sim3_W(w, sigma), t), w, sigma[..., None]],
                     dim=-1)
