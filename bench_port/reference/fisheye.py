"""The plain stereo-fisheye frontend: two unrectified Kannala-Brandt8 (KB8)
cameras, in plain PyTorch float32.

A frozen copy of the port's `pipeline/frontend.py::process_stereo_fisheye`
as it stood when the benchmark took KB8 rigs, with what it calls
(`ops/matching.py`: `mutual_match` and `rotation_consistency`;
`ops/cameras.py`: KB8 projection, its Jacobian and unprojection;
`ops/triangulate.py`: `triangulate_dlt`; `ops/lie.py`: `inv3x3`), and the
plain ORB of `frontend.py`. It imports nothing of the port. Per slot of the
left image: mutual Hamming matching inside the lapping columns with the 0.9
ratio and the rotation histogram, DLT of the two bearings, two Gauss-Newton
steps over both reprojections, the z > 0.05 and 5.991 sigma^2 gates; depth
is the left camera's z, and `u_right` is -1 (a monocular row).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import frontend

TH_LOW = 50
NN_RATIO = 0.9
BIG = 1_000_000
HISTO_LENGTH = 30
MIN_Z = 0.05
CHI2_2DOF = 5.991


def _poly(theta, k0, k1, k2, k3):
    t2 = theta * theta
    f = theta * (1.0 + t2 * (k0 + t2 * (k1 + t2 * (k2 + t2 * k3))))
    df = 1.0 + t2 * (3 * k0 + t2 * (5 * k1 + t2 * (7 * k2 + 9 * t2 * k3)))
    return f, df


def kb8_project(p: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r = torch.sqrt(torch.clamp(x * x + y * y, min=0.0))
    theta_d, _ = _poly(torch.atan2(r, z), *p[4:8])
    inv_r = 1.0 / torch.clamp(r, min=1e-8)
    scale = torch.where(r > 1e-8, theta_d * inv_r, torch.ones_like(r))
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)


def kb8_unproject(p: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> z = 1 bearings: ten Newton steps on theta from theta_d
    clipped to +-pi/2."""
    fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, -math.pi / 2, math.pi / 2)
    theta = theta_d_c
    for _ in range(10):
        f, df = _poly(theta, *p[4:8])
        theta = theta - (f - theta_d_c) / torch.where(
            torch.abs(df) > 1e-8, df, torch.ones_like(df))
    scale = torch.where(theta_d > 1e-8,
                        torch.tan(theta) / torch.clamp(theta_d, min=1e-8),
                        torch.ones_like(theta_d))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(p: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(X), (..., 2, 3); r floored at 1e-6."""
    fx, fy = p[0], p[1]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r2 = torch.clamp(x * x + y * y, min=1e-12)
    r = torch.sqrt(r2)
    R2 = r2 + z * z
    f, fp = _poly(torch.atan2(r, z), *p[4:8])
    dth_dx = x * z / (R2 * r)
    dth_dy = y * z / (R2 * r)
    dth_dz = -r / R2
    g = f / r
    dg_dx = (fp * dth_dx * r - f * (x / r)) / r2
    dg_dy = (fp * dth_dy * r - f * (y / r)) / r2
    dg_dz = fp * dth_dz / r
    row0 = torch.stack([fx * (g + x * dg_dx), fx * x * dg_dy,
                        fx * x * dg_dz], dim=-1)
    row1 = torch.stack([fy * y * dg_dx, fy * (g + y * dg_dy),
                        fy * y * dg_dz], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 inverse by the adjugate over the determinant."""
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


def triangulate_dlt(x1, x2, P1, P2) -> torch.Tensor:
    """Points from two bearings (..., 3) and two [R|t] (..., 3, 4): the
    DLT with the homogeneous weight fixed to 1, by 3x3 normal equations."""
    def two_rows(x, P):
        r0 = x[..., 0:1] * P[..., 2, :] - x[..., 2:3] * P[..., 0, :]
        r1 = x[..., 1:2] * P[..., 2, :] - x[..., 2:3] * P[..., 1, :]
        return r0, r1

    a0, a1 = two_rows(x1, P1)
    a2, a3 = two_rows(x2, P2)
    A4 = torch.stack([a0, a1, a2, a3], dim=-2)
    A = A4[..., :3]
    b = -A4[..., 3]
    AtA = A.transpose(-1, -2) @ A
    Atb = (A.transpose(-1, -2) @ b[..., None])[..., 0]
    AtA = AtA + 1e-12 * torch.eye(3, dtype=A.dtype, device=A.device)
    return (inv3x3(AtA) @ Atb[..., None])[..., 0]


def rotation_consistency(idx_b, angle_a, angle_b) -> torch.Tensor:
    """Matches whose angle difference falls in the three fullest of 30
    bins (the second and third dropped under a tenth of the first); the
    rest reset to -1."""
    valid = idx_b >= 0
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_a - angle_b[idx_b.clamp(min=0).long()], two_pi)
    b = torch.floor(rot * (HISTO_LENGTH / two_pi)).to(torch.int32) \
        % HISTO_LENGTH
    counts = torch.bincount(b[valid].long(), minlength=HISTO_LENGTH)
    top_v, top_i = torch.sort(counts, descending=True, stable=True)
    top_v, top_i = top_v[:3], top_i[:3]
    keep = top_v >= torch.clamp((0.1 * top_v[0]).to(top_v.dtype), min=1)
    bin_ok = torch.zeros(HISTO_LENGTH, dtype=torch.bool, device=b.device)
    bin_ok[top_i[keep]] = True
    return torch.where(valid & bin_ok[b.long()], idx_b, -1)


def mutual_match(desc_a, valid_a, desc_b, valid_b, angle_a, angle_b):
    """a -> b index, -1 none: best under TH_LOW, under 0.9 of the second,
    each the other's best, then the rotation histogram."""
    d = frontend._hamming(desc_a, desc_b)
    ok = valid_a[:, None] & valid_b[None, :]
    d = torch.where(ok, d, BIG)
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), best] = BIG
    second_d = d2.min(dim=1).values
    good = (best_d <= TH_LOW) & (best_d <= NN_RATIO * second_d)
    best_a_of_b = torch.argmin(d, dim=0)
    good &= best_a_of_b[best] == torch.arange(desc_a.shape[0],
                                              device=d.device)
    idx_b = torch.where(good, best, -1).to(torch.int32)
    return rotation_consistency(idx_b, angle_a, angle_b)


def _params(p, device) -> torch.Tensor:
    a = np.zeros(8, np.float32)
    a[:len(p)] = p
    return torch.from_numpy(a).to(device)


def match_fisheye(fl: dict, fr: dict, camera: dict, orb: frontend.Orb):
    """(u_right, depth) of the left slots, -1 where unmatched or gated."""
    dev = fl["xy"].device
    w = camera["width"]
    x0l, x1l, x0r, x1r = (camera["lapping"] if len(camera["lapping"]) == 4
                          else (0, w, 0, w))
    lap_l = (fl["xy"][:, 0] >= x0l) & (fl["xy"][:, 0] <= x1l)
    lap_r = (fr["xy"][:, 0] >= x0r) & (fr["xy"][:, 0] <= x1r)
    idx_b = mutual_match(fl["desc"], fl["valid"] & lap_l, fr["desc"],
                         fr["valid"] & lap_r, fl["angle"], fr["angle"])
    has = idx_b >= 0
    ib = idx_b.clamp(min=0).long()

    T = torch.tensor(camera["T_rl"], dtype=torch.float32,
                     device=dev).reshape(3, 4)
    R_rl, t_rl = T[:, :3], T[:, 3]
    p1 = _params(camera["params"], dev)
    p2 = _params(camera["params2"] or camera["params"], dev)
    b_l = kb8_unproject(p1, fl["xy"])
    b_r = kb8_unproject(p2, fr["xy"])[ib]
    N = b_l.shape[0]
    P1 = torch.cat([torch.eye(3, device=dev),
                    torch.zeros((3, 1), device=dev)], 1).expand(N, 3, 4)
    X = triangulate_dlt(b_l, b_r, P1, T.expand(N, 3, 4))
    scale2 = torch.tensor([s * s for s in orb.level_scales()],
                          dtype=torch.float32, device=dev)
    s2_l = scale2[fl["octave"].long()]
    s2_r = scale2[fr["octave"].long()][ib]

    xy_r = fr["xy"][ib]
    wl = (1.0 / torch.clamp(s2_l, min=1e-9))[:, None, None]
    wr = (1.0 / torch.clamp(s2_r, min=1e-9))[:, None, None]
    eye = torch.eye(3, device=dev)

    def gn_step(X):
        r1 = kb8_project(p1, X) - fl["xy"]
        J1 = kb8_project_jac(p1, X)
        Xr_ = X @ R_rl.T + t_rl
        r2 = kb8_project(p2, Xr_) - xy_r
        J2 = kb8_project_jac(p2, Xr_) @ R_rl
        Hm = ((J1 * wl).transpose(1, 2) @ J1
              + (J2 * wr).transpose(1, 2) @ J2 + 1e-6 * eye)
        g = (torch.einsum("nij,ni->nj", J1 * wl, r1)
             + torch.einsum("nij,ni->nj", J2 * wr, r2))
        return X - torch.einsum("nij,nj->ni", inv3x3(Hm), g)

    X = gn_step(gn_step(X))
    z_l = X[:, 2]
    Xr = X @ R_rl.T + t_rl
    z_r = Xr[:, 2]
    e_l = torch.sum((kb8_project(p1, X) - fl["xy"]) ** 2, -1)
    e_r = torch.sum((kb8_project(p2, Xr) - xy_r) ** 2, -1)
    good = (has & (z_l > MIN_Z) & (z_r > MIN_Z)
            & (e_l < CHI2_2DOF * s2_l) & (e_r < CHI2_2DOF * s2_r))
    depth = torch.where(good, z_l, torch.full_like(z_l, -1.0))
    return torch.full((N,), -1.0, device=dev), depth


def stereo_fisheye_frontend(img_l: np.ndarray, img_r: np.ndarray,
                            orb: frontend.Orb, camera: dict, device) -> dict:
    """One unrectified KB8 uint8 pair -> numpy arrays of the left image's
    slots, as `frontend.stereo_frontend` gives them."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            imgs = torch.from_numpy(np.stack([img_l, img_r])).to(device)
            feats, _ = frontend.extract(imgs.to(torch.float32), orb)
            fl = {k: v[0] for k, v in feats.items()}
            fr = {k: v[1] for k, v in feats.items()}
            u_right, depth = match_fisheye(fl, fr, camera, orb)
            out = {k: v.cpu().numpy() for k, v in fl.items()}
            out["u_right"] = u_right.cpu().numpy()
            out["depth"] = depth.cpu().numpy()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return out
