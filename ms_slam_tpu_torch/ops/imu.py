"""IMU preintegration on manifold (Forster-style).

Port of `ms_slam_tpu/ops/imu.py`: delta rotation/velocity/position, the 9x9
measurement covariance plus the 6x6 bias random walk, the incremental bias
Jacobians (JRg/JVg/JVa/JPg/JPa), bias-corrected getters, state prediction,
the 9-row preintegration residual and its information.

Every function takes leading batch axes (one preintegration per keyframe
interval) where the reference is `vmap`ped.

`integrate` is the reference's `lax.scan`. Everything that does not depend
on the running state is computed for all rows (and all intervals) at once
before the loop: exp(w dt), the right Jacobians, hat(acc), the discretized
noise, the total time and the bias-walk covariance (a masked sum). Only
the recurrences stay sequential: dR, dV, dP, the five bias Jacobians and
A C A^T. The update order is the reference's (dP and dV with the
pre-update dR). Two steps differ from the reference in rounding only:

- the running dR is re-orthonormalized by `lie.orthonormalize` (one Newton
  step of the polar decomposition, exact to rounding for a product of two
  rotations; the reference's quaternion round trip is ~150 small operations
  a row), and by the quaternion round trip once at the end; the
  bias-corrected dR of the getters and of the residual likewise;
- the accelerometer noise term B N B^T uses dR dR^T = I, which makes the
  whole noise term independent of the state.

A masked row has dt = 0 and zero measurements, which makes its step the
identity, so no per-row select is needed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import lie
from .lie import _mv

GRAVITY = 9.81  # ref include/ImuTypes.h:43 GRAVITY_VALUE


class PreintState(NamedTuple):
    """Preintegrated quantities between two frames/keyframes (leading batch
    axes allowed on every field)."""

    dT: torch.Tensor     # () total time
    dR: torch.Tensor     # (3,3)
    dV: torch.Tensor     # (3,)
    dP: torch.Tensor     # (3,)
    C: torch.Tensor      # (15,15) covariance [theta, v, p, bg, ba]
    JRg: torch.Tensor    # (3,3) d(dR)/d(bg)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bias: torch.Tensor   # (6,) [bg, ba] used during integration


def init_state(bias: torch.Tensor, dtype=torch.float32) -> PreintState:
    dev = bias.device
    z3 = torch.zeros(3, 3, dtype=dtype, device=dev)
    return PreintState(
        dT=torch.zeros((), dtype=dtype, device=dev),
        dR=torch.eye(3, dtype=dtype, device=dev),
        dV=torch.zeros(3, dtype=dtype, device=dev),
        dP=torch.zeros(3, dtype=dtype, device=dev),
        C=torch.zeros(15, 15, dtype=dtype, device=dev),
        JRg=z3, JVg=z3.clone(), JVa=z3.clone(), JPg=z3.clone(),
        JPa=z3.clone(), bias=bias.to(dtype))


def preint_from_numpy(d: dict, device=None, dtype=None) -> PreintState:
    """A PreintState from a dict of arrays keyed by field name (what
    `preint_to_numpy` returns, or `reference_state._asdict()`)."""
    out = [torch.as_tensor(np.array(d[k]), device=device)
           for k in PreintState._fields]
    return PreintState(*[t if dtype is None else t.to(dtype) for t in out])


def preint_to_numpy(st: PreintState) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in st._asdict().items()}


def integrate(bias: torch.Tensor, meas: torch.Tensor, valid: torch.Tensor,
              noise_gyro, noise_acc, walk_gyro, walk_acc,
              n_rows: Optional[int] = None) -> PreintState:
    """Integrate a padded measurement batch.

    meas: (..., M, 7) rows [dt, ax, ay, az, gx, gy, gz]; valid: (..., M).
    bias: (6,) or (..., 6). noise_*: continuous-time densities (discretized
    per sample: sigma^2 / dt). n_rows: when the caller knows that every row
    from this index on is masked, the loop stops there."""
    dt_ = meas.dtype
    dev = meas.device
    bias = bias.to(dt_)
    batch = meas.shape[:-2]
    Mr = meas.shape[-2]
    meas = torch.where(valid[..., None], meas, torch.zeros_like(meas))
    bias_b = bias.expand(*batch, 6)
    dt = meas[..., 0]                                    # 0 on masked rows
    acc = meas[..., 1:4] - bias_b[..., None, 3:]
    gyr = meas[..., 4:7] - bias_b[..., None, :3]
    hdt2 = 0.5 * dt * dt
    safe_dt = torch.clamp(dt, min=1e-6)
    # (Python floats or 0-d tensors: no host-to-device copy either way)
    ng = noise_gyro ** 2 / safe_dt
    na = noise_acc ** 2 / safe_dt
    wg = walk_gyro ** 2 * safe_dt
    wa = walk_acc ** 2 * safe_dt

    # state-independent parts, all rows at once
    ah = lie.hat(acc)                                    # (..., M, 3, 3)
    w_dt = gyr * dt[..., None]
    dRi = lie.so3_exp(w_dt)
    dRiT = dRi.transpose(-1, -2)
    rJdt = lie.so3_right_jacobian(w_dt) * dt[..., None, None]
    eye3 = torch.eye(3, dtype=dt_, device=dev).expand(*batch, Mr, 3, 3)
    z3 = torch.zeros_like(eye3)
    # B N B^T with dR dR^T = I: gyro noise in the theta block, accelerometer
    # noise in the v/p blocks
    Qtt = ng[..., None, None] * (rJdt @ rJdt.transpose(-1, -2))
    Qvv = (na * dt * dt)[..., None, None] * eye3
    Qvp = (na * dt * hdt2)[..., None, None] * eye3
    Qpp = (na * hdt2 * hdt2)[..., None, None] * eye3
    Q = torch.cat([torch.cat([Qtt, z3, z3], -1),
                   torch.cat([z3, Qvv, Qvp], -1),
                   torch.cat([z3, Qvp, Qpp], -1)], -2)   # (..., M, 9, 9)
    A_top = torch.cat([dRiT, z3, z3], -1)                # rows 0:3 of A
    A_vp = torch.cat([torch.cat([eye3, z3], -1),
                      torch.cat([eye3 * dt[..., None, None], eye3], -1)],
                     -2)                                 # A[3:9, 3:9]
    vf = valid.to(dt_)
    dT = torch.sum(dt, dim=-1)
    Cb_diag = torch.cat([
        torch.sum(wg * vf, -1)[..., None].expand(*batch, 3),
        torch.sum(wa * vf, -1)[..., None].expand(*batch, 3)], -1)

    dR = torch.eye(3, dtype=dt_, device=dev).expand(*batch, 3, 3)
    dV = torch.zeros(*batch, 3, dtype=dt_, device=dev)
    dP = torch.zeros_like(dV)
    JRg = torch.zeros(*batch, 3, 3, dtype=dt_, device=dev)
    JVg, JVa, JPg, JPa = JRg, JRg, JRg, JRg
    C9 = torch.zeros(*batch, 9, 9, dtype=dt_, device=dev)

    steps = Mr if n_rows is None else min(int(n_rows), Mr)
    for i in range(steps):
        dti = dt[..., i, None]
        dti_m = dti[..., None]
        hi = hdt2[..., i, None]
        hi_m = hi[..., None]
        # 1) position and velocity with the pre-update dR
        acc_w = _mv(dR, acc[..., i, :])
        dP = dP + dV * dti + acc_w * hi
        dV = dV + acc_w * dti
        dRah = dR @ ah[..., i, :, :]
        A = torch.cat([A_top[..., i, :, :],
                       torch.cat([torch.cat([-dRah * dti_m, -dRah * hi_m],
                                            -2), A_vp[..., i, :, :]], -1)],
                      -2)
        # bias Jacobians of P and V (pre-update dR and JRg)
        dRahJ = dRah @ JRg
        JPa = JPa + JVa * dti_m - dR * hi_m
        JPg = JPg + JVg * dti_m - dRahJ * hi_m
        JVa = JVa - dR * dti_m
        JVg = JVg - dRahJ * dti_m
        # 2) rotation increment
        dR = lie.orthonormalize(dR @ dRi[..., i, :, :])
        JRg = dRiT[..., i, :, :] @ JRg - rJdt[..., i, :, :]
        # covariance propagation
        C9 = A @ C9 @ A.transpose(-1, -2) + Q[..., i, :, :]

    C = torch.zeros(*batch, 15, 15, dtype=dt_, device=dev)
    C[..., :9, :9] = C9
    C[..., 9:, 9:] = torch.diag_embed(Cb_diag)
    return PreintState(dT=dT, dR=lie.normalize_rotation(dR), dV=dV, dP=dP,
                       C=C, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                       bias=bias_b)


# ---------------------------------------------------------------------------
# Bias-corrected getters (ref GetDeltaRotation/Velocity/Position with an
# updated bias, include/ImuTypes.h:190-205)
# ---------------------------------------------------------------------------

def delta_rotation(st: PreintState, bg_new: torch.Tensor) -> torch.Tensor:
    db = bg_new - st.bias[..., :3]
    return lie.orthonormalize(st.dR @ lie.so3_exp(_mv(st.JRg, db)))


def delta_velocity(st: PreintState, bg_new, ba_new) -> torch.Tensor:
    return st.dV + _mv(st.JVg, bg_new - st.bias[..., :3]) \
        + _mv(st.JVa, ba_new - st.bias[..., 3:])


def delta_position(st: PreintState, bg_new, ba_new) -> torch.Tensor:
    return st.dP + _mv(st.JPg, bg_new - st.bias[..., :3]) \
        + _mv(st.JPa, ba_new - st.bias[..., 3:])


def _default_g(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=like.dtype,
                        device=like.device)


def predict_state(st: PreintState, R_wb, v_w, p_w, bg, ba, g=None):
    """Propagate the body state across the preintegration interval (ref
    Tracking::PredictStateIMU, src/Tracking.cc:1727)."""
    if g is None:
        g = _default_g(R_wb)
    dT = st.dT[..., None]
    R2 = R_wb @ delta_rotation(st, bg)
    v2 = v_w + g * dT + _mv(R_wb, delta_velocity(st, bg, ba))
    p2 = p_w + v_w * dT + 0.5 * g * dT * dT \
        + _mv(R_wb, delta_position(st, bg, ba))
    return R2, v2, p2


# ---------------------------------------------------------------------------
# Inertial residual (EdgeInertial, ref src/G2oTypes.cc)
# ---------------------------------------------------------------------------

def inertial_residual(st: PreintState, R1, v1, p1, R2, v2, p2, bg, ba,
                      g=None) -> torch.Tensor:
    """9-dim preintegration factor residual [er, ev, ep] between body
    states 1 and 2 (world frame, R = R_wb)."""
    return inertial_residual_jac(st, R1, v1, p1, R2, v2, p2, bg, ba, g,
                                 jac=False)[0]


class InertialJac(NamedTuple):
    """Jacobians of the 9-row residual, each (..., 9, 3). Rotations are
    perturbed on the left, R <- Exp(delta) R; the rest additively."""

    th1: torch.Tensor
    v1: torch.Tensor
    p1: torch.Tensor
    th2: torch.Tensor
    v2: torch.Tensor
    p2: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    g: torch.Tensor


def inertial_residual_jac(st: PreintState, R1, v1, p1, R2, v2, p2, bg, ba,
                          g=None, jac: bool = True):
    """The residual and its written-out (Forster) Jacobians.

    With E = dR(bg)^T R1^T R2 and er = Log(E):
      d er / d th2 =  Jr^-1(er) R2^T,     d er / d th1 = -Jr^-1(er) R2^T,
      d er / d bg  = -Jr^-1(-er) Jr(JRg db) JRg,
      ev = R1^T a - dV(bg, ba),  a = v2 - v1 - g dT,
      ep = R1^T b - dP(bg, ba),  b = p2 - p1 - v1 dT - g dT^2 / 2,
      d ev / d th1 = R1^T hat(a),  d ep / d th1 = R1^T hat(b).
    """
    if g is None:
        g = _default_g(R1)
    dT = st.dT[..., None]
    db = bg - st.bias[..., :3]
    c = _mv(st.JRg, db)
    dR = lie.orthonormalize(st.dR @ lie.so3_exp(c))
    dV = delta_velocity(st, bg, ba)
    dP = delta_position(st, bg, ba)
    R1T = R1.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1T @ R2)
    a = v2 - v1 - g * dT
    b = p2 - p1 - v1 * dT - 0.5 * g * dT * dT
    ev = _mv(R1T, a) - dV
    ep = _mv(R1T, b) - dP
    r = torch.cat([er, ev, ep], -1)
    if not jac:
        return r, None
    z = torch.zeros_like(R1T)
    dT_m = dT[..., None]
    Jr_inv_R2T = lie.so3_right_jacobian_inv(er) @ R2.transpose(-1, -2)
    J_bg_r = -(lie.so3_right_jacobian_inv(-er)
               @ lie.so3_right_jacobian(c) @ st.JRg)
    J = InertialJac(
        th1=torch.cat([-Jr_inv_R2T, R1T @ lie.hat(a), R1T @ lie.hat(b)], -2),
        v1=torch.cat([z, -R1T, -R1T * dT_m], -2),
        p1=torch.cat([z, z, -R1T], -2),
        th2=torch.cat([Jr_inv_R2T, z, z], -2),
        v2=torch.cat([z, R1T, z], -2),
        p2=torch.cat([z, z, R1T], -2),
        bg=torch.cat([J_bg_r, -st.JVg.expand_as(z), -st.JPg.expand_as(z)],
                     -2),
        ba=torch.cat([z, -st.JVa.expand_as(z), -st.JPa.expand_as(z)], -2),
        g=torch.cat([z, -R1T * dT_m, -0.5 * R1T * dT_m * dT_m], -2))
    return r, J


def information(st: PreintState) -> torch.Tensor:
    """9x9 information of the preintegration factor: the inverse of the
    propagated covariance, symmetrized, with a regularizer RELATIVE to the
    covariance's scale (tiny-noise covariances are ~1e-8: an absolute
    epsilon is invisible and the float32 inverse can go indefinite)."""
    C = st.C[..., :9, :9]
    C = 0.5 * (C + C.transpose(-1, -2))
    tr = torch.diagonal(C, dim1=-2, dim2=-1).sum(-1)
    eps = 1e-4 * torch.clamp(tr / 9.0, min=1e-12)
    C = C + eps[..., None, None] * torch.eye(9, dtype=C.dtype,
                                             device=C.device)
    info = torch.linalg.inv_ex(C).inverse        # no host check of `info`
    return 0.5 * (info + info.transpose(-1, -2))


def sqrt_information(st: PreintState) -> torch.Tensor:
    """Cholesky factor L (info = L L^T) with relative jitter; L^T whitens
    the residual."""
    info = information(st)
    tr = torch.diagonal(info, dim1=-2, dim2=-1).sum(-1)
    jit = 1e-6 * torch.clamp(tr / 9.0, min=1e-12)
    return torch.linalg.cholesky_ex(
        info + jit[..., None, None] * torch.eye(9, dtype=info.dtype,
                                                device=info.device)).L
