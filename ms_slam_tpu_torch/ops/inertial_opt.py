"""Visual-inertial state optimization.

Port of `ms_slam_tpu/ops/inertial_opt.py`:

- `pose_vel_bias_optimize`: the tracking-side motion-only optimization of
  [T_wb, v, bg, ba] with visual reprojection, the preintegration factor
  against the fixed previous state and a bias random walk (ref
  Optimizer::PoseInertialOptimizationLastFrame). On the card it is one
  launch of the hand-written kernel `csrc/pose_vel_bias.cu`; on the CPU
  its plain version `pose_vel_bias_optimize_plain`;
- `inertial_window_refine`: the inertial half of LocalInertialBA, window
  poses, velocities and a shared bias against fixed landmarks;
- `inertial_init`: the IMU initialization MAP estimate of gravity direction,
  shared biases (and optional scale) and per-keyframe velocities, seeded by
  a closed-form linear alignment (ref Optimizer::InertialOptimization);
- `vi_window_ba`: the joint visual-inertial window BA with Schur elimination
  of the landmarks (ref Optimizer::LocalInertialBA);
- `vi_full_ba`: the whole-chain visual-inertial BA, Schur complement solved
  matrix-free by block-Jacobi preconditioned CG (ref
  Optimizer::FullInertialBA);
- `marginalize` (ref Optimizer::Marginalize).

Where the reference takes `jax.jacfwd` of the stacked residual, the
Jacobians here are written out: a launch-bound path pays tens of
microseconds per operation and transform level under `torch.func`. The
visual rows depend only on their own keyframe's six pose columns
(`proj_res_jac`, shared by all three solvers); the 9-row inertial factor
has the Forster Jacobians of `imu.inertial_residual_jac`. The state of
every solver is additive in position, velocity and bias and
left-multiplicative in rotation, R = Exp(d_theta) R0 with d_theta
ACCUMULATED over the iterations, so each rotation column carries the left
Jacobian J_l(d_theta) that maps a change of d_theta to a left perturbation.
A test holds each against `torch.func.jacfwd`.

The normal equations are solved with the `_ex` forms of `torch.linalg`,
which do not check `info` on the host: no call here synchronizes.

An unrectified stereo pair adds each right keypoint as a 2-row residual
through the second lens (`rig`; upstream's
`EdgeSE3ProjectXYZ[OnlyPose]ToBody`), with its own variance, the
monocular gate and Huber weight. Every solver takes the right rows as a
second copy of its factor table (index F + f for factor f), evaluated with
the left rows in one pass (`_rows`), so its sums and Schur blocks run as
they do over the left rows; without a rig the table is the left rows'
alone.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..utils.trace import span
from . import _native, cameras, imu, lie, robust
from .lie import _mv

G0 = imu.GRAVITY
CHI2_INERTIAL = 16.92      # Huber delta^2 on the whitened 9-row factor


def _solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H x = b without the host-side check of LAPACK's / cuSOLVER's info."""
    return torch.linalg.solve_ex(H, b[..., None]).result[..., 0]


def lstsq_min_norm(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD, singular values below
    eps * max(m, n) * s_max dropped: what `jnp.linalg.lstsq` (and LAPACK's
    gelsd) computes. On CUDA `torch.linalg.lstsq` has only LAPACK's `gels`,
    a QR factorization that assumes full rank; the alignment system of
    `inertial_init` loses rank when the scale is free and the motion has no
    acceleration."""
    U, s, Vh = torch.linalg.svd(A, full_matrices=False)
    rcond = torch.finfo(A.dtype).eps * max(A.shape[-2:])
    s_inv = torch.where(s > rcond * s[..., :1], 1.0 / s, torch.zeros_like(s))
    return _mv(Vh.transpose(-1, -2), s_inv * _mv(U.transpose(-1, -2), b))


def proj_res_jac(model: int, params, bf, R_cw, t_cw, p_wb, X, uv, ur,
                 stereo, jac: bool = True, pose_jac: bool = True):
    """Reprojection residual of world points X through cameras that ride on
    a body (T_wc = T_wb T_bc), per factor, and its Jacobians.

    Returns rv (F,3) = [uv - proj, ur - proj_r (0 for mono)], Xc (F,3),
    Jpose (F,3,6) wrt [dp, dtheta] of the BODY pose (p additive, R_wb
    perturbed on the left) and Jpt (F,3,3) wrt the world point:
      Xc = R_cw (X - p) - R_bc^T t_bc,
      d Xc / d p = -R_cw, d Xc / d theta = R_cw hat(X - p), d Xc / d X = R_cw.
    """
    Xc = _mv(R_cw, X) + t_cw
    uvp = cameras.project(model, params, Xc)
    z = torch.clamp(Xc[..., 2], min=1e-6)
    urp = uvp[..., 0] - bf / z
    r3 = torch.where(stereo, ur - urp, torch.zeros_like(z))
    rv = torch.cat([uv - uvp, r3[..., None]], -1)
    if not jac:
        return rv, Xc, None, None
    Jproj = cameras.project_jac(model, params, Xc)
    zero = torch.zeros_like(z)
    dur = Jproj[..., 0, :] + torch.stack([zero, zero, bf / (z * z)], -1)
    J3 = torch.cat([Jproj, dur[..., None, :]], -2)
    J3 = J3 * torch.stack([torch.ones_like(z), torch.ones_like(z),
                           stereo.to(z.dtype)], -1)[..., None]
    Jpt = -(J3 @ R_cw)
    if not pose_jac:
        return rv, Xc, None, Jpt
    Jpose = torch.cat([-Jpt, Jpt @ lie.hat(X - p_wb)], -1)
    return rv, Xc, Jpose, Jpt


def _rows(model: int, params, bf, R_cw, t_cw, p_wb, X, uv, ur, stereo,
          jac: bool = True, pose_jac: bool = True, rig=None, xy_r=None):
    """The visual rows of a solver: `proj_res_jac`'s. With a rig the
    per-row inputs (R_cw, t_cw, p_wb, X, stereo) hold each factor twice,
    F = len(uv) apart: the first F rows are the left camera's (monocular:
    an unrectified pair has no u_right), the last F its right camera's
    (`cameras.rig_project`). The returned camera points are the right
    camera's for the right rows, and every third row is zero."""
    if rig is None:
        return proj_res_jac(model, params, bf, R_cw, t_cw, p_wb, X, uv, ur,
                            stereo, jac, pose_jac)
    F = uv.shape[0]
    Xs, proj, J2 = cameras.rig_project(
        model, params, rig, _mv(R_cw[:F], X[:F]) + t_cw[:F], jac)
    zero = torch.zeros_like(Xs[..., :1])
    rv = torch.cat([torch.cat([uv, xy_r]) - proj, zero], -1)
    if not jac:
        return rv, Xs, None, None
    Jpt = -(torch.cat([J2, torch.zeros_like(J2[..., :1, :])], -2) @ R_cw)
    if not pose_jac:
        return rv, Xs, None, Jpt
    return rv, Xs, torch.cat([-Jpt, Jpt @ lie.hat(X - p_wb)], -1), Jpt


def _right_tables(rig, right, valid, w_info, hub_d2, stereo, dt):
    """A solve's right copy of its factor table: the rig and the right
    pixels in the solve's precision, and w_info, hub_d2, stereo and valid
    each followed by the right rows' (`cameras.right_info`)."""
    w_r, has = cameras.right_info(right, valid)
    return (rig.to(dt), right[:, :2].to(dt), torch.cat([w_info, w_r.to(dt)]),
            torch.cat([hub_d2, torch.full_like(hub_d2, robust.CHI2_2DOF)]),
            torch.cat([stereo, torch.zeros_like(stereo)]),
            torch.cat([valid, has]))


def _cam_of_body(R, p, R_bc, t_bc):
    """T_cw of the camera riding on body pose (R, p): (T_wb T_bc)^-1."""
    R_cw = (R @ R_bc).transpose(-1, -2)
    return R_cw, -_mv(R_cw, _mv(R, t_bc) + p)


class PVBResult(NamedTuple):
    R_wb: torch.Tensor
    p_wb: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    inlier: torch.Tensor
    n_inliers: torch.Tensor
    inlier_r: torch.Tensor = None   # the right rows' flags (rig only)
    n_right: torch.Tensor = None    # and their count


def pose_vel_bias_optimize_plain(
        model: int, params, bf, R_bc, t_bc,
        R1, p1, v1, bg1, ba1, preint: imu.PreintState,
        R2, p2, v2, X, uv, u_right, sigma2, mask, walk_info,
        n_rounds: int = 4, n_iters: int = 6, g=None, *, rig=None,
        right=None) -> PVBResult:
    """Optimize the current body state [p, R, v, bg, ba] given the last
    (fixed) state 1, the preintegration since then and visual matches.
    R_bc/t_bc: the body-from-camera extrinsic T_bc. g: world gravity.
    rig with right (N,3) [u, v, sigma2] (u < 0: none): the right-camera
    rows."""
    dt = R2.dtype
    dev = R2.device
    params = params.to(dt)
    bf = torch.as_tensor(bf, dtype=dt, device=dev)
    if g is None:
        g = imu._default_g(R2)
    is_stereo = u_right >= 0.0
    w_info = 1.0 / torch.clamp(sigma2, min=1e-12)
    LT = imu.sqrt_information(preint).transpose(-1, -2)
    hub_d2 = torch.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF).to(dt)
    sqrt_walk = torch.sqrt(walk_info.to(dt))
    eye15 = torch.eye(15, dtype=dt, device=dev)
    J_walk = torch.cat([torch.zeros(6, 9, dtype=dt, device=dev),
                        torch.diag(sqrt_walk)], -1)

    def unpack(x):
        return (lie.orthonormalize(lie.so3_exp(x[3:6]) @ R2),
                p2 + x[:3], v2 + x[6:9], bg1 + x[9:12], ba1 + x[12:15])

    def visual(R, p, jac):
        R_cw, t_cw = _cam_of_body(R, p, R_bc, t_bc)
        return proj_res_jac(model, params, bf, R_cw, t_cw, p, X, uv, u_right,
                            is_stereo, jac)

    N = X.shape[0]
    if rig is not None:
        rig, xy_r, w_info, hub_d2, is_stereo, mask = _right_tables(
            rig, right, mask, w_info, hub_d2, is_stereo, dt)
        X2 = X.repeat(2, 1)

        def visual(R, p, jac):
            R_cw, t_cw = _cam_of_body(R, p, R_bc, t_bc)
            return _rows(model, params, bf, R_cw.expand(2 * N, 3, 3),
                         t_cw.expand(2 * N, 3), p.expand(2 * N, 3), X2, uv,
                         u_right, is_stereo, jac, rig=rig, xy_r=xy_r)

    x = torch.zeros(15, dtype=dt, device=dev)
    inlier = mask
    for _ in range(n_rounds):
        for _ in range(n_iters):
            R, p, v, bg, ba = unpack(x)
            rv, Xc, Jpose, _ = visual(R, p, True)
            chi2 = torch.sum(rv * rv, -1) * w_info
            w = robust.huber_weight(chi2, hub_d2) * w_info * inlier \
                * (Xc[..., 2] > 1e-2)
            Jl = lie.so3_left_jacobian(x[3:6])
            Jv = torch.cat([Jpose[..., :3], Jpose[..., 3:] @ Jl], -1)
            JvW = Jv * w[:, None, None]
            H = torch.zeros(15, 15, dtype=dt, device=dev)
            H[:6, :6] = torch.einsum("nij,nik->jk", JvW, Jv)
            gvec = torch.zeros(15, dtype=dt, device=dev)
            gvec[:6] = -torch.einsum("nij,ni->j", JvW, rv)
            ri, Ji = imu.inertial_residual_jac(preint, R1, v1, p1, R, v, p,
                                               bg, ba, g)
            J_in = torch.cat([
                LT @ torch.cat([Ji.p2, Ji.th2 @ Jl, Ji.v2, Ji.bg, Ji.ba],
                               -1), J_walk], 0)
            r_in = torch.cat([_mv(LT, ri), x[9:15] * sqrt_walk])
            H = H + J_in.T @ J_in + 1e-6 * eye15
            gvec = gvec - _mv(J_in.T, r_in)
            x = x + _solve(H, gvec)
        R, p, _, _, _ = unpack(x)
        rv, Xc, _, _ = visual(R, p, False)
        chi2 = torch.sum(rv * rv, -1) * w_info
        inlier = mask & (chi2 <= hub_d2) & (Xc[..., 2] > 0)
    R, p, v, bg, ba = unpack(x)
    inlier_r = n_right = None
    if rig is not None:
        inlier, inlier_r = inlier[:N], inlier[N:]
        n_right = inlier_r.sum().to(torch.int32)
    return PVBResult(R_wb=R, p_wb=p, v=v, bg=bg, ba=ba, inlier=inlier,
                     n_inliers=inlier.sum().to(torch.int32),
                     inlier_r=inlier_r, n_right=n_right)


# ---------------------------------------------------------------------------
# pose_vel_bias_optimize: the hand-written CUDA kernel and its dispatch
# ---------------------------------------------------------------------------

# kernel launches made through pose_vel_bias_optimize, and the calls that
# took the plain version on a CPU tensor, counted under a lock as
# `orb.py`'s gather counters are
pvb_kernel_launches = 0
pvb_plain_calls = 0
_count_lock = threading.Lock()


def _count(name: str):
    with _count_lock:
        globals()[name] += 1


_PREINT_SHAPES = (("dT", ()), ("dR", (3, 3)), ("dV", (3,)), ("dP", (3,)),
                  ("JRg", (3, 3)), ("JVg", (3, 3)), ("JVa", (3, 3)),
                  ("JPg", (3, 3)), ("JPa", (3, 3)), ("bias", (6,)))


def _launch_args(model: int, params, bf, R_bc, t_bc, R1, p1, v1, bg1, ba1,
                 preint: imu.PreintState, LT, R2, p2, v2, X, uv, u_right,
                 sigma2, mask, walk_info, n_rounds: int, n_iters: int, g,
                 rig=None, right=None) -> tuple:
    """The arguments of `msslam_pose_vel_bias` and the result tensors it
    fills (allocated here), after checking every input: contiguous
    float32 tensors of the plain version's shapes on R2's device, a bool
    mask. Raises ValueError otherwise. LT: the transposed
    `imu.sqrt_information(preint)`. bf is read as a Python float. With a
    rig, its lens and T_rl and the (N,3) right keypoints too (else null
    pointers). The arguments hold the inputs' addresses only: the caller keeps the
    tensors alive until the launch."""
    dev = R2.device
    if model not in (cameras.PINHOLE, cameras.KB8):
        raise ValueError(f"no camera model {model}")
    N = X.shape[0] if X.dim() == 2 else -1
    if not 0 <= N < 2 ** 31:
        raise ValueError(f"X must be (N,3), got {tuple(X.shape)}")
    floats = [("params", params, (8,)), ("R_bc", R_bc, (3, 3)),
              ("t_bc", t_bc, (3,)), ("R1", R1, (3, 3)), ("p1", p1, (3,)),
              ("v1", v1, (3,)), ("bg1", bg1, (3,)), ("ba1", ba1, (3,)),
              *[(f"preint.{k}", getattr(preint, k), shape)
                for k, shape in _PREINT_SHAPES],
              ("sqrt_information(preint)", LT, (9, 9)), ("R2", R2, (3, 3)),
              ("p2", p2, (3,)), ("v2", v2, (3,)), ("X", X, (N, 3)),
              ("uv", uv, (N, 2)), ("u_right", u_right, (N,)),
              ("sigma2", sigma2, (N,)), ("walk_info", walk_info, (6,)),
              ("g", g, (3,))]
    rig_floats = [] if rig is None else [
        ("rig.params2", rig.params2, (8,)), ("rig.T", rig.T, (3, 4)),
        ("right", right, (N, 3))]
    for name, t, shape in floats + rig_floats + [("mask", mask, (N,))]:
        dtype = torch.bool if name == "mask" else torch.float32
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(
                f"{name} must be a contiguous {shape} {dtype} tensor on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    state = torch.empty(21, dtype=torch.float32, device=dev)
    out = PVBResult(R_wb=state[:9].view(3, 3), p_wb=state[9:12],
                    v=state[12:15], bg=state[15:18], ba=state[18:21],
                    inlier=torch.empty(N, dtype=torch.bool, device=dev),
                    n_inliers=torch.empty((), dtype=torch.int32,
                                          device=dev))
    rig_args = (None,) * 5
    if rig is not None:
        out = out._replace(
            inlier_r=torch.empty(N, dtype=torch.bool, device=dev),
            n_right=torch.empty((), dtype=torch.int32, device=dev))
        rig_args = (rig.params2.data_ptr(), rig.T.data_ptr(),
                    right.data_ptr(), out.inlier_r.data_ptr(),
                    out.n_right.data_ptr())
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    args = (model, float(bf), N, int(n_rounds), int(n_iters),
            *[t.data_ptr() for _, t, _ in floats[:-2]], mask.data_ptr(),
            walk_info.data_ptr(), g.data_ptr(), state.data_ptr(),
            out.inlier.data_ptr(), out.n_inliers.data_ptr(), *rig_args,
            stream)
    return args, out


def load_kernel() -> ctypes.CDLL:
    """The kernel's library, built (nvcc, at first use in a checkout) and
    loaded. A System that will track with an IMU on the card calls it while
    it is set up, so that no tracked frame waits for the compiler."""
    lib = _native.load("pose_vel_bias")
    fn = lib.msslam_pose_vel_bias
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p] * 38
        fn.restype = ctypes.c_int
    return lib


def pose_vel_bias_optimize(
        model: int, params, bf, R_bc, t_bc,
        R1, p1, v1, bg1, ba1, preint: imu.PreintState,
        R2, p2, v2, X, uv, u_right, sigma2, mask, walk_info,
        n_rounds: int = 4, n_iters: int = 6, g=None, *, rig=None,
        right=None, timing=None) -> PVBResult:
    """`pose_vel_bias_optimize_plain` by the tensors' device: a CPU tensor
    takes the plain version; a CUDA tensor launches the kernel
    (csrc/pose_vel_bias.cu) on the current stream, or raises ValueError
    for inputs it does not take (`_launch_args`). rig / right: the
    right-camera rows, in the same launch. Given a `Timing`, the launch is
    the span `pvb_opt.kernel`."""
    if R2.device.type == "cpu":
        _count("pvb_plain_calls")
        return pose_vel_bias_optimize_plain(
            model, params, bf, R_bc, t_bc, R1, p1, v1, bg1, ba1, preint,
            R2, p2, v2, X, uv, u_right, sigma2, mask, walk_info, n_rounds,
            n_iters, g, rig=rig, right=right)
    if R2.device.type != "cuda":
        raise ValueError(f"no pose_vel_bias_optimize for device {R2.device}")
    if g is None:
        g = imu._default_g(R2)
    LT = imu.sqrt_information(preint).transpose(-1, -2).contiguous()
    args, out = _launch_args(model, params, bf, R_bc, t_bc, R1, p1, v1, bg1,
                             ba1, preint, LT, R2, p2, v2, X, uv, u_right,
                             sigma2, mask, walk_info, n_rounds, n_iters, g,
                             rig, right)
    fn = load_kernel().msslam_pose_vel_bias
    with span(timing, "pvb_opt.kernel"):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"pose_vel_bias kernel launch failed: CUDA error {rc}")
    _count("pvb_kernel_launches")
    return out


class WindowRefineResult(NamedTuple):
    R_wb: torch.Tensor    # (W,3,3)
    p_wb: torch.Tensor    # (W,3)
    vels: torch.Tensor    # (W,3)
    bg: torch.Tensor
    ba: torch.Tensor
    cost: torch.Tensor


def inertial_window_refine(
        model: int, params, bf, R_wb, p_wb, vels, kf_mask,
        preints: imu.PreintState, preint_valid, bg0, ba0, g,
        X, f_kf, f_uv, f_ur, f_sigma2, f_valid, walk_info,
        n_iters: int = 5, R_bc=None, t_bc=None) -> WindowRefineResult:
    """The inertial half of LocalInertialBA (ref Optimizer::LocalInertialBA):
    jointly refine the window keyframes' poses, velocities and a shared
    bias against fixed landmarks X (one row per factor) and the
    preintegration chain (preints stacked on a (W-1,) axis, interval
    i -> i+1). f_kf indexes the window. The oldest keyframe's pose is held
    by a soft prior (1e3 on its six tangent entries). State: 9 per keyframe
    (dp, dtheta, dv) + 6 bias; Gauss-Newton with a dense (9W+6)^2 solve,
    the visual rows' Huber weights fixed within a step (IRLS)."""
    W = R_wb.shape[0]
    dt = R_wb.dtype
    dev = R_wb.device
    D = 9 * W + 6
    params = params.to(dt)
    bf = torch.as_tensor(bf, dtype=dt, device=dev)
    R_bc = (torch.eye(3, dtype=dt, device=dev) if R_bc is None
            else R_bc.to(dt))
    t_bc = (torch.zeros(3, dtype=dt, device=dev) if t_bc is None
            else t_bc.to(dt))
    p_wb, vels = p_wb.to(dt), vels.to(dt)
    bg0, ba0, g = bg0.to(dt), ba0.to(dt), g.to(dt)
    f_kf = f_kf.long()
    is_stereo = f_ur >= 0.0
    w_info = torch.where(f_valid, 1.0 / torch.clamp(f_sigma2, min=1e-12),
                         torch.zeros_like(f_sigma2)).to(dt)
    hub_d2 = torch.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF).to(dt)
    ok = (preint_valid & kf_mask[:-1] & kf_mask[1:]).to(dt)
    LT = imu.sqrt_information(preints).transpose(-1, -2)
    sqrt_walk = torch.sqrt(walk_info.to(dt))
    # constant Jacobian rows: the bias walk and the first pose's prior
    J_prior = torch.zeros(12, D, dtype=dt, device=dev)
    J_prior[:6, 9 * W:] = torch.diag(sqrt_walk)
    J_prior[6:, :6] = 1e3 * torch.eye(6, dtype=dt, device=dev)
    cols = (9 * torch.arange(W - 1, device=dev)[:, None]
            + torch.arange(18, device=dev))[:, None, :].expand(W - 1, 9, 18)
    eyeD = torch.eye(D, dtype=dt, device=dev)

    def unpack(x):
        d = x[:9 * W].reshape(W, 9)
        R = lie.orthonormalize(lie.so3_exp(d[:, 3:6]) @ R_wb)
        return (R, p_wb + d[:, :3], vels + d[:, 6:], bg0 + x[9 * W:9 * W + 3],
                ba0 + x[9 * W + 3:])

    def visual(R, p, jac):
        R_cw, t_cw = _cam_of_body(R, p, R_bc, t_bc)
        return proj_res_jac(model, params, bf, R_cw[f_kf], t_cw[f_kf],
                            p[f_kf], X.to(dt), f_uv, f_ur, is_stereo, jac)

    def sqrt_w(rv, Xc):
        return torch.sqrt(_point_weights(rv, Xc, w_info, hub_d2))

    def residuals(x, R, p, v, bg, ba, sw, jac):
        """Stacked residual [visual, whitened chain, bias walk, prior] and,
        with jac, its Jacobian's normal equations (H, J^T r)."""
        rv, Xc, Jpose, _ = visual(R, p, jac)
        rv = rv * sw[:, None]
        r, J = imu.inertial_residual_jac(preints, R[:-1], v[:-1], p[:-1],
                                         R[1:], v[1:], p[1:], bg, ba, g)
        ri = _mv(LT, r) * ok[:, None]
        res = torch.cat([rv.reshape(-1), ri.reshape(-1),
                         x[9 * W:] * sqrt_walk, x[:6] * 1e3])
        if not jac:
            return res
        Jl = lie.so3_left_jacobian(x[:9 * W].reshape(W, 9)[:, 3:6])
        J6 = torch.cat([Jpose[..., :3], Jpose[..., 3:] @ Jl[f_kf]], -1) \
            * sw[:, None, None]
        Hv = torch.zeros(W, 6, 6, dtype=dt, device=dev).index_add_(
            0, f_kf, J6.transpose(-1, -2) @ J6)
        gv = torch.zeros(W, 6, dtype=dt, device=dev).index_add_(
            0, f_kf, _mv(J6.transpose(-1, -2), rv))
        J18 = torch.cat([J.p1, J.th1 @ Jl[:-1], J.v1,
                         J.p2, J.th2 @ Jl[1:], J.v2], -1)
        J18 = LT @ J18 * ok[:, None, None]
        Ji = torch.zeros(W - 1, 9, D, dtype=dt, device=dev)
        Ji.scatter_(2, cols, J18)
        Ji[:, :, 9 * W:] = LT @ torch.cat([J.bg, J.ba], -1) \
            * ok[:, None, None]
        Jr = torch.cat([Ji.reshape(-1, D), J_prior], 0)
        rr = torch.cat([ri.reshape(-1), x[9 * W:] * sqrt_walk, x[:6] * 1e3])
        H = Jr.T @ Jr
        Hb = H[:9 * W, :9 * W].view(W, 9, W, 9)
        k = torch.arange(W, device=dev)
        Hb[k, :6, k, :6] += Hv
        Jtr = _mv(Jr.T, rr)
        Jtr[:9 * W].view(W, 9)[:, :6] += gv
        return res, H, Jtr

    x = torch.zeros(D, dtype=dt, device=dev)
    for _ in range(n_iters):
        R, p, v, bg, ba = unpack(x)
        rv, Xc, _, _ = visual(R, p, False)
        _, H, Jtr = residuals(x, R, p, v, bg, ba, sqrt_w(rv, Xc), True)
        x = x + _solve(H + 1e-6 * eyeD, -Jtr)
    R, p, v, bg, ba = unpack(x)
    rv, Xc, _, _ = visual(R, p, False)
    r = residuals(x, R, p, v, bg, ba, sqrt_w(rv, Xc), False)
    return WindowRefineResult(R_wb=R, p_wb=p, vels=v, bg=bg, ba=ba,
                              cost=torch.sum(r * r))


class VIWindowResult(NamedTuple):
    R_wb: torch.Tensor    # (W,3,3)
    p_wb: torch.Tensor    # (W,3)
    vels: torch.Tensor    # (W,3)
    bg: torch.Tensor
    ba: torch.Tensor
    mp_pos: torch.Tensor  # (M,3) updated landmark pool
    g: torch.Tensor       # (3,) refined world gravity vector
    cost: torch.Tensor


class _Chain:
    """What `vi_window_ba` and `vi_full_ba` share: the state layout
    x = [9 per keyframe (dp, dtheta, dv), 6 shared bias, 2 gravity
    direction], the hard gauge on the first keyframe's pose, and the
    inertial chain with its priors (residual rows and their Jacobian)."""

    def __init__(self, R_wb, p_wb, vels, kf_mask, preints, preint_valid,
                 bg0, ba0, g, walk_info, R_bc, t_bc):
        self.W = W = R_wb.shape[0]
        self.dt = dt = R_wb.dtype
        self.dev = dev = R_wb.device
        self.D = 9 * W + 8
        self.R0, self.p0, self.v0 = R_wb, p_wb.to(dt), vels.to(dt)
        self.bg0, self.ba0, self.g0 = bg0.to(dt), ba0.to(dt), g.to(dt)
        self.R_bc = (torch.eye(3, dtype=dt, device=dev) if R_bc is None
                     else R_bc.to(dt))
        self.t_bc = (torch.zeros(3, dtype=dt, device=dev) if t_bc is None
                     else t_bc.to(dt))
        self.preints = preints
        self.ok = (preint_valid & kf_mask[:-1] & kf_mask[1:]).to(dt)
        self.LT = imu.sqrt_information(preints).transpose(-1, -2)
        self.sqrt_walk = torch.sqrt(walk_info.to(dt))
        # orthonormal basis of the plane perpendicular to gravity
        g_norm = self.g0 / torch.clamp(torch.linalg.norm(self.g0), min=1e-9)
        ex = torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev)
        ey = torch.tensor([0.0, 1.0, 0.0], dtype=dt, device=dev)
        ref_ax = torch.where(torch.abs(g_norm[0]) < 0.9, ex, ey)
        e1 = torch.linalg.cross(g_norm, ref_ax)
        self.e1 = e1 / torch.clamp(torch.linalg.norm(e1), min=1e-9)
        self.e2 = torch.linalg.cross(g_norm, self.e1)
        self.E12 = torch.stack([self.e1, self.e2], -1)          # (3,2)
        # the gauge keyframe's pose columns carry no Jacobian
        self.free6 = torch.ones(W, 1, 6, dtype=dt, device=dev)
        self.free6[0] = 0.0
        # constant rows of the prior Jacobian: bias walk, the weak
        # gravity-direction prior (sigma 0.05 rad a call), and a Tikhonov
        # term on the hard-masked first-pose tangent
        D = self.D
        Jp = torch.zeros(14, D, dtype=dt, device=dev)
        Jp[:6, 9 * W:9 * W + 6] = torch.diag(self.sqrt_walk)
        Jp[6:8, 9 * W + 6:] = 20.0 * torch.eye(2, dtype=dt, device=dev)
        Jp[8:, :6] = torch.eye(6, dtype=dt, device=dev)
        self.J_prior = Jp
        ar = torch.arange(W - 1, device=dev)
        cols = 9 * ar[:, None] + torch.arange(18, device=dev)
        self.col18 = cols[:, None, :].expand(W - 1, 9, 18)

    def unpack(self, x):
        """x -> R, p, v, bg, ba, R_cw, t_cw, dtheta (gauge row zeroed)."""
        W = self.W
        d = x[:9 * W].reshape(W, 9)
        d6 = d[:, :6] * self.free6[:, 0]             # hard gauge
        p = self.p0 + d6[:, :3]
        R = lie.orthonormalize(lie.so3_exp(d6[:, 3:]) @ self.R0)
        v = self.v0 + d[:, 6:]
        bg = self.bg0 + x[9 * W:9 * W + 3]
        ba = self.ba0 + x[9 * W + 3:9 * W + 6]
        R_cw, t_cw = _cam_of_body(R, p, self.R_bc, self.t_bc)
        return R, p, v, bg, ba, R_cw, t_cw, d6[:, 3:]

    def gravity_of(self, x):
        W = self.W
        rv = x[9 * W + 6] * self.e1 + x[9 * W + 7] * self.e2
        return _mv(lie.so3_exp(rv), self.g0), rv

    def inprior(self, x, R, p, v, bg, ba, dth):
        """Residual rows [whitened Huber-weighted inertial chain, bias walk,
        gravity-direction prior, gauge Tikhonov] and their (rows, D)
        Jacobian. Returns (r_in, J_in)."""
        W, D = self.W, self.D
        g_cur, rv = self.gravity_of(x)
        r, J = imu.inertial_residual_jac(
            self.preints, R[:-1], v[:-1], p[:-1], R[1:], v[1:], p[1:], bg,
            ba, g_cur)
        ri = _mv(self.LT, r) * self.ok[:, None]             # (W-1,9)
        chi2_i = torch.sum(ri * ri, -1)
        # Huber on the whitened chain (ref LocalInertialBA: delta^2 = 16.92)
        si = torch.sqrt(robust.huber_weight(chi2_i, CHI2_INERTIAL))
        Jl = lie.so3_left_jacobian(dth)                     # (W,3,3)
        free = self.free6
        J18 = torch.cat([
            torch.cat([J.p1, J.th1 @ Jl[:-1]], -1) * free[:-1], J.v1,
            torch.cat([J.p2, J.th2 @ Jl[1:]], -1) * free[1:], J.v2], -1)
        dg = -(lie.hat(g_cur) @ lie.so3_left_jacobian(rv) @ self.E12)
        scale = (self.ok * si)[:, None, None]
        J18 = self.LT @ J18 * scale
        J8 = self.LT @ torch.cat([J.bg, J.ba, J.g @ dg], -1) * scale
        Ji = torch.zeros(W - 1, 9, D, dtype=self.dt, device=self.dev)
        Ji.scatter_(2, self.col18, J18)
        Ji[:, :, 9 * W:] = J8
        r_in = torch.cat([(ri * si[:, None]).reshape(-1),
                          x[9 * W:9 * W + 6] * self.sqrt_walk,
                          x[9 * W + 6:] * 20.0, x[:6]])
        return r_in, torch.cat([Ji.reshape(-1, D), self.J_prior], 0)

    def embed_pose_blocks(self, H, Hv):
        """H[9k:9k+6, 9k:9k+6] += Hv[k] for every keyframe k."""
        W = self.W
        Hb = H[:9 * W, :9 * W].view(W, 9, W, 9)
        k = torch.arange(W, device=self.dev)
        Hb[k, :6, k, :6] += Hv
        return H

    def embed6(self, w6):
        """(W,6) pose entries -> (D,) state vector."""
        out = torch.zeros(self.D, dtype=self.dt, device=self.dev)
        out[:9 * self.W].view(self.W, 9)[:, :6] = w6
        return out

    def ext6(self, v):
        return v[:9 * self.W].reshape(self.W, 9)[:, :6]


def _point_weights(rv, Xc, w_info, hub_d2):
    chi2 = torch.sum(rv * rv, -1) * w_info
    return robust.huber_weight(chi2, hub_d2) * w_info * (Xc[..., 2] > 1e-2)


def _damp_points(Hpp):
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    return Hpp + 1e-3 * torch.diag_embed(
        torch.diagonal(Hpp, dim1=-2, dim2=-1)) + 1e-6 * eye3


def vi_window_ba(
        model: int, params, bf, R_wb, p_wb, vels, kf_mask,
        preints: imu.PreintState, preint_valid, bg0, ba0, g,
        mp_pos, f_pt, f_kf, f_uv, f_ur, f_sigma2, f_valid,
        a_Rcw, a_tcw, a_cam, a_pt, a_uv, a_ur, a_sigma2, a_valid,
        walk_info, R_bc=None, t_bc=None, n_iters: int = 5, *, rig=None,
        f_right=None, a_right=None) -> VIWindowResult:
    """Full visual-inertial local BA (ref Optimizer::LocalInertialBA):
    jointly refine the temporal window keyframes' poses and velocities, the
    shared bias, the gravity direction AND the observed landmarks, with
    fixed out-of-window observers (`a_*`, camera-frame poses) anchoring
    shared points. preints: fields stacked on a leading (W-1,) axis,
    interval i -> i+1. f_pt/a_pt index the (M,3) landmark pool, f_kf the
    window, a_cam the anchor cameras.

    Joint Gauss-Newton with Schur elimination of the landmarks. A visual
    factor touches only its own keyframe's 6 pose columns, so the coupling
    is kept as (M, W, 6, 3) instead of the reference's (M, 9W+8, 3).

    rig with f_right / a_right ((F,3) / (A,3) [u, v, sigma2], u < 0: none):
    the right-camera rows of the window's and the anchors' factors."""
    ch = _Chain(R_wb, p_wb, vels, kf_mask, preints, preint_valid, bg0, ba0,
                g, walk_info, R_bc, t_bc)
    W, D, dt, dev = ch.W, ch.D, ch.dt, ch.dev
    params = params.to(dt)
    bf = torch.as_tensor(bf, dtype=dt, device=dev)
    M = mp_pos.shape[0]
    f_pt, f_kf = f_pt.long(), f_kf.long()
    a_pt, a_cam = a_pt.long(), a_cam.long()
    is_stereo = f_ur >= 0.0
    a_is_stereo = a_ur >= 0.0
    zero = torch.zeros((), dtype=dt, device=dev)
    w_info = torch.where(f_valid, 1.0 / torch.clamp(f_sigma2, min=1e-12), zero)
    a_w_info = torch.where(a_valid, 1.0 / torch.clamp(a_sigma2, min=1e-12),
                           zero)
    hub_d2 = torch.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF).to(dt)
    a_hub_d2 = torch.where(a_is_stereo, robust.CHI2_3DOF,
                           robust.CHI2_2DOF).to(dt)
    xy_r = a_xy_r = None
    if rig is not None:
        _, xy_r, w_info, hub_d2, is_stereo, f_valid = _right_tables(
            rig, f_right, f_valid, w_info, hub_d2, is_stereo, dt)
        rig, a_xy_r, a_w_info, a_hub_d2, a_is_stereo, a_valid = \
            _right_tables(rig, a_right, a_valid, a_w_info, a_hub_d2,
                          a_is_stereo, dt)
        f_pt, f_kf = f_pt.repeat(2), f_kf.repeat(2)
        a_pt, a_cam = a_pt.repeat(2), a_cam.repeat(2)
    a_R = a_Rcw[a_cam]
    a_t = a_tcw[a_cam]
    touched = torch.zeros(M, dtype=dt, device=dev).index_add_(
        0, f_pt, f_valid.to(dt)) > 0
    eyeD = torch.eye(D, dtype=dt, device=dev)
    lin6 = f_pt * W + f_kf                    # (point, keyframe) block index

    x = torch.zeros(D, dtype=dt, device=dev)
    P_all = mp_pos.to(dt)
    for _ in range(n_iters):
        R, p, v, bg, ba, R_cw, t_cw, dth = ch.unpack(x)
        rv, Xc, Jpose, Jp = _rows(
            model, params, bf, R_cw[f_kf], t_cw[f_kf], p[f_kf], P_all[f_pt],
            f_uv, f_ur, is_stereo, rig=rig, xy_r=xy_r)
        sw = torch.sqrt(_point_weights(rv, Xc, w_info, hub_d2))
        Jl = lie.so3_left_jacobian(dth)
        J6 = torch.cat([Jpose[..., :3], Jpose[..., 3:] @ Jl[f_kf]], -1) \
            * (sw[:, None, None] * ch.free6[f_kf])
        Jp = Jp * sw[:, None, None]
        rvw = rv * sw[:, None]

        r_in, J_in = ch.inprior(x, R, p, v, bg, ba, dth)
        Hxx = J_in.T @ J_in
        Hv = torch.zeros(W, 6, 6, dtype=dt, device=dev).index_add_(
            0, f_kf, J6.transpose(-1, -2) @ J6)
        Hxx = ch.embed_pose_blocks(Hxx, Hv)
        bx = -_mv(J_in.T, r_in) - ch.embed6(
            torch.zeros(W, 6, dtype=dt, device=dev).index_add_(
                0, f_kf, _mv(J6.transpose(-1, -2), rvw)))

        # anchor factors: fixed cameras, landmarks free
        arv, aXc, _, aJp = _rows(model, params, bf, a_R, a_t, None,
                                 P_all[a_pt], a_uv, a_ur, a_is_stereo,
                                 pose_jac=False, rig=rig, xy_r=a_xy_r)
        aw = _point_weights(arv, aXc, a_w_info, a_hub_d2) * a_valid
        aJpW = aJp * aw[:, None, None]
        Hpp = torch.zeros(M, 3, 3, dtype=dt, device=dev)
        Hpp.index_add_(0, a_pt, aJpW.transpose(-1, -2) @ aJp)
        Hpp.index_add_(0, f_pt, Jp.transpose(-1, -2) @ Jp)
        bp = torch.zeros(M, 3, dtype=dt, device=dev)
        bp.index_add_(0, a_pt, -_mv(aJpW.transpose(-1, -2), arv))
        bp.index_add_(0, f_pt, -_mv(Jp.transpose(-1, -2), rvw))
        Wc = torch.zeros(M * W, 6, 3, dtype=dt, device=dev).index_add_(
            0, lin6, J6.transpose(-1, -2) @ Jp).view(M, W * 6, 3)

        # damping (Levenberg): g2o runs LM, not plain GN
        Hxx = Hxx + 1e-3 * torch.diag(torch.diag(Hxx)) + 1e-6 * eyeD
        Hpp_inv = lie.inv3x3(_damp_points(Hpp))

        # Schur reduce onto the pose/velocity/bias block
        Y = Wc @ Hpp_inv                                     # (M, 6W, 3)
        Yr = Y.transpose(0, 1).reshape(6 * W, M * 3)
        Wr = Wc.transpose(0, 1).reshape(6 * W, M * 3)
        S6 = (Yr @ Wr.T).view(W, 6, W, 6)
        S = Hxx.clone()
        S[:9 * W, :9 * W].view(W, 9, W, 9)[:, :6, :, :6] -= S6
        vred = bx - ch.embed6(_mv(Yr, bp.reshape(M * 3)).view(W, 6))
        dx = _solve(S + 1e-8 * eyeD, vred)
        dxp = _mv(Hpp_inv, bp - _mv(Wc.transpose(-1, -2),
                                    ch.ext6(dx).reshape(6 * W)))
        x = x + dx
        P_all = P_all + dxp * touched[:, None]

    R, p, v, bg, ba, _, _, _ = ch.unpack(x)
    return VIWindowResult(R_wb=R, p_wb=p, vels=v, bg=bg, ba=ba, mp_pos=P_all,
                          g=ch.gravity_of(x)[0],
                          cost=torch.zeros((), dtype=dt, device=dev))


def vi_full_ba(
        model: int, params, bf, R_wb, p_wb, vels, kf_mask,
        preints: imu.PreintState, preint_valid, bg0, ba0, g,
        mp_pos, f_pt, f_kf, f_uv, f_ur, f_sigma2, f_valid, walk_info,
        R_bc=None, t_bc=None, n_iters: int = 4,
        cg_iters: int = 64, *, rig=None,
        f_right=None) -> VIWindowResult:
    """JOINT whole-chain visual-inertial BA (ref Optimizer::FullInertialBA,
    run after a loop correction): one optimization over every temporal
    keyframe of the active map: poses, velocities, shared bias, gravity
    direction and all observed landmarks.

    Schur complement on the landmarks, the reduced (9W+8)-dim camera system
    solved MATRIX-FREE by block-Jacobi preconditioned CG: each matvec is two
    passes over the factor table, memory stays O(F + M + D^2). The visual
    pose blocks are taken at a zero local perturbation around the current
    pose, as the reference takes them. Gauge: the oldest chain keyframe's
    pose is hard-fixed (velocity and bias stay free). The chain may have
    any length; masked keyframes (`kf_mask`) and intervals
    (`preint_valid`) drop out, so a padded chain gives the same result.
    rig with f_right (F,3) [u, v, sigma2] (u < 0: none): the right-camera
    rows."""
    ch = _Chain(R_wb, p_wb, vels, kf_mask, preints, preint_valid, bg0, ba0,
                g, walk_info, R_bc, t_bc)
    W, D, dt, dev = ch.W, ch.D, ch.dt, ch.dev
    params = params.to(dt)
    bf = torch.as_tensor(bf, dtype=dt, device=dev)
    M = mp_pos.shape[0]
    f_pt, f_kf = f_pt.long(), f_kf.long()
    is_stereo = f_ur >= 0.0
    zero = torch.zeros((), dtype=dt, device=dev)
    w_info = torch.where(f_valid, 1.0 / torch.clamp(f_sigma2, min=1e-12), zero)
    hub_d2 = torch.where(is_stereo, robust.CHI2_3DOF, robust.CHI2_2DOF).to(dt)
    xy_r = None
    if rig is not None:
        rig, xy_r, w_info, hub_d2, is_stereo, f_valid = _right_tables(
            rig, f_right, f_valid, w_info, hub_d2, is_stereo, dt)
        f_pt, f_kf = f_pt.repeat(2), f_kf.repeat(2)
    free_kf = ((f_kf != 0) & f_valid).to(dt)
    touched = torch.zeros(M, dtype=dt, device=dev).index_add_(
        0, f_pt, f_valid.to(dt)) > 0
    eyeD = torch.eye(D, dtype=dt, device=dev)
    tiny = torch.tensor(1e-20, dtype=dt, device=dev)

    x = torch.zeros(D, dtype=dt, device=dev)
    P_all = mp_pos.to(dt)
    for _ in range(n_iters):
        R, p, v, bg, ba, R_cw, t_cw, dth = ch.unpack(x)
        rv, Xc, J6, Jp = _rows(
            model, params, bf, R_cw[f_kf], t_cw[f_kf], p[f_kf], P_all[f_pt],
            f_uv, f_ur, is_stereo, rig=rig, xy_r=xy_r)
        sw = torch.sqrt(_point_weights(rv, Xc, w_info, hub_d2))
        J6w = J6 * (sw * free_kf)[:, None, None]
        Jpw = Jp * sw[:, None, None]
        rvw = rv * sw[:, None]
        J6wT = J6w.transpose(-1, -2)
        JpwT = Jpw.transpose(-1, -2)

        r_in, J_in = ch.inprior(x, R, p, v, bg, ba, dth)
        Hxx = J_in.T @ J_in
        Hv = torch.zeros(W, 6, 6, dtype=dt, device=dev).index_add_(
            0, f_kf, J6wT @ J6w)
        Hxx = ch.embed_pose_blocks(Hxx, Hv)
        bx = -_mv(J_in.T, r_in) - ch.embed6(
            torch.zeros(W, 6, dtype=dt, device=dev).index_add_(
                0, f_kf, _mv(J6wT, rvw)))

        Hpp = torch.zeros(M, 3, 3, dtype=dt, device=dev).index_add_(
            0, f_pt, JpwT @ Jpw)
        bp = torch.zeros(M, 3, dtype=dt, device=dev).index_add_(
            0, f_pt, -_mv(JpwT, rvw))
        Hpp_inv = lie.inv3x3(_damp_points(Hpp))
        Hxx = Hxx + 1e-3 * torch.diag(torch.diag(Hxx)) + 1e-6 * eyeD

        def W_t_apply(vec):
            """(D,) -> (M,3): W^T v = sum_f Jpw^T (J6w v_kf)."""
            y = _mv(J6w, ch.ext6(vec)[f_kf])
            return torch.zeros(M, 3, dtype=dt, device=dev).index_add_(
                0, f_pt, _mv(JpwT, y))

        def W_apply(zp):
            """(M,3) -> (D,): W z = sum_f J6w^T (Jpw z_pf)."""
            zf = _mv(Jpw, zp[f_pt])
            return ch.embed6(torch.zeros(W, 6, dtype=dt, device=dev)
                             .index_add_(0, f_kf, _mv(J6wT, zf)))

        def S_apply(vec):
            return _mv(Hxx, vec) - W_apply(_mv(Hpp_inv, W_t_apply(vec)))

        b_red = bx - W_apply(_mv(Hpp_inv, bp))

        # block-Jacobi preconditioner from Hxx's diagonal blocks
        k = torch.arange(W, device=dev)
        blk9 = Hxx[:9 * W, :9 * W].view(W, 9, W, 9)[k, :, k, :]
        blk9_inv = torch.linalg.inv_ex(blk9).inverse
        tail_inv = torch.linalg.inv_ex(Hxx[9 * W:, 9 * W:]).inverse

        def prec(rr):
            r9 = _mv(blk9_inv, rr[:9 * W].reshape(W, 9)).reshape(-1)
            return torch.cat([r9, _mv(tail_inv, rr[9 * W:])])

        xk = torch.zeros(D, dtype=dt, device=dev)
        rk = b_red
        zk = prec(b_red)
        pk = zk
        for _ in range(cg_iters):
            Ap = S_apply(pk)
            rz = rk @ zk
            alpha = rz / torch.maximum(pk @ Ap, tiny)
            xk = xk + alpha * pk
            rk = rk - alpha * Ap
            zk = prec(rk)
            beta = (rk @ zk) / torch.maximum(rz, tiny)
            pk = zk + beta * pk
        dx = xk
        dxp = _mv(Hpp_inv, bp - W_t_apply(dx))
        x = x + dx
        P_all = P_all + dxp * touched[:, None]

    R, p, v, bg, ba, _, _, _ = ch.unpack(x)
    return VIWindowResult(R_wb=R, p_wb=p, vels=v, bg=bg, ba=ba, mp_pos=P_all,
                          g=ch.gravity_of(x)[0],
                          cost=torch.zeros((), dtype=dt, device=dev))


def marginalize(H: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Schur-marginalize the variable block [start, end] (inclusive) out of
    an information matrix (ref Optimizer::Marginalize): the block's
    information is folded into the remaining variables through the SVD
    pseudo-inverse (singular values below 1e-6 zeroed, as the reference
    does), and the marginalized rows and columns come back zeroed in
    place."""
    n = H.shape[0]
    K = torch.as_tensor(np.concatenate([np.arange(0, start),
                                        np.arange(end + 1, n)]),
                        device=H.device)
    B = torch.arange(start, end + 1, device=H.device)
    Hkk = H[K][:, K]
    Hkb = H[K][:, B]
    Hbb = H[B][:, B]
    U, s, Vh = torch.linalg.svd(Hbb, full_matrices=False)
    s_inv = torch.where(s > 1e-6, 1.0 / torch.clamp(s, min=1e-12),
                        torch.zeros_like(s))
    Hbb_pinv = (Vh.T * s_inv[None, :]) @ U.T
    res = torch.zeros_like(H)
    res[K[:, None], K[None, :]] = Hkk - Hkb @ Hbb_pinv @ Hkb.T
    return res


class InertialInitResult(NamedTuple):
    R_wg: torch.Tensor    # (3,3) gravity direction (g_world = R_wg [0,0,-G])
    bg: torch.Tensor
    ba: torch.Tensor
    scale: torch.Tensor
    vels: torch.Tensor    # (K,3) body velocities
    cost: torch.Tensor


def _linear_alignment(R_wb, p_wb, preints, with_scale: bool):
    """The closed-form seed: with rotations known, the ev/ep preintegration
    equations are LINEAR in (v_0..v_{K-1}, g_w, s): one least-squares solve
    gives velocities, gravity and (mono) scale. Returns the system too."""
    K = R_wb.shape[0]
    dt, dev = R_wb.dtype, R_wb.device
    T = preints.dT
    RdV = _mv(R_wb[:-1], preints.dV)
    RdP = _mv(R_wb[:-1], preints.dP)
    dp_vis = p_wb[1:] - p_wb[:-1]
    D_lin = 3 * K + 3 + (1 if with_scale else 0)
    A = torch.zeros(K - 1, 6, D_lin, dtype=dt, device=dev)
    b = torch.zeros(K - 1, 6, dtype=dt, device=dev)
    i = torch.arange(K - 1, device=dev)
    for r in range(3):
        # ev rows: -v_i + v_{i+1} - T g = R_i dV_i
        A[i, r, 3 * i + r] = -1.0
        A[i, r, 3 * i + 3 + r] = 1.0
        A[i, r, 3 * K + r] = -T
        b[:, r] = RdV[:, r]
        # ep rows: -T v_i - T^2 g / 2 + s dp_i = R_i dP_i (s folded into the
        # right side when it is fixed)
        A[i, 3 + r, 3 * i + r] = -T
        A[i, 3 + r, 3 * K + r] = -0.5 * T * T
        if with_scale:
            A[i, 3 + r, 3 * K + 3] = dp_vis[:, r]
            b[:, 3 + r] = RdP[:, r]
        else:
            b[:, 3 + r] = RdP[:, r] - dp_vis[:, r]
    return A.reshape(-1, D_lin), b.reshape(-1), T, RdV, RdP, dp_vis


def inertial_init(R_wb, p_wb, preints: imu.PreintState, prior_g, prior_a,
                  n_iters: int = 20,
                  with_scale: bool = False) -> InertialInitResult:
    """Gravity/bias/scale MAP from keyframe poses and chained
    preintegrations. R_wb/p_wb: (K,...) body keyframe poses (visual, up to
    scale for mono). preints: fields stacked on a leading (K-1,) axis.
    prior_g/prior_a: bias priors.

    The nonlinear MAP is seeded by the linear alignment above (minimum-norm
    least squares: with the scale free the system loses rank when the
    motion has no acceleration); biases and the whitened refinement stay
    nonlinear. With
    `with_scale` the scale is the reduced-major-axis estimate (geometric
    mean of the forward and the inverse regression slopes), pinned in the
    refinement."""
    K = R_wb.shape[0]
    dt, dev = R_wb.dtype, R_wb.device
    p_wb = p_wb.to(dt)
    prior_g = torch.as_tensor(prior_g, dtype=dt, device=dev)
    prior_a = torch.as_tensor(prior_a, dtype=dt, device=dev)
    A, b, T, RdV, RdP, dp_vis = _linear_alignment(R_wb, p_wb, preints,
                                                  with_scale)
    sol = lstsq_min_norm(A, b)
    v_lin = sol[:3 * K].reshape(K, 3)
    g_lin = sol[3 * K:3 * K + 3]
    gn = g_lin / torch.clamp(torch.linalg.norm(g_lin), min=1e-9)
    if with_scale:
        # errors in variables: the forward regression (s as slope on the
        # noisy visual deltas) is biased low, the inverse one high; their
        # geometric mean is the reduced-major-axis estimator
        g_fix = 9.81 * gn
        chain = torch.cat([torch.zeros(1, 3, dtype=dt, device=dev),
                           torch.cumsum(g_fix[None, :] * T[:, None] + RdV,
                                        0)])
        disp = chain[:-1] * T[:, None] \
            + 0.5 * g_fix[None, :] * (T * T)[:, None] + RdP
        eye3 = torch.eye(3, dtype=dt, device=dev)
        TI = T[:, None, None] * eye3                        # (K-1,3,3)
        # inverse: dp_vis = w0 T + mu disp (w0 = v0 / s, mu = 1 / s)
        A2 = torch.cat([TI, disp[..., None]], -1).reshape(-1, 4)
        sol2 = lstsq_min_norm(A2, dp_vis.reshape(-1))
        mu = sol2[3]
        s_inv = torch.where(mu > 1e-4, 1.0 / torch.clamp(mu, min=1e-4),
                            torch.abs(sol[3 * K + 3]))
        # forward: s dp_vis - v0 T = disp
        A3 = torch.cat([TI, dp_vis[..., None]], -1).reshape(-1, 4)
        s_fwd = torch.abs(lstsq_min_norm(A3, disp.reshape(-1))[3])
        s_lin = torch.clamp(torch.sqrt(torch.clamp(s_fwd * s_inv, min=1e-6)),
                            1e-2, 1e3)
        # metric velocities consistent with the chain
        v_lin = sol2[None, :3] * s_lin + chain
    else:
        s_lin = torch.ones((), dtype=dt, device=dev)
    # gravity-direction seed: R_wg0 turns [0,0,-1] onto g_lin
    e3n = torch.tensor([0.0, 0.0, -1.0], dtype=dt, device=dev)
    ax = torch.linalg.cross(e3n, gn)
    sin_a = torch.linalg.norm(ax)
    ang = torch.atan2(sin_a, torch.dot(e3n, gn))
    ax = torch.where(sin_a > 1e-9, ax / torch.clamp(sin_a, min=1e-9),
                     torch.tensor([1.0, 0.0, 0.0], dtype=dt, device=dev))
    R_wg0 = lie.so3_exp(ax * ang)
    gI = torch.tensor([0.0, 0.0, -G0], dtype=dt, device=dev)
    LT = imu.sqrt_information(preints).transpose(-1, -2)
    D = 9 + 3 * K
    i = torch.arange(K - 1, device=dev)
    col6 = (9 + 3 * i[:, None] + torch.arange(6, device=dev))[:, None, :] \
        .expand(K - 1, 9, 6)
    J_prior = torch.zeros(7 if with_scale else 6, D, dtype=dt, device=dev)
    J_prior[:3, 2:5] = torch.sqrt(prior_g) * torch.eye(3, dtype=dt,
                                                       device=dev)
    J_prior[3:6, 5:8] = torch.sqrt(prior_a) * torch.eye(3, dtype=dt,
                                                        device=dev)
    if with_scale:
        # log-scale pinned to the regression estimate
        J_prior[6, 8] = 1e4
    eyeD = torch.eye(D, dtype=dt, device=dev)
    R1T = R_wb[:-1].transpose(-1, -2)

    def x_unpack(x):
        rg = torch.cat([x[:2], torch.zeros(1, dtype=dt, device=dev)])
        s = s_lin * torch.exp(x[8]) if with_scale else s_lin
        return (R_wg0 @ lie.so3_exp(rg), x[2:5], x[5:8], s,
                v_lin + x[9:].reshape(K, 3), rg)

    def residuals(x, jac):
        R_wg, bg, ba, s, vels, rg = x_unpack(x)
        g = _mv(R_wg, gI)
        r, J = imu.inertial_residual_jac(
            preints, R_wb[:-1], vels[:-1], s * p_wb[:-1], R_wb[1:], vels[1:],
            s * p_wb[1:], bg, ba, g, jac=jac)
        res = torch.cat([_mv(LT, r).reshape(-1), J_prior @ x])
        if not jac:
            return res, None
        dg = -(R_wg @ lie.hat(gI) @ lie.so3_right_jacobian(rg))[:, :2]
        ds = torch.zeros(K - 1, 9, 1, dtype=dt, device=dev)
        if with_scale:
            ds[:, 6:, 0] = _mv(R1T, s * dp_vis)
        Ji = torch.zeros(K - 1, 9, D, dtype=dt, device=dev)
        Ji[:, :, :9] = LT @ torch.cat([J.g @ dg, J.bg, J.ba, ds], -1)
        Ji.scatter_(2, col6, LT @ torch.cat([J.v1, J.v2], -1))
        return res, torch.cat([Ji.reshape(-1, D), J_prior], 0)

    x = torch.zeros(D, dtype=dt, device=dev)
    for _ in range(n_iters):
        r, J = residuals(x, True)
        x = x + _solve(J.T @ J + 1e-6 * eyeD, -_mv(J.T, r))
    R_wg, bg, ba, s, vels, _ = x_unpack(x)
    r, _ = residuals(x, False)
    return InertialInitResult(R_wg=R_wg, bg=bg, ba=ba, scale=s, vels=vels,
                              cost=torch.sum(r * r))
