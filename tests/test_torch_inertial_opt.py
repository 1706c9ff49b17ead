"""Parity of the port's visual-inertial solvers
(`ms_slam_tpu_torch/ops/inertial_opt.py`) with the JAX reference.

Inputs come from a numpy seed (tests/test_imu.py's `simulate`, the
scenarios of tests/test_inertial_opt.py and tests/test_inertial_window.py)
and are cast explicitly to one dtype for both sides. The reference takes
`jax.jacfwd` of its stacked residuals; the port's Jacobians are written
out, so float64 cases separate algebra from rounding.

Tolerances:
- `pose_vel_bias_optimize` (24 Gauss-Newton steps of a 15x15 solve): float64
  1e-8 on every output, inlier masks equal (its float32 run is held through
  `track_full_imu` on a real frame, test_torch_inertial_system.py);
- `inertial_init` (a minimum-norm least-squares seed, then 20 steps):
  float64 1e-7; float32 gravity direction 2e-4 rad, biases 2e-4 (gyro) and
  2e-2 (accelerometer, weakly observed), velocities 5e-3, scale 1e-3;
- `vi_window_ba`, `vi_full_ba`: in test_torch_inertial_ba.py;
- `marginalize`: 1e-10 in float64;
- the written-out Jacobians against `torch.func.jacfwd`: 1e-9 in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import cameras as jcam
from ms_slam_tpu.ops import imu as jimu
from ms_slam_tpu.ops import inertial_opt as jio
from ms_slam_tpu.ops import lie as jlie
from ms_slam_tpu_torch.ops import imu, inertial_opt, lie

from test_imu import G, simulate

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

PIN = np.array([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0])
BF = 40.0
NOISE = (1e-3, 1e-2, 1e-6, 1e-5)
DT = {"float32": np.float32, "float64": np.float64}


def _j(a, npdt):
    a = np.asarray(a)
    return jnp.asarray(a.astype(npdt) if a.dtype.kind == "f" else a)


def _t(a, npdt):
    a = np.asarray(a)
    return torch.tensor(a.astype(npdt) if a.dtype.kind == "f" else a)


def _project(Xc):
    return np.stack([PIN[0] * Xc[:, 0] / Xc[:, 2] + PIN[2],
                     PIN[1] * Xc[:, 1] / Xc[:, 2] + PIN[3]], -1)


def _preints(segs, npdt, bias=None):
    """Stacked preintegrations of (n, rows, 7) segments, both sides."""
    bias = np.zeros(6) if bias is None else bias
    n, rows, _ = segs.shape
    js = jax.vmap(lambda m: jimu.integrate(
        _j(bias, npdt), m, jnp.ones(rows, bool),
        *[jnp.asarray(v, npdt) for v in NOISE]))(_j(segs, npdt))
    ts = imu.integrate(_t(bias, npdt), _t(segs, npdt),
                       torch.ones(n, rows, dtype=torch.bool), *NOISE)
    return js, ts


def _rot_err(Ra, Rb):
    d = np.asarray(Ra) @ np.swapaxes(np.asarray(Rb), -1, -2)
    c = (np.trace(d, axis1=-2, axis2=-1) - 1) / 2
    return float(np.max(np.arccos(np.clip(c, -1, 1))))


def _ang(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.arccos(np.clip(a @ b / np.linalg.norm(a)
                                   / np.linalg.norm(b), -1, 1)))


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["float64"])
def test_pose_vel_bias_optimize(rng, prec):
    """tests/test_inertial_opt.py:35's scenario with a camera that is not
    the body (T_bc a 5-degree turn and 8 cm off), outliers in the matches
    and a biased IMU."""
    npdt = DT[prec]
    bias_true = np.array([0.004, -0.006, 0.003, 0.03, -0.02, 0.01])
    meas, Rs, vs, ps = simulate(rng, n=100, dt=0.005, bg=bias_true[:3],
                                ba=bias_true[3:])
    js, ts = _preints(meas[None], npdt)
    js = jax.tree.map(lambda a: a[0], js)
    ts = imu.PreintState(*[a[0] for a in ts])
    R_bc = np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.06, 0.04])))
    t_bc = np.array([0.05, -0.03, 0.06])
    N = 200
    X = rng.uniform(-4, 4, (N, 3))
    X[:, 2] += 10.0
    R2, v2, p2 = Rs[-1], vs[-1], ps[-1]
    R_wc = R2 @ R_bc
    p_wc = R2 @ t_bc + p2
    Xc = (X - p_wc) @ R_wc
    ok = Xc[:, 2] > 1.0
    uv = _project(Xc) + rng.normal(0, 0.3, (N, 2))
    uv[:15] += rng.normal(0, 25.0, (15, 2))            # outliers
    ur = uv[:, 0] - BF / np.maximum(Xc[:, 2], 1e-3)
    ur[::7] = -1.0                                     # some mono points
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.03, 0.01])))
    args = [R_bc, t_bc, Rs[0], ps[0], vs[0], np.zeros(3), np.zeros(3)]
    guess = [dR @ R2, p2 + [0.05, -0.04, 0.06], v2 + [0.1, 0.05, -0.1]]
    obs = [X, uv, ur, np.ones(N), ok]
    ref = jio.pose_vel_bias_optimize(
        jcam.PINHOLE, _j(PIN, npdt), _j(BF, npdt),
        *[_j(a, npdt) for a in args], js, *[_j(a, npdt) for a in guess],
        *[_j(a, npdt) for a in obs], walk_info=_j(np.full(6, 1e6), npdt),
        g=_j(G, npdt))
    out = inertial_opt.pose_vel_bias_optimize(
        0, _t(PIN, npdt), BF, *[_t(a, npdt) for a in args], ts,
        *[_t(a, npdt) for a in guess], *[_t(a, npdt) for a in obs],
        walk_info=_t(np.full(6, 1e6), npdt), g=_t(G, npdt))
    f32 = prec == "float32"
    assert out.R_wb.numpy().dtype == npdt
    assert _rot_err(out.R_wb.numpy(), ref.R_wb) < (2e-5 if f32 else 1e-8)
    for name, tol in (("p_wb", 2e-4), ("v", 2e-3), ("bg", 2e-4), ("ba", 2e-4)):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=tol if f32 else 1e-8, err_msg=name)
    differ = int((out.inlier.numpy() != np.asarray(ref.inlier)).sum())
    assert differ <= (2 if f32 else 0)
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= (2 if f32 else 0)
    # and it solved the problem: the true pose, most matches kept
    assert _rot_err(out.R_wb.numpy(), R2) < 2e-3
    assert np.linalg.norm(out.p_wb.numpy() - p2) < 0.02
    assert int(out.n_inliers) > 0.85 * ok.sum()


def _init_scenario(rng, K=8, seg=40, scale=1.0, bg=(0.004, -0.006, 0.003)):
    meas, Rs, vs, ps = simulate(rng, n=K * seg, dt=0.005, bg=np.array(bg))
    kf_R = np.stack([Rs[i * seg] for i in range(K)])
    kf_p = np.stack([ps[i * seg] for i in range(K)]) / scale
    return meas[:(K - 1) * seg].reshape(K - 1, seg, 7), kf_R, kf_p, vs


@pytest.mark.parametrize("prec,with_scale", [("float32", False),
                                             ("float64", False),
                                             ("float64", True)])
def test_inertial_init(rng, prec, with_scale):
    """tests/test_inertial_opt.py:216's scenario; with_scale on a map
    shrunk by 1.6."""
    npdt = DT[prec]
    segs, kf_R, kf_p, vs = _init_scenario(rng, scale=1.6 if with_scale
                                          else 1.0)
    js, ts = _preints(segs, npdt)
    ref = jio.inertial_init(_j(kf_R, npdt), _j(kf_p, npdt), js,
                            prior_g=_j(1e2, npdt), prior_a=_j(1e5, npdt),
                            with_scale=with_scale)
    out = inertial_opt.inertial_init(_t(kf_R, npdt), _t(kf_p, npdt), ts,
                                     1e2, 1e5, with_scale=with_scale)
    f32 = prec == "float32"
    gI = np.array([0, 0, -9.81])
    g_ref, g_out = np.asarray(ref.R_wg) @ gI, out.R_wg.numpy() @ gI
    assert _ang(g_ref, g_out) < (2e-4 if f32 else 1e-7)
    for name, tol in (("bg", 2e-4), ("ba", 2e-2), ("vels", 5e-3),
                      ("scale", 1e-3)):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=tol if f32 else 1e-7, err_msg=name)
    if not f32:
        np.testing.assert_allclose(float(out.cost), float(ref.cost),
                                   rtol=1e-6)
    assert _ang(g_out, G) < 0.02
    if with_scale:
        assert abs(float(out.scale) - 1.6) < 0.1


def test_lstsq_on_rank_deficient_chain():
    """Constant velocity (zero acceleration) with the scale free: a map
    scaled by s with velocities scaled alike explains the same motion, so
    the alignment system has a null vector (v_i = v0, g = 0, s = 1) and
    loses rank. `jnp.linalg.lstsq` returns the minimum-norm solution, and
    so does the port's SVD solve. A QR solve that assumes full rank, which
    is all `torch.linalg.lstsq` offers on CUDA (LAPACK's `gels`), does not:
    its triangular factor is singular. With the scale fixed the same chain
    has full rank, and the whole `inertial_init` agrees with the reference
    on it."""
    K, seg, dt = 8, 40, 0.005   # test_inertial_init's shapes: one program
    v0 = np.array([0.3, -0.1, 0.2])
    row = np.array([dt, 0.0, 0.0, 9.81, 0.0, 0.0, 0.0])   # at rest in g
    segs = np.tile(row, (K - 1, seg, 1))
    T = seg * dt
    kf_R = np.tile(np.eye(3), (K, 1, 1))
    kf_p = np.arange(K)[:, None] * v0[None] * T
    js, ts = _preints(segs, np.float64)
    A, b, *_ = inertial_opt._linear_alignment(
        _t(kf_R, np.float64), _t(kf_p, np.float64), ts, True)
    assert int(torch.linalg.matrix_rank(A)) == A.shape[1] - 1
    ref = np.asarray(jnp.linalg.lstsq(jnp.asarray(A.numpy()),
                                      jnp.asarray(b.numpy()))[0])
    np.testing.assert_allclose(inertial_opt.lstsq_min_norm(A, b).numpy(),
                               ref, atol=1e-9)
    Q, R = torch.linalg.qr(A)
    assert float(R.diagonal().abs().min()) < 1e-12 * float(R.abs().max())
    by_qr = torch.linalg.solve_triangular(R, (Q.T @ b)[:, None],
                                          upper=True)[:, 0]
    assert not np.allclose(by_qr.numpy(), ref, atol=1e-3)
    A_fix, *_ = inertial_opt._linear_alignment(
        _t(kf_R, np.float64), _t(kf_p, np.float64), ts, False)
    assert int(torch.linalg.matrix_rank(A_fix)) == A_fix.shape[1]
    r = jio.inertial_init(_j(kf_R, np.float64), _j(kf_p, np.float64), js,
                          prior_g=jnp.asarray(1e2), prior_a=jnp.asarray(1e5))
    o = inertial_opt.inertial_init(_t(kf_R, np.float64),
                                   _t(kf_p, np.float64), ts, 1e2, 1e5)
    np.testing.assert_allclose(o.R_wg.numpy(), np.asarray(r.R_wg), atol=1e-6)
    np.testing.assert_allclose(o.vels.numpy(), np.asarray(r.vels), atol=1e-6)
    assert _ang(o.R_wg.numpy() @ [0, 0, -9.81], [0, 0, -9.81]) < 1e-6


def test_marginalize(rng):
    """tests/test_inertial_opt.py:232's two matrices."""
    n, s, e = 12, 4, 7
    J = rng.normal(size=(30, n))
    H = J.T @ J + 0.5 * np.eye(n)
    H2 = H.copy()
    H2[s:e + 1] = 0
    H2[:, s:e + 1] = 0
    for Hm in (H, H2):
        np.testing.assert_allclose(
            inertial_opt.marginalize(torch.tensor(Hm), s, e).numpy(),
            np.asarray(jio.marginalize(jnp.asarray(Hm), s, e)), atol=1e-10)
    K = np.r_[0:s, e + 1:n]
    out = inertial_opt.marginalize(torch.tensor(H), s, e).numpy()
    np.testing.assert_allclose(out[np.ix_(K, K)],
                               np.linalg.inv(np.linalg.inv(H)[np.ix_(K, K)]),
                               rtol=1e-8)
    assert np.all(out[s:e + 1] == 0) and np.all(out[:, s:e + 1] == 0)


def test_visual_jacobian_against_jacfwd(rng):
    """`proj_res_jac`'s pose and point blocks against `torch.func.jacfwd`
    of the per-factor residual as the reference writes it (`f_res6`,
    inertial_opt.py:588), stereo and mono factors, a camera off the body."""
    dt = torch.float64
    R_bc = lie.so3_exp(torch.tensor([0.05, -0.06, 0.04], dtype=dt))
    t_bc = torch.tensor([0.05, -0.03, 0.06], dtype=dt)
    F = 12
    Rk = lie.so3_exp(torch.tensor(rng.normal(0, 0.2, (F, 3))))
    pk = torch.tensor(rng.normal(0, 0.5, (F, 3)))
    X = torch.tensor(rng.uniform(-3, 3, (F, 3)) + [0, 0, 9.0])
    uv = torch.tensor(rng.uniform(100, 400, (F, 2)))
    ur = uv[:, 0] - 3.0
    stereo = torch.arange(F) % 3 != 0
    params = torch.tensor(PIN)
    bf = torch.tensor(BF, dtype=dt)

    def f_res6(d9, Rk, pk, X, uv, ur, stereo):
        p = pk + d9[:3]
        R = lie.so3_exp(d9[None, 3:6])[0] @ Rk
        Xc = (R @ R_bc).T @ (X + d9[6:] - (R @ t_bc + p))
        z = torch.clamp(Xc[2], min=1e-6)
        u = PIN[0] * Xc[0] / z + PIN[2]
        v = PIN[1] * Xc[1] / z + PIN[3]
        r3 = torch.where(stereo, ur - (u - BF / z), torch.zeros_like(z))
        return torch.stack([uv[0] - u, uv[1] - v, r3])

    J_ref = torch.func.vmap(torch.func.jacfwd(f_res6), in_dims=(None, 0, 0, 0,
                                                               0, 0, 0))(
        torch.zeros(9, dtype=dt), Rk, pk, X, uv, ur, stereo)
    R_cw, t_cw = inertial_opt._cam_of_body(Rk, pk, R_bc, t_bc)
    rv, _, Jpose, Jpt = inertial_opt.proj_res_jac(0, params, bf, R_cw, t_cw,
                                                  pk, X, uv, ur, stereo)
    np.testing.assert_allclose(torch.cat([Jpose, Jpt], -1).numpy(),
                               J_ref.numpy(), atol=1e-9)
    assert torch.all(Jpose[~stereo, 2] == 0)
