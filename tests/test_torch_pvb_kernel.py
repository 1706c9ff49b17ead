"""The inertial tracking refinement's CUDA kernel (`csrc/pose_vel_bias.cu`)
against its plain version, `inertial_opt.pose_vel_bias_optimize_plain`, on
the card, and the wrapper's dispatch.

The kernel has no CPU mode, so the tests marked `cuda` skip on a machine
without a card. The file needs neither jax nor this directory's
conftest.py; on a GPU machine that has only PyTorch it runs as

    python -m pytest --noconftest -q -m cuda tests/test_torch_pvb_kernel.py

The scenario is test_torch_inertial_opt.py::test_pose_vel_bias_optimize's
(a camera that is not the body, outliers, every 7th match monocular, a
biased IMU) at the corridor's 1,280 matches, built here with numpy alone.
Tolerances, float32 on both sides: rotation 2e-5 rad, position 2e-4,
velocity 2e-3, biases 2e-4, inlier masks that differ in at most 2 slots
(those of test_torch_inertial_opt.py's float32 cases). The kernel sums the
visual rows in another order and its LU solve pivots in its own code, so
the two agree to rounding, not bit for bit.
"""
import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import _native, imu, inertial_opt

ENTRY = inertial_opt.KERNEL.name     # its launches in _native.calls

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

G = np.array([0.0, 0.0, -imu.GRAVITY])
PIN = np.array([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0])
# configs/TUM-VI-Fisheye.yaml's Camera1: fx, fy, cx, cy, k1-k4
KB8 = np.array([190.97847715128717, 190.9733070521226, 254.93170605935475,
                256.8974428996504, 0.0034823894022493434,
                0.0007150348452162257, -0.0020532361418706202,
                0.00020293673591811182])
BF = 40.0
NOISE = (1e-3, 1e-2, 1e-6, 1e-5)
# the densities scaled by 0.03: the preintegration's covariance diagonal
# from 4.5e-10 to 4.9e-8, its information up to 2.4e9 (imu.information
# warns that such a float32 inverse can go indefinite)
TINY_NOISE = tuple(0.03 * n for n in NOISE)


def _so3_exp(w):
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(th) / th * W
            + (1 - np.cos(th)) / th ** 2 * W @ W)


def _simulate(n=100, dt=0.005, bg=np.zeros(3), ba=np.zeros(3)):
    """tests/test_imu.py's simulate: a moving body's true states and its
    IMU rows (with the given biases)."""
    R, v, p = np.eye(3), np.array([0.3, -0.1, 0.2]), np.zeros(3)
    meas, Rs, vs, ps = [], [R], [v], [p]
    for k in range(n):
        t = k * dt
        omega = np.array([0.4 * np.sin(t), 0.3, -0.2 * np.cos(t)])
        a_w = np.array([0.5 * np.cos(t), 0.2, 0.4 * np.sin(2 * t)])
        meas.append([dt, *(R.T @ (a_w - G) + ba), *(omega + bg)])
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        R = R @ _so3_exp(omega * dt)
        Rs.append(R)
        vs.append(v)
        ps.append(p)
    return np.asarray(meas), Rs, vs, ps


def _project(model, P, Xc):
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    if model == 0:
        return np.stack([P[0] * x / z + P[2], P[1] * y / z + P[3]], -1)
    r = np.sqrt(x * x + y * y)
    th = np.arctan2(r, z)
    t2 = th * th
    f = th * (1 + t2 * (P[4] + t2 * (P[5] + t2 * (P[6] + t2 * P[7]))))
    s = f / np.maximum(r, 1e-8)
    return np.stack([P[0] * x * s + P[2], P[1] * y * s + P[3]], -1)


def scenario(device, N=1280, model=0, all_mono=False, masked=False,
             seed=19, noise=NOISE):
    """(positional arguments, keyword arguments) of
    pose_vel_bias_optimize, float32 on `device`, and the true (R, p)."""
    rng = np.random.default_rng(seed)
    bias_true = np.array([0.004, -0.006, 0.003, 0.03, -0.02, 0.01])
    meas, Rs, vs, ps = _simulate(bg=bias_true[:3], ba=bias_true[3:])

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)
    preint = imu.integrate(torch.zeros(6, device=device), t(meas),
                           torch.ones(len(meas), dtype=torch.bool,
                                      device=device), *noise)
    R_bc = _so3_exp(np.array([0.05, -0.06, 0.04]))
    t_bc = np.array([0.05, -0.03, 0.06])
    X = rng.uniform(-4, 4, (N, 3))
    X[:, 2] += 10.0
    R2, v2, p2 = Rs[-1], vs[-1], ps[-1]
    Xc = (X - (R2 @ t_bc + p2)) @ (R2 @ R_bc)
    ok = Xc[:, 2] > 1.0
    P = PIN if model == 0 else KB8
    uv = _project(model, P, Xc) + rng.normal(0, 0.3, (N, 2))
    n_out = int(0.075 * N)                       # outliers
    uv[:n_out] += rng.normal(0, 25.0, (n_out, 2))
    ur = uv[:, 0] - BF / np.maximum(Xc[:, 2], 1e-3)
    ur[::7] = -1.0                               # monocular matches
    if all_mono:                                 # the fisheye frontend's
        ur[:] = -1.0
    if masked:
        ok[:] = False
    guess = [_so3_exp(np.array([0.02, -0.03, 0.01])) @ R2,
             p2 + [0.05, -0.04, 0.06], v2 + [0.1, 0.05, -0.1]]
    args = (model, t(P), BF, t(R_bc), t(t_bc), t(Rs[0]), t(ps[0]),
            t(vs[0]), t(np.zeros(3)), t(np.zeros(3)), preint,
            *[t(a) for a in guess], t(X), t(uv), t(ur), t(np.ones(N)),
            torch.tensor(ok, device=device))
    return args, dict(walk_info=t(np.full(6, 1e6)), g=t(G)), (R2, p2)


def _rot_err(Ra, Rb):
    """The angle of Ra Rb^T from its skew part, in float64 (the arccos of
    its trace cannot resolve 2e-5 rad from float32 matrices)."""
    d = Ra.double().cpu().numpy() @ Rb.double().cpu().numpy().T
    s = 0.5 * np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0],
                        d[1, 0] - d[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(s), 1.0)))


def _assert_close(out, ref):
    assert _rot_err(out.R_wb, ref.R_wb) < 2e-5
    for name, tol in (("p_wb", 2e-4), ("v", 2e-3), ("bg", 2e-4),
                      ("ba", 2e-4)):
        np.testing.assert_allclose(getattr(out, name).cpu().numpy(),
                                   getattr(ref, name).cpu().numpy(),
                                   atol=tol, err_msg=name)
    assert int((out.inlier != ref.inlier).sum()) <= 2
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= 2
    assert out.n_inliers.dtype == torch.int32 and out.n_inliers.dim() == 0


CASES = {
    "corridor": dict(),
    "one_step": dict(),          # n_rounds = n_iters = 1: H and g of a step
    "kb8": dict(model=1, all_mono=True),
    "all_masked": dict(masked=True),
    "one_match": dict(N=1),
    "ragged": dict(N=301),       # a multiple of no block or warp size
    "tiny_noise": dict(noise=TINY_NOISE),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_pvb_kernel_against_plain_on_card(name):
    dev = _card()
    args, kw, (R_true, p_true) = scenario(dev, **CASES[name])
    if name == "one_step":
        kw.update(n_rounds=1, n_iters=1)
    before = _native.calls[ENTRY]
    out = inertial_opt.pose_vel_bias_optimize(*args, **kw)
    torch.cuda.synchronize()
    assert _native.calls[ENTRY] == before + 1
    ref = inertial_opt.pose_vel_bias_optimize_plain(*args, **kw)
    for t in (out.R_wb, out.p_wb, out.v, out.bg, out.ba):
        assert torch.isfinite(t).all()
    _assert_close(out, ref)
    if name == "corridor":          # and it solved the problem
        assert _rot_err(out.R_wb, torch.tensor(R_true)) < 2e-3
        assert np.linalg.norm(out.p_wb.cpu().numpy() - p_true) < 0.02
        assert int(out.n_inliers) > 0.85 * int(args[-1].sum())
    if name == "all_masked":
        assert int(out.n_inliers) == 0


@pytest.mark.cuda
def test_pvb_kernel_refuses_float64_on_card():
    dev = _card()
    args, kw, _ = scenario(dev, N=64)
    args = list(args)
    args[14] = args[14].double()                     # X
    before = _native.calls[ENTRY]
    with pytest.raises(ValueError, match="X must be"):
        inertial_opt.pose_vel_bias_optimize(*args, **kw)
    assert _native.calls[ENTRY] == before


def test_pvb_wrapper_takes_plain_version_on_cpu():
    args, kw, _ = scenario(torch.device("cpu"), N=200)
    before = (_native.calls["pose_vel_bias_optimize"], _native.calls[ENTRY])
    out = inertial_opt.pose_vel_bias_optimize(*args, **kw)
    assert (_native.calls["pose_vel_bias_optimize"],
            _native.calls[ENTRY]) == (before[0] + 1, before[1])
    ref = inertial_opt.pose_vel_bias_optimize_plain(*args, **kw)
    for a, b in zip(out, ref):      # inlier_r / n_right: None, no rig
        assert (a is None and b is None) or torch.equal(a, b)


def _refused(args, name):
    """Edits one argument of the wrapper (by its position) so that the
    kernel cannot take it."""
    args = list(args)
    if name == "float64":
        args[14] = args[14].double()                 # X
    elif name == "strided":
        args[15] = args[15].t().contiguous().t()     # uv, column-major
    elif name == "mask_dtype":
        args[18] = args[18].to(torch.uint8)
    elif name == "short_params":
        args[1] = args[1][:4]
    elif name == "model":
        args[0] = 2
    return args


def _checked(args, kw):
    """The wrapper's call (`_kernel_call`) through the entry point's checks,
    on R2's device, without a launch: (C arguments, result)."""
    LT = imu.sqrt_information(args[10]).transpose(-1, -2).contiguous()
    call, out = inertial_opt._kernel_call(*args[:11], LT, *args[11:],
                                          kw["walk_info"], 4, 6, kw["g"])
    return inertial_opt.KERNEL.args(args[11].device, **call), out


@pytest.mark.parametrize("name", ["float64", "strided", "mask_dtype",
                                  "short_params", "model"])
def test_pvb_launch_args_refuse_what_the_kernel_cannot_take(name):
    """The checks in front of the launch, run on CPU tensors (they look at
    device, dtype, shape and layout only)."""
    args, kw, _ = scenario(torch.device("cpu"), N=50)
    with pytest.raises(ValueError):
        _checked(_refused(args, name), kw)
    # the inputs as the scenario made them pass
    call, out = _checked(args, kw)
    # 5 scalars, 32 pointers, the rig's 5 (null here) and the stream
    assert len(call) == 5 + 38 and out.inlier.shape == (50,)
    assert call[-6:-1] == (None,) * 5 and out.n_right is None
