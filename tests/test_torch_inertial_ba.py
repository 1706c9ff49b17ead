"""Parity of the port's two visual-inertial bundle adjustments
(`vi_window_ba`, `vi_full_ba` of `ms_slam_tpu_torch/ops/inertial_opt.py`)
with the JAX reference; the other solvers of that module are held in
test_torch_inertial_opt.py (two files, so that `--dist loadfile` gives each
a worker).

Inputs come from a numpy seed (tests/test_imu.py's `simulate`, the
scenarios of tests/test_inertial_opt.py and tests/test_inertial_window.py)
and are cast explicitly to one dtype for both sides. The reference takes
`jax.jacfwd` of its stacked residuals; the port's Jacobians are written
out, so float64 cases separate algebra from rounding.

Tolerances:
- `vi_window_ba` (5 Schur steps) and `vi_full_ba` (4 steps of 64 CG
  iterations): float64 1e-8 and 1e-7 on every output, and the outcome
  (window poses and points pulled back to the truth; chain position RMSE and
  gravity angle as close to the truth as the reference's within 10%). Their
  float32 runs are held on a real map in test_torch_inertial_system.py (the
  sums are `index_add_`s, added in index order on the CPU);
- a chain padded with masked keyframes against the exact chain (float32, one
  step): 1e-4;
- the dense Jacobian of the inertial chain with its priors against
  `torch.func.jacfwd`: 1e-7 in float64.
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
from ms_slam_tpu_torch.ops import imu, inertial_opt

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


def _window_scenario(rng, W=5, seg=40, n_pts=150, n_anchor=2):
    """tests/test_inertial_window.py:145's scenario, plus anchor cameras
    that see the same points and a camera that is not the body."""
    n_kf = W + n_anchor
    meas, Rs, vs, ps = simulate(rng, n=(n_kf - 1) * seg, dt=0.005)
    kf_R = np.stack([Rs[i * seg] for i in range(n_kf)])
    kf_p = np.stack([ps[i * seg] for i in range(n_kf)])
    kf_v = np.stack([vs[i * seg] for i in range(n_kf)])
    R_bc = np.asarray(jlie.so3_exp(jnp.asarray([0.03, -0.02, 0.04])))
    t_bc = np.array([0.04, -0.02, 0.03])
    X = rng.uniform(-4, 4, (n_pts, 3))
    X[:, 2] += 10.0
    uv = np.zeros((n_kf, n_pts, 2))
    ur = np.zeros((n_kf, n_pts))
    ok = np.zeros((n_kf, n_pts), bool)
    Rcw = np.zeros((n_kf, 3, 3))
    tcw = np.zeros((n_kf, 3))
    for k in range(n_kf):
        R_wc = kf_R[k] @ R_bc
        p_wc = kf_R[k] @ t_bc + kf_p[k]
        Rcw[k], tcw[k] = R_wc.T, -R_wc.T @ p_wc
        Xc = (X - p_wc) @ R_wc
        uv[k] = _project(Xc) + rng.normal(0, 0.05, (n_pts, 2))
        ur[k] = uv[k, :, 0] - BF / np.maximum(Xc[:, 2], 0.1)
        ok[k] = Xc[:, 2] > 1
    ur[:, ::9] = -1.0
    a, w = slice(0, n_anchor), slice(n_anchor, n_kf)   # anchors come first
    Rp, pp, vp = kf_R[w].copy(), kf_p[w].copy(), kf_v[w].copy()
    for k in range(1, W):
        Rp[k] = np.asarray(jlie.so3_exp(jnp.asarray(
            rng.normal(0, 0.01, 3)))) @ Rp[k]
        pp[k] += rng.normal(0, 0.05, 3)
        vp[k] += rng.normal(0, 0.1, 3)
    Xp = X + rng.normal(0, 0.05, X.shape)
    pt = np.tile(np.arange(n_pts, dtype=np.int32), (n_kf, 1))
    cam = np.repeat(np.arange(n_kf, dtype=np.int32)[:, None], n_pts, 1)
    segs = meas.reshape(n_kf - 1, seg, 7)[n_anchor:]
    return dict(
        truth=(kf_R[w], kf_p[w], kf_v[w], X), segs=segs, R_bc=R_bc, t_bc=t_bc,
        state=[Rp, pp, vp, np.ones(W, bool)],
        window=[Xp, pt[w].reshape(-1), (cam[w] - n_anchor).reshape(-1),
                uv[w].reshape(-1, 2), ur[w].reshape(-1),
                np.ones(W * n_pts), ok[w].reshape(-1)],
        anchors=[Rcw[a], tcw[a], cam[a].reshape(-1), pt[a].reshape(-1),
                 uv[a].reshape(-1, 2), ur[a].reshape(-1),
                 np.ones(n_anchor * n_pts), ok[a].reshape(-1)])


def _both_ba(fn_ref, fn_port, s, npdt, anchors, valid=None, with_ref=True,
             **kw):
    js, ts = _preints(s["segs"], npdt)
    W = len(s["state"][0])
    valid = np.ones(W - 1, bool) if valid is None else valid
    head = [np.zeros(3), np.zeros(3), G]
    extra = s["anchors"] if anchors else []
    ref = fn_ref(jcam.PINHOLE, _j(PIN, npdt), _j(BF, npdt),
                 *[_j(a, npdt) for a in s["state"]], js, _j(valid, npdt),
                 *[_j(a, npdt) for a in head + s["window"] + extra],
                 walk_info=_j(np.full(6, 1e6), npdt),
                 R_bc=_j(s["R_bc"], npdt), t_bc=_j(s["t_bc"], npdt),
                 **kw) if with_ref else None
    out = fn_port(0, _t(PIN, npdt), BF,
                  *[_t(a, npdt) for a in s["state"]], ts, _t(valid, npdt),
                  *[_t(a, npdt) for a in head + s["window"] + extra],
                  walk_info=_t(np.full(6, 1e6), npdt),
                  R_bc=_t(s["R_bc"], npdt), t_bc=_t(s["t_bc"], npdt), **kw)
    return ref, out


def _check_ba(ref, out, tols):
    rot, pos, vel, grav = tols
    assert _rot_err(out.R_wb.numpy(), ref.R_wb) < rot
    for name, tol in (("p_wb", pos), ("mp_pos", pos), ("vels", vel),
                      ("bg", pos), ("ba", vel), ("g", grav)):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("prec", ["float64"])
def test_vi_window_ba(rng, prec):
    s = _window_scenario(rng)
    ref, out = _both_ba(jio.vi_window_ba, inertial_opt.vi_window_ba, s,
                        DT[prec], anchors=True)
    _check_ba(ref, out, (5e-5, 5e-4, 2e-3, 2e-2) if prec == "float32"
              else (1e-8,) * 4)
    R_t, p_t, v_t, X_t = s["truth"]
    assert _rot_err(out.R_wb.numpy(), R_t) < np.deg2rad(0.2)
    assert np.abs(out.p_wb.numpy() - p_t).max() < 0.05
    err0 = np.linalg.norm(s["window"][0] - X_t, axis=1).mean()
    err1 = np.linalg.norm(out.mp_pos.numpy() - X_t, axis=1).mean()
    assert err1 < 0.5 * err0


def _chain_scenario(rng, W=8):
    s = _window_scenario(rng, W=W, seg=30, n_pts=120, n_anchor=0)
    # loop-correction-style drift that grows along the chain
    R_t, p_t, v_t, _ = s["truth"]
    drift = np.linspace(0.0, 1.0, W) ** 1.5
    s["state"][0] = np.stack([np.asarray(jlie.so3_exp(jnp.asarray(
        d * np.array([0.02, -0.03, 0.03])))) @ R_t[i]
        for i, d in enumerate(drift)])
    s["state"][1] = p_t + drift[:, None] * np.array([0.15, -0.1, 0.2])
    s["state"][2] = v_t + drift[:, None] * np.array([0.05, 0.04, -0.05])
    return s


@pytest.mark.parametrize("prec", ["float64"])
def test_vi_full_ba(rng, prec):
    s = _chain_scenario(rng)
    ref, out = _both_ba(jio.vi_full_ba, inertial_opt.vi_full_ba, s, DT[prec],
                        anchors=False)
    _check_ba(ref, out, (2e-4, 2e-3, 5e-3, 5e-2) if prec == "float32"
              else (1e-7,) * 4)
    _, p_t, _, _ = s["truth"]

    def rmse(p):
        return float(np.sqrt(np.mean(np.sum((np.asarray(p) - p_t) ** 2, 1))))

    assert rmse(out.p_wb.numpy()) < 0.75 * rmse(s["state"][1])
    assert rmse(out.p_wb.numpy()) < 1.1 * rmse(ref.p_wb) + 1e-6
    assert _ang(out.g.numpy(), G) < 1.1 * _ang(ref.g, G) + 1e-4


def test_vi_full_ba_padded_chain_equals_exact(rng):
    """The reference buckets the chain to a power of two (masked pad
    keyframes) so that XLA reuses one program; the port takes the exact
    length. A chain of 6 padded to 8 gives the exact chain's result."""
    s = _chain_scenario(rng, W=8)
    npdt = np.float32
    exact = {k: v for k, v in s.items()}
    n, npts = 6, 120
    exact["segs"] = s["segs"][:n - 1]
    exact["state"] = [a[:n] for a in s["state"]]
    exact["window"] = [s["window"][0]] + [a[:n * npts]
                                          for a in s["window"][1:]]
    _, out_e = _both_ba(jio.vi_full_ba, inertial_opt.vi_full_ba, exact, npdt,
                        anchors=False, with_ref=False, n_iters=1)
    padded = {k: v for k, v in s.items()}
    padded["state"] = list(s["state"])
    padded["state"][3] = np.arange(8) < n
    padded["window"] = list(s["window"])
    padded["window"][6] = s["window"][6] & (s["window"][2] < n)
    valid = np.arange(7) < n - 1
    _, out_p = _both_ba(jio.vi_full_ba, inertial_opt.vi_full_ba, padded,
                        npdt, anchors=False, valid=valid, with_ref=False,
                        n_iters=1)
    for name in ("R_wb", "p_wb", "vels"):
        np.testing.assert_allclose(getattr(out_p, name).numpy()[:n],
                                   getattr(out_e, name).numpy(), atol=1e-4)
        np.testing.assert_allclose(getattr(out_p, name).numpy()[n:],
                                   padded["state"][{"R_wb": 0, "p_wb": 1,
                                                    "vels": 2}[name]][n:],
                                   atol=1e-6)
    np.testing.assert_allclose(out_p.mp_pos.numpy(), out_e.mp_pos.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out_p.g.numpy(), out_e.g.numpy(), atol=1e-3)


def test_chain_jacobian_against_jacfwd(rng):
    """The dense Jacobian of the inertial chain with its priors (what
    `vi_window_ba` and `vi_full_ba` share) against `torch.func.jacfwd` at a
    state away from zero, where the accumulated rotation tangents carry
    their left Jacobians. Residuals are small, so the Huber weights are 1
    and constant."""
    s = _window_scenario(rng, W=4, n_anchor=0)
    _, ts = _preints(s["segs"], np.float64)
    R_t, p_t, v_t, _ = s["truth"]
    ch = inertial_opt._Chain(
        _t(R_t, np.float64), _t(p_t, np.float64), _t(v_t, np.float64),
        torch.ones(4, dtype=torch.bool), ts, torch.ones(3, dtype=torch.bool),
        torch.zeros(3, dtype=torch.float64),
        torch.zeros(3, dtype=torch.float64), _t(G, np.float64),
        torch.full((6,), 1e6, dtype=torch.float64),
        _t(s["R_bc"], np.float64), _t(s["t_bc"], np.float64))
    x = torch.tensor(rng.normal(0, 2e-4, ch.D))
    x[3:6] = 0.3                       # behind the gauge: must not matter

    def res(x):
        R, p, v, bg, ba, _, _, dth = ch.unpack(x)
        return ch.inprior(x, R, p, v, bg, ba, dth)[0]

    r, J = ch.inprior(x, *[a for i, a in enumerate(ch.unpack(x))
                           if i not in (5, 6)])
    assert float(torch.sum(r[:27].view(3, 9) ** 2, -1).max()) \
        < inertial_opt.CHI2_INERTIAL
    J_ref = torch.func.jacfwd(res)(x)
    # the gauge's own Tikhonov rows are the only ones that see x[:6]
    np.testing.assert_allclose(J.numpy(), J_ref.numpy(), atol=1e-7)
