"""The right-camera rows of an unrectified stereo-fisheye pair against the
plain two-camera model of `bench_port/reference/rig.py` (float64, automatic
differentiation), and the rectified solves as they were.

The rig is configs/TUM-VI-Fisheye.yaml's: two KB8 lenses and the inverse
of its `Stereo.T_c1_c2`. Tolerances and their reasons:
- residuals 1e-9 px and Jacobians 1e-7 (px per metre or per radian, at
  entries up to ~400) against the reference in float64: the same formulas
  by two derivations (written out against automatic differentiation), so
  only rounding separates them; against central differences of the port's
  own residual (step 1e-6): 2e-4 relative, the differences' truncation;
- `pose_optimize` with right rows against the plain Levenberg-Marquardt on
  0.4 px noise with outliers: both stop at the stationary point of the
  same robust cost with the same inlier sets, so in float64 they agree to
  1e-7 rad and 1e-7 m (where each stops iterating); in float32 to 2e-5 rad
  and 5e-5 m (float32 normal equations over 300 rows), inlier sets within
  2 rows;
- the rectified solves (pinhole pose optimization with stereo rows, both
  BAs, the inertial tracking refinement and the three inertial BAs, in
  float64 on seeded inputs) against the values the solvers gave before the
  right rows existed, to 1e-12 relative (the CPU's rounding), with every
  right-row function made to raise: no right row takes part.
"""
import os
import sys

import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import ba, cameras, imu, inertial_opt, pose_opt

from test_torch_pvb_kernel import _simulate, _so3_exp, scenario

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from bench_port.reference import rig as ref  # noqa: E402

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

KB8 = 1
P1 = np.array([190.97847715128717, 190.9733070521226, 254.93170605935475,
               256.8974428996504, 0.0034823894022493434,
               0.0007150348452162257, -0.0020532361418706202,
               0.00020293673591811182])
P2 = np.array([190.44236969414825, 190.4344384721956, 252.59949716835982,
               254.91723064636983, 0.0034003170790442797,
               0.001766278153469831, -0.00266312569781606,
               0.0003299517423931039])
T_C1_C2 = np.array([[0.999999, -0.000528, 0.001413, 0.101063],
                    [0.000527, 0.999999, 0.000506, -0.001946],
                    [-0.001414, -0.000505, 0.999999, 0.000931],
                    [0.0, 0.0, 0.0, 1.0]])
T_RL = np.linalg.inv(T_C1_C2)[:3]
S2 = 1.2 ** (2 * np.arange(8))                 # per-octave variance


def rig(dt=torch.float64):
    return cameras.Rig(params2=torch.tensor(P2, dtype=dt),
                       T=torch.tensor(T_RL, dtype=dt).contiguous())


def pose(rng, rot=0.3, trans=0.5):
    """A random camera pose (R_cw, t_cw), float64 numpy."""
    return _so3_exp(rng.normal(0, rot, 3)), rng.normal(0, trans, 3)


def points(rng, R, t, n, near=1.0, far=8.0):
    """n world points inside 70 degrees of the left camera's axis that the
    right camera sees in front of it too."""
    d = rng.normal(0, 1, (n, 3))
    d[:, 2] = np.abs(d[:, 2]) + 1.2 * np.linalg.norm(d[:, :2], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    Xc = d * rng.uniform(near, far, (n, 1))
    return (Xc - t) @ R


def observe(R, t, X, rng, noise=0.0):
    """Left pixels, and right keypoints (n, 3) [u, v, sigma2] with their
    octaves' variances, of the reference's model."""
    Rt, tt, Xt = (torch.tensor(a) for a in (R, t, X))
    n = len(X)
    uv = ref.project("kb8", torch.tensor(P1), Xt @ Rt.T + tt).numpy()
    Xr = (Xt @ Rt.T + tt) @ torch.tensor(T_RL[:, :3]).T \
        + torch.tensor(T_RL[:, 3])
    xy_r = ref.project("kb8", torch.tensor(P2), Xr).numpy()
    oct_l = rng.integers(0, 3, n)
    oct_r = np.clip(oct_l + rng.integers(-1, 2, n), 0, 7)
    uv = uv + rng.normal(0, noise, uv.shape) * np.sqrt(S2[oct_l])[:, None]
    xy_r = xy_r + rng.normal(0, noise, xy_r.shape) \
        * np.sqrt(S2[oct_r])[:, None]
    right = np.concatenate([xy_r, S2[oct_r][:, None]], 1)
    return uv, right, S2[oct_l]


def perturbed(R, t, d):
    """Exp(d[3:]) (R, t) + (0, d[:3]): the reference's left perturbation."""
    E = ref.exp_so3(d[3:])
    return E @ R, E @ t + d[:3]


def central(f, x0, eps=1e-6):
    """(m..., k) central differences of f at the float64 vector x0."""
    cols = []
    for i in range(x0.shape[0]):
        e = torch.zeros_like(x0)
        e[i] = eps
        cols.append((f(x0 + e) - f(x0 - e)) / (2 * eps))
    return torch.stack(cols, -1)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(21)
    R, t = pose(rng)
    X = points(rng, R, t, 40)
    uv, right, s2 = observe(R, t, X, rng)
    T = {k: torch.tensor(v) for k, v in dict(R=R, t=t, X=X, uv=uv,
                                              right=right).items()}
    T["R_bc"] = torch.tensor(_so3_exp(np.array([0.05, -0.06, 0.04])))
    T["t_bc"] = torch.tensor([0.05, -0.03, 0.06], dtype=torch.float64)
    return T


def _ref_res(c, side):
    """The reference's residual function of one camera of the pair."""
    if side == "left":
        def res(R, t, X, o):
            return ref.left_residual("kb8", torch.tensor(P1), R, t, X, o)
    else:
        def res(R, t, X, o):
            return ref.right_residual("kb8", torch.tensor(P2),
                                      torch.tensor(T_RL), R, t, X, o)
    return res


@pytest.mark.parametrize("site", ["cameras", "pose_opt", "ba", "inertial"])
def test_right_rows_against_reference(case, site):
    """Each solver's rows of both cameras (the left rows first, then the
    right ones, in one pass) against the plain model, and their Jacobians
    against central differences of the port's own residual."""
    c = case
    R, t, X = c["R"], c["t"], c["X"]
    n = len(X)
    obs = {"left": c["uv"], "right": c["right"][:, :2]}
    half = {"left": slice(0, n), "right": slice(n, 2 * n)}
    rg = rig()
    if site == "cameras":
        # both lenses in one pass (one lens a row) against the reference's,
        # the right rows' Jacobian chained through R_rl
        Xc = X @ R.T + t
        Xs, uv, J = cameras.rig_project(KB8, torch.tensor(P1), rg, Xc)
        lens = {"left": (P1, lambda x: x),
                "right": (P2, lambda x: x @ rg.R_rl.T + rg.t_rl)}
        for side, (P, to_cam) in lens.items():
            h = half[side]
            Pt = torch.tensor(P)
            _close(uv[h], ref.kb8_project(Pt, to_cam(Xc)), 1e-9)
            _close(J[h], torch.func.vmap(torch.func.jacfwd(
                lambda x: ref.kb8_project(Pt, to_cam(x))))(Xc), 1e-7)
            assert torch.equal(uv[h], cameras.project(KB8, Pt, Xs[h]))
        return
    if site == "pose_opt":
        def port(R, t):
            return pose_opt._rig_rows(KB8, torch.tensor(P1), rg, R, t, X,
                                      torch.cat([obs["left"],
                                                 obs["right"]]))
    elif site == "ba":
        def port(R, t):
            r, Jc, Jp, _ = ba._rig_res_jac(
                KB8, torch.tensor(P1), rg, R[None], t[None], X,
                torch.zeros(n, dtype=torch.long), torch.arange(n),
                torch.cat([obs["left"], obs["right"]]))
            return r, Jc, Jp
    else:
        R_wb = R.T @ c["R_bc"].T                     # the body carrying it
        p_wb = -R.T @ t - R_wb @ c["t_bc"]

        def body(R_wb, p_wb):
            R_cw, t_cw = inertial_opt._cam_of_body(R_wb, p_wb, c["R_bc"],
                                                   c["t_bc"])
            r, _, Jpose, Jpt = inertial_opt._rows(
                KB8, torch.tensor(P1), 0.0, R_cw.expand(2 * n, 3, 3),
                t_cw.expand(2 * n, 3), p_wb.expand(2 * n, 3), X.repeat(2, 1),
                obs["left"], torch.full((n,), -1.0),
                torch.zeros(2 * n, dtype=torch.bool), rig=rg,
                xy_r=obs["right"])
            assert (r[:, 2] == 0).all() and (Jpose[:, 2] == 0).all()
            return r[:, :2], Jpose[:, :2], Jpt[:, :2]
        got = body(R_wb, p_wb)
        num = central(lambda d: body(ref.exp_so3(d[3:]) @ R_wb,
                                     p_wb + d[:3])[0],
                      torch.zeros(6, dtype=torch.float64))
        np.testing.assert_allclose(got[1], num, rtol=2e-4, atol=1e-6)
        for side in ("left", "right"):
            h, fn = half[side], _ref_res(c, side)
            _close(got[0][h], fn(R, t, X, obs[side]), 1e-9)
            _close(got[1][h], ref.body_jacobian(
                fn, R_wb, p_wb, c["R_bc"], c["t_bc"], X, obs[side]), 1e-7)
            _close(got[2][h], ref.point_jacobian(fn, R, t, X, obs[side]),
                   1e-7)
        return
    got = port(R, t)
    num = central(lambda d: port(*perturbed(R, t, d))[0],
                  torch.zeros(6, dtype=torch.float64))
    np.testing.assert_allclose(got[1], num, rtol=2e-4, atol=1e-6)
    for side in ("left", "right"):
        h, fn = half[side], _ref_res(c, side)
        _close(got[0][h], fn(R, t, X, obs[side]), 1e-9)
        _close(got[1][h], ref.pose_jacobian(fn, R, t, X, obs[side]), 1e-7)
        if site == "ba":
            _close(got[2][h], ref.point_jacobian(fn, R, t, X, obs[side]),
                   1e-7)


@pytest.mark.parametrize("prec", ["float64", "float32"])
def test_pose_optimize_with_right_rows_matches_plain_lm(prec):
    """Seeded points and pose on the TUM-VI rig, 0.4 px noise scaled by
    each keypoint's level, 8 outliers in each image, a start 0.02 rad and
    6 cm off: the port's pose against the plain LM's."""
    dt = getattr(torch, prec)
    rng = np.random.default_rng(5)
    R, t = pose(rng)
    X = points(rng, R, t, 300)
    uv, right, s2 = observe(R, t, X, rng, noise=0.4)
    uv[:8] += 30.0
    right[8:16, :2] -= 30.0
    right[::5, :] = -1.0                          # keypoints with no match
    mask = np.ones(len(X), bool)
    mask[-5:] = False
    R0, t0 = perturbed(torch.tensor(R), torch.tensor(t),
                       torch.tensor([0.03, -0.02, 0.04, 0.012, -0.01, 0.012],
                                    dtype=torch.float64))
    want = ref.pose_lm("kb8", P1, P2, T_RL, R0, t0, X, uv, s2, right, mask)

    def T(a):
        return torch.as_tensor(a).to(dt)
    out = pose_opt.pose_optimize(
        KB8, T(P1), 0.0, T(R0), T(t0), T(X), T(uv),
        torch.full((len(X),), -1.0, dtype=dt), T(s2), torch.tensor(mask),
        rig=rig(dt), right=T(right))
    rot = torch.linalg.matrix_norm(out.R.double() - want[0]).item()
    tra = torch.linalg.norm(out.t.double() - want[1]).item()
    tol = (1e-7, 1e-7, 0) if prec == "float64" else (2e-5, 5e-5, 2)
    assert rot < tol[0] and tra < tol[1], (rot, tra)
    assert int((out.inlier != want[2]).sum()) <= tol[2]
    assert abs(int(out.n_right) - int(want[3].sum())) <= tol[2]
    assert 200 < int(out.n_right) < 300 - 60 - 8 + 1
    # and the solve found the pose
    assert torch.linalg.matrix_norm(out.R.double() - torch.tensor(R)) < 2e-3


# ---------------------------------------------------------------------------
# The rectified solves as they were
# ---------------------------------------------------------------------------

PIN = np.array([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0])
BF = 40.0
G = np.array([0.0, 0.0, -imu.GRAVITY])
NOISE = (1e-3, 1e-2, 1e-6, 1e-5)


def _pin(Xc):
    return np.stack([PIN[0] * Xc[:, 0] / Xc[:, 2] + PIN[2],
                     PIN[1] * Xc[:, 1] / Xc[:, 2] + PIN[3]], -1)


def window_scene(rng, W=4, seg=40, n_pts=120, n_anchor=1, kb8=False):
    """A visual-inertial window on `_simulate`'s body: W keyframes (and
    n_anchor earlier ones as fixed anchors) every `seg` IMU rows, points in
    front of them seen by every keyframe, the window's poses, velocities
    and points perturbed. Pinhole with stereo rows (every 9th mono), or
    with kb8 the TUM-VI rig's left and right keypoints. float64 tensors."""
    n_kf = W + n_anchor
    meas, Rs, vs, ps = _simulate(n=(n_kf - 1) * seg)
    kf_R = np.stack([Rs[i * seg] for i in range(n_kf)])
    kf_p = np.stack([ps[i * seg] for i in range(n_kf)])
    kf_v = np.stack([vs[i * seg] for i in range(n_kf)])
    R_bc = _so3_exp(np.array([0.03, -0.02, 0.04]))
    t_bc = np.array([0.04, -0.02, 0.03])
    X = rng.uniform(-3, 3, (n_pts, 3))
    X[:, 2] += 6.0
    uv = np.zeros((n_kf, n_pts, 2))
    ur = np.full((n_kf, n_pts), -1.0)
    right = np.full((n_kf, n_pts, 3), -1.0)
    ok = np.zeros((n_kf, n_pts), bool)
    Rcw, tcw = np.zeros((n_kf, 3, 3)), np.zeros((n_kf, 3))
    for k in range(n_kf):
        R_wc = kf_R[k] @ R_bc
        p_wc = kf_R[k] @ t_bc + kf_p[k]
        Rcw[k], tcw[k] = R_wc.T, -R_wc.T @ p_wc
        Xc = (X - p_wc) @ R_wc
        ok[k] = Xc[:, 2] > 1
        if kb8:
            uv[k], right[k], _ = observe(Rcw[k], tcw[k], X, rng, noise=0.05)
            right[k, ::6] = -1.0
        else:
            uv[k] = _pin(Xc) + rng.normal(0, 0.05, (n_pts, 2))
            ur[k] = uv[k, :, 0] - BF / np.maximum(Xc[:, 2], 0.1)
            ur[k, ::9] = -1.0
    a, w = slice(0, n_anchor), slice(n_anchor, n_kf)
    Rp, pp, vp = kf_R[w].copy(), kf_p[w].copy(), kf_v[w].copy()
    for k in range(1, W):
        Rp[k] = _so3_exp(rng.normal(0, 0.01, 3)) @ Rp[k]
        pp[k] += rng.normal(0, 0.05, 3)
        vp[k] += rng.normal(0, 0.1, 3)
    Xp = X + rng.normal(0, 0.05, X.shape)
    pt = np.tile(np.arange(n_pts), (n_kf, 1))
    cam = np.repeat(np.arange(n_kf)[:, None], n_pts, 1)
    t64 = torch.float64

    def T(x):
        x = np.asarray(x)
        return torch.tensor(x, dtype=torch.bool if x.dtype == bool
                            else torch.long if x.dtype.kind == "i" else t64)
    segs = meas.reshape(n_kf - 1, seg, 7)[n_anchor:]
    preints = imu.integrate(torch.zeros(6, dtype=t64), T(segs),
                            torch.ones(segs.shape[:2], dtype=torch.bool),
                            *NOISE)
    return dict(
        truth=(kf_R[w], kf_p[w], X), R_bc=T(R_bc), t_bc=T(t_bc),
        state=[T(Rp), T(pp), T(vp), torch.ones(W, dtype=torch.bool),
               preints, torch.ones(W - 1, dtype=torch.bool),
               torch.zeros(3, dtype=t64), torch.zeros(3, dtype=t64), T(G)],
        window=[T(Xp), T(pt[w].reshape(-1)),
                T((cam[w] - n_anchor).reshape(-1)),
                T(uv[w].reshape(-1, 2)), T(ur[w].reshape(-1)),
                T(np.ones(W * n_pts)), T(ok[w].reshape(-1))],
        anchors=[T(Rcw[a]), T(tcw[a]), T(cam[a].reshape(-1)),
                 T(pt[a].reshape(-1)), T(uv[a].reshape(-1, 2)),
                 T(ur[a].reshape(-1)), T(np.ones(n_anchor * n_pts)),
                 T(ok[a].reshape(-1))],
        right=T(right[w].reshape(-1, 3)), a_right=T(right[a].reshape(-1, 3)))


def _pose_case():
    rng = np.random.default_rng(3)
    R, t = _so3_exp(np.array([0.1, -0.2, 0.05])), np.array([0.2, -0.1, 0.3])
    X = rng.uniform(-4, 4, (200, 3))
    X[:, 2] += 8.0
    Xc = X @ R.T + t
    uv = _pin(Xc) + rng.normal(0, 0.5, (200, 2))
    uv[:10] += 20.0
    ur = uv[:, 0] - BF / Xc[:, 2]
    ur[::4] = -1.0
    R0, t0 = _so3_exp(np.array([0.02, 0.01, -0.02])) @ R, t + 0.05
    T = torch.tensor
    return pose_opt.pose_optimize(
        0, T(PIN), BF, T(R0), T(t0), T(X), T(uv), T(ur),
        T(S2[np.arange(200) % 3]), torch.ones(200, dtype=torch.bool))


def _ba_table(alternate: bool):
    s = window_scene(np.random.default_rng(4))
    Xp, f_pt, f_kf, uv, ur, s2, ok = s["window"]
    R_wb, p_wb = s["state"][:2]
    R_cw, t_cw = inertial_opt._cam_of_body(R_wb, p_wb, s["R_bc"], s["t_bc"])
    C = R_cw.shape[0]
    cam_opt = torch.arange(C) > 0
    if alternate:
        return ba.ba_alternate(0, torch.tensor(PIN), BF, R_cw, t_cw, cam_opt,
                               Xp, torch.ones(len(Xp), dtype=torch.bool),
                               f_kf, f_pt, uv, ur, s2, ok)
    return ba.ba_solve(0, torch.tensor(PIN), BF, R_cw, t_cw, cam_opt, Xp,
                       torch.ones(len(Xp), dtype=torch.bool), f_kf, f_pt, uv,
                       ur, s2, ok, n_iters=6, cam_blocked=True)


def _inertial(name):
    s = window_scene(np.random.default_rng(6))
    st, win = s["state"], s["window"]
    kw = dict(walk_info=torch.full((6,), 1e6, dtype=torch.float64),
              R_bc=s["R_bc"], t_bc=s["t_bc"])
    if name == "vi_window_ba":
        return inertial_opt.vi_window_ba(0, torch.tensor(PIN), BF, *st,
                                         *win, *s["anchors"], **kw)
    if name == "vi_full_ba":
        return inertial_opt.vi_full_ba(0, torch.tensor(PIN), BF, *st, *win,
                                       cg_iters=16, **kw)
    Xp, f_pt = win[:2]
    return inertial_opt.inertial_window_refine(
        0, torch.tensor(PIN), BF, *st, Xp[f_pt], *win[2:], **kw)


def _pvb():
    args, kw, _ = scenario(torch.device("cpu"), N=300)
    args = [a.double() if isinstance(a, torch.Tensor) and a.is_floating_point()
            else a for a in args]
    args[10] = imu.PreintState(*[a.double() for a in args[10]])
    kw = {k: v.double() for k, v in kw.items()}
    return inertial_opt.pose_vel_bias_optimize_plain(*args, **kw)


RECTIFIED = {
    "pose_optimize": _pose_case,
    "ba_solve": lambda: _ba_table(False),
    "ba_alternate": lambda: _ba_table(True),
    "pose_vel_bias_optimize_plain": _pvb,
    "vi_window_ba": lambda: _inertial("vi_window_ba"),
    "vi_full_ba": lambda: _inertial("vi_full_ba"),
    "inertial_window_refine": lambda: _inertial("refine"),
}


def checksum(out) -> list:
    """Position-weighted sums of every floating output, float64."""
    sums = []
    for a in out:
        if isinstance(a, torch.Tensor) and a.numel():
            a = a.double().reshape(-1)
            sums.append(float((a * (1 + torch.arange(a.numel()) % 7)).sum()))
    return sums


# checksum(RECTIFIED[name]()) as the solvers gave them before the right
# rows were added (the same code on the CPU, one thread)
BEFORE = {
    "pose_optimize": [8.227413892248595, 0.9038815272299151, 760.0, 190.0,
        96.80033594712667],
    "ba_solve": [45.973602528622635, -6.977661327093717, 3248.6121550366033,
        8.445570301570068, 1914.0],
    "ba_alternate": [45.92276813050081, -7.133553123260265, 4128.090135976583],
    "pose_vel_bias_optimize_plain": [6.852998724353604, 0.5114353892677811,
        1.4224855529925828, 0.0003531970297665, -5.453539243320367e-05, 1112.0,
        278.0],
    "vi_window_ba": [46.12243512066389, 5.558648147211021, 13.357434923237575,
        -0.00012548380986532418, 3.0611963268499226e-06, 2993.0108566651807,
        -29.429850026465356, 0.0],
    "vi_full_ba": [46.123235043292354, 5.570866451535046, 13.382216171448746,
        -0.0002547755058225518, 2.5897715827573157e-05, 2993.8774730701048,
        -29.461006575476226, 0.0],
    "inertial_window_refine": [46.14407049260663, 5.98542134360233,
        14.533138814512133, -0.005594794881951028, 0.00012588731248289393,
        7273.02704625267],
}


@pytest.mark.parametrize("name", list(RECTIFIED))
def test_rectified_solves_unchanged(name, monkeypatch):
    def leak(*a, **k):
        raise AssertionError("a right row in a rectified solve")
    for attr in ("rig_project", "right_info"):
        monkeypatch.setattr(cameras, attr, leak)
    got = checksum(RECTIFIED[name]())
    np.testing.assert_allclose(got, BEFORE[name], rtol=1e-12, atol=1e-12)
