"""The inertial solvers with an unrectified stereo-fisheye pair's right rows,
against the plain evaluation of `bench_port/reference/rig.py`, and the CUDA
kernel's right rows against its plain version on a card.

- `pose_vel_bias_optimize_plain` on test_torch_pvb_kernel.py's KB8 scenario
  with right keypoints (0.3 px noise by level, 5% outliers, every 5th
  keypoint unmatched): the right rows it keeps are those the reference's
  chi2 gate keeps at its solution (the same set in float64, within 2 rows
  in float32, where a row at the gate's edge may go either way), and the
  body pose within 2e-3 rad and 2 cm of the truth (the kernel test's bar);
- `vi_window_ba` on a TUM-VI window with anchors (0.05 px noise by
  level): at its solution the reference's right residuals, whitened by
  each keypoint's variance, have an RMS under 0.2 (the noise alone gives
  0.07; the perturbed start reads over 2), and the window's positions and
  points come three times closer to the truth;
- on a card, the kernel with right rows against the plain version at the
  walk's 1,024 matches, one launch, test_torch_pvb_kernel.py's tolerances
  and the right rows' flags within 2 slots.
"""
import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import inertial_opt

from test_torch_pvb_kernel import _assert_close, scenario
from test_torch_rig_rows import (KB8, P1, T_RL, observe, ref, rig,
                                 window_scene)

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass


def rig_scenario(device, dt=torch.float32, N=1024, seed=19):
    """test_torch_pvb_kernel.py's KB8 scenario on the TUM-VI left lens,
    with each match's right keypoint: (args, kwargs, truth)."""
    args, kw, (R2, p2) = scenario(device, N=N, model=1, all_mono=True,
                                  seed=seed)
    args = list(args)
    args[1] = torch.tensor(P1, dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed + 1)
    R_bc, t_bc = (a.double().cpu().numpy() for a in args[3:5])
    X = args[14].double().cpu().numpy()
    R_wc = R2 @ R_bc
    R_cw, t_cw = R_wc.T, -R_wc.T @ (R2 @ t_bc + p2)
    uv, right, s2 = observe(R_cw, t_cw, X, rng, noise=0.3)
    right[: N // 20, :2] += rng.normal(0, 25.0, (N // 20, 2))
    right[::5] = -1.0
    args[15] = torch.tensor(uv, dtype=torch.float32, device=device)
    args[17] = torch.tensor(s2, dtype=torch.float32, device=device)
    r = rig(torch.float32)
    kw["rig"] = type(r)(*(a.to(device) for a in r))
    kw["right"] = torch.tensor(right, dtype=torch.float32, device=device)
    if dt == torch.float64:
        args = [a.double() if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a for a in args]
        args[10] = type(args[10])(*[a.double() for a in args[10]])
        kw = {k: v.double() if isinstance(v, torch.Tensor) else
              v.to(torch.float64) for k, v in kw.items()}
    return args, kw, (R2, p2)


def _gate(out, args, kw):
    """The reference's right-row inliers at the solution's body pose."""
    R_bc, t_bc = (a.double().cpu() for a in args[3:5])
    R_cw, t_cw = ref.camera_of_body(out.R_wb.double().cpu(),
                                    out.p_wb.double().cpu(), R_bc, t_bc)
    X = args[14].double().cpu()
    right = kw["right"].double().cpu()
    r = ref.right_residual("kb8", kw["rig"].params2.double().cpu(),
                           torch.tensor(T_RL), R_cw, t_cw, X, right[:, :2])
    chi2 = (r * r).sum(-1) / right[:, 2]
    T = torch.tensor(T_RL)
    z = ((X @ R_cw.T + t_cw) @ T[:, :3].T + T[:, 3])[:, 2]
    return args[18].cpu() & (right[:, 0] >= 0) & (chi2 <= 5.991) & (z > 0)


@pytest.mark.parametrize("prec", ["float64", "float32"])
def test_pvb_plain_right_rows_against_reference(prec):
    dt = getattr(torch, prec)
    args, kw, (R2, p2) = rig_scenario(torch.device("cpu"), dt, N=400)
    out = inertial_opt.pose_vel_bias_optimize_plain(*args, **kw)
    assert out.inlier_r is not None and out.n_right is not None
    want = _gate(out, args, kw)
    slack = 0 if prec == "float64" else 2
    assert int((out.inlier_r != want).sum()) <= slack
    assert abs(int(out.n_right) - int(want.sum())) <= slack
    assert int(out.n_right) > 0.7 * 400 * 0.8
    d = out.R_wb.double().numpy() @ R2.T
    assert np.arccos(np.clip((np.trace(d) - 1) / 2, -1, 1)) < 2e-3
    assert np.linalg.norm(out.p_wb.double().numpy() - p2) < 0.02


def test_vi_window_ba_right_rows_against_reference():
    s = window_scene(np.random.default_rng(8), kb8=True)
    st, win = s["state"], s["window"]
    P1t = torch.tensor(P1)
    kw = dict(walk_info=torch.full((6,), 1e6, dtype=torch.float64),
              R_bc=s["R_bc"], t_bc=s["t_bc"], rig=rig(),
              f_right=s["right"], a_right=s["a_right"])
    anchors = list(s["anchors"])
    anchors[5] = torch.full_like(anchors[5], -1.0)      # no stereo rows
    win = list(win)
    win[4] = torch.full_like(win[4], -1.0)
    out = inertial_opt.vi_window_ba(KB8, P1t, 0.0, *st, *win, *anchors,
                                    **kw)

    def right_rms(R_wb, p_wb, P):
        f_pt, f_kf = win[1], win[2]
        R_wc = R_wb[f_kf] @ s["R_bc"]
        p_wc = R_wb[f_kf] @ s["t_bc"] + p_wb[f_kf]
        Xc = torch.einsum("nji,nj->ni", R_wc, P[f_pt] - p_wc)
        Tr = torch.tensor(T_RL)
        Xr = Xc @ Tr[:, :3].T + Tr[:, 3]
        r = s["right"][:, :2] - ref.project("kb8", rig().params2, Xr)
        ok = (s["right"][:, 0] >= 0) & win[6]
        w = (r * r).sum(-1) / s["right"][:, 2]
        return float(torch.sqrt(w[ok].mean()))

    before = right_rms(st[0], st[1], win[0])
    after = right_rms(out.R_wb, out.p_wb, out.mp_pos)
    assert after < 0.2 < 2.0 < before, (before, after)
    R_t, p_t, X_t = s["truth"]
    err = [np.linalg.norm(p.numpy() - p_t, axis=1).max()
           for p in (st[1], out.p_wb)]
    assert err[1] < err[0] / 3, err
    perr = [np.median(np.linalg.norm(P.numpy() - X_t, axis=1))
            for P in (win[0], out.mp_pos)]
    assert perr[1] < perr[0] / 3, perr


@pytest.mark.cuda
def test_pvb_kernel_right_rows_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    args, kw, _ = rig_scenario(dev)
    before = inertial_opt.pvb_kernel_launches
    out = inertial_opt.pose_vel_bias_optimize(*args, **kw)
    torch.cuda.synchronize()
    assert inertial_opt.pvb_kernel_launches == before + 1
    plain = inertial_opt.pose_vel_bias_optimize_plain(*args, **kw)
    _assert_close(out, plain)
    assert int((out.inlier_r != plain.inlier_r).sum()) <= 2
    assert abs(int(out.n_right) - int(plain.n_right)) <= 2
    want = _gate(out, args, kw)
    assert int((out.inlier_r.cpu() != want).sum()) <= 2
