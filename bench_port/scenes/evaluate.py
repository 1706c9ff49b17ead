"""Absolute trajectory error: a frozen copy of
`ms_slam_tpu_torch/utils/evaluate.py`'s `horn_align` and `ate_rmse` (Horn's
closed-form alignment, then the RMSE of the aligned positions)."""
from __future__ import annotations

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = False):
    """Align model (3,N) to data (3,N). Returns (R, t, s, trans_error (N,))."""
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mz = model - mu_m
    dz = data - mu_d
    W = np.zeros((3, 3))
    for i in range(model.shape[1]):
        W += np.outer(mz[:, i], dz[:, i])
    U, _, Vt = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        dots = float(np.sum(dz * (R @ mz)))
        norms = float(np.sum(mz * mz))
        s = dots / max(norms, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    aligned = s * R @ model + t
    err = np.linalg.norm(aligned - data, axis=0)
    return R, t, s, err


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray,
             with_scale: bool = False) -> float:
    """est_xyz, gt_xyz: (N,3) associated positions -> RMSE after alignment."""
    _, _, _, err = horn_align(est_xyz.T, gt_xyz.T, with_scale)
    return float(np.sqrt(np.mean(err ** 2)))
