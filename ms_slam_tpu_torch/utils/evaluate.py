"""Trajectory evaluation: ATE RMSE after Horn closed-form alignment.

Re-implementation of the reference's evaluation/evaluate_ate_scale.py
(:49-97 `align`, :162-165 RMSE reporting): SVD-based Horn alignment with and
without scale correction, plus timestamp association (associate.py analog).
Pure numpy — this is offline tooling.

Copied from ms_slam_tpu/utils/evaluate.py (numpy only); the port keeps its own
copy so that it runs nothing of the JAX package.
"""
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


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association (ref evaluation/associate.py).
    Returns (idx_est, idx_gt)."""
    ie, ig = [], []
    j = 0
    for i, te in enumerate(t_est):
        j = int(np.searchsorted(t_gt, te))
        best, bestd = -1, max_dt
        for k in (j - 1, j):
            if 0 <= k < len(t_gt) and abs(t_gt[k] - te) <= bestd:
                best, bestd = k, abs(t_gt[k] - te)
        if best >= 0:
            ie.append(i)
            ig.append(best)
    return np.asarray(ie, int), np.asarray(ig, int)
