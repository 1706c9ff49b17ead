"""Projection-guided and epipolar descriptor matching.

Port of `ms_slam_tpu/ops/matching.py`: every candidate pair's Hamming
distance comes from one matmul and the geometric gates are masks on that
matrix (constants TH_HIGH=100, TH_LOW=50 and the nn-ratio follow the
reference).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import cameras, hamming, lie
from .indexing import max_at_, set_at_, top_k, add_at_

TH_HIGH = 100
TH_LOW = 50
BIG = 1_000_000
HISTO_LENGTH = 30


def rotation_consistency(idx_b: torch.Tensor, angle_a: torch.Tensor,
                         angle_b: torch.Tensor,
                         n_bins: int = HISTO_LENGTH) -> torch.Tensor:
    """Keep only matches whose keypoint-angle difference falls in the top-3
    histogram bins (bins 2/3 dropped under 10% of the max). idx_b: (Na,)
    a -> b index, -1 none. Returns idx_b with the rest reset to -1."""
    valid = idx_b >= 0
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle_a - angle_b[idx_b.clamp(min=0).long()], two_pi)
    b = torch.floor(rot * (n_bins / two_pi)).to(torch.int32) % n_bins
    counts = add_at_(torch.zeros(n_bins, dtype=torch.int32, device=b.device),
                     torch.where(valid, b, n_bins), 1)
    top_v, top_i = top_k(counts, 3)
    keep_bin = top_v >= torch.clamp((0.1 * top_v[0]).to(top_v.dtype), min=1)
    bin_ok = max_at_(torch.zeros(n_bins, dtype=torch.int32, device=b.device),
                     top_i, keep_bin.to(torch.int32)) > 0
    return torch.where(valid & bin_ok[b.long()], idx_b, -1)


class ProjMatches(NamedTuple):
    mp_slot: torch.Tensor   # (N,) index into the local-point buffer, -1 none
    n_matches: torch.Tensor
    visible: torch.Tensor   # (L,) bool: point passed the frustum test


def predict_octave(dist, max_dist, scale_factor: float, n_levels: int):
    """MapPoint::PredictScale: pyramid level from distance."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1e-6)
    lvl = torch.ceil(torch.log(ratio) / math.log(scale_factor)).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def _best_second(d: torch.Tensor):
    """Row argmin (first on ties), its value, and the second-best value."""
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), best] = BIG
    return best, best_d, d2.min(dim=1).values


def search_by_projection(
    model: int, params, R, t, img_w: int, img_h: int,
    pt_pos, pt_normal, pt_min_dist, pt_max_dist, pt_desc, pt_valid,
    f_xy, f_octave, f_desc, f_valid,
    th_radius, nn_ratio, scale_factor: float, n_levels: int,
    check_view_angle: bool = True, pt_angle=None, f_angle=None,
) -> ProjMatches:
    """Projection-guided association with frustum gating: per point the
    best and second-best feature within the radius/octave gates, the ratio
    test, and mutual-best; the rotation histogram when angles are given."""
    dev = pt_pos.device
    scales = scale_factor ** torch.arange(n_levels, dtype=torch.float32,
                                          device=dev)
    Xc = lie.se3_apply(R, t, pt_pos)
    z = Xc[..., 2]
    uv = cameras.project(model, params, Xc)
    cam_center = -R.T @ t
    vec = pt_pos - cam_center
    dist = torch.linalg.norm(vec, dim=-1)
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < img_w)
              & (uv[:, 1] >= 0) & (uv[:, 1] < img_h))
    in_range = (dist >= 0.8 * pt_min_dist) & (dist <= 1.2 * pt_max_dist)
    visible = pt_valid & (z > 0.2) & in_img & in_range
    if check_view_angle:
        cosv = torch.sum(vec * pt_normal, dim=-1) / torch.clamp(dist, min=1e-6)
        visible &= cosv >= 0.5

    pred_oct = predict_octave(dist, pt_max_dist, scale_factor, n_levels)
    radius = th_radius * scales[pred_oct.long()]

    d = hamming.hamming_matrix(pt_desc, f_desc)      # (L,N)
    du = torch.abs(uv[:, 0:1] - f_xy[None, :, 0])
    dv = torch.abs(uv[:, 1:2] - f_xy[None, :, 1])
    near = (du <= radius[:, None]) & (dv <= radius[:, None])
    oct_ok = ((f_octave[None, :] >= pred_oct[:, None] - 1)
              & (f_octave[None, :] <= pred_oct[:, None]))
    ok = near & oct_ok & visible[:, None] & f_valid[None, :]
    d = torch.where(ok, d, BIG)

    best_f, best_d, second_d = _best_second(d)
    pt_good = (best_d <= TH_HIGH) & (best_d <= nn_ratio * second_d)
    best_p_of_f = torch.argmin(d, dim=0)             # (N,)
    L = pt_pos.shape[0]
    pt_good &= best_p_of_f[best_f] == torch.arange(L, device=dev)

    N = f_xy.shape[0]
    tgt = torch.where(pt_good, best_f, N)
    mp_slot = set_at_(torch.full((N,), -1, dtype=torch.int32, device=dev),
                      tgt, torch.arange(L, dtype=torch.int32, device=dev))
    if pt_angle is not None and f_angle is not None:
        mp_slot = rotation_consistency(mp_slot, f_angle, pt_angle)
    return ProjMatches(mp_slot=mp_slot,
                       n_matches=(mp_slot >= 0).sum().to(torch.int32),
                       visible=visible)


class BowLikeMatches(NamedTuple):
    idx_b: torch.Tensor     # (Na,) index into B's features, -1 none
    n_matches: torch.Tensor


def mutual_match(desc_a, valid_a, desc_b, valid_b, max_dist: int = TH_LOW,
                 nn_ratio: float = 0.7, extra_mask=None, angle_a=None,
                 angle_b=None) -> BowLikeMatches:
    """Frame <-> keyframe descriptor matching: best/second ratio test,
    mutual best, optional extra gate and rotation histogram."""
    d = hamming.hamming_matrix(desc_a, desc_b)
    ok = valid_a[:, None] & valid_b[None, :]
    if extra_mask is not None:
        ok &= extra_mask
    d = torch.where(ok, d, BIG)
    best_b, best_d, second_d = _best_second(d)
    good = (best_d <= max_dist) & (best_d <= nn_ratio * second_d)
    best_a_of_b = torch.argmin(d, dim=0)
    good &= best_a_of_b[best_b] == torch.arange(desc_a.shape[0],
                                                device=d.device)
    idx_b = torch.where(good, best_b, -1).to(torch.int32)
    if angle_a is not None and angle_b is not None:
        idx_b = rotation_consistency(idx_b, angle_a, angle_b)
    return BowLikeMatches(idx_b=idx_b,
                          n_matches=(idx_b >= 0).sum().to(torch.int32))


def epipolar_mask(model: int, params, R12, t12, xy1, xy2, sigma2_2,
                  thresh: float = 3.84) -> torch.Tensor:
    """(N1,N2) mask of feature pairs consistent with the epipolar geometry
    of T12 (camera 2 from camera 1): chi2-gated point-to-line distance."""
    r1 = cameras.unproject(model, params, xy1)
    r2 = cameras.unproject(model, params, xy2)
    E = lie.hat(t12) @ R12
    l2 = r1 @ E.T
    num = torch.abs(l2 @ r2.T)
    den = torch.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None] + 1e-9
    d_px = num / den * params[0]
    return (d_px * d_px) <= thresh * sigma2_2[None, :]
