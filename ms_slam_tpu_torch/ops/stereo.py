"""Batched rectified stereo matching on canvas-packed pyramids.

Port of `ms_slam_tpu/ops/stereo.py::match_stereo_canvas`: all-pairs
Hamming matrix masked by row band, octave and disparity range, a masked
argmin per left feature, an 11-tap mean-removed SAD sweep over +-5 px with
a parabola fit, and the 1.5*1.48*median SAD outlier gate.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import hamming
from .orb import Features, OrbConfig, canvas_layout

DESC_GATE = 75
SAD_W = 5          # half-width of the SAD patch (11 px row window)
SAD_SEARCH = 5     # +-5 px sweep


class StereoMatch(NamedTuple):
    u_right: torch.Tensor  # (N,) float32, -1 where unmatched
    depth: torch.Tensor    # (N,) float32, -1 where unmatched
    valid: torch.Tensor    # (N,) bool


def _reference_median(x: torch.Tensor) -> torch.Tensor:
    """`jnp.median` as the reference uses it (stereo.py:186): NaN if any
    entry is NaN (no NaN skipping), else the midpoint (lo + hi) * 0.5 of
    the two middle values for an even count. `torch.nanmedian` would skip
    the NaNs and `torch.median` returns the lower middle value, so neither
    stands in for it."""
    n = x.shape[0]
    s = torch.sort(x).values
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(mid, float("nan")),
                       mid)


def match_stereo_canvas(feats_l: Features, feats_r: Features,
                        canvas_l: torch.Tensor, canvas_r: torch.Tensor,
                        w: int, bf: float, min_z: float, cfg: OrbConfig
                        ) -> StereoMatch:
    """Match left to right features; the SAD refinement reads the
    keypoint's level region of the packed (H, Wc) canvases."""
    dev = canvas_l.device
    h, Wc = canvas_l.shape
    offs, _, shapes = canvas_layout(h, w, cfg)
    scales = torch.tensor(cfg.level_scales(), dtype=torch.float32, device=dev)
    lo = feats_l.octave.long()

    dist = hamming.hamming_matrix(feats_l.desc, feats_r.desc)  # (N,M)
    yl = feats_l.xy[:, 1][:, None]
    yr = feats_r.xy[:, 1][None, :]
    band = 2.0 * scales[lo][:, None]
    row_ok = torch.abs(yl - yr) <= band
    oct_ok = torch.abs(feats_l.octave[:, None] - feats_r.octave[None, :]) <= 1
    disp = feats_l.xy[:, 0][:, None] - feats_r.xy[:, 0][None, :]
    max_disp = bf / min_z
    disp_ok = (disp > 0.1) & (disp < max_disp)
    ok = row_ok & oct_ok & disp_ok & feats_l.valid[:, None] \
        & feats_r.valid[None, :]
    dist = torch.where(ok, dist, torch.full_like(dist, 10_000))
    best = torch.argmin(dist, dim=1)               # first min, as jnp.argmin
    best_d = torch.gather(dist, 1, best[:, None])[:, 0]
    matched = best_d <= DESC_GATE

    inv_s = 1.0 / scales[lo]
    ul = feats_l.xy[:, 0] * inv_s
    vl = feats_l.xy[:, 1] * inv_s
    ur0 = feats_r.xy[best, 0] * inv_s
    lh = torch.tensor([s[0] for s in shapes], device=dev)[lo]
    lw = torch.tensor([s[1] for s in shapes], device=dev)[lo]
    off = torch.tensor(offs, device=dev)[lo]

    def clip(v, a, b):
        return torch.minimum(torch.maximum(v, a), b)

    yi = clip(torch.round(vl).long(), torch.tensor(SAD_W, device=dev),
              lh - SAD_W - 1)
    lo_x = torch.tensor(SAD_W + SAD_SEARCH, device=dev)
    xi = clip(torch.round(ul).long(), lo_x, lw - SAD_W - SAD_SEARCH - 1)
    xri = clip(torch.round(ur0).long(), lo_x, lw - SAD_W - SAD_SEARCH - 1)
    offs1 = torch.arange(-SAD_W, SAD_W + 1, device=dev)
    base = yi * Wc + off
    lp = canvas_l.reshape(-1)[(base + xi)[:, None] + offs1[None, :]]
    lp = lp - torch.mean(lp, dim=1, keepdim=True)
    woffs = torch.arange(-(SAD_W + SAD_SEARCH), SAD_W + SAD_SEARCH + 1,
                         device=dev)
    rwin = canvas_r.reshape(-1)[(base + xri)[:, None] + woffs[None, :]]
    sweeps = []
    for s in range(2 * SAD_SEARCH + 1):
        rp = rwin[:, s:s + 2 * SAD_W + 1]
        rp = rp - torch.mean(rp, dim=1, keepdim=True)
        sweeps.append(torch.sum(torch.abs(lp - rp), dim=1))
    sad = torch.stack(sweeps, dim=1)
    k = torch.argmin(sad, dim=1)
    kc = torch.clamp(k, 1, 2 * SAD_SEARCH - 1)
    s_m1 = torch.gather(sad, 1, (kc - 1)[:, None])[:, 0]
    s_0 = torch.gather(sad, 1, kc[:, None])[:, 0]
    s_p1 = torch.gather(sad, 1, (kc + 1)[:, None])[:, 0]
    denom = s_m1 + s_p1 - 2 * s_0
    delta = torch.where(torch.abs(denom) > 1e-6,
                        0.5 * (s_m1 - s_p1) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    off_px = (kc.to(torch.float32) - SAD_SEARCH + delta
              + xri.to(torch.float32) - ur0)
    ur_refined = (ur0 + off_px) * scales[lo]
    disparity = feats_l.xy[:, 0] - ur_refined
    matched = matched & (disparity > 0.01) & (disparity < max_disp)
    # parity hazard: the reference's median propagates NaN, so the gate is
    # off (median -> inf) whenever any slot is unmatched
    med = _reference_median(torch.where(matched, s_0,
                                        torch.full_like(s_0, float("nan"))))
    med = torch.nan_to_num(med, nan=float("inf"))
    matched = matched & (s_0 <= 1.5 * 1.48 * med)
    depth = torch.where(matched, bf / torch.clamp(disparity, min=1e-6),
                        torch.full_like(disparity, -1.0))
    u_right = torch.where(matched, ur_refined, torch.full_like(ur_refined, -1.0))
    return StereoMatch(u_right=u_right, depth=depth, valid=matched)
