"""Batched rectified stereo matching.

Port of `ms_slam_tpu/ops/stereo.py`: all-pairs Hamming matrix masked by
row band, octave and disparity range, a masked argmin per left feature, an
11-tap mean-removed SAD sweep over +-5 px with a parabola fit, and the
1.5*1.48*median SAD outlier gate. The three matchers differ only in where
the SAD windows are read: the keypoint's level region of a packed canvas
(`match_stereo_canvas`, the frontend's), its plane of a padded level stack
(`match_stereo_stack`), or a list of level images (`match_stereo`).
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


def _descriptor_match(feats_l: Features, feats_r: Features, bf: float,
                      min_z: float, scales: torch.Tensor):
    """Best right feature per left feature under the row band, octave and
    disparity gates: (best (N,), matched (N,) bool, max disparity)."""
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
    return best, best_d <= DESC_GATE, max_disp


def _clip(v, a, b):
    return torch.minimum(torch.maximum(v, torch.as_tensor(a, device=v.device)),
                         torch.as_tensor(b, device=v.device))


def _sad_offset(lp: torch.Tensor, rwin: torch.Tensor, xri, ur0):
    """The SAD sweep of one left row window lp (N, 11) against the right
    windows rwin (N, 21): the sub-pixel offset of the right match from
    ur0 at the keypoint's level, and the SAD at the chosen shift."""
    lp = lp - torch.mean(lp, dim=1, keepdim=True)
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
    off = (kc.to(torch.float32) - SAD_SEARCH + delta
           + xri.to(torch.float32) - ur0)
    return off, s_0


def _gate(feats_l: Features, matched, ur0, off, s_0, scale_l, bf: float,
          max_disp: float) -> StereoMatch:
    """Refined right coordinate, disparity range and the median SAD gate."""
    ur_refined = (ur0 + off) * scale_l
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


_OFFS1 = (-SAD_W, SAD_W + 1)                         # left window taps
_WOFFS = (-(SAD_W + SAD_SEARCH), SAD_W + SAD_SEARCH + 1)   # right window


def _level_coords(feats_l, feats_r, best, scales):
    lo = feats_l.octave.long()
    inv_s = 1.0 / scales[lo]
    return (lo, feats_l.xy[:, 0] * inv_s, feats_l.xy[:, 1] * inv_s,
            feats_r.xy[best, 0] * inv_s)


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
    best, matched, max_disp = _descriptor_match(feats_l, feats_r, bf, min_z,
                                                scales)
    lo, ul, vl, ur0 = _level_coords(feats_l, feats_r, best, scales)
    lh = torch.tensor([s[0] for s in shapes], device=dev)[lo]
    lw = torch.tensor([s[1] for s in shapes], device=dev)[lo]
    off = torch.tensor(offs, device=dev)[lo]
    yi = _clip(torch.round(vl).long(), SAD_W, lh - SAD_W - 1)
    xi = _clip(torch.round(ul).long(), SAD_W + SAD_SEARCH,
               lw - SAD_W - SAD_SEARCH - 1)
    xri = _clip(torch.round(ur0).long(), SAD_W + SAD_SEARCH,
                lw - SAD_W - SAD_SEARCH - 1)
    base = yi * Wc + off
    offs1 = torch.arange(*_OFFS1, device=dev)
    woffs = torch.arange(*_WOFFS, device=dev)
    # the windows are read from the canvas as it is (bf16 under the TPU
    # numerics) and widened before the means and the 11-tap sums, which
    # need more than bf16's 8 bits (reference stereo.py:158-163)
    lp = canvas_l.reshape(-1)[(base + xi)[:, None] + offs1[None, :]].float()
    rwin = canvas_r.reshape(-1)[(base + xri)[:, None]
                                + woffs[None, :]].float()
    off_px, s_0 = _sad_offset(lp, rwin, xri, ur0)
    return _gate(feats_l, matched, ur0, off_px, s_0, scales[lo], bf, max_disp)


def match_stereo_stack(feats_l: Features, feats_r: Features,
                       stack_l: torch.Tensor, stack_r: torch.Tensor,
                       bf: float, min_z: float, cfg: OrbConfig
                       ) -> StereoMatch:
    """The matcher on padded (L, H, W) level stacks: the SAD windows are
    read from the keypoint's own plane, clipped to the plane's full size
    (as the reference does)."""
    dev = stack_l.device
    _, h, w = stack_l.shape
    scales = torch.tensor(cfg.level_scales(), dtype=torch.float32, device=dev)
    best, matched, max_disp = _descriptor_match(feats_l, feats_r, bf, min_z,
                                                scales)
    lo, ul, vl, ur0 = _level_coords(feats_l, feats_r, best, scales)
    yi = _clip(torch.round(vl).long(), SAD_W, h - SAD_W - 1)
    xi = _clip(torch.round(ul).long(), SAD_W + SAD_SEARCH,
               w - SAD_W - SAD_SEARCH - 1)
    xri = _clip(torch.round(ur0).long(), SAD_W + SAD_SEARCH,
                w - SAD_W - SAD_SEARCH - 1)
    base = lo * (h * w) + yi * w
    offs1 = torch.arange(*_OFFS1, device=dev)
    woffs = torch.arange(*_WOFFS, device=dev)
    lp = stack_l.reshape(-1)[(base + xi)[:, None] + offs1[None, :]]
    rwin = stack_r.reshape(-1)[(base + xri)[:, None] + woffs[None, :]]
    off_px, s_0 = _sad_offset(lp, rwin, xri, ur0)
    return _gate(feats_l, matched, ur0, off_px, s_0, scales[lo], bf, max_disp)


def match_stereo(feats_l: Features, feats_r: Features, level_imgs_l,
                 level_imgs_r, bf: float, min_z: float, cfg: OrbConfig
                 ) -> StereoMatch:
    """The matcher on pyramid lists (one (h_l, w_l) image per level): the
    SAD sweep runs on every level for every keypoint and each keypoint
    keeps its own level's result, as the reference does."""
    dev = feats_l.xy.device
    N = feats_l.xy.shape[0]
    scales = torch.tensor(cfg.level_scales(), dtype=torch.float32, device=dev)
    best, matched, max_disp = _descriptor_match(feats_l, feats_r, bf, min_z,
                                                scales)
    lo, ul, vl, ur0 = _level_coords(feats_l, feats_r, best, scales)
    offs1 = torch.arange(*_OFFS1, device=dev)
    woffs = torch.arange(*_WOFFS, device=dev)
    best_off = torch.zeros(N, dtype=torch.float32, device=dev)
    sad_best = torch.full((N,), float("inf"), dtype=torch.float32, device=dev)
    for l, (iml, imr) in enumerate(zip(level_imgs_l, level_imgs_r)):
        h, w = iml.shape
        yi = _clip(torch.round(vl).long(), SAD_W, h - SAD_W - 1)
        xi = _clip(torch.round(ul).long(), SAD_W + SAD_SEARCH,
                   w - SAD_W - SAD_SEARCH - 1)
        xri = _clip(torch.round(ur0).long(), SAD_W + SAD_SEARCH,
                    w - SAD_W - SAD_SEARCH - 1)
        lp = iml[yi[:, None], xi[:, None] + offs1[None, :]]
        rwin = imr[yi[:, None], xri[:, None] + woffs[None, :]]
        off_l, s_0 = _sad_offset(lp, rwin, xri, ur0)
        this = lo == l
        best_off = torch.where(this, off_l, best_off)
        sad_best = torch.where(this, s_0, sad_best)
    return _gate(feats_l, matched, ur0, best_off, sad_best, scales[lo], bf,
                 max_disp)
