"""Stereo frame processing front end.

Port of `ms_slam_tpu/pipeline/frontend.py` (rectified stereo): ORB on both
images in one batch over canvas-packed pyramids, then stereo matching.
The canvas stays float32 (the reference's bf16 canvas is a TPU bandwidth
choice, orb.py:743-744).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import orb, stereo


class Calib(NamedTuple):
    """Static camera calibration (the reference's fields, so configs carry
    over; the fisheye-stereo fields are accepted but not ported)."""

    model: int
    params: tuple
    bf: float
    width: int
    height: int
    th_depth: float = 35.0
    fps: float = 10.0
    params2: tuple = ()
    T_rl: tuple = ()
    lapping: tuple = ()

    def params_array(self, device=None):
        p = np.zeros(8, np.float32)
        p[:len(self.params)] = self.params
        return torch.from_numpy(p).to(device)

    @property
    def is_fisheye_stereo(self) -> bool:
        return len(self.T_rl) == 12

    @property
    def min_z(self) -> float:
        return max(self.bf / self.params[0], 0.1)


class FrameData(NamedTuple):
    """Device-resident per-frame working state (ref Frame object)."""

    feats: orb.Features
    u_right: torch.Tensor   # (N,)
    depth: torch.Tensor     # (N,)
    sigma2: torch.Tensor    # (N,) per-octave measurement variance


def process_stereo_stacked(imgs: torch.Tensor, calib: Calib,
                           orb_cfg: orb.OrbConfig) -> FrameData:
    """Stereo frontend on a stacked (2,H,W) uint8 pair."""
    return _process_stereo_impl(imgs[0], imgs[1], calib, orb_cfg)


def process_stereo(img_l: torch.Tensor, img_r: torch.Tensor,
                   calib: Calib, orb_cfg: orb.OrbConfig) -> FrameData:
    """Extract ORB on both images and stereo-match."""
    return _process_stereo_impl(img_l, img_r, calib, orb_cfg)


def _process_stereo_impl(img_l, img_r, calib: Calib,
                         orb_cfg: orb.OrbConfig) -> FrameData:
    imgs = torch.stack([img_l, img_r]).to(torch.float32)
    featsB, canvases = orb.extract_canvas_multi(imgs, orb_cfg)
    feats_l = orb.Features(*[a[0] for a in featsB])
    feats_r = orb.Features(*[a[1] for a in featsB])
    sm = stereo.match_stereo_canvas(feats_l, feats_r, canvases[0],
                                    canvases[1], imgs.shape[2],
                                    calib.bf, calib.min_z, orb_cfg)
    scale2 = torch.tensor([s * s for s in orb_cfg.level_scales()],
                          dtype=torch.float32, device=imgs.device)
    return FrameData(feats=feats_l, u_right=sm.u_right, depth=sm.depth,
                     sigma2=scale2[feats_l.octave])


def frame_data_from_numpy(d: dict, device=None) -> FrameData:
    """FrameData from the reference's fields as numpy arrays: keys xy,
    response, angle, octave, desc, valid, u_right, depth, sigma2 (desc
    uint32 words keep their bits as int32)."""
    def t(name, dtype=None):
        a = np.array(d[name], dtype=dtype)   # a private, writable copy
        if name == "desc":
            a = a.astype(np.uint32).view(np.int32)
        return torch.from_numpy(a).to(device)
    feats = orb.Features(xy=t("xy", np.float32),
                         response=t("response", np.float32),
                         angle=t("angle", np.float32),
                         octave=t("octave", np.int32), desc=t("desc"),
                         valid=t("valid", bool))
    return FrameData(feats=feats, u_right=t("u_right", np.float32),
                     depth=t("depth", np.float32),
                     sigma2=t("sigma2", np.float32))


def frame_data_to_numpy(fr: FrameData) -> dict:
    """Inverse of frame_data_from_numpy (desc back to uint32 words)."""
    out = {k: v.detach().cpu().numpy() for k, v in fr.feats._asdict().items()}
    out["desc"] = out["desc"].view(np.uint32)
    for k in ("u_right", "depth", "sigma2"):
        out[k] = getattr(fr, k).detach().cpu().numpy()
    return out
