"""Frame processing front ends: rectified stereo, stereo fisheye, RGB-D and
monocular.

Port of `ms_slam_tpu/pipeline/frontend.py`. ORB runs over canvas-packed
pyramids, both images of a pair in one batch; then, by sensor:
- rectified stereo: row-band stereo matching with SAD refinement;
- stereo fisheye (two Kannala-Brandt8 cameras, unrectified): mutual
  descriptor matching inside the lapping areas with the rotation histogram,
  DLT triangulation of the matched bearings polished by two Gauss-Newton
  steps over both reprojections, then depth and reprojection gates;
- RGB-D: each keypoint reads the registered depth map and gets a virtual
  right coordinate u - bf/d;
- monocular: features only.
The canvas is float32, or bfloat16 under MSSLAM_FORCE_TPU_NUMERICS=1 (the
reference's TPU numerics, orb.py:743-744); every frontend hands it on as it
is, and only `ops/orb.py` and `ops/stereo.py` widen what they read of it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cameras, lie, matching, orb, stereo, triangulate


class Calib(NamedTuple):
    """Static camera calibration (the reference's fields, so configs carry
    over). For an unrectified stereo-fisheye pair (two KB8 cameras),
    params2 / T_rl / lapping describe the second camera: T_rl maps LEFT-
    camera coordinates into RIGHT-camera ones (12 floats, row-major [R|t]),
    lapping = (x0_l, x1_l, x0_r, x1_r) pixel columns."""

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

    def params2_array(self, device=None):
        """The second camera's parameters (the first's when there are
        none), zero-padded to 8."""
        p = np.zeros(8, np.float32)
        src = self.params2 if self.params2 else self.params
        p[:len(src)] = src
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


def _extract(imgs: torch.Tensor, orb_cfg: orb.OrbConfig):
    """ORB over a (B,H,W) stack in one batch: each image's Features and the
    canvases."""
    featsB, canvases = orb.extract_canvas_multi(imgs.to(torch.float32),
                                                orb_cfg)
    return [orb.Features(*[a[b] for a in featsB])
            for b in range(imgs.shape[0])], canvases


def _scale2(orb_cfg: orb.OrbConfig, device):
    return torch.tensor([s * s for s in orb_cfg.level_scales()],
                        dtype=torch.float32, device=device)


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
    imgs = torch.stack([img_l, img_r])
    (feats_l, feats_r), canvases = _extract(imgs, orb_cfg)
    sm = stereo.match_stereo_canvas(feats_l, feats_r, canvases[0],
                                    canvases[1], imgs.shape[2],
                                    calib.bf, calib.min_z, orb_cfg)
    return FrameData(feats=feats_l, u_right=sm.u_right, depth=sm.depth,
                     sigma2=_scale2(orb_cfg, imgs.device)[feats_l.octave])


def process_stereo_fisheye(imgs: torch.Tensor, calib: Calib,
                           orb_cfg: orb.OrbConfig) -> FrameData:
    """Unrectified stereo-fisheye frontend on a stacked (2,H,W) uint8 pair
    of KB8 images. Matched features get a triangulated left-camera depth;
    u_right stays -1 (there is no rectified right coordinate), so every
    residual downstream is a monocular one."""
    dev = imgs.device
    (f_l, f_r), _ = _extract(imgs, orb_cfg)

    x0l, x1l, x0r, x1r = (calib.lapping if len(calib.lapping) == 4
                          else (0, calib.width, 0, calib.width))
    lap_l = (f_l.xy[:, 0] >= x0l) & (f_l.xy[:, 0] <= x1l)
    lap_r = (f_r.xy[:, 0] >= x0r) & (f_r.xy[:, 0] <= x1r)
    mm = matching.mutual_match(
        f_l.desc, f_l.valid & lap_l, f_r.desc, f_r.valid & lap_r,
        max_dist=matching.TH_LOW, nn_ratio=0.9,
        angle_a=f_l.angle, angle_b=f_r.angle)
    has = mm.idx_b >= 0
    ib = mm.idx_b.clamp(min=0).long()

    # KB8 triangulation in the left camera frame
    T = torch.tensor(calib.T_rl, dtype=torch.float32, device=dev).reshape(3, 4)
    R_rl, t_rl = T[:, :3], T[:, 3]
    p1 = calib.params_array(dev)
    p2 = calib.params2_array(dev)
    b_l = cameras.kb8_unproject(p1, f_l.xy)
    b_r = cameras.kb8_unproject(p2, f_r.xy)[ib]
    N = b_l.shape[0]
    P1 = torch.cat([torch.eye(3, device=dev),
                    torch.zeros((3, 1), device=dev)], 1).expand(N, 3, 4)
    X = triangulate.triangulate_dlt(b_l, b_r, P1, T.expand(N, 3, 4))
    scale2 = _scale2(orb_cfg, dev)
    s2_l = scale2[f_l.octave.long()]
    s2_r = scale2[f_r.octave.long()][ib]

    # Gauss-Newton polish of each point over BOTH reprojections (the
    # bearing DLT minimizes an algebraic error, which biases depth several
    # percent at narrow disparity)
    xy_r = f_r.xy[ib]
    wl = (1.0 / torch.clamp(s2_l, min=1e-9))[:, None, None]
    wr = (1.0 / torch.clamp(s2_r, min=1e-9))[:, None, None]
    eye = torch.eye(3, device=dev)

    def gn_step(X):
        r1 = cameras.kb8_project(p1, X) - f_l.xy
        J1 = cameras.kb8_project_jac(p1, X)
        Xr_ = X @ R_rl.T + t_rl
        r2 = cameras.kb8_project(p2, Xr_) - xy_r
        J2 = cameras.kb8_project_jac(p2, Xr_) @ R_rl
        Hm = ((J1 * wl).transpose(1, 2) @ J1
              + (J2 * wr).transpose(1, 2) @ J2 + 1e-6 * eye)
        g = (torch.einsum("nij,ni->nj", J1 * wl, r1)
             + torch.einsum("nij,ni->nj", J2 * wr, r2))
        return X - torch.einsum("nij,nj->ni", lie.inv3x3(Hm), g)

    X = gn_step(gn_step(X))
    z_l = X[:, 2]
    Xr = X @ R_rl.T + t_rl
    z_r = Xr[:, 2]
    e_l = torch.sum((cameras.kb8_project(p1, X) - f_l.xy) ** 2, -1)
    e_r = torch.sum((cameras.kb8_project(p2, Xr) - xy_r) ** 2, -1)
    min_z = 0.05
    good = (has & (z_l > min_z) & (z_r > min_z)
            & (e_l < 5.991 * s2_l) & (e_r < 5.991 * s2_r))
    depth = torch.where(good, z_l, torch.full_like(z_l, -1.0))
    return FrameData(feats=f_l, u_right=torch.full((N,), -1.0, device=dev),
                     depth=depth, sigma2=s2_l)


def process_rgbd(img: torch.Tensor, depth_map: torch.Tensor, calib: Calib,
                 orb_cfg: orb.OrbConfig) -> FrameData:
    """RGB-D frame: ORB on the grey image; each keypoint reads its depth
    from the registered depth map (metres) at its rounded pixel (half to
    even, as jnp.round) and gets a virtual right coordinate u - bf/d."""
    (feats,), _ = _extract(img[None], orb_cfg)
    h, w = depth_map.shape
    ui = torch.round(feats.xy[:, 0]).to(torch.int64).clamp(0, w - 1)
    vi = torch.round(feats.xy[:, 1]).to(torch.int64).clamp(0, h - 1)
    d = depth_map[vi, ui]
    ok = (d > 0.05) & feats.valid
    neg = torch.full_like(d, -1.0)
    depth = torch.where(ok, d, neg)
    # a true division: `float / tensor` is `reciprocal() * float` in torch
    u_right = torch.where(ok, feats.xy[:, 0] - torch.full_like(d, calib.bf)
                          / torch.clamp(d, min=1e-6), neg)
    return FrameData(feats=feats, u_right=u_right, depth=depth,
                     sigma2=_scale2(orb_cfg, img.device)[feats.octave.long()])


def process_mono(img: torch.Tensor, calib: Calib,
                 orb_cfg: orb.OrbConfig) -> FrameData:
    """Monocular frame: features only, no depth."""
    del calib
    (feats,), _ = _extract(img[None], orb_cfg)
    n = feats.xy.shape[0]
    neg = torch.full((n,), -1.0, device=img.device)
    return FrameData(feats=feats, u_right=neg, depth=neg.clone(),
                     sigma2=_scale2(orb_cfg, img.device)[feats.octave.long()])


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
