"""Faults planted in the port's timed path, each of which a cell's
`correct` has to catch: the CPU tests plant them at a small size, and
`read_faults.py` reads them on the card at a cell's own size. A run of the
benchmark never loads this module.

`plant(name, setattr, setenv)` installs one through `setattr(owner,
attribute, value)` (pytest's `monkeypatch.setattr`, or the builtin for a
process that ends after the reading); "control" is the program's own
lower-precision path, the bf16 canvas, switched on through `setenv`.
"""
from __future__ import annotations

import os

import torch


def _track_frozen(setattr):
    """The tracking step, visual or inertial, returns the pose it was
    given."""
    from ms_slam_tpu_torch.pipeline import tracking_ops as to

    def freeze(orig):
        def frozen(ms, calib, orb_cfg, frame, R_last, t_last, *a, **k):
            out = orig(ms, calib, orb_cfg, frame, R_last, t_last, *a, **k)
            stats = out.stats.clone()
            stats[:9] = R_last.reshape(9)
            stats[9:12] = t_last
            return out._replace(R=R_last, t=t_last, stats=stats)
        return frozen

    setattr(to, "track_full", freeze(to.track_full))
    setattr(to, "track_full_imu", freeze(to.track_full_imu))


def _descriptor_flip(setattr):
    """Each descriptor has one bit flipped where it is produced."""
    from ms_slam_tpu_torch.ops import orb
    orig = orb.descriptors_from_patches
    setattr(orb, "descriptors_from_patches",
            lambda patches, angle: orig(patches, angle) ^ 1)


def _right_dropped(setattr):
    """From the tenth frame on, the stereo batch's right image is left out:
    its features come back invalid, so no keypoint gets a stereo depth."""
    from ms_slam_tpu_torch.pipeline import frontend
    orig = frontend._extract
    calls = []

    def half(imgs, orb_cfg):
        feats, canvases = orig(imgs, orb_cfg)
        calls.append(1)
        if len(feats) == 2 and len(calls) > 10:
            feats[1] = feats[1]._replace(
                valid=torch.zeros_like(feats[1].valid))
        return feats, canvases

    setattr(frontend, "_extract", half)


def _select_first_n(setattr):
    """The selector keeps, for each row, the first observations up to the
    row's requirement, in slot order."""
    from ms_slam_tpu_torch.ops import select
    orig = select.select_points

    def first_n(obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf, **kw):
        res = orig(obs_pt, obs_cell, obs_valid, cost, p_valid, req_kf, **kw)
        P = cost.shape[0]
        ok = obs_valid & (obs_pt >= 0)
        rank = torch.cumsum(ok.to(torch.int32), 1) - 1
        take = ok & (rank < req_kf[:, None])
        keep = torch.zeros(P + 1, dtype=torch.bool, device=cost.device)
        keep[torch.where(take, obs_pt, P).long().reshape(-1)] = True
        keep = keep[:P] & p_valid
        cover = (keep[obs_pt.clamp(0, P - 1).long()] & ok).sum(1)
        return res._replace(keep=keep, kf_cover=cover.to(torch.int32))

    setattr(select, "select_points", first_n)


def _imu_rows_halved(setattr):
    """Every second IMU row of a preintegration is left out."""
    from ms_slam_tpu_torch.ops import imu
    orig = imu.integrate

    def halved(bias, meas, valid, *a, **k):
        every = torch.arange(meas.shape[-2], device=meas.device) % 2 == 0
        return orig(bias, meas, valid & every, *a, **k)

    setattr(imu, "integrate", halved)


FAULTS = {"track_frozen": _track_frozen,
          "descriptor_flip": _descriptor_flip,
          "right_dropped": _right_dropped,
          "select_first_n": _select_first_n,
          "imu_rows_halved": _imu_rows_halved}


def plant(name: str, setattr=setattr, setenv=os.environ.__setitem__):
    """Install the fault `name`, or the control."""
    if name == "control":
        setenv("MSSLAM_FORCE_TPU_NUMERICS", "1")
    else:
        FAULTS[name](setattr)
