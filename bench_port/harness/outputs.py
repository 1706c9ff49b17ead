"""What the program produced, copied to the host once the window has
closed: the tracked poses, the map's pools, the sampled keyframes' stored
features, the sparsification windows solved in the window and the
inertial state. The judge reads nothing else of it."""
from __future__ import annotations

import numpy as np
import torch

MAP_FIELDS = ("kf_valid", "kf_sparsified", "kf_frame_id", "kf_ord",
              "kp_xy", "kp_valid", "obs_mp", "mp_pos", "mp_valid",
              "mp_first_kf", "mp_first_ord")
KF_FIELDS = {"xy": "kp_xy", "octave": "kp_octave", "angle": "kp_angle",
             "desc": "kp_desc", "valid": "kp_valid", "u_right": "kp_uright",
             "depth": "kp_depth"}


class Windows:
    """The sparsification windows solved while installed: for each, the
    map as the port's `sparsify_window` was handed it (the fields the
    selection reads) and the valid mask it left, kept as device copies (no
    host sync inside the window), up to `limit` windows."""

    MAP = ("obs_mp", "kp_xy", "kf_valid", "mp_valid")

    def __init__(self, limit: int = 4):
        self.limit = limit
        self.solved: list = []
        self._mod = self._orig = None

    def install(self):
        from ms_slam_tpu_torch.pipeline import sparsification
        self._mod, self._orig = sparsification, sparsification.sparsify_window
        orig = self._orig

        def sparsify_window(ms, win_idx, win_mask, n_req, lam, lam_grid,
                            **kw):
            snap = None
            if len(self.solved) < self.limit:
                snap = {k: getattr(ms, k).clone() for k in self.MAP}
                snap.update(win_idx=win_idx.clone(),
                            win_mask=win_mask.clone(), n_req=int(n_req),
                            lam=float(lam), lam_grid=float(lam_grid), **kw)
            out = orig(ms, win_idx, win_mask, n_req, lam, lam_grid, **kw)
            if snap is not None:
                self.solved.append((snap, out.ms.mp_valid.clone()))
            return out

        sparsification.sparsify_window = sparsify_window

    def remove(self):
        if self._mod is not None:
            self._mod.sparsify_window = self._orig
            self._mod = None

    def host(self) -> list:
        return [({k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                  for k, v in snap.items()}, after.cpu())
                for snap, after in self.solved]


def capture(slam, fps: float, first_window_frame: int, seed: int,
            n_frontend: int) -> dict:
    ms = slam.ms

    def host(t):
        return np.array(t.cpu())        # a copy, also of a CPU tensor

    m = {k: host(getattr(ms, k)) for k in MAP_FIELDS}
    traj = [(int(round(ts * fps)), Twc) for ts, Twc in slam.poses_wc()]
    lost = sum(1 for e in slam.trajectory
               if e.lost and e.frame_id >= first_window_frame)
    # keyframes whose stored features the sparsifier has not compacted,
    # those of the window first; a sample drawn from the seed
    cand = np.flatnonzero(m["kf_valid"] & ~m["kf_sparsified"])
    late = cand[m["kf_frame_id"][cand] >= first_window_frame]
    pool = late if len(late) else cand
    rng = np.random.default_rng(seed ^ 0x5EED)
    pick = sorted(rng.choice(pool, min(n_frontend, len(pool)),
                             replace=False).tolist()) if len(pool) else []
    kfs = []
    for k in pick:
        kf = {a: host(getattr(ms, b)[k]) for a, b in KF_FIELDS.items()}
        kf["frame"] = int(m["kf_frame_id"][k])
        kfs.append(kf)
    out = {"map": m, "trajectory": traj, "lost_frames": lost,
           "frontend_kfs": kfs}
    if slam.cfg.use_imu:
        out["gravity"] = (None if slam.gravity is None
                          else np.asarray(slam.gravity, np.float64))
        out["imu_bias"] = np.asarray(slam.imu_bias, np.float64)
        # the velocities of the keyframes made in the window
        kfs = [k for k in np.flatnonzero(m["kf_valid"])
               if m["kf_frame_id"][k] >= first_window_frame]
        out["kf_vel"] = (np.array([m["kf_frame_id"][k] for k in kfs], int),
                         np.asarray(slam.kf_velocities, np.float64)[kfs])
        times = slam._kf_times
        out["imu_stage"] = int(slam._imu_stage)
        out["imu_baseline_s"] = (float(times[-1] - times[0]) if times
                                 else 0.0)
    return out
