"""The numbers that decide `correct`, each worked out from the run's inputs
(the rendered pairs, the ground-truth poses and scene, the true IMU bias)
and compared with what the program produced. Plain numpy, and the plain
frontend of `frontend.py` and plain selection of `select.py`; nothing of
the port is imported and nothing the port made is taken, bar the outputs
under judgement.

- `frontend_mismatch_pct`: sampled keyframes' stored features (keypoint,
  level, angle, descriptor, stereo depth) against the plain frontend on the
  same pair, slot by slot: `frontend.py`'s rectified matcher for a pinhole
  rig, `fisheye.py`'s two-view triangulation for a KB8 one;
- `ate_pct`, `lost_frames`: the tracked poses against the ground truth;
- `map_err_p90_pct`: live map points against the surface point their first
  keyframe's keypoint sees in the scene, along the ray of the rig's own
  lens (for a KB8 rig the renderer's own inverse of the lens);
- `select_diff_pct`, `select_gap_pct`: each sparsification window solved in
  the window, worked out again by the plain selection from the map the
  port's selector was handed: the share of the window's points kept by one
  side only, and how far the port's selection cost lies above the plain
  one's;
- inertial: gravity's angle from the ground truth's, the velocities of the
  window's keyframes against the ground-truth body's, both biases against
  the rows' true ones.
"""
from __future__ import annotations

import numpy as np

from ..scenes.evaluate import ate_rmse
from ..scenes.fisheye import kb8_bearings
from ..scenes.motion import body_velocity
from . import fisheye, frontend, select

NUMBERS = ("frontend_mismatch_pct", "ate_pct", "lost_frames",
           "map_err_p90_pct", "select_diff_pct", "select_gap_pct",
           "gravity_angle_deg", "velocity_err_pct", "gyro_bias_err",
           "accel_bias_err")


def frontend_mismatch(prog: dict, ref: dict) -> tuple[int, int]:
    """Slots where either side holds a feature, and how many of them differ
    (validity, position beyond 1e-3 px, level, angle beyond 1e-4 rad,
    descriptor, stereo match, depth beyond 1e-4 relative)."""
    pv, rv = prog["valid"].astype(bool), ref["valid"].astype(bool)
    used = pv | rv
    both = pv & rv
    bad = pv != rv
    bad |= both & (np.abs(prog["xy"] - ref["xy"]).max(1) > 1e-3)
    bad |= both & (prog["octave"] != ref["octave"])
    dang = np.abs(np.angle(np.exp(1j * (prog["angle"] - ref["angle"]))))
    bad |= both & (dang > 1e-4)
    bad |= both & np.any(prog["desc"] != ref["desc"], axis=1)
    pd, rd = prog["depth"], ref["depth"]
    bad |= both & ((pd > 0) != (rd > 0))
    bad |= both & (pd > 0) & (rd > 0) & (np.abs(pd - rd) > 1e-4 * rd)
    return int(bad.sum()), int(used.sum())


def ray_cast(world: dict, T_wc: np.ndarray, rays_c: np.ndarray):
    """(n, 3) world points where the (n, 3) camera rays from the poses
    (n, 4, 4) first meet the corridor's planes (nan where none)."""
    d = np.einsum("nij,nj->ni", T_wc[:, :3, :3], rays_c)
    O = T_wc[:, :3, 3]
    best = np.full(len(d), np.inf)
    planes = [(0, world.get("half_w", 3.0)), (0, -world.get("half_w", 3.0)),
              (1, world.get("y_floor", 1.6)), (1, world.get("y_ceil", -2.2))]
    for ax, val in planes:
        da = d[:, ax]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(np.abs(da) > 1e-9, (val - O[:, ax]) / da, -1.0)
        ok = (t > 0.1) & (t < best)
        best = np.where(ok, t, best)
    X = O + best[:, None] * d
    X[~np.isfinite(best)] = np.nan
    return X


def alignment(first_gt: np.ndarray, first_est: np.ndarray) -> np.ndarray:
    """The transform from the System's world to the ground truth's, through
    the first tracked frame (T_wc in each)."""
    return first_gt @ np.linalg.inv(first_est)


def keypoint_rays(camera: dict, xy: np.ndarray) -> np.ndarray:
    """(n, 3) camera rays of the left image's keypoints (n, 2) by the rig's
    lens: z = 1 rays of a pinhole camera, unit bearings of a KB8 one."""
    if camera["model"] == "kb8":
        import torch
        xy_t = torch.from_numpy(xy)
        return kb8_bearings(camera["params"], xy_t[:, 0],
                            xy_t[:, 1]).numpy()
    return np.stack([(xy[:, 0] - camera["cx"]) / camera["fx"],
                     (xy[:, 1] - camera["cy"]) / camera["fy"],
                     np.ones(len(xy))], 1)


def map_error(run: dict, inp, A: np.ndarray) -> np.ndarray:
    """Per live map point with its first keyframe's observation: the
    distance to the scene point that keypoint sees from the ground-truth
    pose, over that point's distance from the camera, in percent."""
    ms = run["map"]
    kf_ok = ms["kf_valid"]
    cam = inp.camera
    pts, rays, poses = [], [], []
    for k in np.flatnonzero(kf_ok):
        row = ms["obs_mp"][k]
        n = np.flatnonzero(row >= 0)
        p = row[n]
        mine = (ms["mp_valid"][p] & (ms["mp_first_kf"][p] == k)
                & (ms["mp_first_ord"][p] == ms["kf_ord"][k]))
        n, p = n[mine], p[mine]
        if not len(p):
            continue
        rays.append(keypoint_rays(cam, ms["kp_xy"][k][n].astype(np.float64)))
        f = int(ms["kf_frame_id"][k])
        poses.append(np.repeat(inp.poses[f][None], len(p), 0))
        pts.append(ms["mp_pos"][p].astype(np.float64))
    if not pts:
        return np.zeros(0)
    T = np.concatenate(poses)
    X_gt = ray_cast(inp.world, T, np.concatenate(rays))
    X = np.concatenate(pts) @ A[:3, :3].T + A[:3, 3]
    dist = np.linalg.norm(X_gt - T[:, :3, 3], axis=1)
    err = np.linalg.norm(X - X_gt, axis=1) / dist * 100.0
    return err[np.isfinite(err)]


def selection(windows: list, device) -> dict:
    """The plain selection of each captured window against the port's."""
    import torch
    out = {"select_windows": len(windows)}
    if not windows:
        return out
    differ = points = 0
    gaps, kept = [], []
    for snap, after in windows:
        w = select.Window(**{k: (v.to(device) if isinstance(v, torch.Tensor)
                                 else v) for k, v in snap.items()})
        r = select.judge_window(w, after.to(device))
        differ += r["differ"]
        points += r["points"]
        gaps.append(100.0 * (r["objective_prog"] - r["objective_ref"])
                    / max(r["objective_ref"], 1e-9))
        kept.append((r["kept_prog"], r["kept_ref"], r["points"]))
    out["select_diff_pct"] = 100.0 * differ / max(points, 1)
    out["select_gap_pct"] = max(gaps)
    out["select_kept"] = kept
    return out


def judge(run: dict, inp, orb: frontend.Orb, device) -> dict:
    """Every number of the cell, worked out again from the inputs."""
    out = {}
    # frontend: the sampled keyframes against the plain frontend
    bad = used = 0
    cam = inp.camera
    for kf in run["frontend_kfs"]:
        left, right = inp.frames[kf["frame"]]
        if cam["model"] == "kb8":
            ref = fisheye.stereo_fisheye_frontend(left, right, orb, cam,
                                                  device)
        else:
            ref = frontend.stereo_frontend(left, right, orb, cam["bf"],
                                           cam["fx"], device)
        b, u = frontend_mismatch(kf, ref)
        bad += b
        used += u
    out["frontend_mismatch_pct"] = 100.0 * bad / max(used, 1)
    out["frontend_kfs"] = len(run["frontend_kfs"])

    # tracking: every tracked frame against the ground truth
    traj = run["trajectory"]
    ids = np.array([f for f, _ in traj], int)
    est = np.array([T for _, T in traj])
    gt = inp.poses[ids]
    path = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    out["ate_pct"] = (100.0 * ate_rmse(est[:, :3, 3], gt[:, :3, 3])
                      / max(path, 1e-9))
    out["lost_frames"] = run["lost_frames"]

    # mapping: live points against the scene
    A = alignment(gt[0], est[0])
    err = map_error(run, inp, A)
    out["map_err_p90_pct"] = (float(np.percentile(err, 90)) if len(err)
                              else float("inf"))
    out["map_points_checked"] = int(len(err))

    # sparsification: the windows solved again
    out.update(selection(run.get("windows", []), device))

    # inertial state, in the ground truth's world through the alignment
    if inp.imu is not None:
        def angle(g):
            g = A[:3, :3] @ np.asarray(g, np.float64)
            return float(np.degrees(np.arccos(np.clip(
                g[1] / max(np.linalg.norm(g), 1e-12), -1, 1))))

        out["gravity_angle_deg"] = angle(run["gravity"]
                                         if run["gravity"] is not None
                                         else np.zeros(3))
        out["gravity_log"] = [(f, round(angle(g), 3))
                              for f, g in run.get("gravity_log", [])]
        frames, vel = run["kf_vel"]
        if len(frames):
            v_gt = body_velocity(inp.poses, inp.T_bc, inp.fps, frames)
            d = vel @ A[:3, :3].T - v_gt
            out["velocity_err_pct"] = float(
                100.0 * np.sqrt((d ** 2).sum(1).mean())
                / max(np.sqrt((v_gt ** 2).sum(1).mean()), 1e-9))
        out["velocity_kfs"] = int(len(frames))
        bias = np.asarray(run["imu_bias"], np.float64)
        out["gyro_bias_err"] = float(np.linalg.norm(bias[:3] - inp.bias[:3]))
        out["accel_bias_err"] = float(np.linalg.norm(bias[3:]
                                                     - inp.bias[3:]))
        out["imu_stage"] = run["imu_stage"]
        out["imu_baseline_s"] = run["imu_baseline_s"]
    return out
