"""4Seasons stereo-inertial driver (port of
examples/stereo_inertial_4season.py, after the reference system's
stereo_inertial_4season.cc).

4Seasons layout: <seq>/undistorted_images/cam0|cam1/<t_ns>.png,
<seq>/times.txt (id t_s ...), <seq>/imu.txt (t_ns gx gy gz ax ay az).

Usage: python -m ms_slam_tpu_torch.examples.stereo_inertial_4season
       <settings.yaml> <seq_dir> [--out traj.txt] [--max-frames N]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..pipeline.system import System
from ..utils.config import Settings
from ..utils.datasets import StereoFrame


def load_4season(seq):
    times = []
    with open(os.path.join(seq, "times.txt")) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = line.split()
            times.append((v[0], float(v[1])))
    imu = []
    imu_path = os.path.join(seq, "imu.txt")
    if os.path.exists(imu_path):
        with open(imu_path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = [float(x) for x in line.split()]
                imu.append([v[0] * 1e-9, v[4], v[5], v[6], v[1], v[2], v[3]])
    return times, np.asarray(imu) if imu else None


def frames_4season(seq, times, imu, n: int):
    """StereoFrames of the first n listed frames whose images read, each
    with the IMU rows [t, a, g] since the previous such frame (None without
    an imu.txt); images are read with cv2."""
    import cv2
    prev_t = None
    for i, (fid, ts) in enumerate(times):
        if i >= n:
            break
        l, r = (cv2.imread(os.path.join(seq, "undistorted_images", cam,
                                        f"{fid}.png"), cv2.IMREAD_GRAYSCALE)
                for cam in ("cam0", "cam1"))
        if l is None or r is None:
            continue
        rows = None
        if imu is not None and prev_t is not None:
            rows = imu[(imu[:, 0] > prev_t) & (imu[:, 0] <= ts)]
        prev_t = ts
        yield StereoFrame(ts, l.astype(np.float32), r.astype(np.float32),
                          rows)


def run(slam, frames, n: int):
    """Track the frames (IMU rows turned into [dt, a, g]), then shut the
    System down; returns the per-frame wall times (s)."""
    prev_t = None
    tt = []
    for i, fr in enumerate(frames):
        t0 = time.perf_counter()
        if fr.imu is not None and prev_t is not None:
            rows = fr.imu
            dts = np.diff(np.concatenate([[prev_t], rows[:, 0]])) \
                if len(rows) else np.zeros(0)
            rows = np.concatenate([dts[:, None], rows[:, 1:]], axis=1) \
                if len(rows) else np.zeros((0, 7))
            slam.track_stereo_imu(fr.left, fr.right, fr.timestamp, rows)
        else:
            slam.track_stereo(fr.left, fr.right, fr.timestamp)
        prev_t = fr.timestamp
        tt.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}/{n} state={slam.state} "
                  f"kf={slam.keyframes_in_map()} "
                  f"mp={slam.map_points_in_map()} "
                  f"compressed={slam.compressed_map_points_in_map()}",
                  file=sys.stderr)
    slam.shutdown()
    return tt


def main(argv=None):
    """Run the driver; returns the System."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--out", default="CameraTrajectory_4s.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the System (cpu only on request)")
    args = ap.parse_args(argv)

    st = Settings(args.settings)
    cfg = st.system_config()
    times, imu = load_4season(args.seq_dir)
    cfg.use_imu = imu is not None
    slam = System(cfg, device=args.device)
    n = len(times) if args.max_frames is None else min(len(times),
                                                       args.max_frames)
    tt = run(slam, frames_4season(args.seq_dir, times, imu, n), n)
    slam.save_trajectory_tum(args.out)
    print(f"mean tracking time: {np.mean(tt[3:]):.4f}")
    print(f"trajectory saved to {args.out}")
    return slam


if __name__ == "__main__":
    main()
