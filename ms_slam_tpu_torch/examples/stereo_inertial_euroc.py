"""EuRoC stereo-inertial driver (port of examples/stereo_inertial_euroc.py,
after the reference system's stereo_inertial_euroc.cc, which hands each
frame the IMU measurements since the previous one).

Usage: python -m ms_slam_tpu_torch.examples.stereo_inertial_euroc
       <settings.yaml> <mav0_dir> [--out traj.txt] [--max-frames N]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..pipeline.system import System
from ..utils.config import Settings
from ..utils.datasets import EurocStereo
from .stereo_euroc import rectification


def run(slam, frames, n: int):
    """Track the first n frames (frame IMU rows [t, a, g] turned into
    [dt, a, g] since the previous frame), then shut the System down;
    returns the per-frame wall times (s)."""
    times = []
    prev_t = None
    for i, fr in enumerate(frames):
        if i >= n:
            break
        t0 = time.perf_counter()
        if fr.imu is not None and len(fr.imu) and prev_t is not None:
            ts = fr.imu[:, 0]
            dts = np.diff(np.concatenate([[prev_t], ts]))
            rows = np.concatenate([dts[:, None], fr.imu[:, 1:]], axis=1)
            slam.track_stereo_imu(fr.left, fr.right, fr.timestamp, rows)
        else:
            slam.track_stereo(fr.left, fr.right, fr.timestamp)
        prev_t = fr.timestamp
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}/{n} state={slam.state} "
                  f"kf={slam.keyframes_in_map()} "
                  f"imu_init={slam.imu_initialized}", file=sys.stderr)
    slam.shutdown()
    return times


def main(argv=None):
    """Run the driver; returns the System."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("mav_dir")
    ap.add_argument("--out", default="CameraTrajectory_vi.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the System (cpu only on request)")
    args = ap.parse_args(argv)

    st = Settings(args.settings)
    cfg = st.system_config()
    cfg.use_imu = True
    ds = EurocStereo(args.mav_dir, rect_from_settings=rectification(st),
                     with_imu=True)
    slam = System(cfg, device=args.device)
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    times = run(slam, ds, n)
    slam.save_trajectory_tum(args.out)
    print(f"mean tracking time: {np.mean(times[3:]):.4f}")
    print(f"imu initialized: {slam.imu_initialized}")
    print(f"trajectory saved to {args.out}")
    return slam


if __name__ == "__main__":
    main()
