"""KITTI stereo driver.

Port of examples/stereo_kitti.py, after the reference system's
stereo_kitti.cc: load the sequence, track every pair, sample resident
memory per frame (VmRSS from /proc/self/status), print peak memory and mean
tracking time, save the KITTI-format trajectory.

Usage: python -m ms_slam_tpu_torch.examples.stereo_kitti <settings.yaml>
       <sequence_dir> [--out traj.txt] [--max-frames N] [--max-kf K]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..pipeline.system import System
from ..utils import native
from ..utils.config import Settings
from ..utils.datasets import KittiOdometry, with_lookahead


def mem_usage_mb() -> float:
    """VmRSS in MB (the reference driver's mem_usage)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return float(line.split()[1]) / 1024.0
    return 0.0


def run(slam, frames, n: int):
    """Track the first n stereo frames, then shut the System down; returns
    the per-frame wall times (s) and resident memory samples (MB)."""
    times, mems = [], []
    # the NEXT pair rides into track_stereo, as in the reference's driver
    for i, (fr, nxt) in enumerate(with_lookahead(frames)):
        if i >= n:
            break
        t0 = time.perf_counter()
        slam.track_stereo(fr.left, fr.right, fr.timestamp, next_images=nxt)
        times.append(time.perf_counter() - t0)
        mems.append(mem_usage_mb())
        if i % 50 == 0:
            print(f"frame {i}/{n} state={slam.state} "
                  f"kf={slam.keyframes_in_map()} "
                  f"mp={slam.map_points_in_map()} "
                  f"compressed={slam.compressed_map_points_in_map()} "
                  f"mem={mems[-1]:.0f}MB", file=sys.stderr)
    slam.shutdown()
    return times, mems


def main(argv=None):
    """Run the driver; returns the System."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--max-kf", type=int, default=512)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the System (cpu only on request)")
    args = ap.parse_args(argv)

    st = Settings(args.settings)
    cfg = st.system_config(max_kf=args.max_kf)
    ds = KittiOdometry(args.sequence)
    slam = System(cfg, device=args.device)
    print(f"native prefetch: {'ON' if native.available() else 'off'}",
          file=sys.stderr)
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    times, mems = run(slam, ds.frames(), n)
    slam.save_trajectory_kitti(args.out)
    # the reference driver's report
    times = np.asarray(times[3:])
    print("-------")
    print(f"mean tracking time: {times.mean():.4f}")
    print(f"median tracking time: {np.median(times):.4f}")
    print(f"max memory usage: {max(mems):.1f} MB")
    print(f"map points: {slam.map_points_in_map()}")
    print(f"compressed map points: {slam.compressed_map_points_in_map()}")
    stats = slam.memory_stats()
    print(f"map memory reduction (measured): {stats['reduction']*100:.1f}% "
          f"({stats['live_bytes']/1e6:.2f} MB live map vs "
          f"{stats['without_sparsification_bytes']/1e6:.2f} MB had the "
          f"selector kept every point/slot)")
    print(f"trajectory saved to {args.out}")
    return slam


if __name__ == "__main__":
    main()
