"""EuRoC stereo driver (port of examples/stereo_euroc.py, after the
reference system's stereo_euroc.cc).

Usage: python -m ms_slam_tpu_torch.examples.stereo_euroc <settings.yaml>
       <mav0_dir> [--out traj.txt] [--max-frames N] [--device cuda]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..pipeline.system import System
from ..utils import native
from ..utils.config import Settings
from ..utils.datasets import EurocStereo, with_lookahead

RECT_KEYS = ("K_l", "K_r", "D_l", "D_r", "R_l", "R_r", "P_l", "P_r")


def rectification(st: Settings):
    """The settings' stereo rectification for EurocStereo, or None where
    the file has none (images already rectified)."""
    if not all(k in st.flat for k in RECT_KEYS):
        return None
    rect = {k: st.flat[k] for k in RECT_KEYS}
    rect["rows"] = st.get("LEFT.height", "Camera.height", required=True)
    rect["cols"] = st.get("LEFT.width", "Camera.width", required=True)
    return rect


def run(slam, frames, n: int):
    """Track the first n stereo frames, then shut the System down; returns
    the per-frame wall times (s)."""
    times = []
    for i, (fr, nxt) in enumerate(with_lookahead(frames)):
        if i >= n:
            break
        t0 = time.perf_counter()
        slam.track_stereo(fr.left, fr.right, fr.timestamp, next_images=nxt)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            print(f"frame {i}/{n} state={slam.state} "
                  f"kf={slam.keyframes_in_map()} "
                  f"mp={slam.map_points_in_map()}", file=sys.stderr)
    slam.shutdown()
    return times


def main(argv=None):
    """Run the driver; returns the System."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("mav_dir")
    ap.add_argument("--out", default="CameraTrajectory_euroc.txt")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the System (cpu only on request)")
    args = ap.parse_args(argv)

    st = Settings(args.settings)
    cfg = st.system_config()
    ds = EurocStereo(args.mav_dir, rect_from_settings=rectification(st))
    slam = System(cfg, device=args.device)
    print(f"native prefetch: {'ON' if native.available() else 'off'}",
          file=sys.stderr)
    n = len(ds) if args.max_frames is None else min(len(ds), args.max_frames)
    times = run(slam, ds.frames(), n)
    slam.save_trajectory_tum(args.out)
    print(f"mean tracking time: {np.mean(times[3:]):.4f}")
    print(f"trajectory saved to {args.out}")
    return slam


if __name__ == "__main__":
    main()
