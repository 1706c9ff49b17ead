"""ATE evaluation CLI (the reference system's evaluate_ate_scale.py).

Usage: python -m ms_slam_tpu_torch.examples.evaluate_ate <gt.txt> <est.txt>
       [--scale] [--max-dt 0.02]
Both files TUM format: t tx ty tz qx qy qz qw (gt may be EuRoC csv).
Port of examples/evaluate_ate.py on the port's `utils.evaluate`.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils.evaluate import associate, ate_rmse


def read_tum(path):
    ts, xyz = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            v = line.replace(",", " ").split()
            t = float(v[0])
            if t > 1e14:   # EuRoC ns
                t *= 1e-9
            ts.append(t)
            xyz.append([float(v[1]), float(v[2]), float(v[3])])
    return np.asarray(ts), np.asarray(xyz)


def main(argv=None) -> float:
    """Print the report; returns the RMSE in metres."""
    ap = argparse.ArgumentParser()
    ap.add_argument("gt")
    ap.add_argument("est")
    ap.add_argument("--scale", action="store_true")
    ap.add_argument("--max-dt", type=float, default=0.02)
    args = ap.parse_args(argv)

    t_gt, gt = read_tum(args.gt)
    t_est, est = read_tum(args.est)
    ie, ig = associate(t_est, t_gt, args.max_dt)
    if len(ie) < 2:
        print("too few associations", file=sys.stderr)
        sys.exit(1)
    rmse = ate_rmse(est[ie], gt[ig], with_scale=args.scale)
    print(f"compared_pose_pairs {len(ie)} pairs")
    print(f"absolute_translational_error.rmse {rmse:.6f} m")
    return rmse


if __name__ == "__main__":
    main()
