"""A rehearsal of a TUM-VI stereo-inertial fisheye cell on the card, through
the harness's own run, with no file of the benchmark added: the rig of
`configs/TUM-VI-Fisheye.yaml` (two unrectified Kannala-Brandt8 cameras at
512x512, 1024 features, 8 levels, 20 Hz, the full `Stereo.T_c1_c2`), the
IMU block of `configs/EuRoC-Inertial.yaml` (200 Hz, its noise densities and
`T_b_c1`) set through the configuration's `settings` fields, and a
handheld walk down the EuRoC corridor at 0.05 m a frame with sway, bob,
yaw, pitch and roll.

    python bench_port/tests/rehearse_kb8.py \
        --fault <none|control|name> [...] --seconds <s> --seeds <n> [...]

Prints one JSON line per run, as `read_faults.py` does, with frames/s and
the peak device memory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)

import read_faults  # noqa: E402

# configs/EuRoC-Inertial.yaml's IMU block, as SystemConfig fields
EUROC_IMU = {
    "use_imu": True,
    "imu_noise_gyro": 1.7e-04,
    "imu_noise_acc": 2.0e-03,
    "imu_gyro_walk": 1.9393e-05,
    "imu_acc_walk": 3.0e-03,
    "Tbc": [0.0148655429818, -0.999880929698, 0.00414029679422,
            -0.0216401454975, 0.999557249008, 0.0149672133247,
            0.025715529948, -0.064676986768, -0.0257744366974,
            0.00375618835797, 0.999660727178, 0.00981073058949,
            0.0, 0.0, 0.0, 1.0],
}

WALK = {"speed_m_per_frame": 0.05,
        "lateral_m": {"amp": 0.08, "hz": 0.8, "phase": 1.0},
        "vertical_m": {"amp": 0.05, "hz": 1.7},
        "yaw_rad": {"amp": 0.1, "hz": 0.25},
        "pitch_rad": {"amp": 0.05, "hz": 0.4, "phase": 0.5},
        "roll_rad": {"amp": 0.04, "hz": 0.3, "phase": 2.0}}

# the corridor's numbers and the drive's map number, at their limits
LIMITS = {"frontend_mismatch_pct": {"max": 40.0}, "ate_pct": {"max": 2.0},
          "lost_frames": {"max": 0}, "map_err_p90_pct": {"max": 15.0},
          "gravity_angle_deg": {"max": 18.19},
          "velocity_err_pct": {"max": 35.0}}


def rehearsal(yaml_path: str = os.path.join(REPO, "configs",
                                            "TUM-VI-Fisheye.yaml")):
    """(cell, config, traffic) of the rehearsal: the corridor cell's files
    with the rig of `yaml_path` (by default TUM-VI's), the EuRoC IMU block
    and the walk."""
    from bench_port.harness import registry
    cfg = registry.config("euroc-stereo-inertial")
    cfg["yaml_path"] = yaml_path
    for field, value in EUROC_IMU.items():
        if field == "Tbc":
            value = np.asarray(value, np.float64).reshape(4, 4)
        cfg["settings"][field] = {"field": field, "value": value}
    traffic = registry.traffic("corridor")
    traffic["motion"] = dict(WALK)
    cell = {"name": "tumvi-stereo-inertial.walk", "frontend_kfs": 3,
            "limits": LIMITS}
    return cell, cfg, traffic


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fault", nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not read_faults.card_ready():
        return 3
    cell, cfg, traffic = rehearsal()
    for rec in read_faults.read(cell, args.fault, args.seconds, args.seeds,
                                cfg=cfg, traffic=traffic):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
