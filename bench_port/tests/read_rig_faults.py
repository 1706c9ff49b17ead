"""`read_faults.py` with the walk cell's fault of `rig_faults.py` beside
`faults.py`'s, read on the card at the cell's own size:

    python bench_port/tests/read_rig_faults.py \
        --workload tumvi-stereo-inertial.walk \
        --fault none right_rows_off track_frozen descriptor_flip \
        imu_rows_halved control --seconds 51 --seeds <n> [...]

`faults.py`'s faults go in when the window opens, as `read_faults.read`
plants them. "right rows off" goes in before the System is built and
stays for the whole run: the program as it was before the right camera
became a factor, whose map loses its scale from the first keyframe on
(planted at the window's start it would meet a map the warm-up already
made at the right scale, which the IMU then holds). One JSON line per run,
as `read_faults.py` prints them. The limits of
`cells/tumvi-stereo-inertial.walk.json` are set from these readings
(PERF.md, section 2).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import faults  # noqa: E402
import read_faults  # noqa: E402
import rig_faults  # noqa: E402,F401  (adds right_rows_off to faults.FAULTS)

WHOLE_RUN = ("right_rows_off",)


def read(cell: dict, faults_: list, seconds: float, seeds: list):
    """`read_faults.read`, with each fault of WHOLE_RUN planted for the
    whole run (and taken out after it) instead of at the window's start."""
    for fault in faults_:
        if fault not in WHOLE_RUN:
            yield from read_faults.read(cell, [fault], seconds, seeds)
            continue
        undo = []

        def patch(owner, name, value):
            undo.append((owner, name, getattr(owner, name)))
            setattr(owner, name, value)
        faults.plant(fault, patch)
        try:
            for rec in read_faults.read(cell, ["none"], seconds, seeds):
                yield {**rec, "fault": fault}
        finally:
            for owner, name, old in reversed(undo):
                setattr(owner, name, old)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not read_faults.card_ready():
        return 3
    from bench_port.harness import registry
    for rec in read(registry.cell(args.workload), args.fault, args.seconds,
                    args.seeds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
