"""Read a cell's correctness numbers on the card with a fault of
`faults.py` planted (or the control, or `none` for sound runs), on several
seeds in one process, at the cell's own size:

    python bench_port/tests/read_faults.py --workload <cell> \
        --fault <name|control|none> [...] --seconds <s> --seeds <n> [...]

Each fault is planted when the window opens, after a sound warm-up, and
taken out again after the run. Prints one JSON line per run: the numbers,
each compared number beside its limit, and whether the run came out
correct. The limits of `cells/<cell>.json` are set from these readings
(PERF.md, section 2).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)


def read(cell: dict, faults_: list, seconds: float, seeds: list,
         cfg: dict | None = None, traffic: dict | None = None):
    """Run the cell on the card once per fault and seed, each fault planted
    when the window opens and taken out after the run; yield one record
    per run. `cfg` and `traffic` stand in for the cell's files."""
    import faults
    from bench_port.harness import run_cell, window
    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def setenv(name, value):
        undo.append((os.environ, name, os.environ.get(name)))
        os.environ[name] = value

    sound_run = window.Window.run
    fault = None

    def broken_run(self, *a, **k):
        if fault != "none":
            faults.plant(fault, patch, setenv)
        return sound_run(self, *a, **k)

    window.Window.run = broken_run
    try:
        for fault in faults_:
            for seed in seeds:
                try:
                    res = run_cell.run(cell, seed, seconds, False, "cuda",
                                       time.perf_counter(), cfg=cfg,
                                       traffic=traffic)
                finally:
                    for owner, name, old in reversed(undo):
                        if owner is os.environ:
                            if old is None:
                                os.environ.pop(name, None)
                            else:
                                os.environ[name] = old
                        else:
                            setattr(owner, name, old)
                    undo.clear()
                line = run_cell.result_line(res)
                yield {"fault": fault, "seed": seed,
                       "correct": line["correct"], "frames": res["attempted"],
                       "frames_per_s": res["frames_per_s"],
                       "memory_peak_bytes": res["memory_peak_bytes"],
                       "checks": line["checks"], "numbers": res["numbers"],
                       "stats": res["stats"]}
    finally:
        window.Window.run = sound_run


def card_ready() -> bool:
    """The benchmark's environment, one math thread, and a card."""
    from bench_port import run as bench_run
    bench_run.environment(os.path.dirname(os.path.dirname(HERE)))
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not card_ready():
        return 3
    from bench_port.harness import registry
    for rec in read(registry.cell(args.workload), args.fault, args.seconds,
                    args.seeds):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
