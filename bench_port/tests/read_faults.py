"""Read a cell's correctness numbers on the card with a fault of
`faults.py` planted (or the control, or `none` for sound runs), on several
seeds in one process, at the cell's own size:

    python bench_port/tests/read_faults.py --workload <cell> \
        --fault <name|control|none> --seconds <s> --seeds <n> [<n> ...]

The fault is planted when the window opens, after a sound warm-up, and
taken out again after the run. Prints one JSON line per seed: the numbers,
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from bench_port import run as bench_run
    bench_run.environment(os.path.dirname(os.path.dirname(HERE)))
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    import faults
    from bench_port.harness import registry, run_cell, window
    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def setenv(name, value):
        undo.append((os.environ, name, os.environ.get(name)))
        os.environ[name] = value

    sound_run = window.Window.run

    def broken_run(self, *a, **k):
        if args.fault != "none":
            faults.plant(args.fault, patch, setenv)
        return sound_run(self, *a, **k)

    window.Window.run = broken_run
    cell = registry.cell(args.workload)
    for seed in args.seeds:
        res = run_cell.run(cell, seed, args.seconds, False, "cuda",
                           time.perf_counter())
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
        print(json.dumps({
            "fault": args.fault, "seed": seed, "correct": line["correct"],
            "frames": res["attempted"], "checks": line["checks"],
            "numbers": res["numbers"], "stats": res["stats"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
