"""Digests that show two trees of the benchmark make the same inputs and
judge alike, on the card at a cell's own size:

    python bench_port/tests/digest_parity.py --root <tree> --workload <cell> \
        --seed <n> --frames <N> (--run <seconds> --save <file> | --load <file>)

`--root` is the directory that holds the `bench_port/` (and the port) to
use. The inputs are those of a 51 s run. With `--run` the cell runs once
for that many seconds through the tree's `run_cell.run`; the program's
outputs go to `--save`. With `--load`
the tree renders the cell's inputs itself and judges the outputs saved by
another tree's run. Either way it prints one JSON line: the SHA-256 of the
first N rendered pairs, of their poses and of the IMU rows before them
(with the true bias), and of the judge's numbers, with the numbers.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np


def _sha(chunks) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(np.ascontiguousarray(c).tobytes())
    return h.hexdigest()


def _scalar(o):
    return o.item() if hasattr(o, "item") else str(o)


def digest(inp, n: int, numbers: dict) -> dict:
    return {"frames_rendered": len(inp.frames),
            "pairs": _sha(x for p in inp.frames[:n] for x in p),
            "poses": _sha([inp.poses[:n]]),
            "imu": (_sha(inp.imu[:n - 1] + [inp.bias]) if inp.imu
                    else None),
            "numbers": hashlib.sha256(json.dumps(
                numbers, sort_keys=True, default=_scalar).encode()
            ).hexdigest()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--run", type=float)
    ap.add_argument("--save")
    ap.add_argument("--load")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from bench_port import run as bench_run
    bench_run.environment(root)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from bench_port.harness import inputs, registry, run_cell
    from bench_port.reference import judge
    cell = registry.cell(args.workload)
    out = {"root": root, "workload": args.workload, "seed": args.seed}
    if args.run:
        seen = {}
        sound = judge.judge

        def keep(program, inp, orb, device):
            seen.update(program=program, inp=inp, orb=orb)
            return sound(program, inp, orb, device)

        judge.judge = keep
        try:
            n51 = inputs.frame_count(registry.traffic(cell["traffic"]), 51.0)
            res = run_cell.run(cell, args.seed, args.run, False, "cuda",
                               time.perf_counter(), n_frames=n51)
        finally:
            judge.judge = sound
        torch.save(seen["program"], args.save)
        again = judge.judge(seen["program"], seen["inp"], seen["orb"], "cuda")
        out.update(digest(seen["inp"], args.frames, res["numbers"]),
                   numbers_again=digest(seen["inp"], args.frames,
                                        again)["numbers"],
                   attempted=res["attempted"])
        numbers = res["numbers"]
    else:
        cfg = registry.config(cell["config"])
        traffic = registry.traffic(cell["traffic"])
        cfg_sys = inputs.system_config(cfg)
        inp = inputs.make(cfg_sys, cfg, traffic, args.seed, 51.0, "cuda")
        program = torch.load(args.load, weights_only=False)
        numbers = judge.judge(program, inp, run_cell.reference_orb(cfg_sys),
                              "cuda")
        out.update(digest(inp, args.frames, numbers))
    out["judged"] = {k: v for k, v in numbers.items()
                     if k in judge.NUMBERS}
    print(json.dumps(out, default=_scalar), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
