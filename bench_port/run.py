"""The benchmark of ms_slam_tpu_torch: one cell, run once.

    python bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell (`cells/<cell>.json`: a configuration and a traffic mix),
makes its frames on the card from the seed, builds the port's System from
the configuration's settings file, runs the mix's warm-up, then drives the
System in a closed loop for `--seconds` and prints one JSON line. With
`--trace 0` the line's metrics are the end-to-end ones (`frames_per_s`,
`frame_p95_ms`, `setup_s`); with `--trace 1` they are the per-layer ones,
read from the benchmark's spans, the System's timers and a profiler slice.
After the window the plain reference works out again, from the same
inputs, what the program produced, and `correct` says whether every number
is within its limit; the numbers and limits are the last lines on stderr.

Exits 2 on bad arguments, 3 without enough CUDA cards, 4 when JAX or the
JAX package was loaded, and with an error on any failure, printing no
result line in each case.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """perf_counter's reading at the moment this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "ms_slam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (`ms_slam_tpu_torch` is not `ms_slam_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def environment(root: str):
    """Every build and kernel cache inside the checkout, at fixed paths;
    one host thread for the math libraries' pools, so that the run is the
    loop's one busy thread (with the System's prefetch worker)."""
    base = os.path.join(root, "bench_port", ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment(os.path.dirname(HERE))

    from bench_port.harness import registry
    cell = registry.cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3

    from bench_port.harness import run_cell
    result = run_cell.run(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (the benchmark "
              "runs the port alone)", file=sys.stderr)
        return 4
    run_cell.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
