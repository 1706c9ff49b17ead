"""One run of one cell: inputs, set-up, warm-up, the window, the traced
extras, the program's outputs, then the plain reference's judgement."""
from __future__ import annotations

import gc
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..reference import frontend as ref_frontend
from ..reference import judge
from . import inputs, outputs, registry, tracing, window


def reference_orb(cfg_sys) -> ref_frontend.Orb:
    o = cfg_sys.orb
    return ref_frontend.Orb(n_features=o.n_features, n_levels=o.n_levels,
                            scale_factor=o.scale_factor, ini_th=o.ini_th,
                            min_th=o.min_th, cell_size=o.cell_size,
                            cell_top_k=o.cell_top_k, edge=o.edge)


def compare(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "max" | "min", "ok"}} for every limit of the cell;
    a number the run could not give fails."""
    out = {}
    for name, lim in limits.items():
        v = numbers.get(name)
        ok = v is not None and np.isfinite(v)
        if ok and "max" in lim:
            ok = v <= lim["max"]
        if ok and "min" in lim:
            ok = v >= lim["min"]
        out[name] = {"value": v, **lim, "ok": bool(ok)}
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, n_frames: int | None = None, cfg: dict | None = None,
        traffic: dict | None = None) -> dict:
    """Run the cell once. `cfg` and `traffic` stand in for the files the
    cell names (the CPU rehearsal's small sizes)."""
    cfg = cfg or registry.config(cell["config"])
    traffic = traffic or registry.traffic(cell["traffic"])
    from ms_slam_tpu_torch.pipeline.system import System

    t_in = time.perf_counter()
    cfg_sys = inputs.system_config(cfg)
    inp = inputs.make(cfg_sys, cfg, traffic, seed, seconds, device, n_frames)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_sys = time.perf_counter()
    slam = System(cfg_sys, device=device)
    feed = window.Feed(slam, inp)
    t_warm = time.perf_counter()
    n_warm = window.warm_up(feed, traffic["warmup"])

    spans = None
    if trace:
        spans = tracing.Spans()
        spans.install(slam, feed)
        spans.recording = True
    before = {k: len(v) for k, v in slam.timing.items()}
    timing = {}

    def on_close():
        if spans is not None:
            spans.recording = False
        timing.update({key: v[before.get(key, 0):]
                       for key, v in slam.timing.items()})

    win = window.Window(n_warm)
    solved = outputs.Windows()
    solved.install()
    gc.collect()
    gc.freeze()         # set-up's objects stay out of the window's collections
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    setup = {"start_s": t_in - t_start, "inputs_s": t_sys - t_in,
             "system_s": t_warm - t_sys, "warmup_s": t0 - t_warm}
    win.run(feed, seconds, on_close=on_close)
    solved.remove()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = {}
    if trace:
        # the profiler slice: a few more frames after the window, so that
        # its cost stays out of the window's host times
        tr = traffic.get("trace", {})
        summary = tracing.profile_slice(
            spans, feed.call, n_warm + win.attempted,
            int(tr.get("skip_frames", 2)), int(tr.get("frames", 12)),
            on_card)
    program = outputs.capture(slam, inp.fps, n_warm, seed,
                              int(cell.get("frontend_kfs", 3)))
    program["windows"] = solved.host()
    program["gravity_log"] = feed.gravity_log
    stats = {"keyframes": len(timing.get("keyframe_step", [])),
             "windows": slam._sparsifier.stats["windows"]
             if slam._sparsifier is not None else 0,
             "loop_queries": slam._loop_closer.stats.get("queries", 0)
             if slam._loop_closer is not None else 0,
             "prefetch_hits": slam.prefetch_hits}
    slam.shutdown()
    if spans is not None:
        spans.remove()
    del slam, feed, solved
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    numbers = judge.judge(program, inp, reference_orb(cfg_sys), device)
    checks = compare(numbers, cell["limits"])
    lat = sorted(win.latencies_s())
    res = {"cell": cell["name"], "seed": seed, "trace": trace,
           "attempted": win.attempted, "failed": win.failed(),
           "warmup_frames": n_warm, "setup_s": setup_s, "setup": setup,
           "frames": len(inp.frames),
           "frames_per_s": win.frames_per_s(),
           "latency_ms": [x * 1e3 for x in lat],
           "window_s": win.t_end - win.t0, "flush_s": win.t_flushed - win.t_end,
           "memory_peak_bytes": int(peak), "numbers": numbers,
           "checks": checks, "stats": stats,
           "device": (torch.cuda.get_device_name(0) if on_card else "cpu")}
    if trace:
        rec = {"frames": win.attempted, "timing": timing,
               "spans": dict(spans.host_s),
               "slice": summary}
        res["slice"] = rec["slice"]
        res["per_layer"] = {}
        for name, _ in registry.per_layer_for(cell["name"]):
            v = registry.metric_reader(name)(rec)
            if v is not None:
                res["per_layer"][name] = v
    return res


UNITS = {"frames_per_s": "frames/s", "frame_p95_ms": "ms", "setup_s": "s"}


def result_line(res: dict) -> dict:
    """The JSON object of the contract; the compared numbers come last."""
    lat = res["latency_ms"]
    if res["trace"]:
        units = dict(registry.per_layer_for(res["cell"]))
        metrics = {k: {"value": v, "unit": units.get(k)}
                   for k, v in res["per_layer"].items()}
    else:
        metrics = {
            "frames_per_s": {"value": res["frames_per_s"],
                             "unit": UNITS["frames_per_s"]},
            "frame_p95_ms": {"value": float(np.percentile(lat, 95))
                             if lat else float("inf"),
                             "unit": UNITS["frame_p95_ms"]},
            "setup_s": {"value": res["setup_s"], "unit": UNITS["setup_s"]}}
    dev = {"platform": "cpu" if res["device"] == "cpu" else "gpu",
           "kind": res["device"], "count": 1,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": all(c["ok"] for c in res["checks"].values())
            and res["attempted"] > 0,
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if res["trace"]:
        sl = res.get("slice") or {}
        dev["busy_s"] = sl.get("busy_s", 0.0)
        dev["window_s"] = sl.get("window_s", 0.0)
        if sl:
            line["breakdown"] = {"device_ops": sl["device_ops"],
                                 "idle_gaps": sl["idle_gaps"]}
    line["checks"] = {k: {kk: vv for kk, vv in c.items() if kk != "ok"}
                      for k, c in res["checks"].items()}
    return line


def report(res: dict, out=sys.stdout, err=sys.stderr):
    lat = res["latency_ms"]
    print(f"# {res['cell']} seed {res['seed']}: warm-up {res['warmup_frames']}"
          f" frames, set-up {res['setup_s']:.3f} s; window "
          f"{res['window_s']:.3f} s, {res['attempted']} frames submitted, "
          f"{res['frames_per_s']:.4f} frames/s; latency over {len(lat)} "
          f"frames: median {statistics.median(lat) if lat else 0:.1f} ms, "
          f"p95 {np.percentile(lat, 95) if lat else 0:.1f} ms, max "
          f"{max(lat) if lat else 0:.1f} ms; flush {res['flush_s']:.3f} s; "
          f"peak {res['memory_peak_bytes']} B", file=err)
    print(f"# set-up {json.dumps(res['setup'])}, {res['frames']} frames "
          "rendered", file=err)
    print(f"# stats {json.dumps(res['stats'])}; numbers "
          f"{json.dumps(res['numbers'])}", file=err)
    if res.get("slice"):
        s = dict(res["slice"])
        print(f"# slice: {json.dumps(s)}", file=err)
    for name, c in res["checks"].items():
        lim = " ".join(f"{k} {c[k]}" for k in ("max", "min") if k in c)
        print(f"check {name} {c['value']} {lim} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=err)
    err.flush()
    print(json.dumps(result_line(res)), file=out)
    out.flush()
