"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the hand-written CUDA kernels from the sources in the
     checkout (ms_slam_tpu_torch/csrc) into ms_slam_tpu_torch/_build;
  3. kernel vs plain: the patch-gather kernel against its plain PyTorch
     version at the main path's shapes, bit for bit, with CUDA-event times;
  4. main path: System.track_stereo on 100 rendered KITTI-size stereo frames
     (384x1248, 2048 ORB features, 8 levels; the bench.py configuration
     without sparsification and loop closing), held to tracking state,
     keyframe count and ATE against the ground truth, and to the kernel's
     launch count in that run;
  5. a JSON line of per-kernel results, then the final JSON status line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FRAMES = 100
H, W = 384, 1248
FX = 718.856
BASELINE = 0.537


def _check(cond: bool, msg: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device():
    _check(torch.cuda.is_available(), "no CUDA device (this script needs one)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"# nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")


def phase_build():
    from ms_slam_tpu_torch.ops import _native
    t0 = time.perf_counter()
    _native.build("patch_gather")
    _native.load("patch_gather")
    print(f"# build: patch_gather.cu in {time.perf_counter() - t0:.2f} s")


def _cuda_ms(fn, n=50, warmup=5):
    """Median of n CUDA-event timings of fn() after warm-up, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_kernel():
    """Patch gather at B=2, H=384, Wc=5888, n=2048 per image, with centres
    beyond all four clip edges."""
    from ms_slam_tpu_torch.ops import orb
    B, Hc, n = 2, H, 2048
    _, Wc, _ = orb.canvas_layout(H, W, orb.OrbConfig(n_features=2048,
                                                     n_levels=8))
    _check(Wc == 5888, f"canvas width {Wc} != 5888")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    canvas = torch.rand((B, Hc, Wc), generator=g, device=dev) * 255.0
    ys = torch.randint(-8, Hc + 8, (B * n,), generator=g, device=dev,
                       dtype=torch.int32)
    xs = torch.randint(-8, Wc + 8, (B * n,), generator=g, device=dev,
                       dtype=torch.int32)
    # explicit corners and edges: top, bottom, left, right
    ys[:8] = torch.tensor([0, Hc - 1, 5, Hc + 3, 10, 200, -3, 100],
                          dtype=torch.int32)
    xs[:8] = torch.tensor([0, Wc - 1, 3000, 10, -5, Wc + 2, 40, Wc - 3],
                          dtype=torch.int32)
    bi = torch.arange(B, device=dev, dtype=torch.int32).repeat_interleave(n)
    out = orb.extract_patches_canvas(canvas, bi, ys, xs)
    ref = orb.extract_patches_canvas_plain(canvas, bi, ys, xs)
    torch.cuda.synchronize()
    _check(out.shape == ref.shape == (B * n, 45, 45), "patch shape")
    err = float((out - ref).abs().max())
    _check(torch.equal(out, ref), f"kernel != plain (max abs err {err})")
    plain_ms = _cuda_ms(lambda: orb.extract_patches_canvas_plain(
        canvas, bi, ys, xs))
    ms = _cuda_ms(lambda: orb.extract_patches_canvas(canvas, bi, ys, xs))
    print(f"# patch_gather 2x{Hc}x{Wc}, {n} kp/img: bit-exact vs plain; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, "
          f"median of 50)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _timed(module, name, key, acc):
    """Wrap module.name so each call is timed between device syncs."""
    fn = getattr(module, name)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        acc.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    setattr(module, name, wrapper)


def phase_main_path():
    from ms_slam_tpu_torch.models.map_state import MapConfig
    from ms_slam_tpu_torch.ops import orb
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline import system as system_mod
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
    from ms_slam_tpu_torch.utils import evaluate, synth

    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                  width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=2048, n_levels=8),
        map=MapConfig(max_kf=128, max_mp=32768, n_feat=2048,
                      local_mp_cap=4096, window_kf=6),
        min_init_depth_points=300, max_frames_between_kf=10, ba_iters=6)
    rng = np.random.default_rng(0)
    world = synth.CorridorWorld(rng, half_w=6.0, y_floor=1.7)
    poses = synth.make_trajectory(N_FRAMES, "forward")
    t0 = time.perf_counter()
    frames = [tuple(np.clip(im, 0, 255).astype(np.uint8) for im in
                    world.render_stereo(K, T, BASELINE, H, W)) for T in poses]
    print(f"# rendered {N_FRAMES} stereo frames in "
          f"{time.perf_counter() - t0:.1f} s")

    stage = {}
    _timed(system_mod, "process_stereo_stacked", "frontend", stage)
    _timed(system_mod.to, "track_full", "track", stage)
    _timed(system_mod.mo, "keyframe_step", "keyframe_step", stage)

    slam = System(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    orb.patch_gather_launches = 0
    frame_s = []
    for i in range(N_FRAMES):
        t0 = time.perf_counter()
        slam.track_stereo(frames[i][0], frames[i][1], 0.1 * i)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    slam.shutdown()
    torch.cuda.synchronize()
    launches = orb.patch_gather_launches

    steady = np.asarray(frame_s[10:])
    print(f"# main path: {N_FRAMES} frames; frames/s over frames 10-99: "
          f"{len(steady) / steady.sum():.3f}; frame wall p50 "
          f"{np.percentile(frame_s, 50) * 1e3:.2f} ms, p95 "
          f"{np.percentile(frame_s, 95) * 1e3:.2f} ms")
    for k in ("frontend", "track", "keyframe_step"):
        v = np.asarray(stage.get(k, [0.0]))
        print(f"# stage {k:<14} n={len(stage.get(k, []))} "
              f"mean {v.mean() * 1e3:.2f} ms p50 "
              f"{np.percentile(v, 50) * 1e3:.2f} ms total {v.sum():.2f} s")
    n_kf, n_mp = slam.keyframes_in_map(), slam.map_points_in_map()
    print(f"# keyframes {n_kf}, map points {n_mp}, kernel launches "
          f"{launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    _check(slam.state == "OK", f"final state {slam.state}")
    _check(len(slam.trajectory) == N_FRAMES
           and not any(e.lost for e in slam.trajectory), "a frame was lost")
    _check(n_kf >= 5, f"only {n_kf} keyframes")
    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    est, gt = [], []
    for ts, Twc in slam.poses_wc():
        est.append(Twc[:3, 3])
        gt.append(gt_by_ts[round(ts, 6)][:3, 3])
    est, gt = np.stack(est), np.stack(gt)
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    ate = evaluate.ate_rmse(est, gt)
    print(f"# ATE {ate:.4f} m on a {path:.2f} m path "
          f"({100 * ate / path:.3f}%, bar 2%)")
    _check(np.isfinite(est).all() and ate < 0.02 * path, "ATE above 2%")
    _check(launches >= N_FRAMES,
           f"patch_gather launched {launches} times for {N_FRAMES} frames")
    return launches


def main():
    phase_device()
    phase_build()
    kern = phase_kernel()
    launches = phase_main_path()
    print(json.dumps({"kernels": [{
        "name": "patch_gather", "route": "cuda",
        "source": "ms_slam_tpu_torch/csrc/patch_gather.cu",
        "replaces": "ms_slam_tpu/ops/orb.py:665",
        "launches": launches, **kern}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
