"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the hand-written CUDA kernels from the sources in the
     checkout (ms_slam_tpu_torch/csrc) into ms_slam_tpu_torch/_build;
  3. kernel vs plain: the patch-gather kernel against its plain PyTorch
     version at the main path's shapes, bit for bit; then the kernel's own
     time (200 launches of its C entry point between two CUDA events, L2
     warm; one event pair per launch after a 256 MiB write, L2 cold) beside
     its bound (bytes over 3.35 TB/s), the plain version and the nearest
     single PyTorch call;
  4. main path: System.track_stereo on 100 rendered KITTI-size stereo frames
     (384x1248, 2048 ORB features, 8 levels) with the sliding-window
     sparsifier live at bench.py's parameters (N=100, lambda=500,
     lambda_grid=10, window 30). Cuts against bench.py: its warm-up
     thresholds nonlocal_kf=3 and sparsify_queue_min=2 (bench.py:128), so
     that windows fire inside 100 frames (at the reference's 30 and 11 the
     first fires near frame 450); 100 frames of its 600; loop closing off
     (not ported). Held to tracking state, keyframe count, ATE against the
     ground truth, at least one window before shutdown(), a memory
     reduction and compressed points after it, and the kernel's launch
     count in that run;
  5. relocalization: a stereo pair rendered at frame 60's pose turned 10
     degrees in yaw and moved 0.3 m sideways goes through track_stereo from
     the LOST state against the keyframe database phase 4 left; held to
     state OK, a camera-centre error under 0.35 m (tests/test_pnp.py's bar)
     and the kernel's launch count in that run;
  6. argmin ties on the card: the first index wins, as in the reference
     (bow_vector's word votes depend on it); and the selector on one of
     phase 4's windows, on the card against the CPU (printed, not held:
     the card's float scatter-adds sum in another order);
  then a JSON line of per-kernel results and the final JSON status line.

Options, for work on the kernel: --kernel-only stops after phase 3 and
prints no status line; --parent DIR also builds the patch_gather.cu of
another checkout of this repository (same C interface) and times the two
kernels in turns in phase 3: parent, this, this, parent.
"""
from __future__ import annotations

import argparse
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
HBM_BYTES_PER_S = 3.35e12       # NVIDIA H100 SXM data sheet


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
    print(f"# build: patch_gather.cu in {time.perf_counter() - t0:.2f} s; "
          "nvcc -Xptxas -v said:")
    for line in _native.build_log.get("patch_gather", "").splitlines():
        if "ptxas info" in line and "Compiling" not in line:
            print(f"#   {line.strip()}")


def _cuda_ms(fn, n=50, warmup=5):
    """Median of n CUDA-event timings of fn() after warm-up, in ms. One
    event pair per call: the span holds the host's time inside fn() too."""
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


def _run_ms(fn, n=200, warmup=20, reps=5):
    """ms per fn() in a run of n back-to-back calls between two CUDA events
    (the caches stay warm, the host stays ahead of the device): median of
    reps such runs."""
    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        per_call.append(a.elapsed_time(b) / n)
    return float(np.median(per_call))


def _cold_ms(fn, flush, n=50, warmup=3):
    """Median ms of fn() with the L2 cache cold: `flush` (larger than the
    50 MB L2) is overwritten before each call, outside the event pair."""
    pairs = []
    for _ in range(warmup + n):
        flush.fill_(1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs[warmup:]]))


def _kernel_inputs():
    """Patch-gather inputs at the main path's shapes (B=2, H=384, Wc=5888,
    2048 keypoints per image), with centres beyond all four clip edges."""
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
    return canvas, bi, ys, xs


def _c_launch(c_fn, canvas, bi, ys, xs, out):
    """A closure that calls a kernel's C entry point directly: no checks,
    no allocation, so a run of calls keeps the device busy."""
    import ctypes
    c_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    c_fn.restype = ctypes.c_int
    B, Hc, Wc = canvas.shape
    args = (canvas.data_ptr(), bi.data_ptr(), ys.data_ptr(), xs.data_ptr(),
            out.data_ptr(), bi.shape[0], B, Hc, Wc,
            torch.cuda.current_stream().cuda_stream)

    def launch():
        rc = c_fn(*args)
        _check(rc == 0, f"kernel launch failed: CUDA error {rc}")
    launch.tensors = (canvas, bi, ys, xs, out)    # keep the pointers alive
    return launch


def _build_parent(parent_dir):
    """The patch-gather kernel of another checkout (same C interface),
    built beside this one's for a comparison in one call."""
    import ctypes
    import os

    from ms_slam_tpu_torch.ops import _native
    src = os.path.join(parent_dir, "ms_slam_tpu_torch", "csrc",
                       "patch_gather.cu")
    lib = os.path.join(_native.BUILD_DIR, "libpatch_gather_parent.so")
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    return ctypes.CDLL(lib).msslam_patch_gather_f32


def phase_kernel(parent_dir=None):
    """Patch gather at the main path's shapes: bit for bit against the plain
    version through the wrapper, then the kernel's own time (its C entry
    point, output allocated once) with the L2 cache warm and cold, beside
    its bound, the plain version and the nearest single PyTorch call."""
    from ms_slam_tpu_torch.ops import orb
    canvas, bi, ys, xs = _kernel_inputs()
    B, Hc, Wc = canvas.shape
    n = bi.shape[0]
    out = orb.extract_patches_canvas(canvas, bi, ys, xs)
    ref = orb.extract_patches_canvas_plain(canvas, bi, ys, xs)
    torch.cuda.synchronize()
    _check(out.shape == ref.shape == (n, 45, 45), "patch shape")
    err = float((out - ref).abs().max())
    _check(torch.equal(out, ref), f"kernel != plain (max abs err {err})")

    # the least time the card could take: every input read once, the output
    # written once, at the H100's 3.35 TB/s; the kernel does no arithmetic
    n_bytes = 4 * (out.numel() + canvas.numel() + bi.numel() + ys.numel()
                   + xs.numel())
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3

    lib = orb._patch_gather_lib()
    buf = torch.empty_like(out)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    this = _c_launch(lib.msslam_patch_gather_f32, canvas, bi, ys, xs, buf)
    this()
    torch.cuda.synchronize()
    _check(torch.equal(buf, ref), "kernel != plain through its C entry")
    if parent_dir is not None:
        buf_p = torch.empty_like(out)
        parent = _c_launch(_build_parent(parent_dir), canvas, bi, ys, xs,
                           buf_p)
        parent()
        torch.cuda.synchronize()
        _check(torch.equal(buf_p, ref), "the parent's kernel != plain")
        for who, fn in (("parent", parent), ("this", this), ("this", this),
                        ("parent", parent)):
            w, c = _run_ms(fn), _cold_ms(fn, flush)
            print(f"# in turns, {who:<6}: warm {w:.4f} ms "
                  f"({100 * bound_ms / w:.1f}% of the bound), cold "
                  f"{c:.4f} ms ({100 * bound_ms / c:.1f}%)")
    ms = _run_ms(this)
    ms_cold = _cold_ms(this, flush)
    wrapper_ms = _cuda_ms(lambda: orb.extract_patches_canvas(
        canvas, bi, ys, xs))
    plain_ms = _run_ms(lambda: orb.extract_patches_canvas_plain(
        canvas, bi, ys, xs), n=50, warmup=5)
    # the nearest single PyTorch call: the plain version's last step alone,
    # on an (n, 2025) int64 index built beforehand (66 MB the kernel never
    # reads); the port does not call it
    R = orb.EXTRACT_R
    base = ((bi.long().clamp(0, B - 1) * Hc + ys.long().clamp(R, Hc - R - 1)
             - R) * Wc + xs.long().clamp(R, Wc - R - 1) - R)
    ar = torch.arange(2 * R + 1, device=canvas.device)
    idx = base[:, None] + (ar[:, None] * Wc + ar[None, :]).reshape(1, -1)
    flat = canvas.reshape(-1)
    _check(torch.equal(flat[idx].view(n, 45, 45), ref), "library call")
    library_ms = _run_ms(lambda: flat[idx], n=50, warmup=5)
    print(f"# patch_gather {B}x{Hc}x{Wc}, {n // B} kp/img: bit-exact vs "
          f"plain. Bound {bound_ms:.4f} ms ({n_bytes} bytes at 3.35 TB/s). "
          f"Kernel alone, 200 launches between two events (L2 warm), median "
          f"of 5 runs: {ms:.4f} ms = {100 * bound_ms / ms:.1f}% of the "
          f"bound; L2 cold, median of 50 event pairs: {ms_cold:.4f} ms = "
          f"{100 * bound_ms / ms_cold:.1f}%")
    # what the card does on traffic of the same size, by PyTorch's own
    # kernels (yardsticks only), and the kernel's floor: one group, one block
    fill_ms = _run_ms(lambda: buf.fill_(1.0))
    copy_ms = _run_ms(lambda: buf.copy_(out))
    one = _c_launch(lib.msslam_patch_gather_f32, canvas, bi[:4].clone(),
                    ys[:4].clone(), xs[:4].clone(), buf)
    one_ms = _run_ms(one)
    print(f"#   same method: Tensor.fill_ of the {out.numel() * 4} B output "
          f"{fill_ms:.4f} ms; Tensor.copy_ into it from a tensor of its size "
          f"(as many bytes through the SMs as the gather) {copy_ms:.4f} ms; "
          f"the kernel on one group of 4 keypoints {one_ms:.4f} ms")
    print(f"#   one event pair around one call of the checking wrapper "
          f"(host gap inside the span), median of 50: {wrapper_ms:.4f} ms; "
          f"plain version {plain_ms:.4f} ms; nearest library call "
          f"(canvas.reshape(-1)[idx], index prebuilt) {library_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "ms_cold": ms_cold,
            "ms_wrapper_call": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "share_of_bound": bound_ms / ms,
            "share_of_bound_cold": bound_ms / ms_cold}


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


def _render(world, K, T):
    return tuple(np.clip(im, 0, 255).astype(np.uint8)
                 for im in world.render_stereo(K, T, BASELINE, H, W))


def phase_main_path():
    from ms_slam_tpu_torch.models.map_state import MapConfig
    from ms_slam_tpu_torch.ops import orb
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline import sparsification
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
        min_init_depth_points=300, max_frames_between_kf=10, ba_iters=6,
        sparsify=True, sparsify_n=100, sparsify_lambda=500.0,
        sparsify_grid_lambda=10.0, sparsify_window=30,
        sparsify_queue_min=2, nonlocal_kf=3)
    rng = np.random.default_rng(0)
    world = synth.CorridorWorld(rng, half_w=6.0, y_floor=1.7)
    poses = synth.make_trajectory(N_FRAMES, "forward")
    t0 = time.perf_counter()
    frames = [_render(world, K, T) for T in poses]
    print(f"# rendered {N_FRAMES} stereo frames in "
          f"{time.perf_counter() - t0:.1f} s")

    stage = {}
    _timed(system_mod, "process_stereo_stacked", "frontend", stage)
    _timed(system_mod.to, "track_full", "track", stage)
    _timed(system_mod.mo, "keyframe_step", "keyframe_step", stage)
    _timed(sparsification, "sparsify_window", "sparsify_window", stage)
    windows_seen = []
    build = sparsification.build_window_tables

    def keep_first_window(*a, **k):
        out = build(*a, **k)
        if not windows_seen:
            windows_seen.append(tuple(v.clone() for v in out))
        return out
    sparsification.build_window_tables = keep_first_window

    slam = System(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    orb.patch_gather_launches = 0
    frame_s = []
    for i in range(N_FRAMES):
        t0 = time.perf_counter()
        slam.track_stereo(frames[i][0], frames[i][1], 0.1 * i)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    slam._flush_pipeline()
    windows_before = slam._sparsifier.stats["windows"]
    slam.shutdown()
    torch.cuda.synchronize()
    launches = orb.patch_gather_launches

    steady = np.asarray(frame_s[10:])
    print(f"# main path: {N_FRAMES} frames; frames/s over frames 10-99: "
          f"{len(steady) / steady.sum():.3f}; frame wall p50 "
          f"{np.percentile(frame_s, 50) * 1e3:.2f} ms, p95 "
          f"{np.percentile(frame_s, 95) * 1e3:.2f} ms")
    for k in ("frontend", "track", "keyframe_step", "sparsify_window"):
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

    st = slam._sparsifier.stats
    mem = slam.memory_stats()
    n_comp = slam.compressed_map_points_in_map()
    sw = np.asarray(stage.get("sparsify_window", [0.0]))
    print(f"# sparsification: windows {windows_before} before shutdown(), "
          f"{st['windows']} after; killed {st['killed']}, kept "
          f"{st['kept']}, slots freed {st['slots_freed']}; reduction "
          f"{mem['reduction']:.4f}; compressed points {n_comp}; KFDB "
          f"candidates {int(slam.kf_db.present.sum())}; sparsify_window "
          f"p50 {np.percentile(sw, 50) * 1e3:.2f} ms, max "
          f"{sw.max() * 1e3:.2f} ms")
    _check(windows_before >= 1, "no window solved before shutdown()")
    _check(mem["reduction"] > 0, f"reduction {mem['reduction']}")
    _check(n_comp > 0, "no compressed map point after shutdown()")
    return {"launches": launches, "slam": slam, "world": world, "K": K,
            "poses": poses, "window": windows_seen[0]}


def phase_relocalize(run):
    """Track a perturbed view of frame 60 from the LOST state."""
    from scipy.spatial.transform import Rotation

    from ms_slam_tpu_torch.ops import orb
    slam, poses = run["slam"], run["poses"]
    T_q = poses[60].copy()
    T_q[:3, :3] = T_q[:3, :3] @ Rotation.from_euler(
        "y", np.deg2rad(10)).as_matrix()
    T_q[:3, 3] += T_q[:3, :3] @ np.array([0.3, 0.0, 0.0])
    img_l, img_r = _render(run["world"], run["K"], T_q)
    found = []
    relocalize = slam._relocalize

    def timed(frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = relocalize(frame)
        torch.cuda.synchronize()
        found.append((time.perf_counter() - t0,
                      None if out is None else int(out.n_inliers)))
        return out
    slam._relocalize = timed
    orb.patch_gather_launches = 0
    # twice: the first call also pays the solvers' one-time set-up
    for rep in range(2):
        slam.state = "LOST"
        slam._lost_frames = 0
        slam.vel = None
        slam.track_stereo(img_l, img_r, 0.1 * (N_FRAMES + rep))
        torch.cuda.synchronize()
        # the map frame is the first camera's, the world frame here
        err = float(np.linalg.norm(
            np.linalg.inv(slam.current_pose())[:3, 3] - T_q[:3, 3]))
        print(f"# relocalization {rep + 1}: state {slam.state}, "
              f"camera-centre error {err:.4f} m (bar 0.35 m)")
        _check(slam.state == "OK", f"relocalization ended {slam.state}")
        _check(err < 0.35, f"relocalization error {err:.3f} m")
    launches = orb.patch_gather_launches
    print("# _relocalize wall time (synchronised): "
          + ", ".join(f"{s * 1e3:.2f} ms ({n} inliers after refinement)"
                      for s, n in found)
          + f"; kernel launches {launches}")
    _check(launches >= 2, "patch_gather not launched by relocalization")


def phase_ties_and_selector(window):
    """argmin ties on the card, then the selector on a phase-4 window."""
    from ms_slam_tpu_torch.models import vocab
    from ms_slam_tpu_torch.ops import select
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    d = torch.randint(0, 4, (4096, 2048), generator=g, device=dev)
    d[:, 5] = -1
    d[:, 9] = -1
    first = torch.argmin(d, dim=1)
    _check(bool((first == 5).all()), "argmin did not take the first tie")
    _check(torch.equal(torch.argmin(d[:, 6:], dim=1).cpu(),
                       torch.argmin(d[:, 6:].cpu(), dim=1)),
           "argmin ties differ between the card and the CPU")
    cb = vocab.make_codebook(16, device=dev)
    cb[7] = cb[3]
    h = vocab.bow_vector(cb, cb[[3, 3]],
                         torch.ones(2, dtype=torch.bool, device=dev))
    _check(abs(float(h[3]) - 2 / 3) < 1e-6 and abs(float(h[7]) - 1 / 3)
           < 1e-6, f"bow_vector tie votes {h[3].item()}, {h[7].item()}")
    print("# argmin ties on the card: first index, as the reference")

    obs_pt, obs_cell, obs_ok, cost, _, pt_valid, req = window
    args = (obs_pt, obs_cell, obs_ok, cost, pt_valid, req)
    kw = dict(lam=500.0, lam_grid=10.0, n_cells=64 * 48)
    on_card = select.select_points(*args, **kw)
    t0 = time.perf_counter()
    on_cpu = select.select_points(*[a.cpu() for a in args], **kw)
    cpu_s = time.perf_counter() - t0
    n_diff = int((on_card.keep.cpu() != on_cpu.keep).sum())
    card_ms = _cuda_ms(lambda: select.select_points(*args, **kw), n=5,
                       warmup=1)
    print(f"# selector on a {tuple(obs_pt.shape)} window, "
          f"{int(pt_valid.sum())} points: kept {int(on_card.keep.sum())} on "
          f"the card, {int(on_cpu.keep.sum())} on the CPU, {n_diff} differ; "
          f"card {card_ms:.2f} ms (CUDA events, median of 5), CPU "
          f"{cpu_s * 1e3:.1f} ms (host clock, one call)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after phase 3 (no status line is printed)")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="another checkout of this repository: phase 3 also "
                    "builds its patch_gather.cu and times the two kernels "
                    "in turns (parent, this, this, parent)")
    args = ap.parse_args()
    phase_device()
    phase_build()
    kern = phase_kernel(args.parent)
    launches = None
    if not args.kernel_only:
        run = phase_main_path()
        phase_relocalize(run)
        phase_ties_and_selector(run["window"])
        launches = run["launches"]
    print(json.dumps({"kernels": [{
        "name": "patch_gather", "route": "cuda",
        "source": "ms_slam_tpu_torch/csrc/patch_gather.cu",
        "replaces": "ms_slam_tpu/ops/orb.py:665",
        "launches": launches, **kern}]}))
    if args.kernel_only:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
