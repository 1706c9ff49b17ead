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
  7. loop closing at full width: System.track_stereo with sparsify=True and
     loop_closing=True (default loop_covis_min=100) over a closed circuit
     in a BoxWorld that drives into a second lap, as
     benchmarks/ref_scale_gate.py does, shortened (see phase_loop_closing).
     Held to state OK, queries > 0, verified >= 1, refines >= 2,
     loops >= 1, ATE after shutdown() under 2% of the path, the current
     keyframe's centre error smaller after the correction than before it,
     the mean error of the last 12 frames under 2% of the path, and one
     kernel launch per frame;
  8. stereo-inertial at full width: phase 4's configuration with
     use_imu=True at the reference's defaults, System.track_stereo_imu over
     tests/test_inertial_system.py's scene (PlaneWorld, the "arc" path at
     10 Hz, synth.make_imu at 200 Hz) with 8 blank frame pairs after
     inertial stage 2, then one direct _full_inertial_ba() (see
     phase_inertial for the bars and the cuts);
  then a JSON line of per-kernel results and the final JSON status line.

Options, for work on one part: --kernel-only stops after phase 3,
--loop-only runs phases 1-3 and 7, --imu-only phases 1-3 and 8; none of
them prints a status line.
--parent DIR also builds the patch_gather.cu of another checkout of this
repository (same C interface) and times the two kernels in turns in
phase 3: parent, this, this, parent.
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


def _make_world(name, kwargs):
    from ms_slam_tpu_torch.utils import synth
    return getattr(synth, name)(np.random.default_rng(0), **kwargs)


def _render_chunk(name, kwargs, K, poses):
    world = _make_world(name, kwargs)
    return [_render(world, K, T) for T in poses]


def _render_all(name, kwargs, K, poses, n_workers=6):
    """Render every pose's stereo pair in worker processes (numpy ray
    casting, ~1 s a frame on one core); each worker builds the same world
    from the seed. The pool is gone when this returns."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    chunks = [poses[i::n_workers] for i in range(n_workers)]
    with ProcessPoolExecutor(
            n_workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        parts = list(ex.map(_render_chunk, [name] * n_workers,
                            [kwargs] * n_workers, [K] * n_workers, chunks))
    frames = [None] * len(poses)
    for w, part in enumerate(parts):
        frames[w::n_workers] = part
    return frames


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
    world_args = ("CorridorWorld", dict(half_w=6.0, y_floor=1.7))
    world = _make_world(*world_args)
    poses = synth.make_trajectory(N_FRAMES, "forward")
    t0 = time.perf_counter()
    frames = _render_all(*world_args, K, poses)
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
    return launches


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


def _circuit(n_frames: int, radius: float, lap: int, ramp: int):
    """A closed loop driven facing forward (z along the tangent), carried on
    into a second lap: the revisit is a moving overlap, so place recognition
    gets a stream of revisit keyframes to confirm against. The drive starts
    from rest: the turn rate grows linearly to 2*pi/lap a frame over the
    first `ramp` frames (the first frames have no velocity model yet, and a
    full-rate first step would move features 37 px at these widths), so the
    first lap ends at frame lap + ramp/2."""
    from scipy.spatial.transform import Rotation
    w = 2 * np.pi / lap
    poses = []
    for i in range(n_frames):
        a = w * i * i / (2 * ramp) if i < ramp else w * (i - ramp / 2)
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", a).as_matrix()
        T[:3, 3] = [radius * np.sin(a), 0.0, radius * (1 - np.cos(a))]
        poses.append(T)
    return poses


LOOP_LAP = 120          # frames in one lap at full rate
LOOP_RAMP = 20          # frames of the start from rest: lap 1 ends at 130
LOOP_FRAMES = 170       # lap 1 plus 40 frames of the second
LOOP_RADIUS = 9.0       # metres
LOOP_KF_EVERY = 5       # max_frames_between_kf
LOOP_TEX_SCALE = 0.07   # metres a texel: the 768-texel textures span 53.8 m


def phase_loop_closing():
    """Loop closing at full width: 1248x384 frames, 2048 features, 8 levels,
    the map capacities and sparsifier parameters of phase 4, loop closing on
    at its default thresholds.

    The scene is benchmarks/ref_scale_gate.py's: BoxWorld(half=24) and a
    circle of radius 9 m driven facing forward. Cuts against that gate: a
    lap of LOOP_LAP = 120 frames instead of 1000 (3 degrees and 0.47 m a
    frame instead of 0.36 degrees and 0.057 m), reached from rest over
    LOOP_RAMP = 20 frames (the gate starts at its full, eight times slower
    rate), and LOOP_FRAMES = 170 frames instead of 1500, so that the second
    lap begins inside the script's budget; max_frames_between_kf =
    LOOP_KF_EVERY = 5 instead of 10, so that
    keyframes stay about as far apart in angle as a turning car's; the
    sparsifier's warm-up thresholds nonlocal_kf=3 and sparsify_queue_min=2
    (bench.py:128) instead of 30 and 11, so that sparsified keyframes, the
    only retrieval candidates, exist by the time the lap closes; the map
    capacities of phase 4 (128 keyframes, 32768 points) instead of 256 and
    65536; and textures of LOOP_TEX_SCALE = 0.07 m a texel instead of 0.02,
    so that their period (53.8 m) exceeds the 48 m room. At 0.02 the floor
    and ceiling repeat every 15.36 m, and with keyframes this far apart the
    verification cascade accepted a place two periods away (28 inliers,
    then 335/98/351 and 263/55/257 on the 31/52/102 ladder), which is
    perceptual aliasing of the scene, not a revisit."""
    from ms_slam_tpu_torch.models.map_state import MapConfig
    from ms_slam_tpu_torch.ops import orb, pose_graph, sim3
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline import loop_closing, mapping_ops
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
    from ms_slam_tpu_torch.utils import evaluate

    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                  width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=2048, n_levels=8),
        map=MapConfig(max_kf=128, max_mp=32768, n_feat=2048,
                      local_mp_cap=4096, window_kf=6),
        min_init_depth_points=300, max_frames_between_kf=LOOP_KF_EVERY,
        ba_iters=6, sparsify=True, sparsify_n=100, sparsify_lambda=500.0,
        sparsify_grid_lambda=10.0, sparsify_window=30,
        sparsify_queue_min=2, nonlocal_kf=3, loop_closing=True)
    poses = _circuit(LOOP_FRAMES, LOOP_RADIUS, LOOP_LAP, LOOP_RAMP)
    t0 = time.perf_counter()
    frames = _render_all("BoxWorld", dict(half=24.0, tex_scale=LOOP_TEX_SCALE),
                         K, poses)
    print(f"# loop closing: rendered {LOOP_FRAMES} stereo frames in "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    slam = System(cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"# loop closing: System built in {time.perf_counter() - t0:.2f} s "
          "(the LoopCloser pays torch.func's first use there)")

    stage = {}
    _timed(loop_closing, "detect_and_verify", "detect_and_verify", stage)
    _timed(loop_closing, "refine_hypothesis", "refine_hypothesis", stage)
    # the parts of one _verify_pair / refine_hypothesis
    _timed(sim3, "sim3_from_hypotheses", "  sim3_from_hypotheses", stage)
    _timed(sim3, "sim3_guided_match", "  sim3_guided_match", stage)
    _timed(sim3, "sim3_refine", "  sim3_refine", stage)
    _timed(sim3, "sim3_refine_world", "  sim3_refine_world", stage)
    _timed(mapping_ops, "fuse_into", "fuse_into", stage)
    _timed(pose_graph, "optimize_pose_graph", "pose_graph", stage)
    _timed(mapping_ops, "global_ba", "global_ba", stage)

    lc = slam._loop_closer
    gt_centre = {i: T[:3, 3] for i, T in enumerate(poses)}
    corrections = []
    correct_loop = lc._correct_loop

    def kf_centre_err(slot):
        # the first camera's frame is both the map's and the circuit's
        T = slam._kf_pose(slot)
        fid = int(slam.ms.kf_frame_id[slot])
        return float(np.linalg.norm(-T[:3, :3].T @ T[:3, 3]
                                    - gt_centre[fid])), fid

    def timed_correct_loop(cur, match, *S_cm):
        before, fid = kf_centre_err(cur)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        correct_loop(cur, match, *S_cm)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        corrections.append({
            "frame": fid, "match_frame": int(slam.ms.kf_frame_id[match]),
            "before_m": before, "after_m": kf_centre_err(cur)[0], "s": dt})
    lc._correct_loop = timed_correct_loop
    trace = []
    insert_keyframe = lc.insert_keyframe

    def traced_insert(slot):
        insert_keyframe(slot)
        h = lc._hyp
        trace.append(f"{int(slam.ms.kf_frame_id[slot])}:"
                     f"{slam.keyframes_in_map()}:"
                     f"{int(slam.kf_db.present.sum())}:"
                     f"{'-' if h is None else h['n_coin']}")
    lc.insert_keyframe = traced_insert
    fetched = []
    flush = lc.flush

    def logged_flush():
        if lc._pending is not None:
            kind, slot, packed = lc._pending
            p = packed.get()
            fid = int(slam.ms.kf_frame_id[slot])
            if kind == "refine":
                fetched.append(f"{fid}: refine against frame "
                               f"{int(slam.ms.kf_frame_id[lc._hyp['match']])}"
                               f" gave {p[:3].astype(int).tolist()} (ladder "
                               f"{[lc.th_proj, lc.th_opt + 1, lc.th_rep]})")
            elif p[:, 2].max() >= 10:
                fetched.append(f"{fid}: query gave " + ", ".join(
                    f"frame {int(slam.ms.kf_frame_id[int(r[0])])} score "
                    f"{r[1]:.3f} inliers {int(r[2])}" for r in p))
        flush()
    lc.flush = logged_flush

    torch.cuda.reset_peak_memory_stats()
    orb.patch_gather_launches = 0
    frame_s = []
    for i in range(LOOP_FRAMES):
        t0 = time.perf_counter()
        slam.track_stereo(frames[i][0], frames[i][1], 0.1 * i)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    slam.shutdown()
    torch.cuda.synchronize()
    launches = orb.patch_gather_launches

    steady = np.asarray(frame_s[10:])
    print(f"# loop closing: {LOOP_FRAMES} frames (lap {LOOP_LAP} after a "
          f"ramp of {LOOP_RAMP}, radius {LOOP_RADIUS} m); frames/s over "
          f"frames 10-{LOOP_FRAMES - 1}: "
          f"{len(steady) / steady.sum():.3f}; frame wall p50 "
          f"{np.percentile(frame_s, 50) * 1e3:.2f} ms, p95 "
          f"{np.percentile(frame_s, 95) * 1e3:.2f} ms, max "
          f"{max(frame_s) * 1e3:.2f} ms; keyframes "
          f"{slam.keyframes_in_map()}, map points "
          f"{slam.map_points_in_map()}, sparsification windows "
          f"{slam._sparsifier.stats['windows']}, KFDB candidates "
          f"{int(slam.kf_db.present.sum())}; kernel launches {launches}; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"# loop closer: {lc.stats}; loop edges {lc.loop_edges}")
    print("# per keyframe, frame:keyframes in the map:KFDB candidates:"
          "coincidences of the held hypothesis: " + " ".join(trace))
    for k in ("detect_and_verify", "  sim3_from_hypotheses",
              "  sim3_guided_match", "  sim3_refine", "refine_hypothesis",
              "  sim3_refine_world", "fuse_into", "pose_graph", "global_ba"):
        v = np.asarray(stage.get(k, [0.0]))
        print(f"# call {k:<22} n={len(stage.get(k, []))} p50 "
              f"{np.percentile(v, 50) * 1e3:.2f} ms max {v.max() * 1e3:.2f} "
              f"ms (host clock between device syncs)")
    for line in fetched:
        print(f"# fetched at keyframe of frame {line}")
    for c in corrections:
        print(f"# correction at frame {c['frame']} onto frame "
              f"{c['match_frame']}: _correct_loop {c['s'] * 1e3:.1f} ms; "
              f"current keyframe's centre error {c['before_m']:.4f} m "
              f"before, {c['after_m']:.4f} m after")

    _check(slam.state == "OK", f"final state {slam.state}")
    _check(lc.stats["queries"] > 0, "no database query was dispatched")
    _check(lc.stats["verified"] >= 1, "no candidate verified")
    _check(lc.stats["refines"] >= 2, f"refines {lc.stats['refines']}")
    _check(lc.stats["loops"] >= 1 and corrections, "no loop was closed")
    first = corrections[0]
    _check(first["after_m"] < first["before_m"],
           "the correction did not bring the current keyframe closer")
    rows = [(ts, Twc) for ts, Twc in slam.poses_wc()]
    est = np.stack([Twc[:3, 3] for _, Twc in rows])
    gt = np.stack([gt_centre[int(round(ts * 10))] for ts, _ in rows])
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    ate = evaluate.ate_rmse(est, gt)
    tail = float(np.mean(np.linalg.norm(est - gt, axis=1)[-12:]))
    print(f"# loop closing: ATE {ate:.4f} m on a {path:.2f} m path "
          f"({100 * ate / path:.3f}%, bar 2%); mean error of the last 12 "
          f"frames, not aligned, {tail:.4f} m ({100 * tail / path:.3f}%, "
          f"bar 2%)")
    _check(len(rows) == LOOP_FRAMES, f"{len(rows)} of {LOOP_FRAMES} frames "
           "have a pose")
    _check(np.isfinite(est).all() and ate < 0.02 * path, "ATE above 2%")
    _check(tail < 0.02 * path, "second-lap error above 2% of the path")
    _check(launches == LOOP_FRAMES,
           f"patch_gather launched {launches} times for {LOOP_FRAMES} frames")
    return launches


IMU_FRAMES = 120        # 12 s at 10 Hz
IMU_DT = 0.1
IMU_RATE = 200          # rows a second (configs/EuRoC-Inertial.yaml)
IMU_PATH_SCALE = 1.8    # the arc's 2.9 m stretched to 5.3 m over 120 frames
IMU_BLANK = 8           # blank frame pairs of the blackout


def phase_inertial():
    """Stereo-inertial SLAM at full width: phase 4's configuration (1248x384,
    2048 features, 8 levels, its map capacities and sparsifier parameters,
    loop closing off) with use_imu=True at the reference's defaults
    (imu_init_kfs=8, imu_init_time=1.0, SystemConfig's noise densities), Tbc
    the identity (synth.make_imu takes camera = body), 10 Hz frames with
    20 IMU rows each.

    The scene is tests/test_inertial_system.py's: PlaneWorld(z_wall=14,
    y_floor=2), make_trajectory(n, "arc"), and its blackout case's 8 blank
    frame pairs. Cuts and changes against that test: KITTI geometry and 2048
    features instead of 320x240 and 512; IMU_FRAMES = 120 frames instead of
    65-70 with the arc's translation stretched by IMU_PATH_SCALE = 1.8, so
    that the motion per frame stays the test's 4.4 cm while the run passes
    the 5 s stage at the default imu_init_time; max_frames_between_kf=10 as
    phase 4 instead of 3 (the inertial temporal rule sets the keyframe rate
    anyway); the blackout starts 4 frames after stage 2 is reached instead
    of at a fixed frame. Against configs/EuRoC-Inertial.yaml: its IMU rate
    (200 Hz); synthetic noise-free rows instead of its sensor; 10 Hz frames
    instead of 20 Hz; Tbc identity instead of its extrinsic.

    Held: state OK at the end on Atlas map 0; imu_initialized and stage >= 2;
    |norm(g) - 9.81| < 0.5 and g[1] / norm(g) > 0.95; RECENTLY_LOST seen in
    the blackout and OK after it; ATE over the visible frames under 6% of the
    path and under 2.5% before the blackout; track_full_imu taken on every
    frame dispatched after the initialization; no sparsification window
    before stage 2 and at least one by shutdown(); one patch-gather launch a
    frame; after _full_inertial_ba() everything finite, gravity inside the
    same bars, and the keyframe-centre RMSE against the truth not above 1.5
    times its value before."""
    from ms_slam_tpu_torch.models.map_state import MapConfig
    from ms_slam_tpu_torch.ops import imu as imu_ops
    from ms_slam_tpu_torch.ops import inertial_opt, orb
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline import system as system_mod
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
    from ms_slam_tpu_torch.utils import evaluate, synth

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
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
        sparsify_queue_min=2, nonlocal_kf=3, use_imu=True)
    poses = synth.make_trajectory(IMU_FRAMES, "arc")
    for T in poses:
        T[:3, 3] *= IMU_PATH_SCALE
    imu_rows = synth.make_imu(poses, IMU_DT, imu_rate=IMU_RATE)
    t0 = time.perf_counter()
    frames = _render_all("PlaneWorld", dict(z_wall=14.0, y_floor=2.0), K,
                         poses)
    print(f"# inertial ({card}): rendered {IMU_FRAMES} stereo frames in "
          f"{time.perf_counter() - t0:.1f} s; {len(imu_rows[0])} IMU rows a "
          f"frame")
    blank = np.zeros((H, W), np.uint8)

    slam = System(cfg, device="cuda")
    stage = {}
    pvb = inertial_opt.pose_vel_bias_optimize
    last_pvb = {}

    def timed_pvb(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pvb(*a, **k)
        torch.cuda.synchronize()
        stage.setdefault("pose_vel_bias_optimize", []).append(
            time.perf_counter() - t0)
        last_pvb["args"] = (a, k)
        return out
    inertial_opt.pose_vel_bias_optimize = timed_pvb
    integrate = imu_ops.integrate

    def timed_integrate(bias, meas, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = integrate(bias, meas, *a, **k)
        torch.cuda.synchronize()
        key = ("integrate, one frame's rows" if meas.dim() == 2
               else "integrate, a run of keyframe intervals")
        stage.setdefault(key, []).append(time.perf_counter() - t0)
        stage.setdefault(key + ": (intervals, rows)", []).append(
            (1 if meas.dim() == 2 else meas.shape[0],
             k.get("n_rows") or meas.shape[-2]))
        return out
    imu_ops.integrate = timed_integrate
    track_full = system_mod.to.track_full
    track_full_imu = system_mod.to.track_full_imu

    def timed_track_imu(ms, calib_, orb_, frame, R_last, t_last, *a, **k):
        """Times the inertial step; on every 5th one the visual step runs
        first on the same frame from the same poses, on a copy of the map
        (track_full updates point statistics in place)."""
        n = len(stage.get("track_full_imu", []))
        if n % 5 == 0:
            R2, t2 = slam._Rt_dev2 if slam._Rt_dev2 is not None \
                else (R_last, t_last)
            copy = type(ms)(*[v.clone() for v in ms])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            track_full(copy, calib_, orb_, frame, R_last, t_last, R2, t2,
                       slam._has_vel, *a[8:], **{kk: v for kk, v in k.items()
                                                 if kk != "n_rows"})
            torch.cuda.synchronize()
            stage.setdefault("track_full, same frames", []).append(
                time.perf_counter() - t0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = track_full_imu(ms, calib_, orb_, frame, R_last, t_last, *a, **k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        stage.setdefault("track_full_imu", []).append(dt)
        if n % 5 == 0:
            stage.setdefault("track_full_imu, same frames", []).append(dt)
        return out
    system_mod.to.track_full_imu = timed_track_imu

    torch.cuda.reset_peak_memory_stats()
    orb.patch_gather_launches = 0
    frame_s, states, stages, peaks = [], [], [], []
    blank_from = None
    imu_expected = 0
    windows_before_stage2 = 0
    for i in range(IMU_FRAMES):
        if blank_from is None and slam._imu_stage >= 2:
            blank_from = i + 4
        dark = blank_from is not None \
            and blank_from <= i < blank_from + IMU_BLANK
        img_l, img_r = (blank, blank) if dark else frames[i]
        imu_expected += int(slam.imu_initialized and slam.state == "OK")
        if slam._imu_stage < 2:
            windows_before_stage2 = slam._sparsifier.stats["windows"]
        t0 = time.perf_counter()
        if i == 0:
            slam.track_stereo(img_l, img_r, 0.0)
        else:
            slam.track_stereo_imu(img_l, img_r, IMU_DT * i, imu_rows[i - 1])
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        states.append(slam.state)
        stages.append((slam.imu_initialized, slam._imu_stage))
        peaks.append((torch.cuda.max_memory_allocated(), len(slam.kf_order)))
    slam._flush_pipeline()
    torch.cuda.synchronize()
    launches = orb.patch_gather_launches
    imu_ops.integrate = integrate
    system_mod.to.track_full_imu = track_full_imu
    inertial_opt.pose_vel_bias_optimize = pvb

    def first(pred):
        return next((i for i, s in enumerate(stages) if pred(s)), None)
    i_init, i_s2 = first(lambda s: s[0]), first(lambda s: s[1] >= 2)
    _check(i_init is not None, "the IMU was never initialized")
    _check(i_s2 is not None and blank_from is not None,
           f"inertial stage {slam._imu_stage}: stage 2 never reached")
    fs = np.asarray(frame_s)
    vis = np.ones(IMU_FRAMES, bool)
    vis[blank_from:blank_from + IMU_BLANK] = False
    after = np.arange(IMU_FRAMES) > i_init
    print(f"# inertial: initialized at frame {i_init}, stage 2 at frame "
          f"{i_s2}, blackout frames {blank_from}-"
          f"{blank_from + IMU_BLANK - 1}; "
          f"frames/s before initialization (frames 10-{i_init}) "
          f"{(i_init - 9) / fs[10:i_init + 1].sum():.3f}, after it (visible "
          f"frames) {(after & vis).sum() / fs[after & vis].sum():.3f}; frame "
          f"wall p50 {np.percentile(fs, 50) * 1e3:.2f} ms, p95 "
          f"{np.percentile(fs, 95) * 1e3:.2f} ms, max {fs.max() * 1e3:.2f} "
          f"ms; keyframes {slam.keyframes_in_map()}, map points "
          f"{slam.map_points_in_map()}; kernel launches {launches}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    # where the peak comes from: the frame after which it rose the most
    rise = np.diff([p for p, _ in peaks], prepend=peaks[0][0])
    i_rise = int(np.argmax(rise))
    print(f"# inertial: the peak rose most at frame {i_rise} "
          f"({peaks[i_rise - 1][0] / 2**20:.1f} -> "
          f"{peaks[i_rise][0] / 2**20:.1f} MiB), with "
          f"{peaks[i_rise][1]} keyframes created; "
          f"{peaks[i_init][0] / 2**20:.1f} MiB at the initialization")
    for k, v in slam.timing.items():
        if k.startswith("imu_init") or k == "inertial_window_ba":
            stage[f"System: {k}"] = v
    for k in sorted(stage):
        if k.endswith("(intervals, rows)"):
            continue
        v = np.asarray(stage[k])
        shape = stage.get(k + ": (intervals, rows)")
        extra = "" if shape is None else \
            f"; (intervals, rows) from {min(shape)} to {max(shape)}"
        print(f"# call {k:<40} n={len(v)} p50 "
              f"{np.percentile(v, 50) * 1e3:.2f} ms max {v.max() * 1e3:.2f} "
              f"ms (host clock between device syncs; {card}){extra}")

    # what the cheap re-orthonormalization (lie.orthonormalize, 4 launches)
    # saves over the quaternion round trip (lie.normalize_rotation, ~150) in
    # the joint refinement: the last frame's call again, in turns
    from ms_slam_tpu_torch.ops import lie
    newton = lie.orthonormalize
    a, k = last_pvb["args"]
    turns = []
    for name, fn in (("quaternion", lie.normalize_rotation),
                     ("newton", newton), ("newton", newton),
                     ("quaternion", lie.normalize_rotation)):
        lie.orthonormalize = fn
        ts = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pvb(*a, **k)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        turns.append(f"{name} {np.median(ts) * 1e3:.1f} ms "
                     f"({int(res.n_inliers)} inliers)")
    lie.orthonormalize = newton
    print("# call pose_vel_bias_optimize on the last frame's inputs, "
          "re-orthonormalizing by, in turns (median of 7): "
          + ", ".join(turns) + f" ({card})")

    g = np.asarray(slam.gravity, np.float64)
    print(f"# inertial: gravity {g.round(4).tolist()} (norm "
          f"{np.linalg.norm(g):.4f}), bias gyro "
          f"{np.float64(slam.imu_bias[:3]).round(5).tolist()} acc "
          f"{np.float64(slam.imu_bias[3:]).round(5).tolist()}; inertial steps "
          f"{slam.imu_frames} of {imu_expected} frames dispatched after the "
          f"initialization; windows before stage 2: {windows_before_stage2}")

    def gravity_ok(g):
        n = float(np.linalg.norm(g))
        return abs(n - 9.81) < 0.5 and g[1] / n > 0.95
    _check(slam.state == "OK" and slam.active_map == 0,
           f"final state {slam.state} on map {slam.active_map}")
    _check(slam.imu_initialized and slam._imu_stage >= 2, "inertial stage")
    _check(gravity_ok(g), f"gravity {g}")
    dark_states = states[blank_from:blank_from + IMU_BLANK + 1]
    _check("RECENTLY_LOST" in dark_states,
           f"the blackout was not felt: {dark_states}")
    _check(slam.imu_frames == imu_expected and imu_expected > 30,
           f"{slam.imu_frames} inertial steps for {imu_expected} frames")
    _check(windows_before_stage2 == 0,
           f"{windows_before_stage2} windows solved before stage 2")
    _check(launches == IMU_FRAMES,
           f"patch_gather launched {launches} times for {IMU_FRAMES} frames")

    def ate(rows):
        est = np.stack([Twc[:3, 3] for _, Twc in rows])
        gt = np.stack([poses[int(round(ts / IMU_DT))][:3, 3]
                       for ts, _ in rows])
        path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
        _check(np.isfinite(est).all(), "a pose is not finite")
        return evaluate.ate_rmse(est, gt), path
    rows = slam.poses_wc()
    t_dark = (IMU_DT * blank_from - 1e-6,
              IMU_DT * (blank_from + IMU_BLANK) - 1e-6)
    a_vis, p_vis = ate([r for r in rows if not t_dark[0] <= r[0] < t_dark[1]])
    a_pre, p_pre = ate([r for r in rows if r[0] < t_dark[0]])
    print(f"# inertial: ATE over the visible frames {a_vis:.4f} m on a "
          f"{p_vis:.2f} m path ({100 * a_vis / p_vis:.3f}%, bar 6%); before "
          f"the blackout {a_pre:.4f} m on {p_pre:.2f} m "
          f"({100 * a_pre / p_pre:.3f}%, bar 2.5%)")
    _check(a_vis < 0.06 * p_vis, "ATE over the visible frames above 6%")
    _check(a_pre < 0.025 * p_pre, "ATE before the blackout above 2.5%")

    def kf_rmse():
        err = []
        for slot in slam.kf_order:
            T = slam._kf_pose(slot)
            fid = int(slam.ms.kf_frame_id[slot])
            err.append(np.linalg.norm(-T[:3, :3].T @ T[:3, 3]
                                      - poses[fid][:3, 3]))
        return float(np.sqrt(np.mean(np.square(err))))
    before = kf_rmse()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam._full_inertial_ba()
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    after_ba = kf_rmse()
    g2 = np.asarray(slam.gravity, np.float64)
    print(f"# inertial: _full_inertial_ba over {len(slam.kf_order)} keyframes "
          f"{full_s * 1e3:.1f} ms ({card}); keyframe-centre RMSE "
          f"{before:.4f} m before, {after_ba:.4f} m after; gravity "
          f"{g2.round(4).tolist()}")
    ms = slam.ms
    _check(all(bool(torch.isfinite(t).all()) for t in (ms.kf_R, ms.kf_t,
                                                       ms.mp_pos))
           and np.isfinite(slam.kf_velocities).all()
           and np.isfinite(slam.imu_bias).all(), "non-finite after the BA")
    _check(gravity_ok(g2), f"gravity after the BA {g2}")
    _check(after_ba <= 1.5 * before + 1e-4,
           f"keyframe RMSE {before:.4f} -> {after_ba:.4f} m")
    slam.shutdown()
    torch.cuda.synchronize()
    n_win = slam._sparsifier.stats["windows"]
    print(f"# inertial: sparsification windows by shutdown(): {n_win}")
    _check(n_win >= 1, "no sparsification window by shutdown()")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after phase 3 (no status line is printed)")
    ap.add_argument("--loop-only", action="store_true",
                    help="phases 1-3 and 7 only (no status line is printed)")
    ap.add_argument("--imu-only", action="store_true",
                    help="phases 1-3 and 8 only (no status line is printed)")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="another checkout of this repository: phase 3 also "
                    "builds its patch_gather.cu and times the two kernels "
                    "in turns (parent, this, this, parent)")
    args = ap.parse_args()
    phase_device()
    phase_build()
    kern = phase_kernel(args.parent)
    by_phase = {}
    part = args.kernel_only or args.loop_only or args.imu_only
    if not part:
        run = phase_main_path()
        by_phase["main_path"] = run["launches"]
        by_phase["relocalization"] = phase_relocalize(run)
        phase_ties_and_selector(run["window"])
    if not (args.kernel_only or args.imu_only):
        by_phase["loop_closing"] = phase_loop_closing()
    if not (args.kernel_only or args.loop_only):
        by_phase["inertial"] = phase_inertial()
    print(json.dumps({"kernels": [{
        "name": "patch_gather", "route": "cuda",
        "source": "ms_slam_tpu_torch/csrc/patch_gather.cu",
        "replaces": "ms_slam_tpu/ops/orb.py:665",
        "launches": sum(by_phase.values()) if by_phase else None,
        "launches_by_phase": by_phase, **kern}]}))
    if part:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
