"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the hand-written CUDA kernels from the sources in the
     checkout (ms_slam_tpu_torch/csrc) into ms_slam_tpu_torch/_build and
     prints what `nvcc -Xptxas -v` said of each (registers, spills);
  3. kernel vs plain: the patch-gather kernel against its plain PyTorch
     version at the stereo main path's shapes, bit for bit; then the
     kernel's own time (200 launches of its C entry point between two CUDA
     events, L2 warm; one event pair per launch after a 256 MiB write, L2
     cold) beside its bound (bytes over 3.35 TB/s), the plain version and
     the nearest single PyTorch call; then the same check and times at the
     monocular / RGB-D shape (one 384x5888 canvas, 2048 keypoints), the
     stereo-fisheye shape (two 512x2560 canvases, 2 x 1024 keypoints), the
     EuRoC shape of phase 13 (two 480x3584 canvases, 2 x 1280) and the
     padded level stack of phase 18's stack extractor (2 x 8 planes of
     384x1248, 2 x 2048 keypoints, each keypoint's image index its plane);
     then the kernel's bf16 entry point (the canvas of
     MSSLAM_FORCE_TPU_NUMERICS) the same way on a bf16 canvas at the
     stereo, the monocular / RGB-D, the stereo-fisheye and the EuRoC
     shapes, bit for bit against the plain version's bf16 gather widened to
     f32; then the pose_vel_bias kernel (inertial_opt.pose_vel_bias_optimize
     on the card) at the corridor's 1,280 matches, against its plain
     version within tests/test_torch_pvb_kernel.py's tolerances, and its
     time alone (200 launches of its C entry point between two events, L2
     warm; one event pair a launch after a 256 MiB write, L2 cold) beside
     the plain version's and the wrapper's, each between events; then the
     same kernel with an unrectified KB8 pair's right rows (TUM-VI's rig,
     the walk cell's 1,024 matches; tests/test_torch_rig_inertial.py's
     scenario) against its plain version and the plain two-camera model
     of bench_port/reference/rig.py, and its time the same way; then the
     pose_opt kernel (pose_opt.pose_optimize on the card) at the drive's
     2,048 matches (the local map's 4 x 10, the motion stage's 2 x 5) and
     the walk's 1,024 with their right keypoints, against its plain version
     within tests/test_torch_pose_opt_kernel.py's tolerances, and its time
     the same way;
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
  9. monocular at full width: System.track_monocular over 60 frames of
     tests/test_mono_rgbd.py's scene, from the two-view initialization on
     (phase_mono);
 10. RGB-D at full width: System.track_rgbd over 40 frames of the same
     scene with rendered depth, then 10 frames in localization mode
     (phase_rgbd);
 11. stereo fisheye at the TUM-VI geometry (two KB8 cameras, 512x512,
     1024 features): the frontend's triangulated depths on frame 0 against
     the render, then System.track_stereo over 40 frames of
     tests/test_fisheye.py's scene (phase_fisheye);
 12. mono-inertial at full width: System.track_monocular_imu over
     tests/test_inertial_system.py's 70-frame excited arc to a metric map
     (phase_mono_inertial);
 13. the CLI path at configs/EuRoC-Inertial.yaml's width: the verify
     skill's fabricated EuRoC dataset through the port's own
     examples.gen_fake_euroc, examples.stereo_inertial_euroc and
     examples.evaluate_ate, then a checkpoint saved, loaded into a fresh
     System and relocalized against, and the viewer's outputs
     (phase_cli);
 14. the Atlas merge and the sharded global BA at full width, on the
     System phase 7 leaves (run right after it): `_merge_maps` of the
     second lap's keyframes, moved by a known offset, back onto the first
     lap's map; then `parallel.dist_ba.dist_global_ba` on 1 and 4 shards of
     the card and `mapping_ops.global_ba` from one perturbed copy of the
     merged map, held by the robust reprojection cost, and the branch a
     System with dist_ba_devices=4 takes on this machine
     (phase_merge_and_dist_ba);
 15. the Atlas at full width: tests/test_atlas.py's new map after an
     irrecoverable loss with a merge found by place recognition, then its
     cross-map relocalization, on phase 7's circuit (phase_atlas);
 16. an inertial loop closure at full width: phase 7's circuit with
     use_imu, a biased, noisy IMU and configs/EuRoC-Inertial.yaml's
     camera-to-body transform, closed through the 4-DoF essential graph
     (phase_inertial_loop);
 17. the memory A/B (phase 4's frames with sparsification on and off) and
     pool recycling (the same frames, pools the run overflows)
     (phase_memory); phases 16 and 15 in turn, and 17, 18 and 19 in turn,
     run in two more processes beside phases 8-13, on the same card;
 18. bench.py's software pipeline (bench.py:35,92-106): phase 4's frames
     and configuration with MSSLAM_PIPELINE_DEPTH=4 (three frames in
     flight, completed two at a time) and next_images on every frame, so
     each frame's frontend is prefetched on a side stream while the frames
     before it complete; then the padded-stack extractor and its stereo
     matcher at full width on frame 0 (phase_pipeline); run after phase 17
     in its process;
 19. the reference's TPU numerics: phase 4's frames and configuration with
     MSSLAM_FORCE_TPU_NUMERICS=1, so every canvas is bf16 and every patch
     gather goes through the kernel's bf16 entry point; then frame 0 on the
     card against the CPU under the switch (phase_tpu_numerics); run after
     phase 18 in its process;
  then a JSON line of per-kernel results (the f32 and the bf16 entry point,
  the pose_vel_bias and the pose_opt kernel) and the final JSON status line.
Every phase from 4 on checks the kernel's launches in its run: one a frame
(none in phase 14, which renders no frame; in phase 19 one bf16 launch a
frame and no f32 launch). The phases that track with an IMU (8, 12, 13 and
16) also set the pose_vel_bias kernel's count to 0 before their run and
check one launch an inertial step after it; phase 8 then holds the kernel
against the plain version on its last inertial frame's inputs. Phase 4 also
checks one pose_opt launch for each `pose_opt.kernel` event, one of those
for each `pose_opt` event, and two of those at least a tracked frame.

Options, for work on one part: --kernel-only stops after phase 3,
--loop-only runs phases 1-3, 7 and 14, --imu-only phases 1-3 and 8,
--sensors-only phases 1-3 and 9-12, --cli-only phases 1-3 and 13,
--atlas-only phases 1-3 and 15, --imu-loop-only phases 1-3 and 16,
--memory-only phases 1-3 and 17, --pipeline-only phases 1-3 and 18 (and
beside it the same run at depth 2, for a comparison in one call),
--tpu-numerics-only phases 1-3 and 19 (and beside it the same frames with
the f32 canvas); none of them prints a status line.
--sync-census [CELL] runs phases 1-2, then 20 frames of a benchmark cell
(`bench_port/`; the drive by default) after its warm-up, under
`torch.cuda.set_sync_debug_mode("warn")`: every call that blocks the host
on the card, counted a frame by the port's line that made it and by the
innermost span open then (`sync.*` spans are the marked blocking points);
also the spans a frame and one span's host cost.
--parent DIR also builds the patch_gather.cu of another checkout of this
repository (same C interface), holds its entry points bit for bit too and
times the two in turns in phase 3 (parent, this, this, parent; L2 warm and
cold): the f32 entry point at the stereo shape, the bf16 one at the stereo
and the monocular / RGB-D shapes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
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


# the kernels' entry points, whose launches `_native.calls` counts
PG, PG_BF16 = "msslam_patch_gather_f32", "msslam_patch_gather_bf16"
PVB, POSE_OPT = "msslam_pose_vel_bias", "msslam_pose_opt"


def _calls(key: str) -> int:
    """Launches of an entry point (or plain calls of a wrapper) so far."""
    from ms_slam_tpu_torch.ops import _native
    return _native.calls[key]


def _reset(*keys: str):
    from ms_slam_tpu_torch.ops import _native
    for key in keys:
        _native.calls[key] = 0


def _check(cond: bool, msg: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_device():
    _check(torch.cuda.is_available(), "no CUDA device (this script needs one)")
    print(f"# nvidia-smi: {_card()}")
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")


def phase_build():
    from ms_slam_tpu_torch.ops import _native
    for name in ("patch_gather", "pose_vel_bias", "pose_opt"):
        t0 = time.perf_counter()
        _native.build(name)
        _native.load(name)
        print(f"# build: {name}.cu in {time.perf_counter() - t0:.2f} s; "
              "nvcc -Xptxas -v said:")
        for line in _native.build_log.get(name, "").splitlines():
            if ("ptxas info" in line and "Compiling" not in line) \
                    or "spill" in line:
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


def _kernel_inputs(B=2, Hc=H, Wc=5888, n=2048):
    """Patch-gather inputs (B canvases of Hc x Wc, n keypoints per image, or
    n[b] in image b), with centres beyond all four clip edges. The defaults
    are the stereo main path's shapes."""
    dev = torch.device("cuda")
    counts = torch.as_tensor(n, device=dev).expand(B)
    n_all = int(counts.sum())
    g = torch.Generator(device=dev).manual_seed(0)
    canvas = torch.rand((B, Hc, Wc), generator=g, device=dev) * 255.0
    ys = torch.randint(-8, Hc + 8, (n_all,), generator=g, device=dev,
                       dtype=torch.int32)
    xs = torch.randint(-8, Wc + 8, (n_all,), generator=g, device=dev,
                       dtype=torch.int32)
    # explicit corners and edges: top, bottom, left, right
    ys[:8] = torch.tensor([0, Hc - 1, 5, Hc + 3, 10, 200, -3, 100],
                          dtype=torch.int32)
    xs[:8] = torch.tensor([0, Wc - 1, 3000, 10, -5, Wc + 2, 40, Wc - 3],
                          dtype=torch.int32)
    bi = torch.arange(B, device=dev, dtype=torch.int32).repeat_interleave(
        counts)
    return canvas, bi, ys, xs


def _c_launch(canvas, bi, ys, xs, out, c_fn=None):
    """A closure that calls the gather's C entry point for the canvas's
    dtype directly, its arguments checked and built once: no allocation,
    so a run of calls keeps the device busy. c_fn: another checkout's
    entry point of the same C interface in place of this one's."""
    from ms_slam_tpu_torch.ops import orb
    entry = orb._GATHER[canvas.dtype]
    c_fn = entry.fn() if c_fn is None else entry.bind(c_fn)
    B, Hc, Wc = canvas.shape
    args = entry.args(canvas.device, canvas=canvas, bi=bi, ys=ys, xs=xs,
                      out=out, n=bi.shape[0], B=B, H=Hc, Wc=Wc)

    def launch():
        rc = c_fn(*args)
        _check(rc == 0, f"kernel launch failed: CUDA error {rc}")
    launch.tensors = (canvas, bi, ys, xs, out)    # keep the pointers alive
    return launch


def _build_parent(parent_dir):
    """The patch-gather kernel of another checkout (same C interface),
    built beside this one's for a comparison in one call: its f32 and its
    bf16 entry point."""
    import ctypes
    import os

    from ms_slam_tpu_torch.ops import _native
    src = os.path.join(parent_dir, "ms_slam_tpu_torch", "csrc",
                       "patch_gather.cu")
    lib = os.path.join(_native.BUILD_DIR, "libpatch_gather_parent.so")
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    parent = ctypes.CDLL(lib)
    return parent.msslam_patch_gather_f32, parent.msslam_patch_gather_bf16


def phase_kernel(parent_dir=None):
    """Patch gather at the main path's shapes: bit for bit against the plain
    version through the wrapper, then the kernel's own time (its C entry
    point, output allocated once) with the L2 cache warm and cold, beside
    its bound, the plain version and the nearest single PyTorch call."""
    from ms_slam_tpu_torch.ops import _native, orb
    _, Wc, _ = orb.canvas_layout(H, W, orb.OrbConfig(n_features=2048,
                                                     n_levels=8))
    _check(Wc == 5888, f"canvas width {Wc} != 5888")
    _, Wc_euroc, _ = orb.canvas_layout(480, 752, orb.OrbConfig(
        n_features=1280, n_levels=8))
    _check(Wc_euroc == 3584, f"EuRoC canvas width {Wc_euroc} != 3584")
    _check(list(STACK_QUOTAS[:8]) == orb.OrbConfig(
        n_features=2048, n_levels=8).level_quotas(), "stack quotas")
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

    buf = torch.empty_like(out)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    this = _c_launch(canvas, bi, ys, xs, buf)
    this()
    torch.cuda.synchronize()
    _check(torch.equal(buf, ref), "kernel != plain through its C entry")
    parent_f32 = parent_bf16 = None
    if parent_dir is not None:
        parent_f32, parent_bf16 = _build_parent(parent_dir)
        buf_p = torch.empty_like(out)
        parent = _c_launch(canvas, bi, ys, xs, buf_p, parent_f32)
        parent()
        torch.cuda.synchronize()
        _check(torch.equal(buf_p, ref), "the parent's kernel != plain")
        _in_turns(parent, this, flush, bound_ms, "patch_gather")
    ms = _run_ms(this)
    ms_cold = _cold_ms(this, flush)
    wrapper_ms = _cuda_ms(lambda: orb.extract_patches_canvas(
        canvas, bi, ys, xs))
    plain_ms = _run_ms(lambda: orb.extract_patches_canvas_plain(
        canvas, bi, ys, xs), n=50, warmup=5)
    library_ms = _library_ms(canvas, bi, ys, xs, ref, "main path")
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
    one = _c_launch(canvas, bi[:4].clone(), ys[:4].clone(), xs[:4].clone(),
                    buf)
    one_ms = _run_ms(one)
    print(f"#   same method: Tensor.fill_ of the {out.numel() * 4} B output "
          f"{fill_ms:.4f} ms; Tensor.copy_ into it from a tensor of its size "
          f"(as many bytes through the SMs as the gather) {copy_ms:.4f} ms; "
          f"the kernel on one group of 4 keypoints {one_ms:.4f} ms")
    print(f"#   one event pair around one call of the checking wrapper "
          f"(host gap inside the span), median of 50: {wrapper_ms:.4f} ms; "
          f"plain version {plain_ms:.4f} ms; nearest library call "
          f"(canvas.reshape(-1)[idx], index prebuilt) {library_ms:.4f} ms")
    shapes = [_kernel_at_shape(name, *shape)
              for name, shape in SENSOR_KERNEL_SHAPES]
    resident = _native.load(
        "patch_gather").msslam_patch_gather_bf16_resident_blocks()
    _check(resident > 0, f"patch_gather_bf16: resident blocks {resident}")
    print(f"# patch_gather_bf16: {resident} resident blocks on the card (its "
          "grid at most)")
    bf16 = [_kernel_at_shape(name, *shape, dtype=torch.bfloat16,
                             parent=parent_bf16 if name in BF16_IN_TURNS
                             else None)
            for name, shape in BF16_KERNEL_SHAPES]
    return {"max_abs_err": max([err] + [x["max_abs_err"] for x in shapes]),
            "ms": ms, "ms_cold": ms_cold,
            "ms_wrapper_call": wrapper_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "share_of_bound": bound_ms / ms,
            "share_of_bound_cold": bound_ms / ms_cold,
            "other_shapes": shapes, "bf16": bf16}


def _in_turns(parent, this, flush, bound_ms, label):
    """Two kernels' C entry points timed parent, this, this, parent (L2
    warm, then cold, each turn); returns the four turns' times."""
    turns = []
    for who, fn in (("parent", parent), ("this", this), ("this", this),
                    ("parent", parent)):
        w, c = _run_ms(fn), _cold_ms(fn, flush)
        turns.append({"who": who, "ms": w, "ms_cold": c})
        print(f"# in turns, {label}, {who:<6}: warm {w:.4f} ms "
              f"({100 * bound_ms / w:.1f}% of the bound), cold "
              f"{c:.4f} ms ({100 * bound_ms / c:.1f}%)")
    return turns


PVB_N = 1280    # the corridor's matches (EuRoC's 1200 features, rounded up)


def _pvb_cases():
    """tests/test_torch_pvb_kernel.py (numpy and the port only), loaded from
    its file for its scenario and its comparison with the plain version."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_pvb_kernel.py")
    threads = torch.get_num_threads()
    spec = importlib.util.spec_from_file_location("pvb_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.set_num_threads(threads)      # the test file pins one thread
    return mod


def phase_pvb_kernel():
    """pose_vel_bias_optimize's kernel at the corridor's shape (1,280
    matches, 4 rounds x 6 steps): against the plain version through the
    wrapper, then its own time through its C entry point (arguments built
    once, so a run of launches keeps the card busy) with the L2 cache warm
    and cold, beside the wrapper's call and the plain version's (each
    between CUDA events)."""
    from ms_slam_tpu_torch.ops import imu, inertial_opt
    cases = _pvb_cases()
    args, kw, _ = cases.scenario(torch.device("cuda"), N=PVB_N)
    out = inertial_opt.pose_vel_bias_optimize(*args, **kw)
    ref = inertial_opt.pose_vel_bias_optimize_plain(*args, **kw)
    torch.cuda.synchronize()
    cases._assert_close(out, ref)
    err = {"rot_rad": cases._rot_err(out.R_wb, ref.R_wb),
           **{k: float((getattr(out, k) - getattr(ref, k)).abs().max())
              for k in ("p_wb", "v", "bg", "ba")},
           "inliers_differ": int((out.inlier != ref.inlier).sum())}
    LT = imu.sqrt_information(args[10]).transpose(-1, -2).contiguous()
    call, c_out = inertial_opt._kernel_call(
        *args[:11], LT, *args[11:], kw["walk_info"], 4, 6, kw["g"])
    c_args = inertial_opt.KERNEL.args(args[11].device, **call)
    fn = inertial_opt.KERNEL.fn()

    def launch():
        rc = fn(*c_args)
        _check(rc == 0, f"pose_vel_bias launch failed: CUDA error {rc}")
    launch.tensors = (args, kw, LT, call)       # keep the pointers alive
    launch()
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(c_out, out)
               if a is not None),
           "pose_vel_bias: two launches on the same inputs differ")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    ms = _run_ms(launch)
    ms_cold = _cold_ms(launch, flush)
    wrapper_ms = _cuda_ms(
        lambda: inertial_opt.pose_vel_bias_optimize(*args, **kw), n=50)
    plain_ms = _run_ms(
        lambda: inertial_opt.pose_vel_bias_optimize_plain(*args, **kw),
        n=5, warmup=2, reps=3)
    # the inputs read once: 28 bytes a match's floats and 1 its mask, the
    # state, the preintegration and L^T; the outputs written once
    n_bytes = 4 * sum(t.numel() for t in (*args[1:2], *args[3:10],
                                          *[getattr(args[10], k) for k
                                            in imu.PreintState._fields
                                            if k != "C"],
                                          LT, *args[11:18], kw["walk_info"],
                                          kw["g"])) \
        + 2 * PVB_N + 4 * 22
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"# pose_vel_bias, {PVB_N} matches, 4 x 6 steps ({_card()}): "
          f"against the plain version rotation {err['rot_rad']:.2e} rad, p "
          f"{err['p_wb']:.2e}, v {err['v']:.2e}, bg {err['bg']:.2e}, ba "
          f"{err['ba']:.2e}, inlier slots differing {err['inliers_differ']}"
          f"; inliers {int(out.n_inliers)} / {int(ref.n_inliers)}")
    print(f"#   kernel alone, 200 launches between two events (L2 warm), "
          f"median of 5 runs: {ms:.4f} ms; L2 cold, median of 50 event "
          f"pairs: {ms_cold:.4f} ms; bytes {n_bytes} ({bound_ms * 1e3:.3f} "
          f"us at 3.35 TB/s: bound by its 24 dependent steps, not bytes)")
    print(f"#   one event pair around the wrapper's call (sqrt_information, "
          f"checks, launch), median of 50: {wrapper_ms:.4f} ms; plain "
          f"version, 5 calls between two events: {plain_ms:.4f} ms a call")
    return {"max_abs_err": max(v for k, v in err.items()
                               if k not in ("inliers_differ",)),
            "err": err, "ms": ms, "ms_cold": ms_cold,
            "ms_wrapper_call": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "latency (24 dependent steps)",
            "bytes": n_bytes}


PVB_RIG_N = 1024   # the walk's matches (TUM-VI's 1024 features)


def phase_pvb_kernel_rig():
    """pose_vel_bias_optimize's kernel with right rows (one launch of
    `msslam_pose_vel_bias` with the rig's pointers) at the walk's 1,024
    matches: against the
    plain version (tests/test_torch_pvb_kernel.py's tolerances, the right
    rows' flags within 2 slots) and the reference's chi2 gate at its
    solution, then its own time through its C entry point, L2 warm and
    cold, and the wrapper's call."""
    from ms_slam_tpu_torch.ops import imu, inertial_opt
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    threads = torch.get_num_threads()
    import test_torch_pvb_kernel
    import test_torch_rig_inertial as cases
    torch.set_num_threads(threads)      # the test files pin one thread
    args, kw, _ = cases.rig_scenario(torch.device("cuda"), N=PVB_RIG_N)
    before = _calls(PVB)
    out = inertial_opt.pose_vel_bias_optimize(*args, **kw)
    torch.cuda.synchronize()
    _check(_calls(PVB) == before + 1,
           "pose_vel_bias with right rows: not one launch")
    ref = inertial_opt.pose_vel_bias_optimize_plain(*args, **kw)
    cases._assert_close(out, ref)
    gate = cases._gate(out, args, kw)
    err = {"rot_rad": test_torch_pvb_kernel._rot_err(out.R_wb, ref.R_wb),
           **{k: float((getattr(out, k) - getattr(ref, k)).abs().max())
              for k in ("p_wb", "v", "bg", "ba")},
           "inliers_differ": int((out.inlier != ref.inlier).sum()),
           "right_differ": int((out.inlier_r != ref.inlier_r).sum()),
           "right_differ_reference": int((out.inlier_r.cpu() != gate).sum())}
    _check(err["right_differ"] <= 2 and err["right_differ_reference"] <= 2,
           f"pose_vel_bias right rows differ: {err}")
    LT = imu.sqrt_information(args[10]).transpose(-1, -2).contiguous()
    call, c_out = inertial_opt._kernel_call(
        *args[:11], LT, *args[11:], kw["walk_info"], 4, 6, kw["g"],
        kw["rig"], kw["right"])
    c_args = inertial_opt.KERNEL.args(args[11].device, **call)
    fn = inertial_opt.KERNEL.fn()

    def launch():
        rc = fn(*c_args)
        _check(rc == 0, f"pose_vel_bias launch failed: CUDA error {rc}")
    launch.tensors = (args, kw, LT, call)       # keep the pointers alive
    launch()
    torch.cuda.synchronize()
    _check(all(torch.equal(a, b) for a, b in zip(c_out, out)),
           "pose_vel_bias with right rows: two launches on the same "
           "inputs differ")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    ms = _run_ms(launch)
    ms_cold = _cold_ms(launch, flush)
    wrapper_ms = _cuda_ms(
        lambda: inertial_opt.pose_vel_bias_optimize(*args, **kw), n=50)
    print(f"# pose_vel_bias with right rows, {PVB_RIG_N} matches, 4 x 6 "
          f"steps ({_card()}): against the plain version rotation "
          f"{err['rot_rad']:.2e} rad, p {err['p_wb']:.2e}, v {err['v']:.2e}"
          f", bg {err['bg']:.2e}, ba {err['ba']:.2e}, inlier slots "
          f"differing {err['inliers_differ']}, right rows' flags differing "
          f"{err['right_differ']} (from the reference's gate "
          f"{err['right_differ_reference']}); inliers {int(out.n_inliers)}"
          f" / {int(ref.n_inliers)}, right rows {int(out.n_right)} / "
          f"{int(ref.n_right)}")
    print(f"#   kernel alone, 200 launches between two events (L2 warm), "
          f"median of 5 runs: {ms:.4f} ms; L2 cold, median of 50 event "
          f"pairs: {ms_cold:.4f} ms; the wrapper's call, median of 50 event "
          f"pairs: {wrapper_ms:.4f} ms")
    return {"err": err, "ms": ms, "ms_cold": ms_cold,
            "ms_wrapper_call": wrapper_ms, "n_right": int(out.n_right)}


# pose_optimize's shapes on the main paths: the drive's 2,048 matches at
# the local map's 4 x 10 and the motion stage's 2 x 5, and the walk's 1,024
# with their right keypoints at 4 x 10
POSE_OPT_SHAPES = (("drive 4x10", dict(N=2048), (4, 10)),
                   ("drive 2x5", dict(N=2048), (2, 5)),
                   ("walk 4x10", dict(N=1024, model=1, rig=True), (4, 10)))


def phase_pose_opt_kernel():
    """pose_optimize's kernel at the drive's and the walk's shapes: one
    launch through the wrapper against the plain version
    (tests/test_torch_pose_opt_kernel.py's scenes and tolerances; the walk's
    right rows' flags against the plain version's gate), then its own time
    through its C entry point (arguments built once, so a run of launches
    keeps the card busy) with the L2 cache warm and cold, beside the
    wrapper's call and the plain version's (each between CUDA events)."""
    import importlib.util
    from ms_slam_tpu_torch.ops import pose_opt
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "test_torch_pose_opt_kernel.py")
    threads = torch.get_num_threads()
    spec = importlib.util.spec_from_file_location("pose_opt_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    torch.set_num_threads(threads)      # the test file pins one thread
    fn = pose_opt.KERNEL.fn()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = []
    for label, scene, (nr, ni) in POSE_OPT_SHAPES:
        args, kw, _ = cases.scenario(torch.device("cuda"), **scene)
        before = _calls(POSE_OPT)
        out = pose_opt.pose_optimize(*args, n_rounds=nr, n_iters=ni, **kw)
        torch.cuda.synchronize()
        _check(_calls(POSE_OPT) == before + 1,
               f"pose_opt {label}: not one launch")
        ref = pose_opt.pose_optimize_plain(*args, n_rounds=nr, n_iters=ni,
                                           **kw)
        cases._assert_close(out, ref)
        err = {"rot_rad": cases._rot_err(out.R.cpu(), ref.R.cpu()),
               "t": float((out.t - ref.t).abs().max()),
               "chi2_rel": abs(float(out.chi2) / float(ref.chi2) - 1),
               "inliers_differ": int((out.inlier != ref.inlier).sum())}
        call, c_out = pose_opt._kernel_call(*args, nr, ni, **kw)
        inlier_r = call["inlier_r"]
        c_args = pose_opt.KERNEL.args(args[3].device, **call)

        def launch(c_args=c_args):
            rc = fn(*c_args)
            _check(rc == 0, f"pose_opt launch failed: CUDA error {rc}")
        launch.tensors = (args, kw, call)       # keep the pointers alive
        launch()
        torch.cuda.synchronize()
        _check(all(torch.equal(a, b) for a, b in zip(c_out, out)
                   if a is not None),
               f"pose_opt {label}: two launches on the same inputs differ")
        if inlier_r is not None:
            want = cases.right_flags(ref.R, ref.t, args, kw)
            err["right_differ"] = int((inlier_r.cpu().numpy() != want).sum())
            _check(err["right_differ"] <= 2,
                   f"pose_opt {label}: right rows' flags differ: {err}")
        ms = _run_ms(launch)
        ms_cold = _cold_ms(launch, flush)
        wrapper_ms = _cuda_ms(lambda: pose_opt.pose_optimize(
            *args, n_rounds=nr, n_iters=ni, **kw), n=50)
        plain_ms = _run_ms(lambda: pose_opt.pose_optimize_plain(
            *args, n_rounds=nr, n_iters=ni, **kw), n=5, warmup=2, reps=3)
        # the inputs read once (28 bytes a match's floats, 1 its mask, 12
        # its right keypoint), the outputs written once
        N = scene["N"]
        n_bytes = 4 * (8 + 9 + 3 + 7 * N) + N + 4 * 13 + N + 4
        if inlier_r is not None:
            n_bytes += 4 * (8 + 12 + 3 * N) + N + 4
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        print(f"# pose_opt {label}, {N} matches ({_card()}): against the "
              f"plain version rotation {err['rot_rad']:.2e} rad, t "
              f"{err['t']:.2e}, chi2 {err['chi2_rel']:.2e} relative, inlier "
              f"slots differing {err['inliers_differ']}"
              + (f", right rows' flags from the gate {err['right_differ']}"
                 if inlier_r is not None else "")
              + f"; inliers {int(out.n_inliers)} / {int(ref.n_inliers)}")
        print(f"#   kernel alone, 200 launches between two events (L2 warm), "
              f"median of 5 runs: {ms:.4f} ms; L2 cold, median of 50 event "
              f"pairs: {ms_cold:.4f} ms; bytes {n_bytes} "
              f"({bound_ms * 1e3:.3f} us at 3.35 TB/s: bound by its "
              f"{nr * ni} dependent iterations, not bytes); the wrapper's "
              f"call, median of 50 event pairs: {wrapper_ms:.4f} ms; plain "
              f"version, 5 calls between two events: {plain_ms:.4f} ms a "
              f"call")
        rows.append({"shape": label, "err": err, "ms": ms, "ms_cold": ms_cold,
                     "ms_wrapper_call": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bytes": n_bytes})
    return {**{k: rows[0][k] for k in ("ms", "ms_cold", "ms_wrapper_call",
                                        "plain_ms", "bound_ms")},
            "bound_by": "latency (40 dependent iterations)",
            "max_abs_err": max(max(r["err"]["rot_rad"], r["err"]["t"])
                               for r in rows),
            "other_shapes": rows[1:]}


def _library_ms(canvas, bi, ys, xs, ref, name):
    """Time of the nearest single PyTorch call: the plain version's last
    step alone, `canvas.reshape(-1)[idx]` on an (n, 2025) int64 index built
    beforehand (66 MB at the main path's shape, which the kernel never
    reads), then `.float()` on a bf16 canvas; the port does not call it."""
    from ms_slam_tpu_torch.ops import orb
    B, Hc, Wc = canvas.shape
    R = orb.EXTRACT_R
    base = ((bi.long().clamp(0, B - 1) * Hc + ys.long().clamp(R, Hc - R - 1)
             - R) * Wc + xs.long().clamp(R, Wc - R - 1) - R)
    ar = torch.arange(2 * R + 1, device=canvas.device)
    idx = base[:, None] + (ar[:, None] * Wc + ar[None, :]).reshape(1, -1)
    flat = canvas.reshape(-1)
    _check(torch.equal(flat[idx].float().view(-1, 45, 45), ref),
           f"{name}: library call")
    return _run_ms(lambda: flat[idx].float(), n=50, warmup=5)


# the kernel's shapes on the monocular / RGB-D path (one 1248x384 image,
# 2048 keypoints), on the stereo-fisheye path (two 512x512 images, 1024
# keypoints each), on the CLI path of phase 13 (two 752x480 EuRoC images,
# configs/EuRoC-Inertial.yaml's 1200 features rounded up to 1280) and in
# phase 18's stack extractor (two 1248x384 images' 8 levels as 16 full-size
# planes; each level's quota of 2048 keypoints in its plane): (B, canvas
# height, canvas width, keypoints per image or per plane)
STACK_QUOTAS = (445, 371, 309, 257, 214, 179, 149, 124) * 2
SENSOR_KERNEL_SHAPES = (("mono_rgbd", (1, 384, 5888, 2048)),
                        ("fisheye", (2, 512, 2560, 1024)),
                        ("euroc", (2, 480, 3584, 1280)),
                        ("stack", (16, 384, 1248, STACK_QUOTAS)))


# the bf16 entry point (the canvas of MSSLAM_FORCE_TPU_NUMERICS) at the
# stereo main path's shape, the monocular / RGB-D shape, and the
# stereo-fisheye and EuRoC shapes (those frontends build a bf16 canvas under
# the switch too); with --parent, timed in turns at the first two
BF16_KERNEL_SHAPES = (("stereo", (2, 384, 5888, 2048)),
                      ("mono_rgbd", (1, 384, 5888, 2048)),
                      ("fisheye", (2, 512, 2560, 1024)),
                      ("euroc", (2, 480, 3584, 1280)))
BF16_IN_TURNS = ("stereo", "mono_rgbd")


def _kernel_at_shape(name, B, Hc, Wc, n, dtype=torch.float32,
                     parent=None):
    """The kernel at another shape of the main paths (or its bf16 entry
    point on a bf16 canvas): bit for bit against the plain version (a bf16
    gather widened to f32) through the wrapper, then its own time (L2 warm
    and cold) beside its bound, one call of the wrapper and the plain
    version; with `parent` (another checkout's C entry point for the same
    dtype), that one bit for bit too and the two timed in turns."""
    from ms_slam_tpu_torch.ops import orb
    canvas, bi, ys, xs = _kernel_inputs(B, Hc, Wc, n)
    canvas = canvas.to(dtype)
    bf16 = dtype == torch.bfloat16
    entry = PG_BF16 if bf16 else PG
    before = _calls(entry)
    out = orb.extract_patches_canvas(canvas, bi, ys, xs)
    ref = orb.extract_patches_canvas_plain(canvas, bi, ys, xs).float()
    torch.cuda.synchronize()
    _check(_calls(entry) == before + 1, f"{name}: {entry} launches")
    n_all = bi.shape[0]
    _check(out.shape == ref.shape == (n_all, 45, 45), f"{name}: patch shape")
    err = float((out - ref).abs().max())
    _check(torch.equal(out, ref), f"{name}: kernel != plain (max abs err "
           f"{err})")
    n_bytes = (4 * (out.numel() + 3 * bi.numel())
               + canvas.element_size() * canvas.numel())
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    buf = torch.empty_like(out)
    fn = _c_launch(canvas, bi, ys, xs, buf)
    fn()
    torch.cuda.synchronize()
    _check(torch.equal(buf, ref), f"{name}: kernel != plain, C entry")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    turns = None
    if parent is not None:
        buf_p = torch.empty_like(out)
        fn_p = _c_launch(canvas, bi, ys, xs, buf_p, parent)
        fn_p()
        torch.cuda.synchronize()
        _check(torch.equal(buf_p, ref), f"{name}: the parent's kernel != "
               "plain")
        turns = _in_turns(fn_p, fn, flush, bound_ms,
                          f"patch_gather{'_bf16' if bf16 else ''} {name}")
    ms, ms_cold = _run_ms(fn), _cold_ms(fn, flush)
    # the same method's floor: the entry point on one group of 4 keypoints
    one_ms = _run_ms(_c_launch(canvas, bi[:4].clone(), ys[:4].clone(),
                               xs[:4].clone(), buf))
    wrapper_ms = _cuda_ms(lambda: orb.extract_patches_canvas(
        canvas, bi, ys, xs))
    plain_ms = _run_ms(lambda: orb.extract_patches_canvas_plain(
        canvas, bi, ys, xs).float(), n=50, warmup=5)
    library_ms = _library_ms(canvas, bi, ys, xs, ref, name)
    print(f"# patch_gather{'_bf16' if bf16 else ''} {B}x{Hc}x{Wc}, {n_all} "
          f"keypoints ({name}): bit-exact vs "
          f"plain. Bound {bound_ms:.5f} ms ({n_bytes} bytes at 3.35 TB/s). "
          f"Kernel alone, L2 warm {ms:.4f} ms = {100 * bound_ms / ms:.1f}% "
          f"of the bound; L2 cold {ms_cold:.4f} ms = "
          f"{100 * bound_ms / ms_cold:.1f}%; on one group of 4 keypoints "
          f"{one_ms:.4f} ms; one event pair around one "
          f"wrapper call {wrapper_ms:.4f} ms; plain version {plain_ms:.4f} "
          f"ms; nearest library call {library_ms:.4f} ms")
    return {"shape": name, "canvas": [B, Hc, Wc],
            "canvas_dtype": str(dtype).replace("torch.", ""),
            "keypoints": n_all, "max_abs_err": err, "ms": ms,
            "ms_cold": ms_cold, "ms_one_group": one_ms,
            "ms_wrapper_call": wrapper_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": n_bytes,
            **({"in_turns": turns} if turns else {})}


def _timed(module, name, key, acc):
    """Wrap module.name (a module's function or an object's method) so each
    call is timed between device syncs."""
    fn = getattr(module, name)

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        acc.setdefault(key, []).append(time.perf_counter() - t0)
        return out
    setattr(module, name, wrapper)


def _u8(im):
    return np.clip(im, 0, 255).astype(np.uint8)


def _render(world, K, T, kind="stereo"):
    """One frame's images: a rectified stereo pair at phase 4's rig, a
    monocular image, an (image, depth in metres) RGB-D pair, or an
    unrectified KB8 pair at the TUM-VI rig of phase 11."""
    if kind == "stereo":
        return tuple(_u8(im) for im in world.render_stereo(K, T, BASELINE,
                                                           H, W))
    if kind == "mono":
        return (_u8(world.render(K, T, H, W)),)
    if kind == "rgbd":
        img, depth = world.render_rgbd(K, T, H, W)
        return _u8(img), depth.astype(np.float32)
    return tuple(_u8(im) for im in world.render_fisheye_stereo(
        TUMVI_KB8_1, T, TUMVI_BASELINE, TUMVI_H, TUMVI_W,
        kb8_params2=TUMVI_KB8_2))


def _make_world(name, kwargs):
    from ms_slam_tpu_torch.utils import synth
    return getattr(synth, name)(np.random.default_rng(0), **kwargs)


def _render_chunk(name, kwargs, K, poses, kind):
    world = _make_world(name, kwargs)
    return [_render(world, K, T, kind) for T in poses]


_POOL = []              # the render workers, started once, shut in main()
RENDER_WORKERS = 6


def _render_pool():
    """The render workers' pool: spawned at the first render and kept for
    the whole script (starting six interpreters costs ~10 s a time)."""
    if not _POOL:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _POOL.append(ProcessPoolExecutor(
            RENDER_WORKERS, mp_context=multiprocessing.get_context("spawn")))
    return _POOL[0]


def _close_render_pool():
    while _POOL:
        _POOL.pop().shutdown()


def _render_all(name, kwargs, K, poses, kind="stereo"):
    """Render every pose's frame in the worker processes (numpy ray
    casting, ~1 s a stereo frame on one core); each worker builds the same
    world from the seed. A phase that runs in one of the script's own
    processes beside the main one renders in that process, frame after
    frame (it shares the host with two Systems already)."""
    import multiprocessing
    if multiprocessing.parent_process() is not None:
        return _render_chunk(name, kwargs, K, poses, kind)
    n_workers = RENDER_WORKERS
    chunks = [poses[i::n_workers] for i in range(n_workers)]
    parts = list(_render_pool().map(
        _render_chunk, [name] * n_workers, [kwargs] * n_workers,
        [K] * n_workers, chunks, [kind] * n_workers))
    frames = [None] * len(poses)
    for w, part in enumerate(parts):
        frames[w::n_workers] = part
    return frames


CORRIDOR = ("CorridorWorld", dict(half_w=6.0, y_floor=1.7))   # bench.py's


def _corridor_frames():
    """(poses, frames) of phase 4's corridor, rendered once per process:
    phase 17 drives the same frames."""
    if "corridor" not in _FRAMES:
        from ms_slam_tpu_torch.utils import synth
        K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
        poses = synth.make_trajectory(N_FRAMES, "forward")
        t0 = time.perf_counter()
        frames = _render_all(*CORRIDOR, K, poses)
        print(f"# rendered {N_FRAMES} stereo frames in "
              f"{time.perf_counter() - t0:.1f} s")
        _FRAMES["corridor"] = (poses, frames)
    return _FRAMES["corridor"]


def _main_cfg(sparsify=True, max_kf=128, max_mp=32768):
    """Phase 4's configuration (phase 17 changes the switch and the
    pools)."""
    from ms_slam_tpu_torch.models.map_state import MapConfig
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    from ms_slam_tpu_torch.pipeline.system import SystemConfig
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                  width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
    return SystemConfig(
        calib=calib, orb=OrbConfig(n_features=2048, n_levels=8),
        map=MapConfig(max_kf=max_kf, max_mp=max_mp, n_feat=2048,
                      local_mp_cap=4096, window_kf=6),
        min_init_depth_points=300, max_frames_between_kf=10, ba_iters=6,
        sparsify=sparsify, sparsify_n=100, sparsify_lambda=500.0,
        sparsify_grid_lambda=10.0, sparsify_window=30,
        sparsify_queue_min=2, nonlocal_kf=3)


def _ab_arm(slam, ok_frames):
    """What the memory A/B (phase 17) reads of one shut-down System: state,
    memory_stats(), the checkpoint's size, the frame positions, the pools'
    counters."""
    import os
    import tempfile

    from ms_slam_tpu_torch.utils.checkpoint import save_map
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "map.npz")
        save_map(path, slam)
        ckpt = os.path.getsize(path)
    newest = slam.kf_order[-1]
    return {"state": slam.state, "mem": slam.memory_stats(), "ckpt": ckpt,
            "xyz": np.stack([T[:3, 3] for _, T in slam.poses_wc()]),
            "ok_frames": ok_frames, "n_mp": int(slam.n_mp),
            "mp_in_map": slam.map_points_in_map(), "kf_ord": int(slam.kf_ord),
            "n_kf": int(slam.n_kf), "kf_order_len": len(slam.kf_order),
            "newest_points": int((slam.ms.obs_mp[newest] >= 0).sum()),
            "stats": dict(slam._sparsifier.stats)
            if slam._sparsifier is not None else {}}


def phase_main_path():
    from ms_slam_tpu_torch.pipeline import sparsification
    from ms_slam_tpu_torch.pipeline import system as system_mod
    from ms_slam_tpu_torch.pipeline.system import System
    from ms_slam_tpu_torch.utils import evaluate

    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    cfg = _main_cfg()
    world = _make_world(*CORRIDOR)
    poses, frames = _corridor_frames()

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
    _reset(PG, POSE_OPT)
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
    launches = _calls(PG)
    po_launches = _calls(POSE_OPT)
    po_spans = [len(slam.timing.get(k, []))
                for k in ("pose_opt", "pose_opt.kernel")]

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
    # every tracked frame solves its motion stage and its local map, each
    # call one launch inside its span
    print(f"# pose_opt kernel launches {po_launches}; pose_opt and "
          f"pose_opt.kernel events {po_spans}")
    _check(po_launches >= po_spans[0] == po_spans[1] >= 2 * (N_FRAMES - 1),
           f"pose_opt launched {po_launches} times, events {po_spans}")

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
    ok_frames = sum(not e.lost for e in slam.trajectory)
    p4 = {"fps": len(steady) / steady.sum(),
          "p50": np.percentile(frame_s, 50) * 1e3,
          "p95": np.percentile(frame_s, 95) * 1e3,
          "stages": _pipeline_stages(slam),
          "numerics": {"ate": ate, "path": path, "n_kf": n_kf, "n_mp": n_mp,
                       "kept": st["kept"], "killed": st["killed"],
                       "reduction": mem["reduction"],
                       "frontend_ms": _p50_ms(stage, "frontend")}}
    return {"launches": launches, "pose_opt_launches": po_launches,
            "slam": slam, "world": world, "K": K,
            "poses": poses, "window": windows_seen[0],
            "ab_on": _ab_arm(slam, ok_frames), "p4": p4}


def phase_relocalize(run):
    """Track a perturbed view of frame 60 from the LOST state."""
    from scipy.spatial.transform import Rotation

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
    _reset(PG)
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
    launches = _calls(PG)
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


def _circuit(n_frames: int, radius: float, lap: int, ramp: int,
             start: float = 0.0):
    """A closed loop driven facing forward (z along the tangent), carried on
    into a second lap: the revisit is a moving overlap, so place recognition
    gets a stream of revisit keyframes to confirm against. The drive starts
    from rest: the turn rate grows linearly to 2*pi/lap a frame over the
    first `ramp` frames (the first frames have no velocity model yet, and a
    full-rate first step would move features 37 px at these widths), so the
    first lap ends at frame lap + ramp/2. `start` (radians) starts the drive
    that far along the same circle."""
    from scipy.spatial.transform import Rotation
    w = 2 * np.pi / lap
    poses = []
    for i in range(n_frames):
        a = start + (w * i * i / (2 * ramp) if i < ramp
                     else w * (i - ramp / 2))
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", a).as_matrix()
        T[:3, 3] = [radius * np.sin(a), 0.0, radius * (1 - np.cos(a))]
        poses.append(T)
    return poses


LOOP_LAP = 120          # frames in one lap at full rate
LOOP_RAMP = 20          # frames of the start from rest: lap 1 ends at 130
LOOP_FRAMES = 155       # lap 1 plus 25 frames of the second
LOOP_RADIUS = 9.0       # metres
LOOP_KF_EVERY = 5       # max_frames_between_kf
LOOP_TEX_SCALE = 0.07   # metres a texel: the 768-texel textures span 53.8 m
_FRAMES = {}            # rendered frames kept for the phases that reuse them


def _circuit_frames():
    """(poses, frames) of phase 7's circuit, rendered once per process:
    phases 15 and 16 drive the same frames."""
    if "circuit" not in _FRAMES:
        K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
        poses = _circuit(LOOP_FRAMES, LOOP_RADIUS, LOOP_LAP, LOOP_RAMP)
        t0 = time.perf_counter()
        frames = _render_all("BoxWorld",
                             dict(half=24.0, tex_scale=LOOP_TEX_SCALE), K,
                             poses)
        print(f"# circuit: rendered {LOOP_FRAMES} stereo frames in "
              f"{time.perf_counter() - t0:.1f} s")
        _FRAMES["circuit"] = (poses, frames)
    return _FRAMES["circuit"]


def phase_loop_closing():
    """Loop closing at full width: 1248x384 frames, 2048 features, 8 levels,
    the map capacities and sparsifier parameters of phase 4, loop closing on
    at its default thresholds.

    The scene is benchmarks/ref_scale_gate.py's: BoxWorld(half=24) and a
    circle of radius 9 m driven facing forward. Cuts against that gate: a
    lap of LOOP_LAP = 120 frames instead of 1000 (3 degrees and 0.47 m a
    frame instead of 0.36 degrees and 0.057 m), reached from rest over
    LOOP_RAMP = 20 frames (the gate starts at its full, eight times slower
    rate), and LOOP_FRAMES = 155 frames instead of 1500, so that the second
    lap begins inside the script's budget (170 until phases 15-17 were
    added; the correction comes near frame 133); max_frames_between_kf =
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
    from ms_slam_tpu_torch.ops import pose_graph, sim3
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
    poses, frames = _circuit_frames()

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
    _reset(PG)
    frame_s = []
    for i in range(LOOP_FRAMES):
        t0 = time.perf_counter()
        slam.track_stereo(frames[i][0], frames[i][1], 0.1 * i)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    slam.shutdown()
    torch.cuda.synchronize()
    launches = _calls(PG)

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
    return launches, slam


def _kf_centres(ms, slots):
    R = ms.kf_R[slots].cpu().numpy().astype(np.float64)
    t = ms.kf_t[slots].cpu().numpy().astype(np.float64)
    return -np.einsum("kji,kj->ki", R, t)


def _kf_ate(ms, kf_order, poses):
    """Keyframe-centre ATE against the truth (Horn-aligned) and the path
    length of the whole drive."""
    from ms_slam_tpu_torch.utils import evaluate
    slots = [k for k in kf_order if bool(ms.kf_valid[k])]
    est = _kf_centres(ms, slots)
    gt = np.stack([poses[int(ms.kf_frame_id[k])][:3, 3] for k in slots])
    path = float(np.sum(np.linalg.norm(np.diff(
        np.stack([T[:3, 3] for T in poses]), axis=0), axis=1)))
    return evaluate.ate_rmse(est, gt), path


def _ba_cost(ms, calib, orb_cfg):
    """The global BA's robust reprojection cost: the Huber cost (the
    solvers' deltas) of every valid observation in front of its camera,
    whitened by its octave's variance."""
    from ms_slam_tpu_torch.ops import ba, robust
    from ms_slam_tpu_torch.pipeline.mapping_ops import _scale2
    dev = ms.kf_R.device
    K, N = ms.obs_mp.shape
    valid = ((ms.obs_mp >= 0) & ms.kf_valid[:, None]
             & ms.kp_valid).reshape(-1)
    f_cam = torch.arange(K, device=dev)[:, None].expand(K, N).reshape(-1)
    f_ur = ms.kp_uright.reshape(-1)
    res, _, _, z = ba._factor_res_jac(
        calib.model, calib.params_array(dev), calib.bf, ms.kf_R, ms.kf_t,
        ms.mp_pos, f_cam, ms.obs_mp.clamp(min=0).reshape(-1).long(),
        ms.kp_xy.reshape(K * N, 2), f_ur, f_ur >= 0)
    e2 = torch.sum(res * res, dim=-1) \
        / _scale2(orb_cfg, dev)[ms.kp_octave.long()].reshape(-1)
    d2 = torch.where(f_ur >= 0, robust.CHI2_3DOF, robust.CHI2_2DOF)
    rho = torch.where(e2 <= d2, e2, 2.0 * torch.sqrt(d2 * e2) - d2)
    return float(rho[valid & (z > 1e-2)].double().sum())


def _launch_count(fn):
    """Kernel launches of one call, from torch.profiler's runtime events
    (cudaLaunchKernel and its variants)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "LaunchKernel" in e.key)


MERGE_OFFSET_M = 0.3    # the second lap's keyframes moved by 0.3 m
MERGE_OFFSET_DEG = 3.0  # and 3 degrees before the merge
DIST_SHARDS = 4         # the sharded global BA's shards on one card


def phase_merge_and_dist_ba(slam):
    """The Atlas merge and the sharded global BA at full width (phase 14),
    on the System phase 7 leaves (its map after the loop correction).

    (a) `_merge_maps`, tests/test_torch_loop_slice.py's recipe: the second
    lap's keyframes become map 1, they and their points are moved by a
    known rigid offset, and the merge is called with the true relative
    transform of the newest keyframe and the first-lap keyframe nearest to
    it. Bypasses the detection of a merge (a lost-then-revisit run).
    (b) `parallel.dist_ba.dist_global_ba` on a copy of the merged map with
    its keyframes (but the anchor) and points perturbed, on 1 and
    DIST_SHARDS shards of one card at the pipeline's CG budget, on 1 shard
    with a budget of 6 x the live keyframes, and `mapping_ops.global_ba`;
    the sharded solves are held by the robust reprojection cost, the
    converged one also by its last CG ratio.
    (c) which global BA a System with dist_ba_devices=DIST_SHARDS takes on
    this machine.
    No frame is rendered or tracked."""
    import dataclasses

    from scipy.spatial.transform import Rotation

    from ms_slam_tpu_torch.ops import pose_graph
    from ms_slam_tpu_torch.parallel import dist_ba
    from ms_slam_tpu_torch.pipeline import mapping_ops

    t_phase = time.perf_counter()
    poses = _circuit(LOOP_FRAMES, LOOP_RADIUS, LOOP_LAP, LOOP_RAMP)
    lc = slam._loop_closer
    _reset(PG)

    # (a) the merge
    lap_end = LOOP_LAP + LOOP_RAMP // 2
    fid = slam.ms.kf_frame_id.cpu().numpy()
    live = [k for k in slam.kf_order if bool(slam.ms.kf_valid[k])]
    second = [k for k in live if fid[k] >= lap_end]
    first = [k for k in live if fid[k] < lap_end]
    _check(len(second) >= 3, f"{len(second)} keyframes in the second lap")
    cur = second[-1]
    cen = _kf_centres(slam.ms, live)
    near = {k: c for k, c in zip(live, cen)}
    match = min(first, key=lambda k: np.linalg.norm(near[k] - near[cur]))
    Rc, tc = slam.ms.kf_R[cur].cpu().double(), slam.ms.kf_t[cur].cpu().double()
    Rm, tm = (slam.ms.kf_R[match].cpu().double(),
              slam.ms.kf_t[match].cpu().double())
    R_cm = (Rc @ Rm.T).numpy().astype(np.float32)
    t_cm = (tc - Rc @ Rm.T @ tm).numpy().astype(np.float32)
    before = _kf_centres(slam.ms, second)
    ate0, path = _kf_ate(slam.ms, slam.kf_order, poses)

    dev = slam.ms.kf_R.device
    D_R = torch.as_tensor(Rotation.from_rotvec(
        np.radians(MERGE_OFFSET_DEG) * np.array([0.0, 1.0, 0.0]))
        .as_matrix(), dtype=torch.float32, device=dev)
    D_t = torch.tensor([MERGE_OFFSET_M, 0.0, 0.0], device=dev)
    ms = slam.ms
    sec = torch.tensor(second, device=dev)
    obs = ms.obs_mp[sec]
    moved = torch.unique(obs[obs >= 0]).long()
    ms.mp_pos[moved] = ms.mp_pos[moved] @ D_R.T + D_t
    R_new = ms.kf_R[sec] @ D_R.T
    ms.kf_t[sec] = ms.kf_t[sec] - (R_new @ D_t[:, None])[..., 0]
    ms.kf_R[sec] = R_new
    for k in second:
        slam.kf_maps[k] = 1
    slam.active_map = 1
    offset = float(np.linalg.norm(_kf_centres(ms, second) - before, axis=1)
                   .max())
    merges0 = lc.stats.get("merges", 0)

    stage = {}
    _timed(mapping_ops, "fuse_into", "fuse_into", stage)
    _timed(pose_graph, "optimize_pose_graph", "pose_graph", stage)
    _timed(mapping_ops, "global_ba", "global_ba", stage)
    weld = lc._weld_ba

    def timed_weld(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weld(*a)
        torch.cuda.synchronize()
        stage.setdefault("_weld_ba", []).append(time.perf_counter() - t0)
    lc._weld_ba = timed_weld
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lc._merge_maps(cur, match, 1.0, R_cm, t_cm)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    lc._weld_ba = weld
    back = np.linalg.norm(_kf_centres(slam.ms, second) - before, axis=1)
    ate1, _ = _kf_ate(slam.ms, slam.kf_order, poses)
    print(f"# merge: {len(second)} second-lap keyframes of {len(live)} as map "
          f"1, moved {offset:.4f} m at most ({MERGE_OFFSET_M} m and "
          f"{MERGE_OFFSET_DEG} degrees), merged at keyframe of frame "
          f"{fid[cur]} onto frame {fid[match]}: _merge_maps "
          f"{merge_s * 1e3:.1f} ms (" + ", ".join(
              f"{k} {sum(v) * 1e3:.1f} ms" for k, v in stage.items())
          + "; host clock between device syncs); the moved keyframes "
          f"{back.max():.4f} m at most from where they stood (bar 0.1 m); "
          f"keyframe-centre ATE {ate0:.4f} m before the offset, "
          f"{ate1:.4f} m after the merge on a {path:.2f} m path "
          f"({100 * ate1 / path:.3f}%, bar 2%)")
    _check(all(m == slam.kf_maps[match] for m in slam.kf_maps)
           and slam.active_map == slam.kf_maps[match],
           "a keyframe label is not back on the target map")
    _check(lc.stats.get("merges", 0) == merges0 + 1, "no merge counted")
    _check(back.max() < 0.1, f"moved keyframes {back.max():.4f} m off")
    _check(ate1 < 0.02 * path, "keyframe ATE above 2% after the merge")

    # (b) the sharded global BA against the local one, on one input
    cfg = slam.cfg
    ms = slam.ms
    g = torch.Generator(device=dev).manual_seed(14)
    free = ms.kf_valid.clone()
    free[match] = False
    d_t = torch.randn(ms.kf_t.shape, generator=g, device=dev) * 0.05
    d_p = torch.randn(ms.mp_pos.shape, generator=g, device=dev) * 0.03
    msp = ms._replace(kf_t=ms.kf_t + d_t * free[:, None],
                      mp_pos=ms.mp_pos + d_p * ms.mp_valid[:, None])
    c_star = _ba_cost(ms, cfg.calib, cfg.orb)
    c0 = _ba_cost(msp, cfg.calib, cfg.orb)
    n_rows = ms.obs_mp.numel()
    n_valid = int(((ms.obs_mp >= 0) & ms.kf_valid[:, None]
                   & ms.kp_valid).sum())
    print(f"# global BA input: {int(ms.kf_valid.sum())} keyframes, "
          f"{int(ms.mp_valid.sum())} points, {n_rows} factor rows of which "
          f"{n_valid} valid; anchor keyframe of frame {fid[match]}")
    # the reference's CG budget (min(6C, max(96, 6C // 8)) = 96 steps for
    # C = 128 keyframe slots) is what the pipeline runs; a fourth solve is
    # given as many steps as the live camera system has unknowns, the most
    # CG needs in exact arithmetic
    n_full = 6 * int(ms.kf_valid.sum())
    last_ratio, budget = [], {}
    solve = dist_ba.dist_ba_solve

    def kept_ratio(*a, **k):
        out = solve(*a, **k, **budget)
        last_ratio.append(float(out[3][-1]))
        return out
    dist_ba.dist_ba_solve = kept_ratio
    card = torch.device("cuda", 0)
    full = f"dist_global_ba D=1, n_cg={n_full}"

    def dist(D, n_cg=None, n_iters=8):
        def run():
            budget.clear()
            if n_cg is not None:
                budget["n_cg"] = n_cg
            return dist_ba.dist_global_ba(msp, cfg.calib, cfg.orb, match,
                                          dist_ba.make_mesh(D, [card] * D),
                                          n_iters=n_iters)
        return run
    runs = {"dist_global_ba D=1": dist(1),
            f"dist_global_ba D={DIST_SHARDS}": dist(DIST_SHARDS),
            full: dist(1, n_full),
            "global_ba": lambda: mapping_ops.global_ba(
                msp, cfg.calib, cfg.orb, match, n_sweeps=2)}
    # the profiler takes minutes over a whole 8-iteration solve (10^5
    # launches); every iteration launches the same kernels (fixed shapes,
    # fixed-length loops), so a sharded solve's count is taken as
    # L1 + 7 (L2 - L1) from profiled 1- and 2-iteration calls (6 above a
    # profiled whole solve's count on an H100); the long-budget solve is
    # not counted
    launches = {"global_ba": _launch_count(runs["global_ba"]), full: None}
    for D in (1, DIST_SHARDS):
        l1, l2 = (_launch_count(dist(D, n_iters=n)) for n in (1, 2))
        launches[f"dist_global_ba D={D}"] = l1 + 7 * (l2 - l1)
    out, ratio = {}, {}
    for k, fn in runs.items():
        last_ratio.clear()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        cost = _ba_cost(res, cfg.calib, cfg.orb)
        ate, _ = _kf_ate(res, slam.kf_order, poses)
        out[k] = cost
        ratio[k] = last_ratio[-1] if last_ratio else None
        n_l = "not counted" if launches[k] is None else launches[k]
        print(f"# {k}: {s * 1e3:.1f} ms (synchronised), kernel launches "
              f"{n_l} (torch.profiler; L1 + 7 (L2 - L1) for dist_global_ba), "
              f"peak device memory "
              f"{peak:.1f} MiB above the {base / 2**20:.1f} MiB held before; "
              f"robust cost {c0:.1f} -> {cost:.1f} (unperturbed map "
              f"{c_star:.1f}); keyframe-centre ATE {ate:.4f} m "
              f"({100 * ate / path:.3f}%, bar 2%)"
              + ("" if ratio[k] is None else
                 f"; last CG ratio {ratio[k]:.3e}"))
        _check(np.isfinite(cost) and ate < 0.02 * path,
               f"{k}: keyframe ATE {ate:.4f} m or cost {cost}")
    dist_ba.dist_ba_solve = solve
    c1, c4 = out["dist_global_ba D=1"], out[f"dist_global_ba D={DIST_SHARDS}"]
    for c in (c1, c4):
        _check(c <= c_star + 0.05 * (c0 - c_star),
               f"sharded cost {c:.1f} above c* + 5% of (c0 - c*) = "
               f"{c_star + 0.05 * (c0 - c_star):.1f}")
    _check(abs(c4 - c1) <= 0.02 * c0, f"|c4 - c1| = {abs(c4 - c1):.1f} "
           f"above 2% of c0 {c0:.1f}")
    # the CG converges when it is given the steps; at the pipeline's budget
    # it ends above the reference's own 1e-2 warning line on this map (the
    # reference does the same: tests/test_torch_dist_ba.py::
    # test_cg_budget_under_converges_alike), and the result is held by cost:
    # within 2% of c0 of the converged solve's
    _check(ratio[full] <= 1e-2, f"CG ratio {ratio[full]:.3e} above 1e-2 "
           f"with {n_full} steps")
    for k in ("dist_global_ba D=1", f"dist_global_ba D={DIST_SHARDS}"):
        _check(0.0 <= ratio[k] < 1.0, f"{k}: CG ratio {ratio[k]}")
        _check(abs(out[k] - out[full]) <= 0.02 * c0,
               f"{k}: cost {out[k]:.1f} against {out[full]:.1f} converged")

    # (c) which global BA a System asking for DIST_SHARDS devices takes here
    lc._ba_mesh = None
    slam.cfg = dataclasses.replace(cfg, dist_ba_devices=DIST_SHARDS)
    mesh = lc._global_ba_mesh()
    slam.cfg = cfg
    lc._ba_mesh = None
    n_cards = torch.cuda.device_count()
    print(f"# a System with dist_ba_devices={DIST_SHARDS} on this machine "
          f"({n_cards} CUDA device(s)) takes "
          + ("mapping_ops.global_ba (the local solve)" if mesh is None else
             f"dist_global_ba over {mesh.devices}"))
    _check((mesh is None) == (n_cards < DIST_SHARDS),
           "the branch does not follow the card count")
    launches_pg = _calls(PG)
    _check(launches_pg == 0, f"patch_gather launched {launches_pg} times "
           "in a phase that renders no frame")
    print(f"# phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return launches_pg


IMU_FRAMES = 90         # 9 s at 10 Hz
IMU_DT = 0.1
IMU_RATE = 200          # rows a second (configs/EuRoC-Inertial.yaml)
IMU_PATH_SCALE = 1.35   # the arc's 2.9 m stretched to 3.9 m over 90 frames
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
    features instead of 320x240 and 512; IMU_FRAMES = 90 frames instead of
    65-70 with the arc's translation stretched by IMU_PATH_SCALE = 1.35, so
    that the motion per frame stays the test's 4.4 cm while the run passes
    stage 2 (near 5 s) at the default imu_init_time (120 frames and 1.8
    until phases 15-17 were added); max_frames_between_kf=10 as
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
    from ms_slam_tpu_torch.ops import inertial_opt
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline import system as system_mod
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
    from ms_slam_tpu_torch.utils import evaluate, synth

    card = _card()
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
    _reset(PG, PVB)
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
    launches = _calls(PG)
    pvb_launches = _calls(PVB)
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

    # the kernel against the plain version on the last inertial frame's
    # System inputs: its preintegration, match mask and mono rows
    a, k = last_pvb["args"]
    k = {kk: v for kk, v in k.items() if kk != "timing"}
    out = pvb(*a, **k)
    ref = inertial_opt.pose_vel_bias_optimize_plain(*a, **k)
    torch.cuda.synchronize()
    cases = _pvb_cases()
    err = {n: float((getattr(out, n) - getattr(ref, n)).abs().max())
           for n in ("p_wb", "v", "bg", "ba")}
    print("# call pose_vel_bias_optimize on the last frame's inputs "
          f"({a[14].shape[0]} matches, {int(a[18].sum())} in the mask, "
          f"{int((a[16] < 0).sum())} mono), kernel against the plain "
          f"version: rotation {cases._rot_err(out.R_wb, ref.R_wb):.2e} rad, "
          + ", ".join(f"{n} {v:.2e}" for n, v in err.items())
          + f", inlier slots differing {int((out.inlier != ref.inlier).sum())}"
          f"; inliers {int(out.n_inliers)} / {int(ref.n_inliers)}")
    cases._assert_close(out, ref)

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
    n_pvb = len(stage["pose_vel_bias_optimize"])
    print(f"# inertial: pose_vel_bias kernel launches {pvb_launches} for "
          f"{n_pvb} calls of pose_vel_bias_optimize and {slam.imu_frames} "
          "inertial steps")
    _check(pvb_launches == n_pvb == slam.imu_frames,
           f"pose_vel_bias launched {pvb_launches} times for {n_pvb} calls "
           f"and {slam.imu_frames} inertial steps")

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
    return launches, pvb_launches


# configs/TUM-VI-Fisheye.yaml: Camera1 and Camera2 (fx, fy, cx, cy, k1-k4),
# 512x512, and the length of Stereo.T_c1_c2's translation
TUMVI_KB8_1 = (190.97847715128717, 190.9733070521226, 254.93170605935475,
               256.8974428996504, 0.0034823894022493434,
               0.0007150348452162257, -0.0020532361418706202,
               0.00020293673591811182)
TUMVI_KB8_2 = (190.44236969414825, 190.4344384721956, 252.59949716835982,
               254.91723064636983, 0.0034003170790442797,
               0.001766278153469831, -0.00266312569781606,
               0.0003299517423931039)
TUMVI_BASELINE = float(np.linalg.norm([0.101063, -0.001946, 0.000931]))
TUMVI_H = TUMVI_W = 512

MONO_FRAMES = 60
RGBD_FRAMES, RGBD_LOC_FRAMES = 40, 10
FISHEYE_FRAMES = 40
MONO_IMU_FRAMES = 70


def _sensor_cfg(calib, n_feat=2048, **kw):
    """Phase 4's widths and map capacities around another calibration, with
    the reference tests' keyframe and BA settings (max_frames_between_kf=8,
    ba_iters=8 unless given)."""
    from ms_slam_tpu_torch.models.map_state import MapConfig
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline.system import SystemConfig
    kw.setdefault("max_frames_between_kf", 8)
    return SystemConfig(
        calib=calib, orb=OrbConfig(n_features=n_feat, n_levels=8),
        map=MapConfig(max_kf=128, max_mp=32768, n_feat=n_feat,
                      local_mp_cap=4096, window_kf=6), **kw)


def _pinhole(bf=0.0, th_depth=0.0):
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    return Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=bf, width=W,
                 height=H, th_depth=th_depth, fps=10.0)


def _drive(slam, frames, step, stage_keys, stage, label):
    """Run `step(slam, i, frame)` over the frames with the kernel's count
    set to 0 just before and read just after (the pipeline flushed); print
    the rate, the frame wall times and the stages' p50."""
    torch.cuda.reset_peak_memory_stats()
    _reset(PG)
    frame_s = []
    for i, fr in enumerate(frames):
        t0 = time.perf_counter()
        step(slam, i, fr)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    slam._flush_pipeline()
    torch.cuda.synchronize()
    launches = _calls(PG)
    fs = np.asarray(frame_s)
    print(f"# {label}: {len(fs)} frames; frames/s over frames 5-"
          f"{len(fs) - 1}: {(len(fs) - 5) / fs[5:].sum():.3f}; frame wall "
          f"p50 {np.percentile(fs, 50) * 1e3:.2f} ms, p95 "
          f"{np.percentile(fs, 95) * 1e3:.2f} ms, max {fs.max() * 1e3:.2f} "
          f"ms; keyframes {slam.keyframes_in_map()}, map points "
          f"{slam.map_points_in_map()}; kernel launches {launches}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB")
    for k in stage_keys:
        v = np.asarray(stage.get(k, [0.0]))
        print(f"# {label} stage {k:<16} n={len(stage.get(k, []))} p50 "
              f"{np.percentile(v, 50) * 1e3:.2f} ms max "
              f"{v.max() * 1e3:.2f} ms (host clock between device syncs)")
    return launches


def _ate(rows, poses, with_scale):
    """(ATE, path length, Horn scale) of a System's rows (timestamp, Twc) at
    10 Hz against the poses."""
    from ms_slam_tpu_torch.utils import evaluate
    est = np.stack([Twc[:3, 3] for _, Twc in rows])
    gt = np.stack([poses[int(round(ts * 10))][:3, 3] for ts, _ in rows])
    _check(np.isfinite(est).all(), "a pose is not finite")
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    scale = evaluate.horn_align(est.T, gt.T, True)[2]
    return evaluate.ate_rmse(est, gt, with_scale=with_scale), path, scale


class _time_stages:
    """`with _time_stages(stage, [(module, name, key), ...]):` times each
    call of those functions between device syncs into stage[key], and puts
    the functions back on exit."""

    def __init__(self, stage, names):
        self.stage, self.names = stage, names

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in self.names]
        for mod, name, key in self.names:
            _timed(mod, name, key, self.stage)

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_mono():
    """Monocular SLAM at full width (phase 9): tests/test_mono_rgbd.py's
    mono scene (PlaneWorld(z_wall=14, y_floor=2), the "arc" path) over
    MONO_FRAMES = 60 frames instead of 30 at 1248x384 with 2048 features
    instead of 320x240 and 512, through System.track_monocular with bf = 0
    and th_depth = 0 (tests/test_twoview.py's monocular calibration; the
    mono test's own build() carries a stereo bf that a monocular frame never
    uses). Held: an initialization (its frame printed), state OK at the end,
    at least 2 keyframes, the scale-free ATE under 12% of the path
    (test_mono_rgbd.py's bar) and one kernel launch a frame. The two-view
    reconstruction's calls are timed (256 batched SVDs of 8x9 and of 16x9
    matrices a call, through cuSOLVER)."""
    from ms_slam_tpu_torch.pipeline import system as system_mod
    from ms_slam_tpu_torch.pipeline.system import System
    from ms_slam_tpu_torch.utils import synth
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(MONO_FRAMES, "arc")
    t0 = time.perf_counter()
    frames = _render_all("PlaneWorld", dict(z_wall=14.0, y_floor=2.0), K,
                         poses, kind="mono")
    print(f"# mono ({_card()}): rendered {MONO_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s")
    slam = System(_sensor_cfg(_pinhole()), device="cuda")
    stage = {}
    with _time_stages(stage, [
            (system_mod, "process_mono", "frontend"),
            (system_mod.to, "track_full", "track"),
            (system_mod.mo, "keyframe_step", "keyframe_step"),
            (system_mod.mo, "mapping_step", "mapping_step"),
            (system_mod.twoview, "reconstruct", "reconstruct")]):
        launches = _drive(
            slam, frames, lambda s, i, fr: s.track_monocular(fr[0], 0.1 * i),
            ("frontend", "track", "keyframe_step", "mapping_step",
             "reconstruct"), stage, "mono")
    init = next((e.frame_id for e in slam.trajectory if not e.lost), None)
    rec = ", ".join(f"{v * 1e3:.1f}" for v in stage.get("reconstruct", []))
    print(f"# mono: initialized at frame {init}; twoview.reconstruct calls "
          f"(ms, synchronised): {rec}")
    _check(init is not None, "the monocular map was never initialized")
    _check(slam.state == "OK", f"final state {slam.state}")
    _check(slam.keyframes_in_map() >= 2, "fewer than 2 keyframes")
    rows = slam.poses_wc()
    ate, path, scale = _ate(rows, poses, with_scale=True)
    print(f"# mono: {len(rows)} frames saved; scale-free ATE {ate:.4f} m on "
          f"a {path:.3f} m path ({100 * ate / path:.3f}%, bar 12%); Horn "
          f"scale of the map {scale:.4f} (arbitrary in monocular)")
    _check(ate < 0.12 * path, "scale-free ATE above 12%")
    _check(launches == MONO_FRAMES,
           f"patch_gather launched {launches} times for {MONO_FRAMES} frames")
    return launches


def phase_rgbd():
    """RGB-D SLAM at full width (phase 10): tests/test_mono_rgbd.py's RGB-D
    scene (PlaneWorld(z_wall=14, y_floor=2), the "arc" path, depth from
    render_rgbd) at 1248x384 with 2048 features and phase 4's virtual
    baseline (bf = fx * 0.537, th_depth = 40 baselines) through
    System.track_rgbd: RGBD_FRAMES = 40 frames mapped, then
    activate_localization_mode() for RGBD_LOC_FRAMES = 10 more frames of the
    same path (make_trajectory(50, "arc")). Held: every frame tracked, the
    ATE over all 50 frames under 2% of the path (test_mono_rgbd.py's bar),
    no keyframe and no map point created or removed in the localization
    leg, state OK after it, and one kernel launch a frame."""
    from ms_slam_tpu_torch.pipeline import system as system_mod
    from ms_slam_tpu_torch.pipeline.system import System
    from ms_slam_tpu_torch.utils import synth
    n = RGBD_FRAMES + RGBD_LOC_FRAMES
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(n, "arc")
    t0 = time.perf_counter()
    frames = _render_all("PlaneWorld", dict(z_wall=14.0, y_floor=2.0), K,
                         poses, kind="rgbd")
    print(f"# rgbd ({_card()}): rendered {n} frames in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = _sensor_cfg(_pinhole(FX * BASELINE, BASELINE * 40),
                      min_init_depth_points=300)
    slam = System(cfg, device="cuda")
    stage = {}
    seen = {}

    def step(s, i, fr):
        if i == RGBD_FRAMES:
            s._flush_pipeline()
            seen["before"] = (s.kf_ord, s.map_points_in_map())
            s.activate_localization_mode()
        s.track_rgbd(fr[0], fr[1], 0.1 * i)
    with _time_stages(stage, [
            (system_mod, "process_rgbd", "frontend"),
            (system_mod.to, "track_full", "track"),
            (system_mod.mo, "keyframe_step", "keyframe_step")]):
        launches = _drive(slam, frames, step,
                          ("frontend", "track", "keyframe_step"), stage,
                          "rgbd")
    after = (slam.kf_ord, slam.map_points_in_map())
    slam.deactivate_localization_mode()
    print(f"# rgbd: keyframes created, map points before the localization "
          f"leg {seen['before']}, after it {after}; state {slam.state}")
    _check(slam.state == "OK", f"final state {slam.state}")
    _check(not any(e.lost for e in slam.trajectory), "a frame was lost")
    _check(after == seen["before"], "the localization leg changed the map")
    rows = slam.poses_wc()
    _check(len(rows) == n, f"{len(rows)} of {n} frames have a pose")
    ate, path, _ = _ate(rows, poses, with_scale=False)
    print(f"# rgbd: ATE {ate:.4f} m on a {path:.3f} m path "
          f"({100 * ate / path:.3f}%, bar 2%)")
    _check(ate < 0.02 * path, "ATE above 2%")
    _check(launches == n, f"patch_gather launched {launches} times for {n} "
           "frames")
    return launches


def _fisheye_calib():
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    b = TUMVI_BASELINE
    return Calib(model=1, params=TUMVI_KB8_1, bf=b * TUMVI_KB8_1[0],
                 width=TUMVI_W, height=TUMVI_H, th_depth=b * 40.0, fps=10.0,
                 params2=TUMVI_KB8_2,
                 T_rl=(1.0, 0.0, 0.0, -b, 0.0, 1.0, 0.0, 0.0,
                       0.0, 0.0, 1.0, 0.0),
                 lapping=(0, TUMVI_W - 1, 0, TUMVI_W - 1))


def phase_fisheye():
    """Stereo-fisheye SLAM at the TUM-VI geometry (phase 11): two KB8
    cameras with configs/TUM-VI-Fisheye.yaml's intrinsics at 512x512, 1024
    features, 8 levels, bf and th_depth derived from the length of its
    Stereo.T_c1_c2 translation (0.1011 m) as its config loader does.
    Cuts: the rig is rendered and calibrated as a pure x-baseline of that
    length (T_rl = [I | (-0.1011, 0, 0)]: synth.render_fisheye_stereo
    draws no other), so the yaml's ~0.09 degree rotation and its y, z
    offsets of 2 and 1 mm are dropped; 10 Hz frames instead of 20 Hz. Scene:
    tests/test_fisheye.py's (BoxWorld(half=6), the "arc" path) over
    FISHEYE_FRAMES = 40 frames instead of 25. Held: on frame 0 the
    frontend's triangulated depths against the rendered geometry, over more
    than 100 matches, with test_fisheye.py's bars expressed as disparity
    errors fx * b * |1/z - 1/z_true| in pixels of each keypoint's pyramid
    level (its 7% median and 15% on 75% of the matches are 0.7 and 1.5 px
    at its 10 px disparity at 6 m; this rig sees 3.2 px there, so a
    relative bar would hold it to a third of the test's pixel error, and 8
    levels instead of its 4 put a third of the keypoints at 1.7-3.6 times
    coarser pixels); then state OK, at least 2 keyframes, every frame
    tracked, the ATE under 3% of the path (test_fisheye.py's bar) and one
    kernel launch a frame."""
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline import frontend
    from ms_slam_tpu_torch.pipeline import system as system_mod
    from ms_slam_tpu_torch.pipeline.system import System
    from ms_slam_tpu_torch.utils import synth
    poses = synth.make_trajectory(FISHEYE_FRAMES, "arc")
    t0 = time.perf_counter()
    frames = _render_all("BoxWorld", dict(half=6.0), None, poses,
                         kind="fisheye")
    print(f"# fisheye ({_card()}): rendered {FISHEYE_FRAMES} frame pairs "
          f"of {TUMVI_W}x{TUMVI_H} in {time.perf_counter() - t0:.1f} s")
    calib = _fisheye_calib()
    orb_cfg = OrbConfig(n_features=1024, n_levels=8)
    fd = frontend.process_stereo_fisheye(
        torch.from_numpy(np.stack(frames[0])).cuda(), calib, orb_cfg)
    depth, xy = fd.depth.cpu().numpy(), fd.feats.xy.cpu().numpy()
    world = _make_world("BoxWorld", dict(half=6.0))
    T0 = poses[0]
    d = synth.kb8_rays(TUMVI_KB8_1, TUMVI_H, TUMVI_W) @ T0[:3, :3].T
    gt_depth = np.full((TUMVI_H, TUMVI_W), np.inf)
    for ax, val, _, _ in world.iter_planes():
        da = d[..., ax]
        da_s = np.where(np.abs(da) > 1e-9, da, 1e-9)
        t = np.where(np.abs(da) > 1e-9, (val - T0[ax, 3]) / da_s, -1)
        gt_depth = np.where((t > 0.1) & (t < gt_depth), t, gt_depth)
    ok = depth > 0
    ui = np.clip(np.round(xy[ok, 0]).astype(int), 0, TUMVI_W - 1)
    vi = np.clip(np.round(xy[ok, 1]).astype(int), 0, TUMVI_H - 1)
    gt = gt_depth[vi, ui]
    rel = np.abs(depth[ok] - gt) / gt
    # the same error as a disparity error, fx * b * |1/z - 1/z_true|, in
    # pixels of each keypoint's own pyramid level
    level_px = orb_cfg.scale_factor ** fd.feats.octave.cpu().numpy()[ok]
    disp = calib.bf * np.abs(1.0 / depth[ok] - 1.0 / gt) / level_px
    print(f"# fisheye frame 0: {int(ok.sum())} triangulated matches; "
          f"disparity error against the render, in pixels of the keypoint's "
          f"level: median {np.median(disp):.4f} (bar 0.7), share under 1.5 "
          f"{(disp < 1.5).mean():.4f} (bar 0.75); relative depth error: "
          f"median {np.median(rel):.4f}, share under 15% "
          f"{(rel < 0.15).mean():.4f}")
    _check(ok.sum() > 100 and np.median(disp) < 0.7
           and (disp < 1.5).mean() > 0.75, "fisheye triangulated depths")

    slam = System(_sensor_cfg(calib, n_feat=1024, min_init_depth_points=100),
                  device="cuda")
    stage = {}
    with _time_stages(stage, [
            (system_mod, "process_stereo_fisheye", "frontend"),
            (system_mod.to, "track_full", "track"),
            (system_mod.mo, "keyframe_step", "keyframe_step")]):
        launches = _drive(
            slam, frames,
            lambda s, i, fr: s.track_stereo(fr[0], fr[1], 0.1 * i),
            ("frontend", "track", "keyframe_step"), stage, "fisheye")
    _check(slam.state == "OK", f"final state {slam.state}")
    _check(slam.keyframes_in_map() >= 2, "fewer than 2 keyframes")
    rows = slam.poses_wc()
    _check(len(rows) == FISHEYE_FRAMES, f"{len(rows)} of {FISHEYE_FRAMES} "
           "frames have a pose")
    ate, path, _ = _ate(rows, poses, with_scale=False)
    print(f"# fisheye: ATE {ate:.4f} m on a {path:.3f} m path "
          f"({100 * ate / path:.3f}%, bar 3%)")
    _check(ate < 0.03 * path, "ATE above 3%")
    _check(launches == FISHEYE_FRAMES, f"patch_gather launched {launches} "
           f"times for {FISHEYE_FRAMES} frames")
    return launches


def phase_mono_inertial():
    """Mono-inertial SLAM at full width (phase 12):
    tests/test_inertial_system.py's mono-inertial case as it stands
    (PlaneWorld(z_wall=14, y_floor=2), 70 frames of the "arc_excited" path
    at 10 Hz, synth.make_imu at 200 Hz, bf = 0, max_frames_between_kf=3,
    use_imu=True, imu_init_kfs=6, imu_init_time=1.0) at 1248x384 with 2048
    features instead of 320x240 and 512. Held (the test's bars):
    initialized; gravity within 0.6 of 9.81 m/s^2 with g_y / |g| > 0.9; the
    Horn scale between the trajectory and the metric ground truth within
    0.2 of 1 over the whole run and over its second half; the scale-free
    ATE under 12% of the path; one patch-gather launch a frame, and one
    pose_vel_bias launch an inertial step."""
    from ms_slam_tpu_torch.pipeline import system as system_mod
    from ms_slam_tpu_torch.pipeline.system import System
    from ms_slam_tpu_torch.utils import synth
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synth.make_trajectory(MONO_IMU_FRAMES, "arc_excited")
    imu = synth.make_imu(poses, 0.1, imu_rate=200)
    t0 = time.perf_counter()
    frames = _render_all("PlaneWorld", dict(z_wall=14.0, y_floor=2.0), K,
                         poses, kind="mono")
    print(f"# mono-inertial ({_card()}): rendered {MONO_IMU_FRAMES} frames "
          f"in {time.perf_counter() - t0:.1f} s")
    cfg = _sensor_cfg(_pinhole(), max_frames_between_kf=3, use_imu=True,
                      imu_init_kfs=6, imu_init_time=1.0)
    slam = System(cfg, device="cuda")
    stage = {}
    scales, init_at = [], []
    apply = slam._apply_map_scale

    def recorded(s):
        scales.append((slam.frame_id, float(s)))
        return apply(s)
    slam._apply_map_scale = recorded

    def step(s, i, fr):
        if i == 0:
            s.track_monocular(fr[0], 0.0)
        else:
            s.track_monocular_imu(fr[0], 0.1 * i, imu[i - 1])
        if s.imu_initialized and not init_at:
            init_at.append(i)
    _reset(PVB)
    with _time_stages(stage, [
            (system_mod, "process_mono", "frontend"),
            (system_mod.to, "track_full", "track"),
            (system_mod.to, "track_full_imu", "track_full_imu"),
            (system_mod.mo, "keyframe_step", "keyframe_step")]):
        launches = _drive(slam, frames, step,
                          ("frontend", "track", "track_full_imu",
                           "keyframe_step"), stage, "mono-inertial")
    pvb_launches = _calls(PVB)
    g = np.asarray(slam.gravity if slam.gravity is not None
                   else np.zeros(3), np.float64)
    rows = slam.poses_wc()
    ate, path, s_all = _ate(rows, poses, with_scale=True)
    half = len(rows) // 2
    _, _, s_half = _ate(rows[half:], poses, with_scale=True)
    mono_init = next((e.frame_id for e in slam.trajectory if not e.lost),
                     None)
    print(f"# mono-inertial: monocular map at frame {mono_init}, IMU "
          f"initialized at frame {init_at[0] if init_at else None}, stage "
          f"{slam._imu_stage}; scales applied (frame, s) "
          f"{[(f, round(v, 4)) for f, v in scales]}; gravity "
          f"{g.round(4).tolist()} (norm {np.linalg.norm(g):.4f}); Horn "
          f"scale {s_all:.4f} over {len(rows)} frames, {s_half:.4f} over the "
          f"second half (bars 1 +- 0.2); scale-free ATE {ate:.4f} m on "
          f"{path:.3f} m ({100 * ate / path:.3f}%, bar 12%)")
    _check(slam.state == "OK", f"final state {slam.state}")
    _check(slam.imu_initialized, "the IMU was never initialized")
    n = float(np.linalg.norm(g))
    _check(abs(n - 9.81) < 0.6 and g[1] / n > 0.9, f"gravity {g}")
    _check(abs(s_all - 1.0) < 0.2 and abs(s_half - 1.0) < 0.2,
           f"Horn scale {s_all}, second half {s_half}")
    _check(ate < 0.12 * path, "scale-free ATE above 12%")
    _check(launches == MONO_IMU_FRAMES, f"patch_gather launched {launches} "
           f"times for {MONO_IMU_FRAMES} frames")
    print(f"# mono-inertial: pose_vel_bias kernel launches {pvb_launches} "
          f"for {slam.imu_frames} inertial steps")
    _check(pvb_launches == slam.imu_frames > 0,
           f"pose_vel_bias launched {pvb_launches} times for "
           f"{slam.imu_frames} inertial steps")
    return launches, pvb_launches


CLI_FRAMES = 40         # the verify skill's 40 frames at 10 Hz
CLI_FPS = 10.0
CLI_RELOC_FRAME = 20
CLI_AFTER = 5           # frames tracked after the relocalization


def _cli_geometry():
    """configs/EuRoC-Inertial.yaml through the port's own settings reader:
    its width, height, fx, baseline (bf / fx), feature budget, levels and
    IMU noise block (as yaml scalars, written into the fabricated
    settings)."""
    from ms_slam_tpu_torch.utils.config import Settings
    st = Settings("configs/EuRoC-Inertial.yaml")
    fx = float(st.get("Camera.fx"))
    return dict(
        width=int(st.get("Camera.width")), height=int(st.get("Camera.height")),
        fx=fx, baseline=float(st.get("Camera.bf")) / fx, fps=CLI_FPS,
        n=CLI_FRAMES, n_features=int(st.get("ORBextractor.nFeatures")),
        n_levels=int(st.get("ORBextractor.nLevels")), seed=3,
        imu_noise=tuple(str(st.get(k)) for k in (
            "IMU.NoiseGyro", "IMU.NoiseAcc", "IMU.GyroWalk", "IMU.AccWalk")))


def phase_cli():
    """The CLI path at EuRoC-Inertial's full width (phase 13): the verify
    skill's recipe through the port's own drivers. Data:
    examples/gen_fake_euroc at configs/EuRoC-Inertial.yaml's 752x480, fx
    435.2047, bf 47.906 (a baseline of bf / fx = 0.110078 m), 1200 features
    (1280 after the settings reader's rounding), 8 levels and IMU noise
    keys; everything
    else the skill's: PlaneWorld and the "arc" path from seed 3, IMU at 200
    Hz, its Sparsification block (N=40, window 4, 3 non-local keyframes),
    loop closing on. Cuts against EuRoC: 10 Hz frames instead of 20 Hz;
    noise-free IMU rows; rectified renders, so no K_l...P_r keys and no
    remap; 40 frames.

    With cv2 the dataset goes to disk and
    examples.stereo_inertial_euroc.main([..., "--device", "cuda"]) runs over
    it (frames through the native prefetch pipeline when it built, else
    cv2); without cv2 the same rendered frames go, as StereoFrames with the
    IMU rows of the written csv, through the same driver loop
    (stereo_inertial_euroc.run), the settings still written and read by the
    port's Settings. Held (the skill's bars): state OK, IMU initialized, ATE
    under 0.1 m against gt.txt through examples.evaluate_ate, one kernel
    launch a frame. Then the map goes through utils.checkpoint.save_map /
    load_map into a fresh System from the same settings with use_imu=False
    (the format holds no inertial state): LOST with equal keyframe and point
    counts; the stereo pair at frame 20's pose turned 10 degrees and moved
    0.3 m (phase 5's recipe) relocalizes to OK within 0.35 m; frames 21-25
    then track OK. utils.viewer: the card map's PLY holds one vertex a live
    point and keyframe; frame PNGs every 10 frames where matplotlib is
    present."""
    import importlib.util
    import os
    import tempfile

    from scipy.spatial.transform import Rotation

    from ms_slam_tpu_torch.examples import (evaluate_ate, gen_fake_euroc,
                                            stereo_inertial_euroc)
    from ms_slam_tpu_torch.pipeline.system import System
    from ms_slam_tpu_torch.utils import checkpoint, native, viewer
    from ms_slam_tpu_torch.utils.config import Settings
    from ms_slam_tpu_torch.utils.datasets import EurocStereo, StereoFrame

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("cv2", "yaml", "matplotlib")}
    t0 = time.perf_counter()
    built = native.available()
    print("# cli: " + ", ".join(f"{m} {'present' if v else 'ABSENT'}"
                               for m, v in have.items())
          + f"; native runtime {'built' if built else 'NOT built'} in "
          f"{time.perf_counter() - t0:.2f} s"
          + ("" if built else f" ({native._load()[1]})"))
    geo = _cli_geometry()
    W_, H_, n = geo["width"], geo["height"], geo["n"]
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    d = work.name
    settings = os.path.join(d, "settings.yaml")
    mav = os.path.join(d, "mav0")
    traj = os.path.join(d, "traj.txt")
    t0 = time.perf_counter()
    if have["cv2"]:
        frames, poses = gen_fake_euroc.write(d, **geo)
    else:
        world, K, poses, imu = gen_fake_euroc.scene(
            W_, H_, geo["fx"], geo["fps"], n, geo["seed"])
        frames = gen_fake_euroc.render(world, K, poses, geo["baseline"], W_,
                                       H_)
        gen_fake_euroc.write_text(d, poses, imu, geo["fps"],
                                  gen_fake_euroc.settings_text(
                                      W_, H_, geo["fx"], geo["baseline"],
                                      geo["fps"], geo["n_features"],
                                      geo["n_levels"], geo["imu_noise"]))
    print(f"# cli ({_card()}): rendered {n} stereo frames of {W_}x{H_} in "
          f"{time.perf_counter() - t0:.1f} s (fx {geo['fx']}, baseline "
          f"{geo['baseline']:.6f} m, {geo['n_features']} features, "
          f"{geo['n_levels']} levels)")

    # what the driver builds, ran and saw: its System (frame PNGs on), its
    # per-frame times, the frame by which the IMU was initialized, and how
    # many native prefetch pipelines were opened
    frames_dir = os.path.join(d, "frames")
    seen = {"pipes": 0}
    driver_system, driver_run = stereo_inertial_euroc.System, \
        stereo_inertial_euroc.run
    real_pipe = native.PrefetchPipeline

    def drawing_system(cfg, device=None):
        cfg.frame_draw_every = 10 if have["matplotlib"] else 0
        cfg.frame_draw_dir = frames_dir
        seen["slam"] = driver_system(cfg, device=device)
        return seen["slam"]

    def watched_run(slam, stream, n_frames):
        def watched():
            for i, fr in enumerate(stream):
                if slam.imu_initialized and "init" not in seen:
                    seen["init"] = i - 1
                yield fr
        seen["times"] = driver_run(slam, watched(), n_frames)
        return seen["times"]

    class CountedPipe(real_pipe):
        def __init__(self, *a, **k):
            seen["pipes"] += 1
            super().__init__(*a, **k)
    stereo_inertial_euroc.System = drawing_system
    stereo_inertial_euroc.run = watched_run
    native.PrefetchPipeline = CountedPipe
    try:
        torch.cuda.reset_peak_memory_stats()
        _reset(PG, PVB)
        t0 = time.perf_counter()
        if have["cv2"]:
            slam = stereo_inertial_euroc.main(
                [settings, mav, "--out", traj, "--device", "cuda"])
        else:
            print("# cli: cv2 absent: the rendered frames go through "
                  "stereo_inertial_euroc.run as StereoFrames (no image files)")
            st = Settings(settings)
            cfg = st.system_config()
            cfg.use_imu = True
            ds = EurocStereo(mav, with_imu=True)  # timestamps, IMU rows
            stream, prev = [], None
            for (im_l, im_r), t_ns in zip(frames, ds.ts):
                t = t_ns * 1e-9
                stream.append(StereoFrame(t, im_l.astype(np.float32),
                                          im_r.astype(np.float32),
                                          ds._attach_imu(t, prev)))
                prev = t
            slam = stereo_inertial_euroc.System(cfg, device="cuda")
            stereo_inertial_euroc.run(slam, stream, n)
            slam.save_trajectory_tum(traj)
        torch.cuda.synchronize()
        drive_s = time.perf_counter() - t0
    finally:
        stereo_inertial_euroc.System = driver_system
        stereo_inertial_euroc.run = driver_run
        native.PrefetchPipeline = real_pipe
    launches = _calls(PG)
    pvb_launches = _calls(PVB)
    peak = torch.cuda.max_memory_allocated() / 2**20
    fs = np.asarray(seen["times"])
    route = ("the native prefetch pipeline" if seen["pipes"]
             else "cv2 in the loop" if have["cv2"] else "memory (no files)")
    print(f"# cli: frames came through {route}; driver wall {drive_s:.1f} s "
          f"(System built, {n} frames, shutdown, trajectory saved); "
          f"frames/s over frames 5-{n - 1}: {(n - 5) / fs[5:].sum():.3f} "
          f"(the driver's per-frame host times); frame p50 "
          f"{np.percentile(fs, 50) * 1e3:.2f} ms, max {fs.max() * 1e3:.2f} "
          f"ms; IMU initialized by frame {seen.get('init')}; keyframes "
          f"{slam.keyframes_in_map()}, map points {slam.map_points_in_map()} "
          f"(compressed {slam.compressed_map_points_in_map()}); kernel "
          f"launches {launches}; peak device memory {peak:.1f} MiB")
    _check(slam is seen.get("slam"), "the driver built another System")
    _check(slam.state == "OK", f"final state {slam.state}")
    _check(slam.imu_initialized, "imu initialized: False")
    _check(launches == n, f"patch_gather launched {launches} times for {n} "
           "frames")
    print(f"# cli: pose_vel_bias kernel launches {pvb_launches} for "
          f"{slam.imu_frames} inertial steps")
    _check(pvb_launches == slam.imu_frames > 0,
           f"pose_vel_bias launched {pvb_launches} times for "
           f"{slam.imu_frames} inertial steps")
    ate = evaluate_ate.main([os.path.join(d, "gt.txt"), traj,
                             "--max-dt", "0.05"])
    print(f"# cli: ATE {ate:.4f} m through examples.evaluate_ate (bar 0.1 m)")
    _check(ate < 0.1, f"ATE {ate:.4f} m")

    snap = viewer.MapSnapshot.from_system(slam)
    ply = os.path.join(d, "map.ply")
    snap.save_ply(ply)
    n_vert = int(snap.mp_valid.sum() + snap.kf_valid.sum())
    with open(ply) as f:
        body = f.read().splitlines()
    drawn = sorted(os.listdir(frames_dir)) if os.path.isdir(frames_dir) \
        else []
    print(f"# cli: PLY of the card map with {n_vert} vertices "
          f"({slam.map_points_in_map()} points, {slam.keyframes_in_map()} "
          f"keyframes); frame PNGs "
          + (f"{len(drawn)}: {drawn}" if have["matplotlib"]
             else "not drawn (matplotlib absent)"))
    _check(f"element vertex {n_vert}" in body
           and len(body) == n_vert + 10, "PLY vertex count")
    _check(n_vert == slam.map_points_in_map() + slam.keyframes_in_map(),
           "PLY vertices != live points + keyframes")
    if have["matplotlib"]:
        _check(len(drawn) >= 1, "no frame PNG was drawn")

    # the checkpoint: save, load into a fresh System, relocalize, track on
    path = os.path.join(d, "map.npz")
    t0 = time.perf_counter()
    checkpoint.save_map(path, slam)
    save_s = time.perf_counter() - t0
    cfg2 = Settings(settings).system_config()
    cfg2.use_imu = False
    slam2 = System(cfg2, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.load_map(path, slam2)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    counts = [(s.keyframes_in_map(), s.map_points_in_map())
              for s in (slam, slam2)]
    print(f"# cli: checkpoint {os.path.getsize(path) / 2**20:.2f} MiB "
          f"(md5 {checkpoint.md5_of_file(path)}), save_map {save_s:.2f} s, "
          f"load_map {load_s:.2f} s; (keyframes, points) saved {counts[0]}, "
          f"loaded {counts[1]}; state {slam2.state}")
    _check(slam2.state == "LOST", f"state after load_map {slam2.state}")
    _check(counts[0] == counts[1], "counts changed through the checkpoint")
    _check(all(t.is_cuda for t in slam2.ms) and slam2.kf_db.rows.is_cuda,
           "the loaded map is not on the card")
    ord_loaded = slam2.kf_ord

    world, K, _, _ = gen_fake_euroc.scene(W_, H_, geo["fx"], geo["fps"], n,
                                          geo["seed"])
    T_q = poses[CLI_RELOC_FRAME].copy()
    T_q[:3, :3] = T_q[:3, :3] @ Rotation.from_euler(
        "y", np.deg2rad(10)).as_matrix()
    T_q[:3, 3] += T_q[:3, :3] @ np.array([0.3, 0.0, 0.0])
    (q_l, q_r), = gen_fake_euroc.render(world, K, [T_q], geo["baseline"], W_,
                                        H_)
    _reset(PG)
    t_next = CLI_FRAMES / CLI_FPS + 1.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam2.track_stereo(q_l, q_r, t_next)
    torch.cuda.synchronize()
    reloc_s = time.perf_counter() - t0
    # the map frame is the first camera's, the world frame here
    err = float(np.linalg.norm(np.linalg.inv(slam2.current_pose())[:3, 3]
                               - T_q[:3, 3]))
    print(f"# cli: relocalization of frame {CLI_RELOC_FRAME}'s pose turned "
          f"10 degrees and moved 0.3 m against the loaded map: state "
          f"{slam2.state}, camera-centre error {err:.4f} m (bar 0.35 m), "
          f"track_stereo {reloc_s * 1e3:.1f} ms (synchronised)")
    _check(slam2.state == "OK", f"relocalization ended {slam2.state}")
    _check(err < 0.35, f"relocalization error {err:.3f} m")
    after = []
    for j, i in enumerate(range(CLI_RELOC_FRAME + 1,
                                CLI_RELOC_FRAME + 1 + CLI_AFTER)):
        slam2.track_stereo(frames[i][0], frames[i][1],
                           t_next + (j + 1) / CLI_FPS)
        slam2._flush_pipeline()
        after.append((i, slam2.state, float(np.linalg.norm(
            np.linalg.inv(slam2.current_pose())[:3, 3] - poses[i][:3, 3]))))
    torch.cuda.synchronize()
    launches2 = _calls(PG)
    print("# cli: after the relocalization (frame, state, camera-centre "
          f"error m): {[(i, s, round(e, 4)) for i, s, e in after]}; "
          f"keyframes made after the load {slam2.kf_ord - ord_loaded}; "
          f"kernel launches {launches2}")
    _check(all(s == "OK" for _, s, _ in after)
           and not any(e.lost for e in slam2.trajectory),
           f"tracking after the relocalization: {after}")
    _check(launches2 == 1 + CLI_AFTER, f"patch_gather launched {launches2} "
           f"times for {1 + CLI_AFTER} frames")
    work.cleanup()
    return launches + launches2, pvb_launches


# ---------------------------------------------------------------------------
# phases 15-17: the Atlas, the inertial loop, the memory A/B and recycling
# ---------------------------------------------------------------------------

ATLAS_MAP0 = 40         # circuit frames 0-39 make map 0 (the ramp and 20 more)
ATLAS_BLIND = 13        # blank pairs: 4 to pass t_recently_lost, 9 LOST at fps 4
ATLAS_REJOIN = 110      # map 1 restarts from rest at 270 degrees and joins the
ATLAS_END = 145         # circuit's frames 110-144, over map 0 from frame 130
ATLAS_S2_MAP0 = 30      # S2: circuit frames 0-29 make map 0
ATLAS_S2_BLANK = 3      # S2: the blackout before the return to map 0
ATLAS_S2_BACK = (12, 18)  # S2: circuit frames back over map 0's ground


def _seam_rmse(slam, cur, live=False, detail=False):
    """tests/test_atlas.py's seam reprojection RMSE (px) around keyframe
    `cur`: the keyframe and its 7 most covisible ones, every valid
    observation in front of the camera; with `live`, only the observations
    of live points (the fusion can leave an observation of a point it
    killed, in both packages: ROADMAP queue 3); with `detail`, a line that
    says how the errors are spread."""
    from ms_slam_tpu_torch.models import map_state as M
    from ms_slam_tpu_torch.ops import cameras
    ms = slam.ms
    dev = ms.kf_R.device
    covis = M.covisibility_counts(ms, cur).cpu().numpy()
    win = [cur] + [int(i) for i in np.argsort(-covis) if covis[i] > 0][:7]
    sl = torch.tensor(win, device=dev)
    obs = ms.obs_mp[sl]
    valid = (obs >= 0) & ms.kp_valid[sl]
    X = ms.mp_pos[obs.clamp(min=0).long()]
    Xc = torch.einsum("kij,knj->kni", ms.kf_R[sl], X) + ms.kf_t[sl][:, None]
    uv = cameras.project(slam.calib.model, slam.calib.params_array(dev),
                         Xc.reshape(-1, 3)).reshape(Xc.shape[0], -1, 2)
    e = (uv - ms.kp_xy[sl]).norm(dim=-1)
    ok = valid & (Xc[..., 2] > 0.05)
    if live:
        ok &= ms.mp_valid[obs.clamp(min=0).long()]
    rmse = float(torch.sqrt(torch.where(ok, e * e, 0.0).sum()
                            / ok.sum().clamp(min=1)))
    if not detail:
        return rmse
    ev = e[ok].cpu().numpy()
    dead = int((ok & ~ms.mp_valid[obs.clamp(min=0).long()]).sum())
    return (f"{rmse:.4f} px over {ev.size} observations (median "
            f"{np.median(ev):.3f}, p99 {np.percentile(ev, 99):.2f}, max "
            f"{ev.max():.1f}, {int((ev > 10).sum())} above 10 px, {dead} of "
            f"dead points)")


def _map_kf_ate(slam, gt):
    """Keyframe-centre ATE (Horn-aligned) of the active map's keyframes
    against the poses their frames were rendered at (gt[frame id]), and the
    length of the path those keyframes' frames cover."""
    from ms_slam_tpu_torch.utils import evaluate
    ms = slam.ms
    slots = [k for k in slam.kf_order if bool(ms.kf_valid[k])
             and slam.kf_maps[k] == slam.active_map]
    fids = [int(ms.kf_frame_id[k]) for k in slots]
    est = _kf_centres(ms, slots)
    ref = np.stack([gt[f][:3, 3] for f in fids])
    o = np.argsort(fids)
    path = float(np.sum(np.linalg.norm(np.diff(ref[o], axis=0), axis=1)))
    return evaluate.ate_rmse(est, ref), path, len(slots)


def _print_calls(stage, keys, card):
    for k in keys:
        v = np.asarray(stage.get(k, [0.0]))
        print(f"# call {k:<22} n={len(stage.get(k, []))} p50 "
              f"{np.percentile(v, 50) * 1e3:.2f} ms max {v.max() * 1e3:.2f} "
              f"ms (host clock between device syncs; {card})")


def _atlas_run(script, cfg, label, card):
    """Drive one System over `script` [(images, true pose, part)], one
    track_stereo call each, 0.1 s apart, with the weld BA, _merge_maps and
    detect_and_verify timed. Returns its outcomes."""
    from ms_slam_tpu_torch.pipeline import loop_closing
    from ms_slam_tpu_torch.pipeline.system import System
    slam = System(cfg, device="cuda")
    lc = slam._loop_closer
    stage = {}
    detect_and_verify = loop_closing.detect_and_verify
    _timed(loop_closing, "detect_and_verify", "detect_and_verify", stage)
    weld_log, merged_at, trace, frame_s = [], [], [], []
    weld = lc._weld_ba

    def weld_spy(cur, match):
        before = (_seam_rmse(slam, cur), _seam_rmse(slam, cur, live=True))
        spread = _seam_rmse(slam, cur, detail=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        weld(cur, match)
        torch.cuda.synchronize()
        stage.setdefault("_weld_ba", []).append(time.perf_counter() - t0)
        weld_log.append((int(slam.ms.kf_frame_id[cur]),
                         int(slam.ms.kf_frame_id[match]), *before,
                         _seam_rmse(slam, cur),
                         _seam_rmse(slam, cur, live=True)))
        print(f"# atlas {label}: seam before the weld BA: {spread}; after: "
              f"{_seam_rmse(slam, cur, detail=True)}")
    lc._weld_ba = weld_spy
    merge = lc._merge_maps

    def timed_merge(cur, match, *S):
        merged_at.append(len(trace))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        merge(cur, match, *S)
        torch.cuda.synchronize()
        stage.setdefault("_merge_maps", []).append(time.perf_counter() - t0)
    lc._merge_maps = timed_merge

    torch.cuda.reset_peak_memory_stats()
    _reset(PG)
    for i, ((img_l, img_r), _, part) in enumerate(script):
        t0 = time.perf_counter()
        slam.track_stereo(img_l, img_r, 0.1 * i)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        trace.append((part, slam.state, slam.active_map))
    slam._flush_pipeline()
    torch.cuda.synchronize()
    launches = _calls(PG)
    loop_closing.detect_and_verify = detect_and_verify

    fs = np.asarray(frame_s)
    runs = []
    for p, st, m in trace:
        if not runs or runs[-1][0] != (p, st[:2], m):
            runs.append([(p, st[:2], m), 0])
        runs[-1][1] += 1
    counts = {m: slam.kf_maps.count(m) for m in set(slam.kf_maps)}
    ate, path, n_kf = _map_kf_ate(slam, [T for _, T, _ in script])
    newest = slam.kf_order[-1]
    print(f"# atlas {label}: {len(script)} frames; frames/s "
          f"{len(fs) / fs.sum():.3f}; frame wall p50 "
          f"{np.percentile(fs, 50) * 1e3:.2f} ms, p95 "
          f"{np.percentile(fs, 95) * 1e3:.2f} ms, max {fs.max() * 1e3:.2f} "
          f"ms; kernel launches {launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"# atlas {label}: (part, state, active map) x frames: " + " ".join(
        f"{p}/{st}/{m}x{n}" for (p, st, m), n in runs))
    print(f"# atlas {label}: loop closer {lc.stats}; merges at frames "
          f"{merged_at}; keyframes by map {counts}")
    for f_cur, f_match, b, bl, a, al in weld_log:
        print(f"# atlas {label}: weld BA at frame {f_cur} onto frame "
              f"{f_match}: seam RMSE (tests/test_atlas.py's) {b:.4f} px "
              f"before, {a:.4f} px after; over live points' observations "
              f"{bl:.4f} px before, {al:.4f} px after (bar: lower)")
    _print_calls(stage, ("detect_and_verify", "_merge_maps", "_weld_ba"),
                 card)
    return {"state": slam.state, "active_map": slam.active_map,
            "counts": counts, "merges": lc.stats.get("merges", 0),
            "n_dv": len(stage.get("detect_and_verify", [])), "ate": ate,
            "path": path, "n_kf": n_kf, "weld": weld_log, "trace": trace,
            "newest_label": slam.kf_maps[newest], "launches": launches,
            "n_frames": len(script)}


def phase_atlas(circuit=None):
    """The Atlas at full width (phase 15): tests/test_atlas.py's S1 (a new
    map after an irrecoverable loss, then a merge found by place
    recognition) and S2 (a cross-map relocalization), each on a System of
    its own, scaled to phase 7's circuit and its frames.

    Configuration: phase 7's (1248x384, 2048 features, 8 levels, phase 4's
    pools and sparsifier, loop closing on at its defaults) with
    test_atlas.py's fps 4 (9 LOST frames start a map) and t_recently_lost
    0.3 s. Scripts, one track_stereo call a frame, 0.1 s apart:
      S1: circuit frames 0-39 (map 0); ATLAS_BLIND blank pairs, past
          t_recently_lost into LOST and a new map; map 1 from rest at 270
          degrees (a 20-frame ramp rendered here, the circuit's start turned
          by 270 degrees: a full-rate start has no velocity model), joining
          circuit frames 110-144, which come back over map 0 from frame 130;
      S2: circuit frames 0-29 (map 0); ATLAS_BLIND blank pairs (map 1); the
          same ramp (map 1, on ground map 0 never saw); a 3-frame blackout;
          circuit frames 12-17 over map 0's ground.
    Cuts against test_atlas.py: the circuit's geometry and phase 7's world
    instead of BoxWorld(half=7) and the 80-frame orbit; map 1 starts from
    rest; 108 and 72 frames instead of 100 and 87.

    Held (S1, tests/test_atlas.py:87-103): a second map created in the
    blind stretch; merges >= 1 reached through the loop closer's database
    queries (detect_and_verify called; the script calls no merge); the weld
    BA lowering the seam's reprojection RMSE on every merge, over the
    observations of live points (test_atlas.py's own RMSE, which also
    counts an observation the fusion left on a point it killed, is printed
    beside it: at full width one such observation, far off and outside
    every BA, outweighed the rest); the active map
    holding the most keyframes; state OK; the active map's keyframe ATE
    under 2% of their path. (S2, :149-160) a second map created; state OK;
    active_map 0; the newest keyframe labelled with it. One patch-gather
    launch a frame. `circuit`: phase 7's (poses, frames), when it ran in
    this script."""
    import dataclasses

    from ms_slam_tpu_torch.pipeline.frontend import Calib

    card = _card()
    t_phase = time.perf_counter()
    poses, frames = circuit or _circuit_frames()
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    w = 2 * np.pi / LOOP_LAP
    restart = _circuit(LOOP_RAMP, LOOP_RADIUS, LOOP_LAP, LOOP_RAMP,
                       start=w * (ATLAS_REJOIN - LOOP_RAMP))
    t0 = time.perf_counter()
    restart_frames = _render_all(
        "BoxWorld", dict(half=24.0, tex_scale=LOOP_TEX_SCALE), K, restart)
    print(f"# atlas ({card}): rendered the {LOOP_RAMP}-frame restart in "
          f"{time.perf_counter() - t0:.1f} s")
    blank = (np.zeros((H, W), np.uint8),) * 2
    ramp = [(f, T, "map1") for f, T in zip(restart_frames, restart)]
    s1 = ([(frames[i], poses[i], "map0") for i in range(ATLAS_MAP0)]
          + [(blank, poses[ATLAS_MAP0], "blind")] * ATLAS_BLIND + ramp
          + [(frames[i], poses[i], "map1") for i in range(ATLAS_REJOIN,
                                                           ATLAS_END)])
    s2 = ([(frames[i], poses[i], "map0") for i in range(ATLAS_S2_MAP0)]
          + [(blank, poses[ATLAS_S2_MAP0], "blind")] * ATLAS_BLIND + ramp
          + [(blank, restart[-1], "blackout")] * ATLAS_S2_BLANK
          + [(frames[i], poses[i], "back") for i in range(*ATLAS_S2_BACK)])
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                  width=W, height=H, th_depth=BASELINE * 40, fps=4.0)
    cfg = dataclasses.replace(
        _main_cfg(), calib=calib, max_frames_between_kf=LOOP_KF_EVERY,
        loop_closing=True, t_recently_lost=0.3)

    r = _atlas_run(s1, cfg, "S1", card)
    r2 = _atlas_run(s2, cfg, "S2", card)
    maps_s1 = {m for p, _, m in r["trace"] if p in ("blind", "map1")}
    print(f"# atlas S1: state {r['state']}, active map {r['active_map']}, "
          f"maps in the blind stretch and after it {sorted(maps_s1)}, "
          f"merges {r['merges']} (bar >= 1) after {r['n_dv']} "
          f"detect_and_verify calls, keyframes by map {r['counts']}; "
          f"keyframe ATE {r['ate']:.4f} m on a {r['path']:.2f} m path over "
          f"{r['n_kf']} keyframes "
          f"({100 * r['ate'] / max(r['path'], 1e-9):.3f}%, bar 2%)")
    maps_s2 = {m for _, _, m in r2["trace"]}
    print(f"# atlas S2: state {r2['state']}, maps {sorted(maps_s2)}, active "
          f"map {r2['active_map']} (bar 0), newest keyframe labelled "
          f"{r2['newest_label']}, merges {r2['merges']}")
    _check(max(maps_s1) >= 1, "S1: no second map in the blind stretch")
    _check(r["merges"] >= 1 and r["n_dv"] > 0, "S1: no merge found by place "
           "recognition")
    _check(all(al <= bl + 1e-6 for _, _, _, bl, _, al in r["weld"]),
           f"S1: the weld BA did not lower the seam RMSE: {r['weld']}")
    _check(r["counts"].get(r["active_map"], 0) >= max(r["counts"].values()),
           f"S1: the active map does not hold the most keyframes")
    _check(r["state"] == "OK", f"S1 ends {r['state']}")
    _check(r["ate"] < 0.02 * r["path"], "S1: keyframe ATE above 2%")
    _check(max(maps_s2) >= 1, "S2: no second map")
    _check(r2["state"] == "OK", f"S2 ends {r2['state']}")
    _check(r2["active_map"] == 0 and r2["newest_label"] == 0,
           f"S2 ends on map {r2['active_map']}, newest keyframe labelled "
           f"{r2['newest_label']}")
    for x in (r, r2):
        _check(x["launches"] == x["n_frames"], f"patch_gather launched "
               f"{x['launches']} times for {x['n_frames']} frames")
    print(f"# phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return r["launches"] + r2["launches"]


# configs/EuRoC-Inertial.yaml IMU.T_b_c1 (camera to body)
EUROC_TBC = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0]])
IMU_LOOP_BIAS_GYRO = (0.004, -0.003, 0.002)   # rad/s, constant
IMU_LOOP_BIAS_ACC = (0.06, -0.04, 0.05)       # m/s^2, constant


def phase_inertial_loop(circuit=None):
    """An inertial loop closure at full width (phase 16): tests/test_
    inertial_system.py::test_inertial_loop_closure_preserves_gravity's
    configuration (use_imu, imu_init_kfs=6, imu_init_time=0.5,
    loop_pitchroll_tol=0.05, loop closing and the selector on) at phase 7's
    width, pools and keyframe spacing, over phase 7's circuit and frames
    (its lap closes at frame 130), with IMU rows at 200 Hz.

    The IMU is a real one's in three ways the reference test's is not: the
    body is configs/EuRoC-Inertial.yaml's T_b_c1 away from the camera
    (passed in SystemConfig.Tbc; the rows are made from the body's poses,
    T_wb = T_wc Tbc^-1), the rows carry constant biases IMU_LOOP_BIAS_GYRO
    and IMU_LOOP_BIAS_ACC, and white noise at SystemConfig's imu_noise_gyro
    and imu_noise_acc densities (sigma = density * sqrt(200 Hz); seed 0).

    Held (tests/test_inertial_system.py:150-162): state OK; initialized
    with _imu_stage >= 2; queries > 0; loops >= 1, each through
    pose_graph.optimize_pose_graph_4dof (counted); |g| within 0.6 of 9.81
    and g_y/|g| > 0.9; and phase 7's frame ATE under 2% of the path. One
    patch-gather launch a frame. `circuit`: phase 7's (poses, frames),
    when another process rendered them."""
    import dataclasses

    from ms_slam_tpu_torch.ops import pose_graph
    from ms_slam_tpu_torch.pipeline import loop_closing
    from ms_slam_tpu_torch.pipeline.system import System
    from ms_slam_tpu_torch.utils import evaluate, synth

    card = _card()
    t_phase = time.perf_counter()
    poses, frames = circuit or _circuit_frames()
    cfg = dataclasses.replace(
        _main_cfg(), max_frames_between_kf=LOOP_KF_EVERY, loop_closing=True,
        use_imu=True, imu_init_kfs=6, imu_init_time=0.5,
        loop_pitchroll_tol=0.05, Tbc=EUROC_TBC)
    Tcb = np.linalg.inv(EUROC_TBC)
    rows = synth.make_imu([T @ Tcb for T in poses], IMU_DT,
                          imu_rate=IMU_RATE)
    rng = np.random.default_rng(0)
    sg = cfg.imu_noise_gyro * np.sqrt(IMU_RATE)
    sa = cfg.imu_noise_acc * np.sqrt(IMU_RATE)
    for r in rows:                      # [dt, ax, ay, az, gx, gy, gz]
        r[:, 1:4] += np.asarray(IMU_LOOP_BIAS_ACC) + rng.normal(
            0, sa, (len(r), 3))
        r[:, 4:7] += np.asarray(IMU_LOOP_BIAS_GYRO) + rng.normal(
            0, sg, (len(r), 3))
    print(f"# inertial loop ({card}): {len(rows[0])} IMU rows a frame, "
          f"white noise sigma {sg:.4f} rad/s and {sa:.4f} m/s^2, biases "
          f"gyro {IMU_LOOP_BIAS_GYRO} acc {IMU_LOOP_BIAS_ACC}, Tbc "
          "configs/EuRoC-Inertial.yaml's T_b_c1")

    slam = System(cfg, device="cuda")
    lc = slam._loop_closer
    stage = {}
    wrapped = [(loop_closing, "detect_and_verify"),
               (pose_graph, "optimize_pose_graph_4dof"),
               (pose_graph, "optimize_pose_graph")]
    originals = [getattr(m, n) for m, n in wrapped]
    _timed(loop_closing, "detect_and_verify", "detect_and_verify", stage)
    _timed(pose_graph, "optimize_pose_graph_4dof",
           "optimize_pose_graph_4dof", stage)
    _timed(pose_graph, "optimize_pose_graph", "optimize_pose_graph", stage)
    _timed(lc, "_correct_loop", "_correct_loop", stage)
    _timed(slam, "_full_inertial_ba", "_full_inertial_ba", stage)
    torch.cuda.reset_peak_memory_stats()
    _reset(PG, PVB)
    frame_s, stages = [], []
    for i in range(LOOP_FRAMES):
        t0 = time.perf_counter()
        if i == 0:
            slam.track_stereo(frames[i][0], frames[i][1], 0.0)
        else:
            slam.track_stereo_imu(frames[i][0], frames[i][1], IMU_DT * i,
                                  rows[i - 1])
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        stages.append((slam.imu_initialized, slam._imu_stage,
                       lc.stats["loops"]))
    slam._flush_pipeline()
    torch.cuda.synchronize()
    launches = _calls(PG)
    pvb_launches = _calls(PVB)
    for (m, n), fn in zip(wrapped, originals):
        setattr(m, n, fn)

    def first(pred):
        return next((i for i, s in enumerate(stages) if pred(s)), None)
    fs = np.asarray(frame_s)
    g = np.asarray(slam.gravity, np.float64)
    bias = np.asarray(slam.imu_bias, np.float64)
    print(f"# inertial loop: {LOOP_FRAMES} frames; initialized at frame "
          f"{first(lambda s: s[0])}, stage 2 at frame "
          f"{first(lambda s: s[1] >= 2)}, first loop at frame "
          f"{first(lambda s: s[2] >= 1)}; frames/s {len(fs) / fs.sum():.3f}; "
          f"frame wall p50 {np.percentile(fs, 50) * 1e3:.2f} ms, p95 "
          f"{np.percentile(fs, 95) * 1e3:.2f} ms, max {fs.max() * 1e3:.2f} "
          f"ms; keyframes {slam.keyframes_in_map()}; kernel launches "
          f"{launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"# inertial loop: loop closer {lc.stats}; gravity "
          f"{g.round(4).tolist()} (norm {np.linalg.norm(g):.4f}, bar "
          f"9.81 +- 0.6; g_y/|g| {g[1] / np.linalg.norm(g):.4f}, bar 0.9); "
          f"bias gyro {bias[:3].round(5).tolist()} (true "
          f"{list(IMU_LOOP_BIAS_GYRO)}), acc {bias[3:].round(4).tolist()} "
          f"(true {list(IMU_LOOP_BIAS_ACC)})")
    _print_calls(stage, ("detect_and_verify", "_correct_loop",
                         "optimize_pose_graph_4dof", "optimize_pose_graph",
                         "_full_inertial_ba"), card)
    rws = slam.poses_wc()
    est = np.stack([T[:3, 3] for _, T in rws])
    ref = np.stack([poses[int(round(ts / IMU_DT))][:3, 3] for ts, _ in rws])
    path = float(np.sum(np.linalg.norm(np.diff(ref, axis=0), axis=1)))
    ate = evaluate.ate_rmse(est, ref)
    print(f"# inertial loop: ATE {ate:.4f} m on a {path:.2f} m path "
          f"({100 * ate / path:.3f}%, bar 2%)")
    n4 = len(stage.get("optimize_pose_graph_4dof", []))
    _check(slam.state == "OK", f"final state {slam.state}")
    _check(slam.imu_initialized and slam._imu_stage >= 2,
           f"inertial stage {slam._imu_stage}")
    _check(lc.stats["queries"] > 0, "no database query")
    _check(lc.stats["loops"] >= 1, f"no loop closed: {lc.stats}")
    _check(n4 >= 1, f"{n4} 4-DoF graphs for {lc.stats['loops']} loops")
    _check(abs(np.linalg.norm(g) - 9.81) < 0.6
           and g[1] / np.linalg.norm(g) > 0.9, f"gravity {g}")
    _check(np.isfinite(est).all() and ate < 0.02 * path, "ATE above 2%")
    _check(launches == LOOP_FRAMES,
           f"patch_gather launched {launches} times for {LOOP_FRAMES} frames")
    print(f"# inertial loop: pose_vel_bias kernel launches {pvb_launches} "
          f"for {slam.imu_frames} inertial steps")
    _check(pvb_launches == slam.imu_frames > 0,
           f"pose_vel_bias launched {pvb_launches} times for "
           f"{slam.imu_frames} inertial steps")
    print(f"# phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return launches, pvb_launches


def _drive_corridor(frames, cfg, label, card):
    """One shut-down System over phase 4's frames: (_ab_arm, seconds)."""
    from ms_slam_tpu_torch.pipeline.system import System
    slam = System(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    ok = 0
    t0 = time.perf_counter()
    for i, (img_l, img_r) in enumerate(frames):
        slam.track_stereo(img_l, img_r, 0.1 * i)
        ok += slam.state == "OK"
    slam.shutdown()
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    arm = _ab_arm(slam, ok)
    print(f"# memory {label}: {len(frames)} frames in {s:.1f} s "
          f"({len(frames) / s:.3f} frames/s, {card}); state {arm['state']}; "
          f"points created {arm['n_mp']}, in the map {arm['mp_in_map']}; "
          f"keyframes made {arm['kf_ord']} in {arm['n_kf']} slots; "
          f"memory_stats {arm['mem']}; checkpoint {arm['ckpt']} B; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          "MiB")
    return arm


# points kept by phase 17's A/B at 320x240 and 512 features on the CPU,
# the reference's and the port's (tests/test_torch_memory_ab.py::
# test_phase17_ab_at_small_size_both_packages): neither meets
# tests/test_memory_ab.py's 0.18 at phase 4's configuration
AB_SMALL_KEPT_REF, AB_SMALL_KEPT_PORT = 0.657, 0.630


def phase_memory(on=None, corridor=None):
    """The memory A/B and pool recycling at full width (phase 17):
    tests/test_memory_ab.py and tests/test_longrun.py on phase 4's frames
    and configuration.

    A/B: the same rendered frames with sparsify=True (phase 4's own run
    when it ran in this process, read right after its shutdown(); else run
    here) and sparsify=False, compared by memory_stats()'s live bytes and
    by the checkpoint's size. Recycling: once more with sparsification on
    and pools of half the points (rounded down to 256) and two thirds of
    the keyframes (at least 9, the window BA's) the A/B's sparsified run
    created, so that the run overflows both.

    Held: A/B (tests/test_memory_ab.py:52-87): both OK; points kept <= 0.18,
    or where the reference misses that on this scenario, its outcome plus
    0.05 (AB_SMALL_KEPT_REF, at 320x240: the reference cannot run the full
    width on a CPU in a test's time); reduction from live bytes >= 0.80;
    the trajectory gap < 3% of the path;
    the sparsified run's checkpoint < 0.35 of the other's. Recycling
    (tests/test_longrun.py:49-67): > 90% of frames OK; points created
    > 1.3 x the pool, the map within it; keyframes made beyond the slots;
    the newest keyframe with > 20 points; the selector killing > 30%. One
    patch-gather launch a frame of the runs made here. `corridor`: phase
    4's (poses, frames), when another process rendered them."""

    card = _card()
    t_phase = time.perf_counter()
    poses, frames = corridor or _corridor_frames()
    _reset(PG)
    n_runs = 2
    if on is None:
        on = _drive_corridor(frames, _main_cfg(), "A, sparsify=True", card)
        n_runs = 3
    off = _drive_corridor(frames, _main_cfg(sparsify=False),
                          "B, sparsify=False", card)
    max_mp = on["n_mp"] // 2 // 256 * 256
    # the window BA needs window_kf - 1 + n_fixed_cams slots (9) in both
    # packages (the reference's top_k refuses fewer)
    max_kf = max(9, on["kf_ord"] * 2 // 3)
    rec = _drive_corridor(frames, _main_cfg(max_kf=max_kf, max_mp=max_mp),
                          f"recycling, pools {max_mp} points and {max_kf} "
                          "keyframes", card)
    launches = _calls(PG)

    kept = on["mem"]["mp_live"] / max(off["mem"]["mp_live"], 1)
    red = 1.0 - on["mem"]["live_bytes"] / max(off["mem"]["live_bytes"], 1)
    n = min(len(on["xyz"]), len(off["xyz"]))
    gap = float(np.linalg.norm(on["xyz"][:n] - off["xyz"][:n], axis=1)
                .mean())
    path = float(np.sum(np.linalg.norm(np.diff(off["xyz"][:n], axis=0),
                                       axis=1)))
    ratio = on["ckpt"] / off["ckpt"]
    kept_bar = max(0.18, AB_SMALL_KEPT_REF + 0.05)
    print(f"# memory A/B: states {on['state']}/{off['state']}; points kept "
          f"{kept:.4f} (tests/test_memory_ab.py's bar 0.18; at 320x240 on "
          f"these frames the reference keeps {AB_SMALL_KEPT_REF}, the port "
          f"{AB_SMALL_KEPT_PORT}: held to <= {kept_bar:.3f}); "
          f"reduction {red:.4f} (bar >= 0.80); "
          f"trajectory gap {gap:.4f} m on a {path:.2f} m path "
          f"({100 * gap / path:.3f}%, bar 3%); checkpoints {on['ckpt']} and "
          f"{off['ckpt']} B (ratio {ratio:.4f}, bar 0.35)")
    st = rec["stats"]
    killed = st.get("killed", 0) / max(st.get("killed", 0)
                                       + st.get("kept", 0), 1)
    print(f"# recycling: frames OK {rec['ok_frames']} of {len(frames)} "
          f"(bar > 90%); points created {rec['n_mp']} for a pool of "
          f"{max_mp} ({rec['n_mp'] / max_mp:.3f}x, bar 1.3x), in the map "
          f"{rec['mp_in_map']}; keyframes made {rec['kf_ord']} in "
          f"{rec['n_kf']} slots; newest keyframe's points "
          f"{rec['newest_points']} (bar > 20); selector killed "
          f"{100 * killed:.1f}% (bar 30%)")
    _check(on["state"] == off["state"] == "OK", "an A/B run did not end OK")
    _check(kept <= kept_bar, f"points kept {kept:.4f}")
    _check(red >= 0.80, f"reduction {red:.4f}")
    _check(gap < 0.03 * path, "trajectory gap above 3%")
    _check(ratio < 0.35, f"checkpoint ratio {ratio:.4f}")
    _check(rec["state"] == "OK" and rec["ok_frames"] > 0.9 * len(frames),
           f"recycling: {rec['ok_frames']} frames OK, ends {rec['state']}")
    _check(rec["n_mp"] > 1.3 * max_mp and rec["mp_in_map"] <= max_mp,
           "recycling: the point pool did not overflow 1.3 times")
    _check(rec["kf_ord"] > rec["n_kf"] and rec["kf_order_len"] <= rec["n_kf"],
           "recycling: keyframe slots not reused")
    _check(rec["newest_points"] > 20, "recycling: the newest keyframe "
           f"has {rec['newest_points']} points")
    _check(killed > 0.3, f"recycling: the selector killed {killed:.3f}")
    _check(launches == n_runs * len(frames), f"patch_gather launched "
           f"{launches} times for {n_runs} x {len(frames)} frames")
    print(f"# phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return launches



PIPELINE_STAGES = ("prefetch_dispatch", "stats_fetch", "complete")
PIPELINE_VARS = ("MSSLAM_PIPELINE_DEPTH", "MSSLAM_FETCH_BATCH",
                 "MSSLAM_SYNC_PREFETCH", "MSSLAM_OBS_EVERY_FRAME")


def _pipeline_stages(slam):
    """(calls, p50 ms, total s) of the System's own pipeline stage timers
    (host clock, no device sync)."""
    out = {}
    for k in PIPELINE_STAGES:
        v = np.asarray(slam.timing.get(k, [0.0]))
        out[k] = (len(slam.timing.get(k, [])), float(np.median(v)) * 1e3,
                  float(v.sum()))
    return out


def _pipeline_system(cfg, depth: int):
    """A System made with MSSLAM_PIPELINE_DEPTH=depth (the fetch batch its
    default, max(1, depth - 2)) and no other pipeline variable set."""
    import os

    from ms_slam_tpu_torch.pipeline.system import System
    saved = {k: os.environ.pop(k, None) for k in PIPELINE_VARS}
    os.environ["MSSLAM_PIPELINE_DEPTH"] = str(depth)
    try:
        slam = System(cfg, device="cuda")
    finally:
        os.environ.pop("MSSLAM_PIPELINE_DEPTH")
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    _check(slam._pipeline_depth == depth
           and slam._fetch_batch == max(1, depth - 2), "pipeline settings")
    return slam


def _drive_pipelined(frames, poses, depth, card):
    """Phase 4's frames through a System at the given depth with next_images
    on every frame, as bench.py:92-106 drives it: no device sync between
    calls. Frames/s over frames 10-99 from the calls' start times; p50 and
    p95 of the calls' wall time."""
    from ms_slam_tpu_torch.utils import evaluate
    slam = _pipeline_system(_main_cfg(), depth)
    torch.cuda.synchronize()
    _reset(PG)
    starts, walls = [], []
    n = len(frames)
    for i in range(n):
        nxt = frames[i + 1] if i + 1 < n else None
        t0 = time.perf_counter()
        slam.track_stereo(frames[i][0], frames[i][1], 0.1 * i,
                          next_images=nxt)
        starts.append(t0)
        walls.append(time.perf_counter() - t0)
    slam.shutdown()
    torch.cuda.synchronize()
    launches = _calls(PG)
    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est = np.stack([Twc[:3, 3] for _, Twc in rows])
    gt = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    mem = slam.memory_stats()
    out = {"slam": slam, "launches": launches,
           "fps": (n - 11) / (starts[-1] - starts[10]),
           "p50": np.percentile(walls, 50) * 1e3,
           "p95": np.percentile(walls, 95) * 1e3,
           "ok": sum(not e.lost for e in slam.trajectory),
           "n_rec": len(slam.trajectory), "ate": evaluate.ate_rmse(est, gt),
           "path": path, "reduction": mem["reduction"],
           "compressed": slam.compressed_map_points_in_map(),
           "hits": slam.prefetch_hits,
           "fetches": len(slam.timing.get("stats_fetch", [])),
           "stages": _pipeline_stages(slam),
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    st = "; ".join(f"{k} n={c} p50 {p:.3f} ms total {t:.3f} s"
                   for k, (c, p, t) in out["stages"].items())
    print(f"# pipeline depth {depth} ({card}): {out['n_rec']} frames, "
          f"{out['ok']} OK, state {slam.state}; frames/s over frames "
          f"10-99 {out['fps']:.3f}; call wall p50 {out['p50']:.2f} ms, p95 "
          f"{out['p95']:.2f} ms; ATE {out['ate']:.4f} m on {path:.2f} m "
          f"({100 * out['ate'] / path:.3f}%); reduction "
          f"{out['reduction']:.4f}, compressed points {out['compressed']}; "
          f"keyframes {slam.keyframes_in_map()}; prefetch hits "
          f"{out['hits']}, stats fetches {out['fetches']}, kernel launches "
          f"{launches}; stages: {st}")
    return out


def phase_pipeline(corridor=None, p4=None, compare_depth2=False):
    """bench.py's pipeline on the card (phase 18): phase 4's 100 corridor
    frames and configuration at MSSLAM_PIPELINE_DEPTH=4 (fetch batch 2)
    with next_images on every frame (bench.py:35,92-106). Held: 100 of 100
    frames OK; ATE under 2% of the path (phase 4's bar); reduction > 0 and
    compressed points > 0 after shutdown(); exactly one patch-gather launch
    a frame (the prefetch neither runs a frontend twice nor drops one); at
    least 90 frames taken from the prefetch; at most 60 stats fetches (two
    frames a fetch). Printed beside phase 4's numbers (`p4`, depth 2 with a
    device sync a frame) when it ran in this script; with compare_depth2
    the same run at depth 2 follows, for a comparison in one call.

    Then the padded-stack extractor at full width on frame 0:
    orb.extract_stack_multi on both images (exactly one patch-gather launch,
    the kernel at the stack shape of phase 3) and stereo.match_stereo_stack,
    held to at least 80% of the frontend's (canvas path's) stereo matches
    on the same frame and a median |disparity - the render's| under 0.7 px
    in pixels of each keypoint's level (phase 11's bar)."""
    from ms_slam_tpu_torch.ops import orb, stereo
    from ms_slam_tpu_torch.pipeline import frontend
    card = _card()
    t_phase = time.perf_counter()
    poses, frames = corridor or _corridor_frames()
    run = _drive_pipelined(frames, poses, 4, card)
    if p4 is not None:
        st = "; ".join(f"{k} n={c} p50 {p:.3f} ms total {t:.3f} s"
                       for k, (c, p, t) in p4["stages"].items())
        print(f"# phase 4 beside it (depth 2, a device sync after each "
              f"frame): frames/s {p4['fps']:.3f}; frame wall p50 "
              f"{p4['p50']:.2f} ms, p95 {p4['p95']:.2f} ms; stages: {st}")
    n = len(frames)
    _check(run["slam"].state == "OK" and run["n_rec"] == n
           and run["ok"] == n, f"pipeline: {run['ok']} of {n} frames OK")
    _check(run["ate"] < 0.02 * run["path"], "pipeline: ATE above 2%")
    _check(run["reduction"] > 0 and run["compressed"] > 0,
           "pipeline: no reduction or no compressed point")
    _check(run["launches"] == n, f"pipeline: patch_gather launched "
           f"{run['launches']} times for {n} frames")
    _check(run["hits"] >= 90, f"pipeline: {run['hits']} prefetch hits")
    _check(run["fetches"] <= 60, f"pipeline: {run['fetches']} stats fetches")
    result = {"depth4": {k: v for k, v in run.items() if k != "slam"}}
    del run
    if compare_depth2:
        d2 = _drive_pipelined(frames, poses, 2, card)
        result["depth2"] = {k: v for k, v in d2.items() if k != "slam"}
        del d2

    # the padded-stack extractor and its matcher on frame 0
    cfg = _main_cfg()
    pair = torch.from_numpy(np.stack(frames[0])).cuda()
    fd = frontend.process_stereo_stacked(pair, cfg.calib, cfg.orb)
    torch.cuda.synchronize()
    _reset(PG)
    t0 = time.perf_counter()
    feats, stacks, _ = orb.extract_stack_multi(pair.float(), cfg.orb)
    fl, fr = (orb.Features(*[a[b] for a in feats]) for b in range(2))
    sm = stereo.match_stereo_stack(fl, fr, stacks[0], stacks[1],
                                   cfg.calib.bf, cfg.calib.min_z, cfg.orb)
    torch.cuda.synchronize()
    stack_ms = (time.perf_counter() - t0) * 1e3
    stack_launches = _calls(PG)
    n_stack = int(sm.valid.sum())
    n_canvas = int((fd.depth > 0).sum())
    gt_depth = _corridor_depth(poses[0])
    ok = sm.valid.cpu().numpy()
    xy = fl.xy.cpu().numpy()[ok]
    disp = (xy[:, 0] - sm.u_right.cpu().numpy()[ok])
    gt = gt_depth[np.clip(np.round(xy[:, 1]).astype(int), 0, H - 1),
                  np.clip(np.round(xy[:, 0]).astype(int), 0, W - 1)]
    level_px = cfg.orb.scale_factor ** fl.octave.cpu().numpy()[ok]
    err = np.abs(disp - cfg.calib.bf / gt) / level_px
    print(f"# stack extractor on frame 0 ({card}): {stack_ms:.2f} ms for "
          f"extract_stack_multi + match_stereo_stack (host clock between "
          f"two device syncs); kernel launches {stack_launches}; stereo "
          f"matches {n_stack} against the canvas frontend's {n_canvas} "
          f"({n_stack / max(n_canvas, 1):.4f}, bar 0.8); |disparity - the "
          f"render's| in pixels of the keypoint's level: median "
          f"{np.median(err):.4f} (bar 0.7), share under 1.5 "
          f"{(err < 1.5).mean():.4f}")
    _check(stack_launches == 1, f"stack extractor: {stack_launches} "
           "patch-gather launches")
    _check(n_stack >= 0.8 * n_canvas, "stack extractor: too few matches")
    _check(np.median(err) < 0.7, "stack extractor: disparity error")
    result.update(stack_launches=stack_launches, stack_matches=n_stack,
                  canvas_matches=n_canvas)
    print(f"# phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return result


def _corridor_depth(T_wc):
    """Depth (camera z) of every pixel of phase 4's corridor seen from T_wc,
    by the renderer's own ray-plane intersection (synth.CorridorWorld)."""
    import inspect

    from ms_slam_tpu_torch.utils import synth
    kw = dict(CORRIDOR[1])
    kw.setdefault("y_ceil", inspect.signature(
        synth.CorridorWorld).parameters["y_ceil"].default)
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    rays = np.stack([(us - W / 2) / FX, (vs - H / 2) / FX,
                     np.ones(us.shape)], -1)              # z = 1: t is depth
    d = rays @ T_wc[:3, :3].T
    depth = np.full((H, W), np.inf)
    for ax, val in ((0, kw["half_w"]), (0, -kw["half_w"]),
                    (1, kw["y_floor"]), (1, kw["y_ceil"])):
        da = d[..., ax]
        hit = np.abs(da) > 1e-9
        t = np.where(hit, (val - T_wc[ax, 3]) / np.where(hit, da, 1.0), -1)
        depth = np.where((t > 0.1) & (t < depth), t, depth)
    return depth


FLAG = "MSSLAM_FORCE_TPU_NUMERICS"


@contextlib.contextmanager
def _tpu_switch(on: bool):
    """MSSLAM_FORCE_TPU_NUMERICS set to "1" (on) or unset inside the block,
    as it was after it."""
    saved = os.environ.pop(FLAG, None)
    if on:
        os.environ[FLAG] = "1"
    try:
        yield
    finally:
        os.environ.pop(FLAG, None)
        if saved is not None:
            os.environ[FLAG] = saved


def _p50_ms(stage, key):
    return float(np.percentile(np.asarray(stage.get(key, [0.0])), 50)) * 1e3


def _drive_numerics(frames, poses, tpu, card):
    """Phase 4's configuration and driving (a device sync after each frame)
    over phase 4's frames, with MSSLAM_FORCE_TPU_NUMERICS=1 when `tpu`, else
    with the switch unset. Both launch counters are reset just before the
    run and read just after it."""
    from ms_slam_tpu_torch.pipeline import system as system_mod
    from ms_slam_tpu_torch.pipeline.system import System
    from ms_slam_tpu_torch.utils import evaluate
    frontend = system_mod.process_stereo_stacked
    stage = {}
    _timed(system_mod, "process_stereo_stacked", "frontend", stage)
    try:
        with _tpu_switch(tpu):
            slam = System(_main_cfg(), device="cuda")
            torch.cuda.synchronize()
            _reset(PG, PG_BF16)
            frame_s = []
            for i, (im_l, im_r) in enumerate(frames):
                t0 = time.perf_counter()
                slam.track_stereo(im_l, im_r, 0.1 * i)
                torch.cuda.synchronize()
                frame_s.append(time.perf_counter() - t0)
            slam._flush_pipeline()
            windows_before = slam._sparsifier.stats["windows"]
            slam.shutdown()
            torch.cuda.synchronize()
            launches = {"f32": _calls(PG),
                        "bf16": _calls(PG_BF16)}
    finally:
        system_mod.process_stereo_stacked = frontend
    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est = np.stack([Twc[:3, 3] for _, Twc in rows])
    gt = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    st, mem = slam._sparsifier.stats, slam.memory_stats()
    steady = np.asarray(frame_s[10:])
    out = {"ok": sum(not e.lost for e in slam.trajectory),
           "n_rec": len(slam.trajectory), "state": slam.state,
           "ate": evaluate.ate_rmse(est, gt), "est_finite":
           bool(np.isfinite(est).all()),
           "path": float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1))),
           "n_kf": slam.keyframes_in_map(), "n_mp": slam.map_points_in_map(),
           "kept": st["kept"], "killed": st["killed"],
           "reduction": mem["reduction"], "windows_before": windows_before,
           "frontend_ms": _p50_ms(stage, "frontend"),
           "fps": len(steady) / steady.sum(), "launches": launches}
    print(f"# {'TPU numerics (bf16 canvas)' if tpu else 'f32 canvas'} "
          f"({card}): {out['n_rec']} frames, {out['ok']} OK, state "
          f"{out['state']}; ATE {out['ate']:.4f} m on {out['path']:.2f} m "
          f"({100 * out['ate'] / out['path']:.3f}%); keyframes "
          f"{out['n_kf']}, live map points {out['n_mp']}; selector kept "
          f"{out['kept']}, killed {out['killed']}, windows before shutdown() "
          f"{windows_before}, reduction {out['reduction']:.4f}; frontend "
          f"stage p50 {out['frontend_ms']:.2f} ms; frames/s over frames "
          f"10-99 {out['fps']:.3f}; kernel launches f32 {launches['f32']}, "
          f"bf16 {launches['bf16']}")
    return out


def _frame0_card_vs_cpu(frames, cfg):
    """Frame 0 extracted on the card and on the CPU under the switch: the
    share of the card's keypoints (level-0 position and octave) the CPU
    also has, and of descriptors equal on those. Printed, not held."""
    from ms_slam_tpu_torch.ops import orb
    pair = torch.from_numpy(np.stack(frames[0])).float()
    with _tpu_switch(True):
        fc, cc = orb.extract_canvas_multi(pair.cuda(), cfg.orb)
        fh, ch = orb.extract_canvas_multi(pair, cfg.orb)
    _check(cc.dtype == ch.dtype == torch.bfloat16, "frame 0: canvas dtype")
    canvas_eq = float((cc.cpu() == ch).float().mean())
    n_card = n_common = n_desc = 0
    for b in range(pair.shape[0]):
        def keys(f):
            xy, oc = f.xy[b].cpu().numpy(), f.octave[b].cpu().numpy()
            va = f.valid[b].cpu().numpy()
            return {(float(x), float(y), int(o)): i for i, ((x, y), o, v)
                    in enumerate(zip(xy, oc, va)) if v}
        kc, kh = keys(fc), keys(fh)
        common = [k for k in kc if k in kh]
        n_card += len(kc)
        n_common += len(common)
        dc, dh = fc.desc[b].cpu().numpy(), fh.desc[b].numpy()
        n_desc += sum(bool((dc[kc[k]] == dh[kh[k]]).all()) for k in common)
    print(f"# frame 0 under the switch, card against CPU: canvas values "
          f"equal {canvas_eq:.6f}; keypoints of the card's {n_card} also "
          f"on the CPU {n_common / max(n_card, 1):.4f}; descriptors equal on "
          f"those {n_desc / max(n_common, 1):.4f}")
    return {"canvas_equal": canvas_eq, "keypoints_common":
            n_common / max(n_card, 1), "desc_equal": n_desc / max(n_common, 1)}


def phase_tpu_numerics(corridor=None, p4=None, compare_f32=False):
    """The reference's TPU numerics on the card (phase 19): phase 4's 100
    corridor frames and configuration (1248x384, 2048 features, 8 levels,
    sparsifier live) with MSSLAM_FORCE_TPU_NUMERICS=1, so every frame's
    canvas is bf16 and its patches come from the kernel's bf16 entry point.
    Held: 100 of 100 frames OK; ATE under 2% of the path (phase 4's bar);
    at least one selector window before shutdown(); reduction > 0; exactly
    100 bf16 launches and no f32 launch in the run. Printed, not held:
    ATE, keyframes, live map points, points kept and the frontend stage
    beside phase 4's f32 run on the same frames (`p4`, when it ran in this
    script; with compare_f32 the f32 run follows here), and on frame 0 the
    share of the card's keypoints and descriptors equal to the CPU port's
    under the switch."""
    card = _card()
    t_phase = time.perf_counter()
    poses, frames = corridor or _corridor_frames()
    run = _drive_numerics(frames, poses, True, card)
    n = len(frames)
    _check(run["state"] == "OK" and run["n_rec"] == n and run["ok"] == n,
           f"tpu numerics: {run['ok']} of {n} frames OK")
    _check(run["est_finite"] and run["ate"] < 0.02 * run["path"],
           "tpu numerics: ATE above 2%")
    _check(run["windows_before"] >= 1,
           "tpu numerics: no window solved before shutdown()")
    _check(run["reduction"] > 0, f"tpu numerics: reduction "
           f"{run['reduction']}")
    _check(run["launches"] == {"f32": 0, "bf16": n}, f"tpu numerics: "
           f"launches {run['launches']} for {n} frames")
    f32 = p4["numerics"] if p4 is not None else None
    if compare_f32:
        f32 = _drive_numerics(frames, poses, False, card)
    if f32 is not None:
        print(f"# beside it, the f32 canvas on the same frames "
              f"({'phase 4' if p4 is not None else 'this phase'}): ATE "
              f"{f32['ate']:.4f} m ({100 * f32['ate'] / f32['path']:.3f}%) "
              f"against {run['ate']:.4f} m "
              f"({100 * run['ate'] / run['path']:.3f}%); keyframes "
              f"{f32['n_kf']} against {run['n_kf']}; live map points "
              f"{f32['n_mp']} against {run['n_mp']}; points kept "
              f"{f32['kept']} against {run['kept']}; frontend stage p50 "
              f"{f32['frontend_ms']:.2f} ms against "
              f"{run['frontend_ms']:.2f} ms")
    frame0 = _frame0_card_vs_cpu(frames, _main_cfg())
    print(f"# phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return {"bf16": run, "f32": f32, "frame0": frame0}


def phase_inertial_loop_then_atlas(circuit):
    """Phases 16 and 15 in turn, in one process beside phases 8-13."""
    return phase_inertial_loop(circuit), phase_atlas(circuit)


def phase_sync_census(name: str, n_steady: int = 20, seed: int = 18):
    """A bench cell's syncs a frame, by file:line and innermost span."""
    import collections
    import threading
    import warnings
    from bench_port.harness import inputs, registry, window
    from ms_slam_tpu_torch.pipeline.system import System
    from ms_slam_tpu_torch.utils.trace import Timing, span
    cell = registry.cell(name)
    cfg, traffic = registry.config(cell["config"]), registry.traffic(
        cell["traffic"])
    cfg_sys, warm = inputs.system_config(cfg), traffic["warmup"]
    inp = inputs.make(cfg_sys, cfg, traffic, seed, 0, "cuda",
                      warm["max_frames"] + n_steady + 2)
    feed = window.Feed(System(cfg_sys, device="cuda"), inp)
    first = window.warm_up(feed, warm)
    tm = feed.slam.timing
    events0 = sum(len(v) for v in tm.values())
    by_line, by_span = collections.Counter(), collections.Counter()

    def show(message, category, filename, lineno, *a, **k):
        here = f"{os.path.relpath(filename)}:{lineno}"
        inner = tm.open[-1][0] if tm.open else "-"
        if threading.current_thread() is not threading.main_thread():
            inner = "prefetch worker"       # the next frame's frontend
        by_line[here, inner.startswith("sync.")] += 1
        by_span[inner] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(first, first + n_steady):
                feed.call(i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    feed.slam.shutdown()
    f = float(n_steady)
    spans = (sum(len(v) for v in tm.values()) - events0) / f
    t, n, t0 = Timing(), 200_000, time.perf_counter()
    for _ in range(n):
        with span(t, "x"):
            pass
    res = {"cell": name, "frames": f, "from_frame": first, "card": _card(),
           "syncs_per_frame": sum(by_span.values()) / f,
           "unmarked_per_frame": sum(v for (_, m), v in by_line.items()
                                     if not m) / f,
           "by_line": [[w, m, v / f] for (w, m), v in by_line.most_common()],
           "by_span": [[k, v / f] for k, v in by_span.most_common()],
           "spans_per_frame": spans,
           "span_cost_us": (time.perf_counter() - t0) / n * 1e6}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/sync_census.{name}.json", "w") as fh:
        json.dump(res, fh, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "by_line"}))
    print("\n".join(f"# {v:8.2f} a frame  {'marked  ' if m else 'unmarked'} "
                    f"{w}" for w, m, v in res["by_line"][:40]))
    return res


def phase_memory_then_pipeline(ab_on, corridor, p4):
    """Phases 17, 18 and 19 in turn, in one process beside phases 8-13."""
    return (phase_memory(ab_on, corridor), phase_pipeline(corridor, p4),
            phase_tpu_numerics(corridor, p4))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-only", action="store_true",
                    help="stop after phase 3 (no status line is printed)")
    ap.add_argument("--loop-only", action="store_true",
                    help="phases 1-3, 7 and 14 only (no status line is "
                    "printed)")
    ap.add_argument("--imu-only", action="store_true",
                    help="phases 1-3 and 8 only (no status line is printed)")
    ap.add_argument("--sensors-only", action="store_true",
                    help="phases 1-3 and 9-12 only (no status line is "
                    "printed)")
    ap.add_argument("--cli-only", action="store_true",
                    help="phases 1-3 and 13 only (no status line is printed)")
    ap.add_argument("--atlas-only", action="store_true",
                    help="phases 1-3 and 15 only (no status line is printed)")
    ap.add_argument("--imu-loop-only", action="store_true",
                    help="phases 1-3 and 16 only (no status line is "
                    "printed)")
    ap.add_argument("--memory-only", action="store_true",
                    help="phases 1-3 and 17 only (no status line is "
                    "printed)")
    ap.add_argument("--pipeline-only", action="store_true",
                    help="phases 1-3 and 18 only, and phase 18's run at "
                    "depth 2 beside it (no status line is printed)")
    ap.add_argument("--tpu-numerics-only", action="store_true",
                    help="phases 1-3 and 19 only, and phase 19's frames "
                    "with the f32 canvas beside it (no status line is "
                    "printed)")
    ap.add_argument("--sync-census", nargs="?", metavar="CELL",
                    const="kitti00-02-stereo.drive",
                    help="phases 1-2, then a benchmark cell's syncs a frame "
                    "(default the drive; no status line is printed)")
    ap.add_argument("--parent", metavar="DIR", default=None,
                    help="another checkout of this repository: phase 3 also "
                    "builds its patch_gather.cu and times its f32 and bf16 "
                    "entry points and this one's in turns (parent, this, "
                    "this, parent)")
    args = ap.parse_args()
    try:
        return _run(args)
    finally:
        _close_render_pool()


def _run(args):
    phase_device()
    phase_build()
    if args.sync_census:
        phase_sync_census(args.sync_census)
        return 0
    kern = phase_kernel(args.parent)
    pvb = phase_pvb_kernel()
    pvb["rig"] = phase_pvb_kernel_rig()
    po = phase_pose_opt_kernel()
    # pose_vel_bias launches, each phase's count set to 0 before its run
    by_phase, bf16_by_phase, pvb_by_phase = {}, {}, {}
    pose_opt_by_phase = {}
    only = [k for k in ("kernel_only", "loop_only", "imu_only",
                        "sensors_only", "cli_only", "atlas_only",
                        "imu_loop_only", "memory_only", "pipeline_only",
                        "tpu_numerics_only")
            if getattr(args, k)]
    part = bool(only)
    t_start = time.perf_counter()
    ab_on = p4 = None
    if not part:
        run = phase_main_path()
        by_phase["main_path"] = run["launches"]
        pose_opt_by_phase["main_path"] = run["pose_opt_launches"]
        by_phase["relocalization"] = phase_relocalize(run)
        phase_ties_and_selector(run["window"])
        ab_on, p4 = run["ab_on"], run["p4"]
        del run
    if not part or only == ["loop_only"]:
        by_phase["loop_closing"], slam = phase_loop_closing()
        by_phase["merge_dist_ba"] = phase_merge_and_dist_ba(slam)
        del slam
    # phases 16 and 15 in turn, and phases 17, 18 and 19 in turn, run in two
    # more processes beside phases 8-13: the port is host-bound (the card is
    # busy 12-17% of a frame), so three Systems share the card with little
    # loss and the script fits its time. Each process counts its own
    # launches; the phases there reuse phase 4's and phase 7's frames.
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with (ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
            "spawn")) if not part else contextlib.nullcontext()) as ex:
        if ex is not None:
            circuit15 = ex.submit(phase_inertial_loop_then_atlas,
                                  _circuit_frames())
            memory17 = ex.submit(phase_memory_then_pipeline, ab_on,
                                 _corridor_frames(), p4)
        if not part or only == ["imu_only"]:
            by_phase["inertial"], pvb_by_phase["inertial"] = \
                phase_inertial()
        if not part or only == ["sensors_only"]:
            by_phase["mono"] = phase_mono()
            by_phase["rgbd"] = phase_rgbd()
            by_phase["fisheye"] = phase_fisheye()
            by_phase["mono_inertial"], pvb_by_phase["mono_inertial"] = \
                phase_mono_inertial()
        if not part or only == ["cli_only"]:
            by_phase["cli"], pvb_by_phase["cli"] = phase_cli()
        if ex is not None:
            loop16, by_phase["atlas"] = circuit15.result()
            by_phase["inertial_loop"], pvb_by_phase["inertial_loop"] = loop16
            by_phase["memory"], pipe, tpu = memory17.result()
            by_phase["pipeline"] = pipe["depth4"]["launches"]
            by_phase["pipeline_stack"] = pipe["stack_launches"]
            by_phase["tpu_numerics"] = tpu["bf16"]["launches"]["f32"]
            bf16_by_phase["tpu_numerics"] = tpu["bf16"]["launches"]["bf16"]
    if only == ["atlas_only"]:
        by_phase["atlas"] = phase_atlas()
    elif only == ["imu_loop_only"]:
        by_phase["inertial_loop"], pvb_by_phase["inertial_loop"] = \
            phase_inertial_loop()
    elif only == ["memory_only"]:
        by_phase["memory"] = phase_memory()
    elif only == ["pipeline_only"]:
        pipe = phase_pipeline(compare_depth2=True)
        by_phase["pipeline"] = pipe["depth4"]["launches"]
        by_phase["pipeline_stack"] = pipe["stack_launches"]
    elif only == ["tpu_numerics_only"]:
        tpu = phase_tpu_numerics(compare_f32=True)
        by_phase["tpu_numerics"] = tpu["bf16"]["launches"]["f32"]
        bf16_by_phase["tpu_numerics"] = tpu["bf16"]["launches"]["bf16"]
    print(f"# phases 4-19 took {time.perf_counter() - t_start:.1f} s")
    bf16 = kern.pop("bf16")
    print(json.dumps({"kernels": [{
        "name": "patch_gather", "route": "cuda",
        "source": "ms_slam_tpu_torch/csrc/patch_gather.cu",
        "replaces": "ms_slam_tpu/ops/orb.py:665",
        "launches": sum(by_phase.values()) if by_phase else None,
        "launches_by_phase": by_phase, **kern}, {
        "name": "patch_gather_bf16", "route": "cuda",
        "source": "ms_slam_tpu_torch/csrc/patch_gather.cu",
        "replaces": "ms_slam_tpu/ops/orb.py:665",
        "launches": (sum(bf16_by_phase.values()) if bf16_by_phase
                     else None),
        "launches_by_phase": bf16_by_phase,
        "max_abs_err": max(x["max_abs_err"] for x in bf16),
        **{k: bf16[0][k] for k in ("ms", "ms_cold", "ms_one_group",
                                   "ms_wrapper_call", "plain_ms",
                                   "library_ms", "bound_ms", "bound_by")},
        **{k: bf16[0][k] for k in ("in_turns",) if k in bf16[0]},
        "share_of_bound": bf16[0]["bound_ms"] / bf16[0]["ms"],
        "share_of_bound_cold": bf16[0]["bound_ms"] / bf16[0]["ms_cold"],
        "other_shapes": bf16[1:]}, {
        "name": "pose_vel_bias", "route": "cuda",
        "source": "ms_slam_tpu_torch/csrc/pose_vel_bias.cu",
        "replaces": None,
        "launches": sum(pvb_by_phase.values()) if pvb_by_phase else None,
        "launches_by_phase": pvb_by_phase, **pvb}, {
        "name": "pose_opt", "route": "cuda",
        "source": "ms_slam_tpu_torch/csrc/pose_opt.cu",
        "replaces": None,
        "launches_this_process": _calls(POSE_OPT),
        "launches_by_phase": pose_opt_by_phase, **po}]}))
    if part:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
