"""What a traced run (`--trace 1`) adds: spans and host times around the
calls into each layer, and a `torch.profiler` slice of a few steady
frames, reduced to device busy time, kernel launches, the patch-gather
kernel's time and bytes, and a breakdown.

The spans are the benchmark's own: `torch.profiler.record_function`
ranges put up by wrappers around the port's module functions and the
System's stage methods, installed only in a traced run. Each wrapper also
keeps its calls' host durations for the whole window.
"""
from __future__ import annotations

import collections
import functools
import time

import torch

from ..scenes import roofline

SPAN = "bench."


class Spans:
    """Wrappers that time and name the calls into the port's layers."""

    def __init__(self):
        self.host_s: dict[str, list] = collections.defaultdict(list)
        self.recording = False          # host times kept while True
        self.gather_calls: list = []    # bytes of each patch gather, sliced
        self.slicing = False
        self._undo = []

    def wrap(self, owner, attr: str, name: str):
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            with torch.profiler.record_function(SPAN + name):
                out = fn(*a, **k)
            if self.recording:
                self.host_s[name].append(time.perf_counter() - t0)
            return out

        self._undo.append((owner, attr, fn, attr in vars(owner)))
        setattr(owner, attr, wrapper)

    def wrap_gather(self, orb):
        fn = orb.extract_patches_canvas

        @functools.wraps(fn)
        def wrapper(canvas, bi, ys, xs):
            if self.slicing:
                self.gather_calls.append(roofline.patch_gather_bytes(
                    tuple(canvas.shape), canvas.element_size(),
                    int(bi.shape[0])))
            return fn(canvas, bi, ys, xs)

        self._undo.append((orb, "extract_patches_canvas", fn, True))
        orb.extract_patches_canvas = wrapper

    def install(self, slam, feed):
        """Spans around each call of the feed and the layers of its
        System."""
        from ms_slam_tpu_torch.ops import orb
        from ms_slam_tpu_torch.pipeline import (loop_closing, sparsification,
                                                system, tracking_ops)
        self.wrap(feed, "call", "call")
        self.wrap(system, "process_stereo_stacked", "frontend")
        self.wrap(tracking_ops, "track_full", "track_full")
        self.wrap(tracking_ops, "track_full_imu", "track_full_imu")
        self.wrap(slam, "_fetch_stats", "stats_fetch")
        self.wrap(slam, "_create_keyframe", "keyframe")
        self.wrap(slam, "_inertial_window_ba", "inertial_window_ba")
        self.wrap(sparsification, "sparsify_window", "sparsify_window")
        self.wrap(loop_closing, "detect_and_verify", "loop_query")
        self.wrap_gather(orb)

    def remove(self):
        for owner, attr, fn, own in reversed(self._undo):
            if own:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)      # the class's method shows again
        self._undo.clear()


def profile_slice(spans: Spans, call, first: int, skip: int, frames: int,
                  on_card: bool) -> dict:
    """Make calls first .. first + skip + frames - 1 and profile the last
    `frames` of them; returns their summary (`reduce_slice`)."""
    for k in range(skip):
        call(first + k)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN + "slice"):
            spans.slicing = True
            for k in range(skip, skip + frames):
                call(first + k)
            if on_card:
                torch.cuda.synchronize()
            spans.slicing = False
    return reduce_slice(prof, spans.gather_calls, frames)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _gaps_by_span(busy, spans, w0: int, w1: int) -> dict:
    """Idle device time in [w0, w1] summed by the innermost benchmark span
    open on the host at the time ("harness" outside every span)."""
    cuts = sorted({w0, w1, *[x for s, e, _ in spans for x in (s, e)
                             if w0 < x < w1]})
    segs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        open_ = [(s, nm) for s, e, nm in spans if s <= a and e >= b]
        segs.append((a, b, max(open_)[1] if open_ else "harness"))
    idle = []
    t = w0
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < w1:
        idle.append((t, w1))
    out = collections.defaultdict(float)
    j = 0
    for g0, g1 in idle:
        while j < len(segs) and segs[j][1] <= g0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < g1:
            a, b, nm = segs[k]
            out[nm] += (min(b, g1) - max(a, g0)) * 1e-9
            k += 1
    return out


def reduce_slice(prof, gather_bytes: list, n_frames: int) -> dict:
    """Device busy time, kernels, the patch gather's time and bytes, the
    top device operations and the idle gaps by the host's span."""
    events = prof.profiler.kineto_results.events()
    spans = []                  # (start, end, name) of the benchmark's
    dev = []                    # (start, end) of every device activity
    kernel_s = collections.defaultdict(float)
    n_kernels = 0
    gather_s = 0.0
    n_gather = 0
    window = None
    for e in events:
        name = e.name()
        if name.startswith(SPAN) and e.device_type() != \
                torch.autograd.DeviceType.CPU:
            continue                    # a span's mirror on the GPU timeline
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            d = e.duration_ns()
            dev.append((s, s + d))
            if not name.startswith(("Memcpy", "Memset")):
                n_kernels += 1
            kernel_s[name] += d * 1e-9
            if "patch_gather" in name:
                gather_s += d * 1e-9
                n_gather += 1
        elif name.startswith(SPAN):
            s = e.start_ns()
            rng = (s, s + e.duration_ns(), name[len(SPAN):])
            if rng[2] == "slice":
                window = rng
            else:
                spans.append(rng)
    if window is None:
        return {}
    w0, w1 = window[0], window[1]
    busy = _merge([(max(s, w0), min(e, w1)) for s, e in dev
                   if e > w0 and s < w1])
    busy_ns = sum(e - s for s, e in busy)
    gaps = _gaps_by_span(busy, spans, w0, w1)
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    out = {"busy_s": busy_ns * 1e-9, "window_s": (w1 - w0) * 1e-9,
           "frames": n_frames, "kernels": n_kernels,
           "device_ops": [[k, v] for k, v in top],
           "idle_gaps": [[k, v] for k, v in sorted(
               gaps.items(), key=lambda kv: -kv[1])[:10]]}
    if n_gather and gather_bytes:
        per_call = sum(gather_bytes) / len(gather_bytes)
        out["gather"] = {"kernel_s": gather_s, "launches": n_gather,
                         "bytes": per_call * n_gather,
                         "bound_s": roofline.bound_seconds(per_call * n_gather)}
    return out
