"""The closed loop that drives the System, as the port's CLI drivers do:
the next pair goes in as soon as the call returns, with `next_images`
set to the pair after it where the entry point takes one
(`track_stereo`; `track_stereo_imu` has no such argument).

A frame's latency runs from the start of its call to the return of the
call after which its `TrajectoryEntry` exists (`len(slam.trajectory)` is
read after every call). Frames still in flight when the window closes are
completed by `poses_wc()`, which flushes the pipeline, and count as late.
"""
from __future__ import annotations

import time


class SequenceExhausted(RuntimeError):
    pass


class Feed:
    """Calls the System with frame i of the inputs."""

    def __init__(self, slam, inputs):
        self.slam = slam
        self.inp = inputs
        self.n = len(inputs.frames)
        self.gravity_log: list = []     # (frame, gravity) at each change

    def call(self, i: int):
        if i + 1 >= self.n:
            raise SequenceExhausted(
                f"frame {i} of {self.n}: the rendered sequence ran out")
        left, right = self.inp.frames[i]
        ts = i / self.inp.fps
        if self.inp.imu is not None and i > 0:
            self.slam.track_stereo_imu(left, right, ts, self.inp.imu[i - 1])
            g = self.slam.gravity
            if g is not None and (not self.gravity_log
                                  or g is not self.gravity_log[-1][1]):
                self.gravity_log.append((i, g))
        else:
            self.slam.track_stereo(left, right, ts,
                                   next_images=None if self.inp.imu
                                   is not None else self.inp.frames[i + 1])


def warm_up(feed: Feed, rule: dict) -> int:
    """Frames from 0 until the mix's warm-up rule holds; returns the count.
    Rules: `keyframe_steps` (that many keyframe steps after the stereo
    initialization), `sparsify_queue` (that many keyframes waiting in the
    sparsifier's queue), `imu_initialized`."""
    slam = feed.slam
    kind = rule["rule"]
    for i in range(int(rule["max_frames"])):
        feed.call(i)
        if kind == "keyframe_steps":
            done = len(slam.timing.get("keyframe_step", [])) >= rule["count"]
        elif kind == "sparsify_queue":
            done = len(slam._sparsifier.queue) >= rule["count"]
        elif kind == "imu_initialized":
            done = bool(slam.imu_initialized)
        else:
            raise ValueError(f"unknown warm-up rule {kind!r}")
        if done:
            return i + 1
    raise RuntimeError(f"warm-up rule {rule} not met in "
                       f"{rule['max_frames']} frames")


class Window:
    """One measured window: submission and completion times per frame."""

    def __init__(self, first: int):
        self.first = first
        self.submit: dict[int, float] = {}
        self.done: dict[int, float] = {}
        self.lost: set[int] = set()
        self.t0 = self.t_end = self.t_flushed = 0.0
        self.completions = 0     # every entry that appeared inside the window

    def _collect(self, slam, seen: int, t: float, inside: bool) -> int:
        traj = slam.trajectory
        if inside:
            self.completions += len(traj) - seen
        for e in traj[seen:]:
            if e.frame_id >= self.first:
                self.done[e.frame_id] = t
                if e.lost:
                    self.lost.add(e.frame_id)
        return len(traj)

    def run(self, feed: Feed, seconds: float, on_close=None,
            clock=time.perf_counter):
        """Submit frames from `first` until `seconds` have passed; then
        flush. `on_close()` is called after the last call, before the
        flush."""
        slam = feed.slam
        seen = len(slam.trajectory)
        i = self.first
        self.t0 = clock()
        while True:
            t = clock()
            if t - self.t0 >= seconds:
                break
            self.submit[i] = t
            feed.call(i)
            seen = self._collect(slam, seen, clock(), True)
            i += 1
        self.t_end = clock()
        if on_close is not None:
            on_close()
        slam.poses_wc()                  # flushes the frames in flight
        self.t_flushed = clock()
        self._collect(slam, seen, self.t_flushed, False)

    # -- what the window measured ---------------------------------------

    @property
    def attempted(self) -> int:
        return len(self.submit)

    def frames_per_s(self) -> float:
        """Completions up to the last call's return over the window's wall
        time (frames of the warm-up still in flight at the start count
        where they complete)."""
        return self.completions / (self.t_end - self.t0)

    def latencies_s(self) -> list:
        """Per submitted frame, completion minus submission (a frame never
        completed is left out and counted by `failed`)."""
        return [self.done[i] - t for i, t in self.submit.items()
                if i in self.done]

    def failed(self) -> int:
        never = sum(1 for i in self.submit if i not in self.done)
        return never + sum(1 for i in self.submit if i in self.lost)
