"""Host spans and blocking points of the port.

`Timing` maps a span's name to the host seconds of each of its events;
`System.timing` is one, and the benchmark's metric readers read it.
`span(timing, name, frame)` times a block into it. While a `torch.profiler`
records, the span also opens the range `msslam.<name>@<frame>` on the host
timeline, so that spans share the device trace's clock; the frame id rides
in the range's name because a range's argument string does not reach the
trace. A range is opened only while a profiler records: `record_function`
costs ~13 us on the host even with none.

`sync(timing, site)` is the span `sync.<site>` around one call that blocks
the host on the device: the number of `sync.*` events counts the program's
marked blocking points, and their sum is the time the host waited there.

`count(timing, name, n)` records a count the program already has on the
host (no span, no sync) as one event of `timing[name]`.
"""
from __future__ import annotations

import time

import torch

PREFIX = "msslam."


def _range(label: str):
    """A function-scope profiler range. `record_function` opens a user
    annotation instead, which the profiler mirrors on the GPU timeline as a
    device event over the kernels inside it, and a reader that sums device
    events (the benchmark's slice) would count the mirror as busy time."""
    return torch._C._profiler._RecordFunctionFast(label)


class Timing(dict):
    """name -> list of host seconds, one entry per event. `open` holds the
    (name, frame) of each span open now, innermost last."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.open: list = []

    def add(self, name: str, seconds: float):
        self.setdefault(name, []).append(seconds)


class span:
    """Context manager: appends the block's host seconds to `timing[name]`
    (not when the block raises); does nothing when `timing` is None. A span
    given no frame id takes its parent's: the frame whose work it does."""

    __slots__ = ("timing", "name", "frame", "t0", "rf")

    def __init__(self, timing, name: str, frame=None):
        self.timing = timing
        self.name = name
        self.frame = frame
        self.rf = None

    def __enter__(self):
        tm = self.timing
        if tm is None:
            return self
        if self.frame is None and tm.open:
            self.frame = tm.open[-1][1]
        tm.open.append((self.name, self.frame))
        if torch.autograd._profiler_enabled():
            label = PREFIX + self.name
            if self.frame is not None:
                label += f"@{self.frame}"
            self.rf = _range(label)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        tm = self.timing
        if tm is None:
            return False
        dt = time.perf_counter() - self.t0
        tm.open.pop()
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
            self.rf = None
        if exc_type is None:
            tm.add(self.name, dt)
        return False


def sync(timing, site: str, frame=None) -> span:
    """The span `sync.<site>` around one call that blocks on the device."""
    return span(timing, "sync." + site, frame)


def count(timing, name: str, n) -> None:
    """Append the count n as one event of `timing[name]`; nothing without a
    Timing."""
    if timing is not None:
        timing.add(name, float(n))
