"""The readers of the program's own spans (`System.timing` keys written by
`ms_slam_tpu_torch/utils/trace.py`) on hand-made records: each gives its
value, and None where its keys are absent, as in a run of a program that
has no such span. CPU only, no System is run.

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from bench_port.harness import registry  # noqa: E402

# four window frames; host seconds of each event
TIMING = {"pose_opt": [0.05, 0.03, 0.06, 0.02, 0.04, 0.03, 0.05, 0.02],
          "search": [0.004, 0.006, 0.005, 0.005, 0.004, 0.006, 0.005, 0.005],
          "track.local_select": [0.01, 0.02, 0.01, 0.02],
          "sync.track_wide": [0.001, 0.002, 0.001, 0.0],
          "sync.track_fallback": [0.0, 0.001, 0.0, 0.003],
          "sync.stats_fetch": [0.002, 0.002, 0.002, 0.002],
          "sync.loop_fetch": [0.01],
          "pvb_opt": [0.2, 0.1, 0.3, 0.2],
          "track": [0.4, 0.4, 0.4, 0.4]}

CASES = [("pose_opt.host_ms", 75.0),
         ("matching.search_host_ms", 10.0),
         ("track.local_select_ms", 15.0),
         ("track.sync_wait_ms", 2.0),
         ("system.syncs_per_frame", 13 / 4),
         ("pvb_opt.host_ms", 200.0)]

# a drive record: the visual step has no `pvb_opt`
DRIVE = {k: v for k, v in TIMING.items() if k != "pvb_opt"}


def _rec(timing: dict, frames: int = 4) -> dict:
    return {"frames": frames, "timing": timing, "spans": {}, "slice": {}}


@pytest.mark.parametrize("name,value", CASES, ids=[c[0] for c in CASES])
def test_reader_value(name, value):
    assert registry.metric_reader(name)(_rec(TIMING)) == pytest.approx(value)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_reader_none_without_its_keys(name):
    """A parent without the spans: only the older keys are there."""
    read = registry.metric_reader(name)
    assert read(_rec({"track": [0.4] * 4})) is None
    assert read(_rec(TIMING, frames=0)) is None


def test_pvb_opt_none_on_a_drive_record():
    assert registry.metric_reader("pvb_opt.host_ms")(_rec(DRIVE)) is None
    assert registry.metric_reader("pose_opt.host_ms")(
        _rec(DRIVE)) == pytest.approx(75.0)


def test_sync_wait_reads_either_key():
    rec = _rec({"sync.track_wide": [0.004, 0.004, 0.004, 0.004]})
    assert registry.metric_reader("track.sync_wait_ms")(
        rec) == pytest.approx(4.0)
