"""S3, a RECENTLY_LOST bridge without an IMU (tests/test_atlas.py::test_
recently_lost_bridges_short_blackout), through the port.

Both packages stay RECENTLY_LOST after the 8-frame blackout until the
orbit comes back over mapped ground and a relocalization succeeds (frame
58 of the reference's 60 in both): a visual RECENTLY_LOST frame only
tries relocalization, as in the reference's Tracking.cc, so the "bridge"
is the grace window that keeps the map (ROADMAP queue 3).

Tier-1: the port alone on test_torch_scenarios.s3_short_script (36
frames: 20 mapped, the 8-frame blackout, the orbit's last 8 frames) at
fps 10 and t_recently_lost 5. Held to the reference test's bars
(tests/test_atlas.py:186-196): RECENTLY_LOST seen, state OK at the end,
one map, active map 0.

slow: both packages on the reference test's own 60 frames, each held to
the same bars.
"""
import pytest
import test_torch_scenarios as S
import torch

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass


def _cfg(P):
    return S.atlas_cfg(P, fps=10.0, t_recently_lost=5.0, loop_covis_min=None)


def _bars(r):
    assert r["saw_recently_lost"], r["trace"]
    assert r["state"] == "OK", r["trace"]
    assert len(r["kf_counts"]) == 1 and r["active_map"] == 0, r


@pytest.fixture(scope="module")
def run():
    P = S.package("port")
    return S.run_atlas(P, S.s3_short_script(), _cfg(P))


def test_blackout_felt(run):
    assert run["saw_recently_lost"], run["trace"]
    # never LOST: the 0.8 s blackout is inside the 5 s grace
    assert "LO" not in run["trace"], run["trace"]


def test_bridged_on_the_same_map(run):
    assert run["state"] == "OK", run["trace"]
    assert run["maps_created"] == 1 and run["active_map"] == 0, run


def test_all_bars(run):
    _bars(run)


@pytest.mark.slow
def test_recently_lost_bridge_both_packages():
    for name in ("ref", "port"):
        P = S.package(name)
        r = S.run_atlas(P, S.s3_script(), _cfg(P))
        r.pop("slam")
        print(name, r)
        _bars(r)
