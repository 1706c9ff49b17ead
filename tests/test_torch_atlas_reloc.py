"""S2, a cross-map relocalization that switches the active map
(tests/test_atlas.py::test_cross_map_relocalization_switches_active_map),
through the port.

Tier-1: the port alone on test_torch_scenarios.s2_short_script (54 frames:
the reference's five phases with 16 mapped frames, 13 blind, 12 of map 1,
the 3-frame blackout and 10 back over map 0) at the reference test's
configuration. Held to its bars (tests/test_atlas.py:149-160): a second
map created, state OK, the active map back to 0 and the newest keyframe's
label equal to it.

slow: both packages on the reference test's own 87 frames, each held to
those bars, with the same final active map and newest label.
"""
import pytest
import test_torch_scenarios as S
import torch

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass


@pytest.fixture(scope="module")
def run():
    P = S.package("port")
    return S.run_atlas(P, S.s2_short_script(), S.atlas_cfg(P))


def test_second_map_created(run):
    assert run["maps_created"] >= 2, run["trace"]
    assert "1" in {t[-1] for t in run["trace"].split()}, run["trace"]


def test_back_on_map_zero(run):
    assert run["state"] == "OK", run["trace"]
    assert run["active_map"] == 0, run["trace"]


def test_newest_keyframe_label(run):
    assert run["newest_label"] == run["active_map"], run


def test_all_bars(run):
    S.atlas_bars(run, merge=False)


@pytest.mark.slow
def test_cross_map_relocalization_both_packages():
    got = {}
    for name in ("ref", "port"):
        P = S.package(name)
        got[name] = S.run_atlas(P, S.s2_script(), S.atlas_cfg(P))
        got[name].pop("slam")
        print(name, got[name])
        S.atlas_bars(got[name], merge=False)
    assert got["port"]["active_map"] == got["ref"]["active_map"] == 0
