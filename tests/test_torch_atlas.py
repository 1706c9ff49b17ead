"""S1, a new Atlas map after an irrecoverable loss and then a merge found
by place recognition (tests/test_atlas.py::test_new_map_and_merge),
through the port.

Tier-1: the port alone on test_torch_scenarios.s1_short_script (58 frames:
12 mapped, 13 blind, map 1 from where the reference's blind stretch ends
and 5 frames into the second lap) at the reference test's 320x240, 512 features,
fps 4 and t_recently_lost 0.3. Held to the reference test's bars
(tests/test_atlas.py:87-103): a second map created in the blind stretch,
a merge reached through the loop closer's database queries, the weld BA
lowering the seam's reprojection RMSE on every merge, the active map
holding the most keyframes, state OK.

slow: both packages on the reference test's own 100 frames, each held to
those bars; the port to the reference's outcome: the same final active
map and merges within 1 of it.
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
    return S.run_atlas(P, S.s1_short_script(), S.atlas_cfg(P))


def test_second_map_created_in_the_blind_stretch(run):
    assert run["maps_created"] >= 2, run["trace"]
    # the blind frames are 12-24: by the first frames after them the active
    # map is no longer map 0 (the labels lag a frame behind the pipeline)
    labels = [t[-1] for t in run["trace"].split()]
    assert set(labels[:12]) == {"0"}, run["trace"]
    assert any(m != "0" for m in labels[12:28]), run["trace"]


def test_merge_found_by_place_recognition(run):
    assert run["queries"] > 0
    assert run["merges"] >= 1, (run["merges"], run["trace"])


def test_weld_lowers_seam_rmse(run):
    assert len(run["weld_log"]) == run["merges"] >= 1
    for before, after in run["weld_log"]:
        assert after <= before + 1e-6, (before, after)


def test_active_map_holds_most_keyframes(run):
    counts = run["kf_counts"]
    assert counts.get(run["active_map"], 0) >= max(counts.values()), counts


def test_state_ok_and_all_bars(run):
    assert run["state"] == "OK"
    S.atlas_bars(run, merge=True)


@pytest.mark.slow
def test_new_map_and_merge_both_packages():
    got = {}
    for name in ("ref", "port"):
        P = S.package(name)
        got[name] = S.run_atlas(P, S.s1_script(), S.atlas_cfg(P))
        got[name].pop("slam")
        print(name, got[name])
        S.atlas_bars(got[name], merge=True)
    ref, port = got["ref"], got["port"]
    assert port["active_map"] == ref["active_map"]
    assert abs(port["merges"] - ref["merges"]) <= 1, (port, ref)


@pytest.mark.slow
def test_phase15_s1_at_small_size_both_packages():
    """chip_smoke.py phase 15's S1 at 320x240 and 512 features in both
    packages: the merge through place recognition and the keyframe ATE
    after it, side by side (the reference cannot run the phase's full
    width here)."""
    script = S.circuit_s1_script()
    got = {}
    for name in ("ref", "port"):
        got[name] = S.run_circuit_s1(S.package(name), script)
        print(name, got[name])
    for r in got.values():
        assert r["state"] == "OK" and r["merges"] >= 1, r
        for before, after in r["weld_log"]:
            assert after <= before + 1e-6, r
    ref, port = got["ref"], got["port"]
    assert port["kf_ate"] < 2 * ref["kf_ate"] + 0.01 * port["kf_path"], (
        port, ref)
