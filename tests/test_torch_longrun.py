"""S4, pool recycling (tests/test_longrun.py), through the port.

Tier-1: the port alone over the first 80 frames of the reference test's
corridor (256x192, 256 features, its configuration and world) with pools
cut so that 80 frames overflow them: 560 point slots (the run creates
about 1.45 times as many) and 16 keyframe slots (about 24 keyframes). Held
to every bar of the reference test: > 90% of frames OK, created points
> 1.3 x the pool, the pool bounded, keyframe ordinals past the pool, the
newest keyframe with > 20 points, the selector killing > 30%.

slow: both packages over the reference test's own 400 frames and pools
(3072 points, 96 keyframes), each held to the same bars; the port's
created points within 25% of the reference's and its killed share within
0.15 of it.
"""
import pytest
import test_torch_scenarios as S
import torch

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

N_FRAMES, MAX_MP, MAX_KF = 80, 560, 16


@pytest.fixture(scope="module")
def run():
    P = S.package("port")
    _, frames = S.corridor_frames(0, N_FRAMES)
    slam, ok = S.run_corridor(
        P, S.longrun_cfg(P, max_mp=MAX_MP, max_kf=MAX_KF), frames)
    return S.longrun_outcomes(P, slam, ok, N_FRAMES, MAX_MP)


def test_tracking_survives(run):
    assert run["state"] == "OK"
    assert run["ok_frames"] > 0.9 * run["n_frames"], run


def test_point_slots_recycled(run):
    assert run["n_mp"] > 1.3 * run["max_mp"], run
    assert run["mp_in_map"] <= run["max_mp"], run


def test_keyframe_slots_recycled(run):
    assert run["kf_ord"] > run["n_kf"], run
    assert run["kf_order_len"] <= run["n_kf"] == MAX_KF, run


def test_newest_keyframe_spawned_points(run):
    assert run["newest_points"] > 20, run


def test_selector_compressed(run):
    assert run["killed"] > 0.3 * (run["killed"] + run["kept"]), run


def test_all_bars(run):
    S.longrun_bars(run)


@pytest.mark.slow
def test_long_run_both_packages():
    _, frames = S.corridor_frames(0, 400)
    got = {}
    for name in ("ref", "port"):
        P = S.package(name)
        slam, ok = S.run_corridor(P, S.longrun_cfg(P), frames)
        got[name] = S.longrun_outcomes(P, slam, ok, 400, 3072)
        print(name, got[name])
        S.longrun_bars(got[name])
    ref, port = got["ref"], got["port"]
    assert abs(port["n_mp"] - ref["n_mp"]) < 0.25 * ref["n_mp"], (port, ref)

    def share(r):
        return r["killed"] / (r["killed"] + r["kept"])
    assert abs(share(port) - share(ref)) < 0.15, (port, ref)
