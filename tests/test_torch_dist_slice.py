"""The sharded global BA through the LoopCloser: `_correct_loop` and
`_merge_maps` with `SystemConfig(dist_ba_devices=4)` on the CPU, in both
packages, from test_torch_loop_slice.py's drifted map (this file has its
own module-scoped fixtures, so that `--dist loadfile` gives it a worker).

The reference sees the 8 virtual CPU devices of tests/conftest.py, the port
a CPU System offers 8 CPU shards: both take `dist_global_ba` over 4 shards
(a spy on each package's function records the call). Tolerances: the
whole-slice ones of test_torch_loop_slice.py (`_compare_maps`: keyframe
rotations 5e-4, translations 5e-3; points 5e-3 for all but 0.5% of them,
which stay within 5e-2; point validity on at most 2 points, the
observation table on under 0.1% of its entries).
"""
import numpy as np
import pytest
import torch

from ms_slam_tpu.parallel import dist_ba as jdist
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.parallel import dist_ba
from ms_slam_tpu_torch.pipeline import loop_closing as tlc

from test_torch_loop_slice import (_both_systems, _centre_err,
                                   _compare_maps, _true_S_cm, loop_state)

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

__all__ = ["loop_state"]       # the fixture, imported for this module


def _spy(mp, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    mp.setattr(module, name, spy)


def _run(st, kind, n_dist):
    """Both Systems from the drifted map; a loop corrected or two maps
    merged with the true relative pose. Returns the Systems, the later
    keyframes' centre errors before, and each package's calls to its two
    global BAs."""
    from ms_slam_tpu.pipeline import mapping_ops as jmo

    if kind == "loop":
        cur, match = st["late"][-1], st["early"][-1]
        kf_maps = None
    else:
        cur, match = st["late"][0], st["early"][-1]
        kf_maps = [0] * st["n_kf"]
        for k in st["late"]:
            kf_maps[k] = 1
    R_cm, t_cm = _true_S_cm(st, cur, match)
    S_cm = (1.0, R_cm.astype(np.float32), t_cm.astype(np.float32))
    calls = {"ref_dist": [], "ref_global": [], "port_dist": [],
             "port_global": []}
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, jdist, "dist_global_ba", calls["ref_dist"])
        _spy(mp, jmo, "global_ba", calls["ref_global"])
        _spy(mp, dist_ba, "dist_global_ba", calls["port_dist"])
        _spy(mp, tlc.mo, "global_ba", calls["port_global"])
        ref, port = _both_systems(st, kf_maps, dist_ba_devices=n_dist)
        before = _centre_err(TM.map_state_to_numpy(port.ms), st, st["late"])
        for slam in (ref, port):
            lc = slam._loop_closer
            if kind == "loop":
                lc._correct_loop(cur, match, *S_cm)
            else:
                lc._merge_maps(cur, match, *S_cm)
    return {"ref": ref, "port": port, "calls": calls, "before": before,
            "pair": (cur, match)}


@pytest.fixture(scope="module")
def loop_run(loop_state):
    return _run(loop_state, "loop", 4)


@pytest.fixture(scope="module")
def merge_run(loop_state):
    return _run(loop_state, "merge", 4)


@pytest.mark.parametrize("which", ["loop_run", "merge_run"])
def test_both_packages_take_the_dist_branch(request, which):
    calls = request.getfixturevalue(which)["calls"]
    assert len(calls["ref_dist"]) == len(calls["port_dist"]) == 1
    assert calls["ref_global"] == calls["port_global"] == []
    (a, k), = calls["port_dist"]
    mesh = a[4]
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert k == {"n_iters": 8}
    (aj, kj), = calls["ref_dist"]
    assert aj[4].devices.size == 4 and kj == {"n_iters": 8}
    # anchored at the matched keyframe in both
    assert a[3] == int(aj[3]) == request.getfixturevalue(which)["pair"][1]


@pytest.mark.parametrize("which", ["loop_run", "merge_run"])
def test_maps_agree(request, which):
    r = request.getfixturevalue(which)
    _compare_maps(r["ref"], r["port"])


def test_correct_loop_removes_the_drift(loop_run, loop_state):
    """The drift moved the later keyframes 0.3 m from where the clean map
    had them; the correction leaves under 0.1 m, in both packages."""
    st = loop_state
    mt = TM.map_state_to_numpy(loop_run["port"].ms)
    mj = {k: np.asarray(v) for k, v in loop_run["ref"].ms._asdict().items()}
    assert loop_run["before"].min() > 0.25
    assert _centre_err(mt, st, st["late"]).max() < 0.1
    assert _centre_err(mj, st, st["late"]).max() < 0.1
    lc, lj = loop_run["port"]._loop_closer, loop_run["ref"]._loop_closer
    assert lc.loop_edges == lj.loop_edges == [loop_run["pair"]]
    assert lc.stats["loops"] == 1


def test_merge_maps_welds_the_maps(merge_run, loop_state):
    st = loop_state
    ref, port = merge_run["ref"], merge_run["port"]
    assert port.kf_maps == ref.kf_maps == [0] * st["n_kf"]
    assert port.active_map == ref.active_map == 0
    assert port._loop_closer.stats["merges"] == 1
    mt = TM.map_state_to_numpy(port.ms)
    assert _centre_err(mt, st, st["late"]).max() < 0.1


def test_mesh_built_once(loop_run):
    """The LoopCloser keeps its mesh: a second correction reuses it."""
    lc = loop_run["port"]._loop_closer
    mesh = lc._global_ba_mesh()
    assert mesh is lc._ba_mesh and len(mesh.devices) == 4
    assert lc._global_ba_mesh() is mesh


@pytest.mark.parametrize("n_dist", [0, 1, 16])
def test_local_global_ba_otherwise(loop_state, n_dist):
    """dist_ba_devices 0 or 1 asks for no mesh, and 16 is more than a CPU
    System offers (8): the port takes the alternating global_ba, as the
    reference does where jax.devices() is too short."""
    st = loop_state
    cur, match = st["late"][-1], st["early"][-1]
    R_cm, t_cm = _true_S_cm(st, cur, match)
    dist_calls, global_calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, dist_ba, "dist_global_ba", dist_calls)
        _spy(mp, tlc.mo, "global_ba", global_calls)
        _, port = _both_systems(st, dist_ba_devices=n_dist)
        port._loop_closer._correct_loop(cur, match, 1.0,
                                        R_cm.astype(np.float32),
                                        t_cm.astype(np.float32))
    assert dist_calls == [] and len(global_calls) == 1
    assert global_calls[0][1] == {"n_sweeps": 2}
    assert port._loop_closer._ba_mesh is None
