"""The Atlas and pool bookkeeping under S1, S2 and S4 (test_torch_scenarios),
bit for bit against the reference from one injected state.

- `alloc_map_slots` on a nearly full pool with freed and quarantined
  slots, an empty pool, a full one and an exact fit: the same slots and
  the same accepted mask;
- `System._free_keyframes` (with and without the IMU's interval merge) and
  the `_alloc_kf_slot` calls after it: the same free list, keyframe order,
  trajectory anchors (poses to 1e-12: the same float64 host arithmetic),
  reference keyframe, IMU segments, Atlas labels of reused slots and
  keyframe-database rows erased;
- `LoopCloser._confirm` from one injected hypothesis: a match in another
  map goes to `_merge_maps`, one in the same map to `_correct_loop`, with
  the same (cur, match, s, R_cm, t_cm) in both packages (1e-6).
No frame is tracked: the Systems are built and their state injected.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_scenarios as S
import torch
from scipy.spatial.transform import Rotation

from ms_slam_tpu.models import map_state as JM
from ms_slam_tpu_torch.models import map_state as TM

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

N_KF = 10


def _pool(case, rng, Mc=64, n_new=24):
    """(mp_valid, mp_quarantine, new_mask) for one allocation case."""
    valid = np.zeros(Mc, bool)
    quar = np.zeros(Mc, np.int32)
    if case == "recycled":          # nearly full: 6 freed, 4 in quarantine
        valid[:] = True
        freed = rng.choice(Mc, 10, replace=False)
        valid[freed] = False
        quar[freed[:4]] = rng.integers(1, 3, 4)
    elif case == "full":
        valid[:] = True
    elif case == "exact":           # as many free slots as new points
        valid[:] = True
        valid[rng.choice(Mc, 9, replace=False)] = False
        n_new = 9
    new = np.zeros(n_new, bool)
    new[rng.choice(n_new, min(n_new, 9 if case == "exact" else 15),
                   replace=False)] = True
    return valid, quar, new


@pytest.mark.parametrize("case", ["recycled", "empty", "full", "exact"])
def test_alloc_map_slots_bit_exact(case):
    rng = np.random.default_rng(3)
    valid, quar, new = _pool(case, rng)
    cfg = JM.MapConfig(max_kf=4, max_mp=len(valid), n_feat=8)
    d = {k: np.array(v) for k, v in JM.empty_map(cfg)._asdict().items()}
    d["mp_valid"], d["mp_quarantine"] = valid, quar
    jms = JM.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    tms = TM.map_state_from_numpy(d, device="cpu")
    js, jok = JM.alloc_map_slots(jms, jnp.asarray(new))
    ts, tok = TM.alloc_map_slots(tms, torch.from_numpy(new))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    # the k-th accepted point takes the k-th free slot; the rest get M
    free = np.flatnonzero(~valid & (quar <= 0))
    got = ts.numpy()
    n_ok = int(tok.sum())
    assert n_ok == min(int(new.sum()), len(free))
    np.testing.assert_array_equal(got[tok.numpy()], free[:n_ok])
    assert (got[~tok.numpy()] == len(valid)).all()


def _systems(use_imu=False):
    """Both packages' Systems at test_atlas.py's configuration, with one
    injected map of N_KF keyframes."""
    d = S.injected_state(S.atlas_cfg(S.package("port")).map, N_KF)
    out = []
    for name in ("ref", "port"):
        P = S.package(name)
        kw = dict(use_imu=True, imu_init_kfs=6, imu_init_time=0.5) \
            if use_imu else {}
        slam = P.System(S.atlas_cfg(P, **kw), **P.kw)
        S.set_state(P, slam, d)
        out.append((P, slam))
    return d, out


def _host_state(slam, rng, use_imu):
    """The same host cursors in either System: keyframe order (slot 7 made
    before slot 2), labels of two maps, trajectory entries anchored to
    several keyframes, keyframe-database candidates, IMU segments."""
    Entry = sys.modules[type(slam).__module__].TrajectoryEntry
    slam.n_kf = N_KF
    slam.kf_ord = N_KF
    slam.kf_order = [0, 1, 7, 2, 3, 4, 5, 6, 8]     # slot 9 already culled
    slam.kf_maps = [0] * 6 + [1] * 4
    slam.active_map = 1
    slam.kf_free = []
    for i in range(14):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.1, 3)).as_matrix()
        T[:3, 3] = rng.normal(size=3)
        slam.trajectory.append(Entry(
            frame_id=i, timestamp=0.1 * i, ref_kf=[0, 7, 2, 5, -1][i % 5],
            T_cr=T, lost=False))
    slam.ref_kf = 0
    slam._refresh_ref_pose()
    slam.kf_db.present[[0, 2, 5, 7]] = True
    if use_imu:
        slam._kf_imu_segments = [
            rng.normal(size=(3 * j + (j > 0), 7)).astype(np.float32)
            for j in range(len(slam.kf_order))]
        slam._kf_imu_segments[0] = np.zeros((0, 7), np.float32)
        slam._kf_times = [0.3 * j for j in range(len(slam.kf_order))]


@pytest.mark.parametrize("use_imu", [False, True])
def test_free_keyframes_and_slot_reuse_match_reference(use_imu):
    _, systems = _systems(use_imu)
    got = []
    for P, slam in systems:
        _host_state(slam, np.random.default_rng(5), use_imu)
        # 0 is the oldest (its entries move to its successor), 7 sits
        # mid-order, 9 is not in the order, 0 repeats
        slam._free_keyframes([0, 7, 9, 0])
        after_free = (list(slam.kf_free), list(slam.kf_order),
                      slam.ref_kf)
        slots = [slam._alloc_kf_slot() for _ in range(4)]
        got.append({
            "after_free": after_free, "slots": slots,
            "kf_maps": list(slam.kf_maps), "n_kf": slam.n_kf,
            "ref_pose": [np.asarray(a) for a in slam._ref_pose_np],
            "anchors": [(e.ref_kf, np.asarray(e.T_cr))
                        for e in slam.trajectory],
            "present": slam.kf_db.present.copy(),
            "segments": [np.asarray(a) for a in
                         getattr(slam, "_kf_imu_segments", [])],
            "kf_times": list(getattr(slam, "_kf_times", []))})
    ref, port = got
    assert port["after_free"] == ref["after_free"] == (
        [0, 7, 9], [1, 2, 3, 4, 5, 6, 8], 1)
    # recycled slots first, last freed first, then the high-water mark;
    # each reused slot takes the active map's label
    assert port["slots"] == ref["slots"] == [9, 7, 0, 10]
    assert port["kf_maps"] == ref["kf_maps"]
    assert [port["kf_maps"][s] for s in (9, 7, 0, 10)] == [1, 1, 1, 1]
    assert port["n_kf"] == ref["n_kf"] == N_KF + 1
    for a, b in zip(port["ref_pose"], ref["ref_pose"]):
        np.testing.assert_array_equal(a, b)
    assert [a for a, _ in port["anchors"]] == [a for a, _ in ref["anchors"]]
    for (_, a), (_, b) in zip(port["anchors"], ref["anchors"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(port["present"], ref["present"])
    assert not port["present"][[0, 7]].any() and port["present"][[2, 5]].all()
    assert len(port["segments"]) == len(ref["segments"])
    for a, b in zip(port["segments"], ref["segments"]):
        np.testing.assert_array_equal(a, b)
    assert port["kf_times"] == ref["kf_times"]


@pytest.mark.parametrize("cross", [True, False])
def test_confirm_routes_by_map(cross):
    """Without an IMU the gate is open: another map's match is merged,
    the same map's closes a loop."""
    (ref, port), R_cm, t_cm = S.confirm_calls(0.2, cross, inertial=False)
    (rc, _), (pc, _) = ref, port
    assert len(rc) == len(pc) == 1
    assert rc[0][0] == pc[0][0] == ("merge" if cross else "loop")
    assert rc[0][1:3] == pc[0][1:3] == (3, 1)
    for a, b, want in zip(pc[0][3:], rc[0][3:], (1.0, R_cm, t_cm)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), atol=1e-6)
        np.testing.assert_allclose(np.asarray(a, np.float64), want,
                                   atol=1e-6)


def test_new_map_after_a_merge_reuses_a_live_label():
    """Reference behaviour kept by the port (ROADMAP queue 3): a new Atlas
    map takes `active_map + 1`, not a fresh id, so after a merge back onto
    map 0 the next map is labelled 1 again while keyframes of an orphan
    map 1 (lost before it could merge) still carry that label."""
    out = []
    for P, slam in _systems()[1]:
        _host_state(slam, np.random.default_rng(5), False)
        slam.kf_maps = [0] * 6 + [1] * 2 + [0] * 2   # 6, 7: orphan map 1
        slam.active_map = 0                           # after a merge
        slam.state = "LOST"
        slam._lost_frames = int(2 * slam.calib.fps)
        slam._relocalize = lambda frame: None
        slam._track_lost(None, 9.9, frame_id=99)
        out.append((slam.active_map, slam.state,
                    [k for k, m in enumerate(slam.kf_maps)
                     if m == slam.active_map]))
    assert out[0] == out[1] == (1, "NOT_INIT", [6, 7])


def _fusion_chain():
    """One keyframe (slot 0, at the identity) whose feature 0 observes
    point A and feature 1 point B, while candidate C projects onto feature
    0 and candidate A onto feature 1, with C seen by 3 keyframes, A by 2
    and B by 1: the fusion's two conflicts chain (A loses to C, B loses to
    A). Returns (numpy state, calib and ORB configs for either package)."""
    from ms_slam_tpu.ops.orb import OrbConfig as JOrb
    from ms_slam_tpu.pipeline.frontend import Calib as JCalib
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    A, B, C = 0, 1, 2
    cfg = JM.MapConfig(max_kf=4, max_mp=16, n_feat=8)
    d = {k: np.array(v) for k, v in JM.empty_map(cfg)._asdict().items()}
    rng = np.random.default_rng(11)
    desc = rng.integers(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
    d["kf_valid"][:] = True
    d["kf_R"][:] = np.eye(3)
    d["kp_valid"][:, :2] = True
    d["kp_xy"][0, :2] = [[160.0, 120.0], [200.0, 120.0]]
    d["kp_desc"][0] = desc
    d["obs_mp"][0, :2] = [A, B]
    d["obs_mp"][1, :2] = [C, A]
    d["obs_mp"][2:, 0] = C
    pos = {A: [200 / 300.0 - 160 / 300.0, 0.0, 1.0], B: [-3.0, 1.0, 9.0],
           C: [0.0, 0.0, 1.0]}
    for p, x in pos.items():
        x = 5.0 * np.asarray(x) if p != B else np.asarray(x)
        d["mp_pos"][p] = x
        d["mp_normal"][p] = x / np.linalg.norm(x)
        d["mp_min_dist"][p] = 1.0
        d["mp_max_dist"][p] = np.linalg.norm(x)
        d["mp_valid"][p] = True
    d["mp_desc"][C] = desc[0]
    d["mp_desc"][A] = desc[1]
    d["mp_desc"][B] = desc[5]
    kw = dict(model=0, params=(300.0, 300.0, 160.0, 120.0), bf=0.0,
              width=320, height=240)
    return d, (JCalib(**kw), JOrb(n_features=8, n_levels=4)), (
        Calib(**kw), OrbConfig(n_features=8, n_levels=4))


def test_fusion_chain_leaves_an_observation_of_a_dead_point():
    """Reference behaviour kept by the port (ROADMAP queue 3): the fusion
    remaps every observation of a loser to its winner in one step, so in a
    chain (A loses to C, B loses to A) B's observer is moved onto A, which
    the same call killed. Both packages leave that observation of a dead
    slot, and agree bit for bit."""
    import jax.numpy as jnp

    from ms_slam_tpu.pipeline import mapping_ops as jmo
    from ms_slam_tpu_torch.pipeline import mapping_ops as tmo
    d, (jcal, jorb), (tcal, torb) = _fusion_chain()
    cand = np.array([2, 0, 0, 0], np.int32)
    cvalid = np.array([True, True, False, False])
    jms = jmo.fuse_into(JM.MapState(**{k: jnp.asarray(v)
                                       for k, v in d.items()}),
                        jcal, jorb, jnp.asarray(0), jnp.asarray(cand),
                        jnp.asarray(cvalid))
    tms = tmo.fuse_into(TM.map_state_from_numpy(d, device="cpu"), tcal,
                        torb, 0, torch.from_numpy(cand),
                        torch.from_numpy(cvalid))
    for f in ("obs_mp", "mp_valid", "mp_quarantine"):
        np.testing.assert_array_equal(getattr(tms, f).numpy(),
                                      np.asarray(getattr(jms, f)), err_msg=f)
    valid, obs = tms.mp_valid.numpy(), tms.obs_mp.numpy()
    assert list(valid[:3]) == [False, False, True]   # A and B lost
    assert list(obs[0, :2]) == [2, 0]                # feature 1 sees dead A
    assert list(obs[1, :2]) == [2, 2]                # A's other observer: C
