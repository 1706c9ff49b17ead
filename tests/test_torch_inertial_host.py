"""The host side of the port's inertial System against the reference's, on
scripted states (no frame is tracked here): the IMU row padding, the
frame-tagged IMU queue and its split at a keyframe, the merge of a culled
keyframe's segment, the culling policy, IMU prediction through a blackout,
the map rescale, the staged initialization's rules, and the entry points'
contracts. The fields involved are plain numpy/Python values in both
packages, so both Systems are given the same state and must end with the
same lists. Float results agree to 1e-6 (float64 host arithmetic in both).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.models import map_state as JM
from ms_slam_tpu.ops import inertial_opt as jio
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline import mapping_ops as jmo
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu.pipeline.system import InFlight as JInFlight
from ms_slam_tpu.pipeline.system import System as JSystem
from ms_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.ops import inertial_opt as tio
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline import mapping_ops as tmo
from ms_slam_tpu_torch.pipeline import system as tsys
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.system import InFlight, System, SystemConfig

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BL = 240, 320, 260.0, 0.15
TBC = np.eye(4)
TBC[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
TBC[:3, 3] = [0.05, -0.02, 0.03]


def _cfg(calib_t, orb_t, map_t, cfg_t, bf=FX * BL, **kw):
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=bf,
                    width=W, height=H, th_depth=BL * 40, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=64, n_levels=4),
                 map=map_t(max_kf=16, max_mp=256, n_feat=64,
                           local_mp_cap=128, window_kf=6),
                 use_imu=True, **kw)


def _pair(**kw):
    return (JSystem(_cfg(JCalib, JOrbConfig, JM.MapConfig, JSystemConfig,
                         **kw)),
            System(_cfg(Calib, OrbConfig, TM.MapConfig, SystemConfig, **kw),
                   device="cpu"))


def _rows(rng, n, dt=0.005):
    r = rng.normal(0, 1.0, (n, 7)).astype(np.float32)
    r[:, 0] = dt
    return r


def _same_lists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_use_imu_constructs_and_mono_entry_raises():
    """`use_imu=True` builds (it raised before the inertial slice), with the
    reference's defaults for the IMU keys; the mono-inertial entry point
    names the ROADMAP item it waits for."""
    ref, port = _pair(Tbc=TBC)
    for k in ("imu_init_kfs", "imu_init_time", "imu_protect_nd",
              "imu_noise_gyro", "imu_noise_acc", "imu_gyro_walk",
              "imu_acc_walk", "Tbc"):
        assert getattr(SystemConfig(), k) == getattr(JSystemConfig(), k), k
    np.testing.assert_allclose(port.Tcb, ref.Tcb)
    assert not port.imu_initialized and port._imu_stage == 0
    with pytest.raises(NotImplementedError, match="item 13"):
        port.track_monocular_imu(None, 0.0, np.zeros((1, 7)))


@pytest.mark.parametrize("n", [20, 64, 65, 200])
def test_pad_imu_rows(rng, n):
    rows = _rows(rng, n)
    rj, vj = JSystem._pad_imu_rows(rows)
    rt, vt = System._pad_imu_rows(rows)
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(vt, vj)
    assert rt.shape == (System.IMU_ROW_CAP, 7)
    # 65 rows merge pairwise into 32 + the odd one; 200 into 100, then 50
    assert vt.sum() == {20: 20, 64: 64, 65: 33, 200: 50}[n]
    # merging keeps the interval's length
    np.testing.assert_allclose(rt[vt, 0].sum(), rows[:, 0].sum(), rtol=1e-5)


class _Ko:
    """A keyframe step that does nothing, for host-only tests."""

    def __init__(self, ms, info):
        self.ms, self.info = ms, info
        self.n_obs = self.obs_mask = None


def test_imu_queue_split_at_keyframe(rng, monkeypatch):
    """Rows are tagged with the frame they precede; a keyframe created for
    frame 4 while frame 5 is in flight takes the rows up to frame 4 and
    leaves frame 5's queued."""
    ref, port = _pair()
    info = np.full(18 + 12, -1.0, np.float32)
    info[:18] = 0.0
    monkeypatch.setattr(jmo, "keyframe_step",
                        lambda ms, *a, **k: _Ko(ms, jnp.asarray(info)))
    monkeypatch.setattr(tmo, "keyframe_step",
                        lambda ms, *a, **k: _Ko(ms, torch.from_numpy(info)))
    queue = [(f, _rows(rng, 20)) for f in (3, 4, 5)]
    for slam in (ref, port):
        monkeypatch.setattr(slam, "_try_imu_init", lambda: None)
        slam.state = "OK"
        slam._alloc_kf_slot()
        slam.kf_order = [0]
        slam._kf_imu_segments = [np.zeros((0, 7), np.float32)]
        slam._kf_times = [0.0]
        slam._imu_accum = list(queue)
        slam.vel_w = np.array([0.1, 0.2, 0.3], np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)

    class _Out:
        R = t = matched_mp = None
    fl_j = JInFlight(frame_id=4, timestamp=0.4, frame=None, out=_Out,
                     imu_used=False)
    ref._create_keyframe(None, _Out, eye, zero, fl=fl_j)
    port._create_keyframe(InFlight(frame_id=4, timestamp=0.4, frame=None,
                                   out=_Out), eye, zero)
    for slam in (ref, port):
        assert [f for f, _ in slam._imu_accum] == [5]
        assert slam._kf_times == [0.0, 0.4]
        np.testing.assert_array_equal(slam.kf_velocities[1], slam.vel_w)
    _same_lists(port._kf_imu_segments, ref._kf_imu_segments)
    np.testing.assert_array_equal(
        port._kf_imu_segments[1], np.concatenate([queue[0][1], queue[1][1]]))
    # track_stereo_imu's own tagging: frame_id + 1
    port.frame_id = 9
    monkeypatch.setattr(port, "track_stereo", lambda *a, **k: None)
    port.track_stereo_imu(None, None, 1.0, queue[0][1])
    assert port._imu_accum[-1][0] == 10 and port._last_ts == 1.0


@pytest.mark.parametrize("which", [0, 2, 4])
def test_cull_merges_imu_segments(rng, which):
    """Culling keyframe i merges intervals (i-1, i) and (i, i+1); culling
    the first leaves the new first keyframe without a predecessor; culling
    the last drops its segment."""
    ref, port = _pair()
    segs = [np.zeros((0, 7), np.float32)] + [_rows(rng, 10 + j)
                                             for j in range(4)]
    order = [3, 1, 4, 0, 2]
    for slam in (ref, port):
        slam.kf_order = list(order)
        slam.n_kf = 5
        slam.ref_kf = 4 if which != 2 else 0
        slam._kf_imu_segments = [s.copy() for s in segs]
        slam._kf_times = [0.0, 0.3, 0.6, 0.9, 1.2]
        slam._free_keyframes([order[which]])
    assert port.kf_order == ref.kf_order and port.kf_free == ref.kf_free
    assert port._kf_times == ref._kf_times
    _same_lists(port._kf_imu_segments, ref._kf_imu_segments)
    assert len(port._kf_imu_segments) == 4
    if which == 2:
        np.testing.assert_array_equal(port._kf_imu_segments[2],
                                      np.concatenate([segs[2], segs[3]]))
    if which == 0:
        assert len(port._kf_imu_segments[0]) == 0


@pytest.mark.parametrize("initialized", [False, True])
def test_cull_policy(initialized):
    ref, port = _pair(imu_protect_nd=4)
    times = [0.0, 0.2, 0.4, 0.8, 2.5, 2.7, 2.9, 3.4, 3.9, 4.4]
    for slam in (ref, port):
        slam.kf_order = list(range(10))[::-1]
        slam._kf_times = list(times)
        slam.imu_initialized = initialized
    cj, rj = ref._cull_policy()
    ct, rt = port._cull_policy()
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert rt == rj == 0.5
    assert ct.numpy().sum() == (5 if initialized else 2)
    for slam in (ref, port):                  # too few keyframes: none
        slam.kf_order = slam.kf_order[:4]
    assert not port._cull_policy()[0].any()
    assert not np.asarray(ref._cull_policy()[0]).any()
    # the visual configuration
    vis = System(_cfg(Calib, OrbConfig, TM.MapConfig, SystemConfig),
                 device="cpu")
    vis.cfg.use_imu = False
    assert vis._cull_policy() == (None, 0.9)


def test_predict_imu_and_extrapolate(rng):
    """A blackout frame is carried forward by IMU propagation through the
    T_bc extrinsic; without rows the constant-velocity model is used."""
    ref, port = _pair(Tbc=TBC)
    rows = _rows(rng, 20)
    rows[:, 1:4] = rows[:, 1:4] * 0.2 + [0.0, -9.81, 0.0]
    rows[:, 4:] *= 0.1
    T = np.eye(4)
    T[:3, :3] = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
    T[:3, 3] = [0.3, -0.1, 2.0]
    for slam in (ref, port):
        slam.imu_initialized = True
        slam.gravity = np.array([0.1, 9.8, -0.2], np.float32)
        slam.imu_bias = np.array([0.01, -0.02, 0.005, 0.1, 0.05, -0.1],
                                 np.float32)
        slam.vel_w = np.array([0.5, 0.0, -0.3], np.float32)
        slam.last_R = T[:3, :3].astype(np.float32)
        slam.last_t = T[:3, 3].astype(np.float32)
        slam._imu_frame_rows = rows
    Tj, vj = ref._predict_imu(ref.current_pose())
    Tt, vt = port._predict_imu(port.current_pose())
    np.testing.assert_allclose(Tt, Tj, atol=1e-9)
    np.testing.assert_allclose(vt, vj, atol=1e-9)
    for slam in (ref, port):
        slam._extrapolate_pose()
        assert slam._Rt_dev is None and slam._v_dev is None
    np.testing.assert_allclose(port.last_R, ref.last_R, atol=1e-6)
    np.testing.assert_allclose(port.last_t, ref.last_t, atol=1e-6)
    np.testing.assert_allclose(port.vel_w, ref.vel_w, atol=1e-6)
    np.testing.assert_allclose(port.last_t, Tj[:3, 3], atol=1e-6)
    vel = np.eye(4)
    vel[:3, 3] = [0.0, 0.0, -0.1]
    for slam in (ref, port):                  # no rows: constant velocity
        slam._imu_frame_rows = None
        slam.vel = vel
        slam._extrapolate_pose()
    np.testing.assert_allclose(port.last_t, ref.last_t, atol=1e-6)
    for slam in (ref, port):
        slam.trajectory = []
        slam._last_ts = 1.0
    assert port._last_frame_dt() == ref._last_frame_dt() == 0.0


def test_apply_map_scale(rng):
    """The mono-inertial rescale (host arithmetic; no mono entry point
    reaches it yet): map, velocities and trajectory scale, rotations and
    gravity do not."""
    ref, port = _pair()
    d = {k: np.array(v)
         for k, v in JM.empty_map(ref.cfg.map)._asdict().items()}
    for k in ("mp_pos", "kf_t", "mp_min_dist", "mp_max_dist"):
        d[k] = rng.normal(0, 1, d[k].shape).astype(np.float32)
    d["kp_depth"] = rng.uniform(-1, 5, d["kp_depth"].shape).astype(np.float32)
    ref.ms = JM.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    port.ms = TM.map_state_from_numpy(d)
    vel = np.eye(4)
    vel[:3, 3] = [0.1, 0.0, -0.2]
    kf_vel = rng.normal(0, 1, (16, 3))
    for slam in (ref, port):
        slam.kf_velocities[:] = kf_vel
        slam.vel_w = np.array([0.5, 0.0, -0.3], np.float32)
        slam.last_t = np.array([1.0, 2.0, 3.0], np.float32)
        slam.vel = vel.copy()
        slam.gravity = np.array([0.0, 9.81, 0.0], np.float32)
        slam._record(0.0, lost=False, frame_id=0)
        slam.trajectory[0].T_cr[:3, 3] = [0.2, 0.1, 0.4]
        slam._apply_map_scale(1.7)
    mj = {k: np.asarray(v) for k, v in ref.ms._asdict().items()}
    mt = TM.map_state_to_numpy(port.ms)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], atol=1e-6, err_msg=k)
    np.testing.assert_allclose(mt["mp_pos"], d["mp_pos"] * 1.7, atol=1e-6)
    assert (mt["kp_depth"][d["kp_depth"] <= 0]
            == d["kp_depth"][d["kp_depth"] <= 0]).all()
    for k in ("kf_velocities", "vel_w", "last_t", "vel", "gravity"):
        np.testing.assert_allclose(getattr(port, k), getattr(ref, k),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(port.trajectory[0].T_cr,
                               ref.trajectory[0].T_cr, atol=1e-6)
    np.testing.assert_allclose(port._ref_pose_np[1], ref._ref_pose_np[1])


def test_try_imu_init_stage_rules(rng, monkeypatch):
    """The staged schedule with the solver replaced by a canned result in
    both packages: nothing before `imu_init_kfs + 1` intervals and
    `imu_init_time`; stage 1 at the first solve, a refresh a second later,
    stage 2 at 5 s, stage 3 at 15 s; a solve that returns NaN advances
    nothing; an empty trailing segment (a blackout interval) shortens the
    chain or stops the attempt."""
    ref, port = _pair(imu_init_kfs=4, imu_init_time=0.5)
    n = 7
    good = dict(R_wg=np.eye(3, dtype=np.float32),
                bg=np.full(3, 0.01, np.float32),
                ba=np.full(3, 0.02, np.float32), scale=np.float32(1.0),
                vels=np.tile(np.arange(3, dtype=np.float32), (n, 1)),
                cost=np.float32(0.0))
    canned = {"res": good}
    calls = {"ref": [], "port": []}

    def fake_j(R_wb, p_wb, sts, **kw):
        calls["ref"].append(R_wb.shape[0])
        return jio.InertialInitResult(**{k: jnp.asarray(v) for k, v in
                                         canned["res"].items()})

    def fake_t(R_wb, p_wb, sts, **kw):
        calls["port"].append(R_wb.shape[0])
        return tio.InertialInitResult(**{k: torch.as_tensor(v) for k, v in
                                         canned["res"].items()})
    monkeypatch.setattr(jio, "inertial_init", fake_j)
    monkeypatch.setattr(tsys.inertial_opt, "inertial_init", fake_t)
    segs = [np.zeros((0, 7), np.float32)] + [_rows(rng, 8)
                                             for _ in range(n - 1)]
    for slam in (ref, port):
        for _ in range(n):
            slam._alloc_kf_slot()
        slam.kf_order = list(range(n))
        slam._kf_imu_segments = [s.copy() for s in segs]

    def step(elapsed, **mods):
        out = []
        for slam in (ref, port):
            slam._kf_times = list(np.linspace(0.0, elapsed, n))
            for k, v in mods.items():
                setattr(slam, k, v(slam) if callable(v) else v)
            slam._try_imu_init()
            out.append((slam.imu_initialized, getattr(slam, "_imu_stage", 0),
                        round(getattr(slam, "_last_gravity_refit", -1e9), 6),
                        None if slam.gravity is None
                        else np.round(np.float64(slam.gravity), 4).tolist(),
                        np.round(np.float64(slam.imu_bias), 4).tolist(),
                        np.round(np.float64(slam.vel_w), 4).tolist()))
        assert out[0] == out[1], out
        return out[1]

    assert step(0.4)[:2] == (False, 0)                 # too little baseline
    for slam in (ref, port):                           # too few intervals
        slam.kf_order = list(range(5))
    assert step(1.0)[:2] == (False, 0)
    for slam in (ref, port):
        slam.kf_order = list(range(n))
    canned["res"] = dict(good, R_wg=np.full((3, 3), np.nan, np.float32))
    assert step(1.0)[:2] == (False, 0)                 # a failed solve
    canned["res"] = good
    got = step(1.0)
    assert got[:3] == (True, 1, 1.0) and got[3] == [0.0, 0.0, -9.81]
    assert got[4] == [0.01] * 3 + [0.02] * 3 and got[5] == [0.0, 1.0, 2.0]
    n_calls = len(calls["port"])
    assert step(1.5)[:3] == (True, 1, 1.0)             # nothing due yet
    assert len(calls["port"]) == n_calls
    assert step(2.1)[:3] == (True, 1, 2.1)             # the 1 s refresh
    assert step(5.2)[:3] == (True, 2, 5.2)
    assert step(15.5)[:3] == (True, 3, 15.5)
    assert step(40.0)[:3] == (True, 3, 15.5)           # schedule finished
    assert calls["port"] == calls["ref"]
    # a blackout interval in the middle: the chain starts after it
    empty = np.zeros((0, 7), np.float32)

    def cut(j):
        def f(slam):
            s = [x.copy() for x in segs]
            s[j] = empty
            return s
        return f
    for slam in (ref, port):
        slam._imu_stage, slam._last_gravity_refit = 1, 1.0
    canned["res"] = dict(good, vels=good["vels"][:4])
    assert step(3.0, _kf_imu_segments=cut(3))[:3] == (True, 1, 3.0)
    assert calls["port"][-1] == calls["ref"][-1] == 4
    # ... and at the newest interval there is no chain: no solve, no marker
    assert step(4.5, _kf_imu_segments=cut(n - 1))[:3] == (True, 1, 3.0)


def test_inertial_state_crosses_packages(rng):
    """The inertial host state moves from a reference System to a port
    System and back by one pair of functions, as copies."""
    ref, port = _pair()
    ref.imu_initialized, ref._imu_stage = True, 2
    ref.gravity = np.array([0.1, 9.8, 0.0], np.float32)
    ref.imu_bias = rng.normal(0, 0.01, 6).astype(np.float32)
    ref.vel_w = rng.normal(0, 1, 3).astype(np.float32)
    ref.kf_velocities[:] = rng.normal(0, 1, (16, 3))
    ref._kf_imu_segments = [np.zeros((0, 7), np.float32), _rows(rng, 5)]
    ref._kf_times = [0.0, 0.3]
    ref._imu_accum = [(7, _rows(rng, 3))]
    d = tsys.inertial_state_to_numpy(ref)
    port._v_dev = torch.zeros(3)
    tsys.inertial_state_from_numpy(port, d)
    assert port._v_dev is None and port._imu_stage == 2
    back = tsys.inertial_state_to_numpy(port)
    assert set(back) == set(tsys.INERTIAL_STATE_FIELDS)
    for k in ("gravity", "imu_bias", "vel_w", "kf_velocities"):
        np.testing.assert_array_equal(back[k], getattr(ref, k))
        assert getattr(port, k) is not getattr(ref, k)
    _same_lists(back["_kf_imu_segments"], ref._kf_imu_segments)
    assert back["_kf_times"] == [0.0, 0.3] and back["_imu_accum"][0][0] == 7
    ref2 = _pair()[0]
    tsys.inertial_state_from_numpy(ref2, back)
    assert ref2.imu_initialized and ref2._imu_stage == 2
    np.testing.assert_array_equal(ref2.imu_bias, ref.imu_bias)
