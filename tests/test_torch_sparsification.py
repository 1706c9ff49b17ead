"""Parity of the port's sparsification slice with the JAX reference: the
selector (`ops/select.py`), the window tables and their application
(`pipeline/sparsification.py`), and the Sparsifier's host queue.

Inputs are made with numpy from a seed and passed as float32/int32 to both
sides (tests/conftest.py turns x64 on, which would otherwise run the
reference selector in float64).

Tolerances and why:
- select_points: identical `keep`, `lp_keep` and `kf_cover` on the 8 toy
  instances of tests/test_select.py AND on its reference-scale instance
  (38 rows x 2048 slots, 64x48 grid). The dual ascent's float32 sums are
  scatter-adds in index order on both sides, and the port multiplies by
  the reciprocal where XLA rewrites a division by a constant, so the
  arithmetic is the same to the bit;
- build_window_tables / sparsify_window on a map built by the reference
  System: the integer tables, `cost` and every mask exact;
- Sparsifier: the same queue, done set and batches step by step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.models import map_state as JM
from ms_slam_tpu.models.map_state import MapConfig as JMapConfig
from ms_slam_tpu.ops import select as jsel
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline import sparsification as jsp
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu.pipeline.system import System as JSystem
from ms_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.ops import select as tsel
from ms_slam_tpu_torch.pipeline import sparsification as tsp
from ms_slam_tpu_torch.utils import synth
from test_select import random_instance, reference_scale_instance

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BL = 240, 320, 260.0, 0.15


def _as32(inst):
    obs_pt, obs_cell, obs_valid, cost, p_valid, req = inst
    return (obs_pt.astype(np.int32), obs_cell.astype(np.int32), obs_valid,
            cost.astype(np.float32), p_valid, req.astype(np.int32))


def _both(inst, **kw):
    rj = jsel.select_points(*[jnp.asarray(a) for a in inst], **kw)
    rt = tsel.select_points(*[torch.from_numpy(np.ascontiguousarray(a))
                              for a in inst], **kw)
    return rj, rt


def _assert_same(rj, rt, fields=("keep", "lp_keep", "kf_cover")):
    for f in fields:
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)


@pytest.mark.parametrize("seed", range(8))
def test_select_toy_instances_exact(seed):
    inst = _as32(random_instance(np.random.default_rng(seed)))
    rj, rt = _both(inst, lam=100.0, lam_grid=5.0, n_cells=8)
    _assert_same(rj, rt)
    sj = float(jsel.selection_cost(
        rj.keep, jnp.asarray(inst[3]), rj.kf_cover, jnp.asarray(inst[5]),
        100.0, *[jnp.asarray(a) for a in inst[:3]], 5.0, 8))
    st = float(tsel.selection_cost(
        rt.keep, torch.from_numpy(inst[3]), rt.kf_cover,
        torch.from_numpy(inst[5]), 100.0,
        *[torch.from_numpy(a) for a in inst[:3]], 5.0, 8))
    assert st == pytest.approx(sj, rel=1e-6)


def test_select_reference_scale_exact():
    """38 rows x 2048 slots, 64x48 grid, N_req=100, lambda=500/10 (the
    KITTI parameterisation): the same selection, and the port meets every
    row requirement the reference meets."""
    o = reference_scale_instance(np.random.default_rng(0))
    inst = _as32(o[:6])
    rj, rt = _both(inst, lam=500.0, lam_grid=10.0, n_cells=o[6])
    _assert_same(rj, rt)
    keep = rt.keep.numpy()
    assert 0 < keep.sum() < 0.2 * inst[4].sum()
    want = np.minimum(inst[5], (inst[0] >= 0).sum(1))
    met_j = np.asarray(rj.kf_cover) >= want
    assert (rt.kf_cover.numpy() >= want)[met_j].all()


def test_select_stable_sort_ties():
    """Equal-cost LP-selected observations at P = 10^4: near 1e6 the
    float32 spacing is 0.0625, so `sel*1e6 - cost - tiebreak` ties exactly
    and only a stable sort reproduces the reference's rank table."""
    rng = np.random.default_rng(3)
    K, N, P = 6, 256, 10000
    obs_pt = np.stack([rng.choice(P, N, replace=False)
                       for _ in range(K)]).astype(np.int32)
    obs_pt[:, -16:] = -1
    obs_cell = rng.integers(0, 16, (K, N)).astype(np.int32)
    cost = np.full(P, 3.0, np.float32)
    cost[rng.choice(P, P // 4, replace=False)] = 7.0
    inst = (obs_pt, obs_cell, obs_pt >= 0, cost, np.ones(P, bool),
            np.full(K, 40, np.int32))
    sel = rng.random(P) < 0.5
    tb = np.float32(1.0 / (P + 2.0))
    ptc = np.clip(obs_pt, 0, P - 1)
    prio = np.where(obs_pt >= 0, sel[ptc].astype(np.float32) * np.float32(1e6)
                    - cost[ptc] - ptc.astype(np.float32) * tb,
                    -np.inf).astype(np.float32)
    # the 0..1 tiebreak keeps only 16 levels per cost: mostly exact ties
    sel_prio = prio[sel[ptc] & (obs_pt >= 0)]
    assert len(np.unique(sel_prio)) <= 2 * 17 < len(sel_prio) // 10
    order = np.asarray(jnp.argsort(-jnp.asarray(prio), axis=1))
    rank_j = np.empty_like(order)
    np.put_along_axis(rank_j, order, np.arange(N)[None].repeat(K, 0), 1)
    np.testing.assert_array_equal(
        tsel._rank_desc(torch.from_numpy(prio)).numpy(), rank_j)
    rj, rt = _both(inst, lam=500.0, lam_grid=10.0, n_cells=16)
    _assert_same(rj, rt)


@pytest.fixture(scope="module")
def ref_map():
    """A map from the reference System (BoxWorld orbit, 16 frames, no
    sparsification yet) and a window of its four oldest keyframes."""
    calib = JCalib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                   width=W, height=H, th_depth=BL * 45, fps=10.0)
    cfg = JSystemConfig(
        calib=calib, orb=JOrbConfig(n_features=512, n_levels=4),
        map=JMapConfig(max_kf=64, max_mp=8192, n_feat=512,
                       local_mp_cap=2048, window_kf=6, grid_w=16, grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=4)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    world = synth.BoxWorld(np.random.default_rng(0), half=7.0)
    slam = JSystem(cfg)
    for i, T in enumerate(synth.make_trajectory(80, "orbit")[:16]):
        slam.track_stereo(*world.render_stereo(K, T, BL, H, W), 0.1 * i)
    slam.shutdown()
    batch = slam.kf_order[:4]
    assert len(slam.kf_order) >= 6
    return {"ms": {k: np.asarray(v) for k, v in slam.ms._asdict().items()},
            "batch": batch}


WIN = dict(grid_w=16, grid_h=12, img_w=W, img_h=H, pt_cap=4096, n_outkf=8)


def _window(batch, n=4):
    idx = np.zeros(n, np.int32)
    mask = np.zeros(n, bool)
    idx[:len(batch)] = batch
    mask[:len(batch)] = True
    return idx, mask


def test_build_window_tables_exact(ref_map):
    idx, mask = _window(ref_map["batch"])
    tj = jsp.build_window_tables(
        JM.MapState(**{k: jnp.asarray(v) for k, v in ref_map["ms"].items()}),
        jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(60, jnp.int32),
        **WIN)
    tt = tsp.build_window_tables(
        TM.map_state_from_numpy(ref_map["ms"]), torch.from_numpy(idx),
        torch.from_numpy(mask), 60, **WIN)
    names = ("obs_pt", "obs_cell", "obs_ok", "cost", "pt_idx", "pt_valid",
             "req")
    for n, a, b in zip(names, tj, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=n)
    req = tt[6].numpy()
    assert (req[:4] == 60).all() and (req[4:] > 0).any()   # observer rows


def test_sparsify_window_exact(ref_map):
    idx, mask = _window(ref_map["batch"][:3])   # a padded window
    oj = jsp.sparsify_window(
        JM.MapState(**{k: jnp.asarray(v) for k, v in ref_map["ms"].items()}),
        jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(60, jnp.int32),
        jnp.asarray(500.0, jnp.float32), jnp.asarray(10.0, jnp.float32),
        **WIN)
    ms_t = TM.map_state_from_numpy(ref_map["ms"])
    ot = tsp.sparsify_window(ms_t, torch.from_numpy(idx),
                             torch.from_numpy(mask), 60, 500.0, 10.0, **WIN)
    assert ot.ms is ms_t                                   # in place
    for f in ("n_kept", "n_killed", "n_slots_freed"):
        assert int(getattr(ot, f)) == int(getattr(oj, f)), f
    assert int(oj.n_killed) > 0 and int(oj.n_slots_freed) > 0
    d = TM.map_state_to_numpy(ot.ms)
    for f in ("mp_valid", "mp_sparsified", "kf_sparsified", "kp_valid",
              "obs_mp", "mp_quarantine"):
        np.testing.assert_array_equal(d[f], np.asarray(getattr(oj.ms, f)),
                                      err_msg=f)


class _Host:
    """The System fields the Sparsifier reads, for both packages."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.n_kf = 0
        self.kf_free = []


class _Cfg:
    nonlocal_kf, sparsify_window, sparsify_queue_min = 2, 3, 2
    sparsify_n, sparsify_lambda, sparsify_grid_lambda = 50, 500.0, 10.0
    use_imu = False


SCRIPTS = {
    # (n_kf after the step, free slots, window) per local-mapping step
    "sliding": [(k + 1, [], list(range(max(0, k - 2), k + 1)))
                for k in range(12)],
    "culled": [(2, [], [0, 1]), (4, [], [2, 3]), (5, [1], [3, 4]),
               (6, [1], [4, 5]), (7, [], [5, 6]), (8, [], [6, 7]),
               (9, [2], [7, 8])],
    "revisit": [(3, [], [0, 1, 2]), (5, [], [3, 4]), (6, [], [0, 5]),
                (7, [], [6]), (8, [], [7]), (9, [], [8, 0]), (10, [], [9])],
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_sparsifier_queue_logic(script):
    """Scripted observe_window sequences: the same queue, done set and
    window batches as the reference after every step, through forget() and
    the finish() flush."""
    states = []
    for mod in (jsp, tsp):
        host = _Host(_Cfg())
        sp = mod.Sparsifier(host)
        batches = []

        def record(batch, sp=sp, batches=batches):
            batches.append(list(batch))
            sp.done.update(batch)

        sp._sparsify = record
        trace = []
        for n_kf, free, window in SCRIPTS[script]:
            host.n_kf, host.kf_free = n_kf, list(free)
            for c in free:
                sp.forget(c)
            sp.observe_window(window)
            trace.append((list(sp.queue), sorted(sp.done), dict(sp.miss),
                          [list(b) for b in batches]))
        sp.finish()
        trace.append((list(sp.queue), sorted(sp.done), dict(sp.miss),
                      [list(b) for b in batches]))
        states.append(trace)
    assert states[0] == states[1]
    assert states[1][-1][3], "no window was ever solved"
