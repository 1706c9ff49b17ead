"""Whole-System scenarios of the reference's slow tests, as runners that
run either package, and checks of the scripts themselves.

The six scenarios (reference tests in brackets):
  S1 a new Atlas map after an irrecoverable loss, then a merge found by
     place recognition (tests/test_atlas.py::test_new_map_and_merge);
  S2 a cross-map relocalization that switches the active map (::test_cross_
     map_relocalization_switches_active_map);
  S3 a RECENTLY_LOST bridge without an IMU (::test_recently_lost_bridges_
     short_blackout);
  S4 pool recycling over a run that creates more points than the pool
     holds (tests/test_longrun.py);
  S5 the memory A/B, sparsification on against off (tests/test_memory_
     ab.py);
  S6 an inertial loop closure through the yaw gate and the 4-DoF essential
     graph (tests/test_inertial_system.py::test_inertial_loop_closure_
     preserves_gravity).

Each `run_*` takes a package namespace from `package("ref" | "port")` and
returns the scenario's outcomes as plain numbers, so that a test holds the
two packages to each other on outcomes (their RANSAC streams cannot
match). The `*_script` functions give the reference tests' own scripts and
the shortened ones the Tier-1 files run on the port alone. The test files
that use them (test_torch_atlas*.py, test_torch_longrun.py,
test_torch_memory_ab.py, test_torch_inertial_loop.py) each hold one
whole-System fixture.
"""
from __future__ import annotations

import os
import tempfile
from types import SimpleNamespace

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from ms_slam_tpu_torch.utils import evaluate, synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

ATLAS_GEOM = (240, 320, 260.0, 0.15)       # H, W, fx, baseline: test_atlas
CORRIDOR_GEOM = (192, 256, 210.0, 0.15)    # test_longrun, test_memory_ab


def package(name: str) -> SimpleNamespace:
    """The classes and modules a scenario needs, from the reference
    ("ref") or the port ("port"); `kw` is what System() takes beside the
    configuration."""
    if name == "ref":
        import jax.numpy as jnp

        from ms_slam_tpu.models import map_state as M
        from ms_slam_tpu.models.map_state import MapConfig
        from ms_slam_tpu.ops.orb import OrbConfig
        from ms_slam_tpu.pipeline.frontend import Calib
        from ms_slam_tpu.pipeline.system import System, SystemConfig
        from ms_slam_tpu.utils.checkpoint import save_map

        def to_numpy(ms):
            return {k: np.asarray(v) for k, v in ms._asdict().items()}
        return SimpleNamespace(
            name=name, System=System, SystemConfig=SystemConfig, Calib=Calib,
            OrbConfig=OrbConfig, MapConfig=MapConfig, M=M, kw={},
            to_numpy=to_numpy, save_map=save_map,
            covis=lambda ms, q: np.asarray(
                M.covisibility_counts(ms, jnp.asarray(q))))
    from ms_slam_tpu_torch.models import map_state as M
    from ms_slam_tpu_torch.models.map_state import MapConfig
    from ms_slam_tpu_torch.ops.orb import OrbConfig
    from ms_slam_tpu_torch.pipeline.frontend import Calib
    from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
    from ms_slam_tpu_torch.utils.checkpoint import save_map
    return SimpleNamespace(
        name=name, System=System, SystemConfig=SystemConfig, Calib=Calib,
        OrbConfig=OrbConfig, MapConfig=MapConfig, M=M, kw={"device": "cpu"},
        to_numpy=M.map_state_to_numpy, save_map=save_map,
        covis=lambda ms, q: M.covisibility_counts(ms, q).cpu().numpy())


def _K(geom):
    H, W, FX, _ = geom
    return np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


def _calib(P, geom, fps, depth_mult):
    H, W, FX, BL = geom
    return P.Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                   width=W, height=H, th_depth=BL * depth_mult, fps=fps)


# ---------------------------------------------------------------------------
# S1-S3: the Atlas (tests/test_atlas.py)
# ---------------------------------------------------------------------------

def atlas_cfg(P, fps=4.0, t_recently_lost=0.3, loop_covis_min=30, **kw):
    """tests/test_atlas.py's configuration (S1 and S2; S3 passes fps=10,
    t_recently_lost=5 and the default loop_covis_min)."""
    extra = {} if loop_covis_min is None else {
        "loop_covis_min": loop_covis_min}
    return P.SystemConfig(
        calib=_calib(P, ATLAS_GEOM, fps, 45),
        orb=P.OrbConfig(n_features=512, n_levels=4),
        map=P.MapConfig(max_kf=96, max_mp=12288, n_feat=512,
                        local_mp_cap=2048, window_kf=6, grid_w=16,
                        grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=3,
        sparsify=True, sparsify_n=40, sparsify_window=4,
        sparsify_queue_min=2, nonlocal_kf=3, loop_closing=True,
        t_recently_lost=t_recently_lost, **extra, **kw)


def s1_script():
    """test_new_map_and_merge: 30 mapped frames of an 80-frame orbit, 22
    blind frames while the camera moves on, then the rest of the lap and
    20 frames into the second: (pose, visible) per frame."""
    lap = synth.make_trajectory(80, "orbit")
    poses = lap + lap[:20]
    return [(T, not 30 <= i < 52) for i, T in enumerate(poses)]


def s1_short_script():
    """S1 shortened: map 0 over 12 frames, 13 blind frames (four to pass
    t_recently_lost, then the nine LOST ones that start map 1 at 4 Hz), map
    1 from where the reference's blind stretch ends (frame 52 of the lap)
    to the lap's end, and 5 frames into the second lap over map 0's
    keyframes (the port merges at the second of them)."""
    lap = synth.make_trajectory(80, "orbit")
    return ([(T, True) for T in lap[:12]] + [(lap[12], False)] * 13
            + [(T, True) for T in lap[52:80] + lap[:5]])


def s2_script():
    """test_cross_map_relocalization_switches_active_map's five phases."""
    lap = synth.make_trajectory(80, "orbit")
    return ([(T, True) for T in lap[:30]] + [(lap[40], False)] * 22
            + [(T, True) for T in lap[52:72]] + [(lap[10], False)] * 3
            + [(T, True) for T in lap[10:22]])


def s2_short_script():
    """S2 shortened: the same five phases with 16 mapped frames, 13 blind
    ones, 12 frames of map 1, the 3-frame blackout and 10 frames back over
    map 0's territory."""
    lap = synth.make_trajectory(80, "orbit")
    return ([(T, True) for T in lap[:16]] + [(lap[40], False)] * 13
            + [(T, True) for T in lap[52:64]] + [(lap[6], False)] * 3
            + [(T, True) for T in lap[6:16]])


def s3_script():
    """test_recently_lost_bridges_short_blackout: a 60-frame orbit with an
    8-frame (0.8 s) blackout at frame 30, under the 5 s grace. Neither
    package tracks again right after the blackout (a visual RECENTLY_LOST
    frame only tries relocalization, as in the reference's Tracking.cc):
    both relocalize when the orbit comes back over its start, at frame
    58."""
    poses = synth.make_trajectory(60, "orbit")
    return [(T, not 30 <= i < 38) for i, T in enumerate(poses)]


def s3_short_script():
    """S3 shortened: 20 mapped frames, the 8-frame blackout, and the last 8
    frames of the orbit, which come back over its start (the camera moves
    on during the blackout, as in the reference's script, only further)."""
    poses = synth.make_trajectory(60, "orbit")
    return ([(T, True) for T in poses[:20]] + [(poses[20], False)] * 8
            + [(T, True) for T in poses[52:60]])


def _seam_rmse(P, slam, cur):
    """test_atlas.py's seam reprojection RMSE around keyframe `cur`: the
    keyframe and its 7 most covisible ones, every valid observation in
    front of the camera."""
    d = P.to_numpy(slam.ms)
    covis = P.covis(slam.ms, cur)
    win = [cur] + [int(i) for i in np.argsort(-covis) if covis[i] > 0][:7]
    obs = d["obs_mp"][win]
    valid = (obs >= 0) & d["kp_valid"][win]
    X = d["mp_pos"][np.clip(obs, 0, None)].astype(np.float64)
    Xc = (np.einsum("kij,knj->kni", d["kf_R"][win].astype(np.float64), X)
          + d["kf_t"][win][:, None].astype(np.float64))
    fx, fy, cx, cy = slam.calib.params[:4]
    z = np.where(np.abs(Xc[..., 2]) > 1e-9, Xc[..., 2], 1e-9)
    uv = np.stack([fx * Xc[..., 0] / z + cx, fy * Xc[..., 1] / z + cy], -1)
    e = np.linalg.norm(uv - d["kp_xy"][win], axis=-1)
    ok = valid & (Xc[..., 2] > 0.05)
    return float(np.sqrt(np.sum(np.where(ok, e * e, 0.0))
                         / max(ok.sum(), 1)))


def kf_ate(P, slam, gt_poses):
    """Keyframe-centre ATE (Horn-aligned) of the keyframes in the active
    map against the poses their frames were rendered at, and the length of
    the path those frames cover."""
    d = P.to_numpy(slam.ms)
    slots = [k for k in slam.kf_order if d["kf_valid"][k]
             and slam.kf_maps[k] == slam.active_map]
    fids = [int(d["kf_frame_id"][k]) for k in slots]
    R = d["kf_R"][slots].astype(np.float64)
    t = d["kf_t"][slots].astype(np.float64)
    est = -np.einsum("kji,kj->ki", R, t)
    gt = np.stack([gt_poses[f][:3, 3] for f in fids])
    order = np.argsort(fids)
    path = float(np.sum(np.linalg.norm(np.diff(gt[order], axis=0), axis=1)))
    return evaluate.ate_rmse(est, gt), path, len(slots)


def run_atlas(P, script, cfg, spy_weld=True):
    """Drive a System over (pose, visible) frames; the outcomes of S1-S3."""
    slam = P.System(cfg, **P.kw)
    H, W, _, BL = ATLAS_GEOM
    K = _K(ATLAS_GEOM)
    world = synth.BoxWorld(np.random.default_rng(0), half=7.0)
    black = np.zeros((H, W), np.float32)
    lc = slam._loop_closer
    weld_log = []
    if spy_weld and lc is not None:
        weld = lc._weld_ba

        def weld_spy(cur, match):
            before = _seam_rmse(P, slam, cur)
            weld(cur, match)
            weld_log.append((before, _seam_rmse(P, slam, cur)))
        lc._weld_ba = weld_spy
    saw_recently_lost = False
    max_map = 0
    ok_frames = 0
    trace = []
    for i, (T_wc, visible) in enumerate(script):
        if visible:
            im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        else:
            im_l = im_r = black
        slam.track_stereo(im_l, im_r, 0.1 * i)
        saw_recently_lost |= slam.state == "RECENTLY_LOST"
        max_map = max(max_map, slam.active_map)
        ok_frames += slam.state == "OK"
        trace.append(f"{slam.state[:2]}{slam.active_map}")
    slam._flush_pipeline()
    counts = {m: slam.kf_maps.count(m) for m in set(slam.kf_maps)}
    ate, path, n_kf = kf_ate(P, slam, [T for T, _ in script])
    stats = dict(lc.stats) if lc is not None else {}
    newest = slam.kf_order[-1]
    return {"state": slam.state, "active_map": slam.active_map,
            "maps_created": max(max(slam.kf_maps), max_map) + 1,
            "merges": stats.get("merges", 0), "loops": stats.get("loops", 0),
            "queries": stats.get("queries", 0), "weld_log": weld_log,
            "kf_counts": counts, "newest_label": slam.kf_maps[newest],
            "saw_recently_lost": saw_recently_lost, "ok_frames": ok_frames,
            "n_frames": len(script), "kf_ate": ate, "kf_path": path,
            "kf_in_active_map": n_kf, "trace": " ".join(trace),
            "slam": slam}


def atlas_bars(r, merge=True):
    """test_new_map_and_merge's bars (tests/test_atlas.py:87-103) on
    run_atlas's outcomes; with merge=False the bars of the cross-map
    relocalization (:149-160)."""
    assert r["maps_created"] >= 2, r["kf_counts"]
    assert r["state"] == "OK", r["state"]
    if merge:
        assert r["merges"] >= 1, r
        assert len(r["weld_log"]) >= 1
        for before, after in r["weld_log"]:
            assert after <= before + 1e-6, (before, after)
        counts = r["kf_counts"]
        assert counts.get(r["active_map"], 0) >= max(counts.values()), counts
    else:
        assert r["newest_label"] == r["active_map"] == 0, r


# ---------------------------------------------------------------------------
# S4 and S5: the corridor (tests/test_longrun.py, tests/test_memory_ab.py)
# ---------------------------------------------------------------------------

def longrun_cfg(P, max_mp=3072, max_kf=96, **kw):
    """tests/test_longrun.py's configuration (its pools: 96 keyframes,
    3072 points)."""
    return P.SystemConfig(
        calib=_calib(P, CORRIDOR_GEOM, 10.0, 40),
        orb=P.OrbConfig(n_features=256, n_levels=4),
        map=P.MapConfig(max_kf=max_kf, max_mp=max_mp, n_feat=256,
                        local_mp_cap=1024, window_kf=6, grid_w=16,
                        grid_h=12),
        min_init_depth_points=60, max_frames_between_kf=4,
        sparsify=True, sparsify_n=25, sparsify_lambda=500.0,
        sparsify_window=8, sparsify_queue_min=4, nonlocal_kf=4, **kw)


def memory_cfg(P, sparsify, **kw):
    """tests/test_memory_ab.py's configuration."""
    return P.SystemConfig(
        calib=_calib(P, CORRIDOR_GEOM, 10.0, 40),
        orb=P.OrbConfig(n_features=256, n_levels=4),
        map=P.MapConfig(max_kf=96, max_mp=16384, n_feat=256,
                        local_mp_cap=1024, window_kf=6, grid_w=16,
                        grid_h=12),
        min_init_depth_points=60, max_frames_between_kf=4,
        sparsify=sparsify, sparsify_n=20, sparsify_lambda=500.0,
        sparsify_window=8, sparsify_queue_min=4, nonlocal_kf=4, **kw)


def corridor_frames(seed, n):
    """The corridor both tests drive: forward motion, tex_scale 0.06; the
    world is made from `seed` (test_longrun's fixture 0, test_memory_ab's
    5)."""
    H, W, _, BL = CORRIDOR_GEOM
    world = synth.CorridorWorld(np.random.default_rng(seed), half_w=3.0,
                                y_floor=1.6, tex_scale=0.06)
    poses = synth.make_trajectory(n, "forward")
    K = _K(CORRIDOR_GEOM)
    return poses, [world.render_stereo(K, T, BL, H, W) for T in poses]


def run_corridor(P, cfg, frames):
    """Drive a System over rendered corridor frames and shut it down."""
    slam = P.System(cfg, **P.kw)
    ok = 0
    for i, (l, r) in enumerate(frames):
        slam.track_stereo(l, r, 0.1 * i)
        ok += slam.state == "OK"
    slam.shutdown()
    return slam, ok


def longrun_outcomes(P, slam, ok_frames, n_frames, max_mp):
    d = P.to_numpy(slam.ms)
    st = slam._sparsifier.stats
    return {"state": slam.state, "ok_frames": ok_frames,
            "n_frames": n_frames, "n_mp": int(slam.n_mp), "max_mp": max_mp,
            "mp_in_map": slam.map_points_in_map(), "kf_ord": int(slam.kf_ord),
            "n_kf": int(slam.n_kf), "kf_order_len": len(slam.kf_order),
            "newest_points": int((d["obs_mp"][slam.kf_order[-1]] >= 0).sum()),
            "killed": st["killed"], "kept": st["kept"]}


def longrun_bars(r):
    """tests/test_longrun.py's bars."""
    assert r["state"] == "OK"
    assert r["ok_frames"] > 0.9 * r["n_frames"], r
    assert r["n_mp"] > 1.3 * r["max_mp"], r
    assert r["mp_in_map"] <= r["max_mp"], r
    assert r["kf_ord"] > r["n_kf"], r
    assert r["kf_order_len"] <= r["n_kf"], r
    assert r["newest_points"] > 20, r
    assert r["killed"] > 0.3 * (r["killed"] + r["kept"]), r


def memory_ab(P, on, off):
    """tests/test_memory_ab.py's measures of one A/B pair of Systems."""
    st_on, st_off = on.memory_stats(), off.memory_stats()
    xyz_on = np.stack([T[:3, 3] for _, T in on.poses_wc()])
    xyz_off = np.stack([T[:3, 3] for _, T in off.poses_wc()])
    n = min(len(xyz_on), len(xyz_off))
    gap = float(np.linalg.norm(xyz_on[:n] - xyz_off[:n], axis=1).mean())
    path = float(np.sum(np.linalg.norm(np.diff(xyz_off[:n], axis=0),
                                       axis=1)))
    with tempfile.TemporaryDirectory() as d:
        sizes = []
        for tag, s in (("on", on), ("off", off)):
            p = os.path.join(d, f"{tag}.npz")
            P.save_map(p, s)
            sizes.append(os.path.getsize(p))
    return {"state_on": on.state, "state_off": off.state,
            "kept": st_on["mp_live"] / max(st_off["mp_live"], 1),
            "reduction": 1.0 - st_on["live_bytes"] / max(
                st_off["live_bytes"], 1),
            "gap": gap, "path": path, "ckpt_on": sizes[0],
            "ckpt_off": sizes[1], "ckpt_ratio": sizes[0] / sizes[1]}


# ---------------------------------------------------------------------------
# S6: the inertial loop (tests/test_inertial_system.py)
# ---------------------------------------------------------------------------

def inertial_loop_cfg(P, **kw):
    """test_inertial_loop_closure_preserves_gravity's configuration."""
    return P.SystemConfig(
        calib=_calib(P, ATLAS_GEOM, 10.0, 45),
        orb=P.OrbConfig(n_features=512, n_levels=4),
        map=P.MapConfig(max_kf=96, max_mp=12288, n_feat=512,
                        local_mp_cap=2048, window_kf=6, grid_w=16,
                        grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=3,
        sparsify=True, sparsify_n=40, sparsify_window=4,
        sparsify_queue_min=2, nonlocal_kf=3, loop_closing=True,
        loop_covis_min=30, loop_pitchroll_tol=0.05, use_imu=True,
        imu_init_kfs=6, imu_init_time=0.5, **kw)


def inertial_loop_script():
    """An 80-frame orbit and 20 frames of its second lap, with 200 Hz IMU
    rows made per lap (the reference test's)."""
    poses = synth.make_trajectory(80, "orbit")
    poses = poses + poses[:20]
    imu = list(synth.make_imu(poses[:80], 0.1, imu_rate=200)) + list(
        synth.make_imu(poses[79:], 0.1, imu_rate=200))
    return poses, imu


def run_inertial_loop(P, n_frames=None):
    poses, imu = inertial_loop_script()
    n_frames = n_frames or len(poses)
    slam = P.System(inertial_loop_cfg(P), **P.kw)
    H, W, _, BL = ATLAS_GEOM
    K = _K(ATLAS_GEOM)
    world = synth.BoxWorld(np.random.default_rng(0), half=7.0)
    for i, T_wc in enumerate(poses[:n_frames]):
        im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        if i == 0:
            slam.track_stereo(im_l, im_r, 0.0)
        else:
            slam.track_stereo_imu(im_l, im_r, 0.1 * i, imu[i - 1])
    slam._flush_pipeline()
    lc = slam._loop_closer
    g = np.asarray(slam.gravity, np.float64)
    rows = slam.poses_wc()
    gt = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    est = np.stack([T[:3, 3] for _, T in rows])
    ref = np.stack([gt[round(ts, 6)][:3, 3] for ts, _ in rows])
    path = float(np.sum(np.linalg.norm(np.diff(ref, axis=0), axis=1)))
    return {"state": slam.state, "imu_initialized": slam.imu_initialized,
            "imu_stage": slam._imu_stage, "queries": lc.stats["queries"],
            "loops": lc.stats["loops"],
            "yaw_rejected": lc.stats.get("yaw_rejected", 0),
            "g_norm": float(np.linalg.norm(g)),
            "g_cos": float(g[1] / np.linalg.norm(g)),
            "ate": evaluate.ate_rmse(est, ref), "path": path}


def inertial_loop_bars(r):
    """tests/test_inertial_system.py:150-162."""
    assert r["state"] == "OK"
    assert r["imu_initialized"] and r["imu_stage"] >= 2, r
    assert r["queries"] > 0, r
    assert r["loops"] >= 1, r
    assert abs(r["g_norm"] - 9.81) < 0.6, r
    assert r["g_cos"] > 0.9, r


# ---------------------------------------------------------------------------
# chip_smoke.py's phases 15 and 17 at 320x240 (the reference cannot run at
# their full width on a CPU in a test's time)
# ---------------------------------------------------------------------------

SMALL_GEOM = (240, 320, 718.856 * 320 / 1248, 0.537)  # phase 4's field of view


def small_main_cfg(P, sparsify=True, **kw):
    """chip_smoke.py's _main_cfg (phase 4's configuration) at 320x240, 512
    features and 4 levels."""
    return P.SystemConfig(
        calib=_calib(P, SMALL_GEOM, kw.pop("fps", 10.0), 40),
        orb=P.OrbConfig(n_features=512, n_levels=4),
        map=P.MapConfig(max_kf=128, max_mp=32768, n_feat=512,
                        local_mp_cap=2048, window_kf=6),
        min_init_depth_points=100, max_frames_between_kf=10, ba_iters=6,
        sparsify=sparsify, sparsify_n=100, sparsify_lambda=500.0,
        sparsify_grid_lambda=10.0, sparsify_window=30,
        sparsify_queue_min=2, nonlocal_kf=3, **kw)


def circuit(n_frames, radius=9.0, lap=120, ramp=20, start=0.0):
    """chip_smoke.py's _circuit: a circle driven facing forward from rest
    (the turn rate ramps up over `ramp` frames), `start` radians along."""
    w = 2 * np.pi / lap
    poses = []
    for i in range(n_frames):
        a = start + (w * i * i / (2 * ramp) if i < ramp
                     else w * (i - ramp / 2))
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", a).as_matrix()
        T[:3, 3] = [radius * np.sin(a), 0.0, radius * (1 - np.cos(a))]
        poses.append(T)
    return poses


def circuit_s1_script():
    """Phase 15's S1 at 320x240: circuit frames 0-39 (map 0), 13 blank
    pairs, map 1 from rest at 270 degrees over a 20-frame ramp joining
    circuit frames 110-159. (images, true pose, visible) per frame."""
    H, W, _, BL = SMALL_GEOM
    K = _K(SMALL_GEOM)
    world = synth.BoxWorld(np.random.default_rng(0), half=24.0,
                           tex_scale=0.07)
    lap = circuit(160)
    ramp = circuit(20, start=2 * np.pi / 120 * 90)
    poses = lap[:40] + [lap[40]] * 13 + ramp + lap[110:160]
    vis = [True] * 40 + [False] * 13 + [True] * 70
    return [(T, v, world.render_stereo(K, T, BL, H, W) if v else None)
            for T, v in zip(poses, vis)]


def run_circuit_s1(P, script):
    import dataclasses
    cfg = dataclasses.replace(
        small_main_cfg(P, fps=4.0), max_frames_between_kf=5,
        loop_closing=True, t_recently_lost=0.3)
    slam = P.System(cfg, **P.kw)
    H, W = SMALL_GEOM[:2]
    black = np.zeros((H, W), np.float32)
    lc = slam._loop_closer
    weld_log = []
    weld = lc._weld_ba

    def weld_spy(cur, match):
        before = _seam_rmse(P, slam, cur)
        weld(cur, match)
        weld_log.append((before, _seam_rmse(P, slam, cur)))
    lc._weld_ba = weld_spy
    for i, (_, vis, ims) in enumerate(script):
        slam.track_stereo(*(ims if vis else (black, black)), 0.1 * i)
    slam._flush_pipeline()
    ate, path, n_kf = kf_ate(P, slam, [T for T, _, _ in script])
    return {"state": slam.state, "active_map": slam.active_map,
            "merges": lc.stats.get("merges", 0), "weld_log": weld_log,
            "kf_counts": {m: slam.kf_maps.count(m) for m in set(slam.kf_maps)},
            "kf_ate": ate, "kf_path": path, "n_kf": n_kf}


# ---------------------------------------------------------------------------
# one injected state for both packages
# ---------------------------------------------------------------------------

def injected_state(map_cfg, n_kf, seed=0):
    """A map state as numpy fields in the reference's dtypes (from its
    empty_map): `n_kf` live keyframes with random poses, features on a
    random 80% of their slots, about half of them observing live points,
    some points kept by the selector, freed point slots with and without
    quarantine. Every field the bookkeeping reads is filled."""
    from ms_slam_tpu.models import map_state as JM
    rng = np.random.default_rng(seed)
    d = {k: np.array(v) for k, v in JM.empty_map(map_cfg)._asdict().items()}
    K, N = d["kp_valid"].shape
    Mc = d["mp_valid"].shape[0]
    d["kf_valid"][:n_kf] = True
    d["kf_R"][:n_kf] = Rotation.random(n_kf, random_state=seed).as_matrix()
    d["kf_t"][:n_kf] = rng.normal(size=(n_kf, 3))
    d["kf_frame_id"][:n_kf] = 3 * np.arange(n_kf)
    d["kf_ord"][:n_kf] = np.arange(n_kf)
    d["kf_sparsified"][:n_kf // 2] = True
    d["kp_valid"][:n_kf] = rng.random((n_kf, N)) < 0.8
    d["kp_xy"][:n_kf] = rng.uniform(0, 300, (n_kf, N, 2))
    d["kp_octave"][:n_kf] = rng.integers(0, 4, (n_kf, N))
    d["kp_desc"][:n_kf] = rng.integers(0, 2**32, (n_kf, N, 8),
                                       dtype=np.uint64).astype(np.uint32)
    d["kp_depth"][:n_kf] = rng.uniform(0.5, 8, (n_kf, N))
    n_mp = int(0.6 * Mc)
    d["mp_valid"][:n_mp] = True
    dead = rng.choice(n_mp, n_mp // 10, replace=False)
    d["mp_valid"][dead] = False
    d["mp_quarantine"][dead[: len(dead) // 2]] = 2
    d["mp_sparsified"][:n_mp] = rng.random(n_mp) < 0.3
    d["mp_pos"][:n_mp] = rng.normal(size=(n_mp, 3))
    d["mp_desc"][:n_mp] = rng.integers(0, 2**32, (n_mp, 8),
                                       dtype=np.uint64).astype(np.uint32)
    d["mp_first_kf"][:n_mp] = rng.integers(0, n_kf, n_mp)
    d["mp_found"][:n_mp] = rng.integers(1, 9, n_mp)
    d["mp_visible"][:n_mp] = d["mp_found"][:n_mp] + 2
    see = d["kp_valid"] & (rng.random((K, N)) < 0.5)
    d["obs_mp"] = np.where(see, rng.integers(0, n_mp, (K, N)),
                           -1).astype(d["obs_mp"].dtype)
    return d


def set_state(P, slam, d):
    """Put numpy fields `d` into a System of package P as its map."""
    if P.name == "ref":
        import jax.numpy as jnp
        slam.ms = type(slam.ms)(**{k: jnp.asarray(v) for k, v in d.items()})
    else:
        slam.ms = P.M.map_state_from_numpy(d, device="cpu")
    slam._obs_dirty = True


def confirm_calls(pitch, cross, inertial, yaw=0.0, n_kf=10):
    """Route one injected hypothesis through `_confirm` in both packages:
    keyframes 3 (current) and 1 (matched) at the identity, S_cm the
    rotation vector (pitch, -yaw, 0): `pitch` rad across gravity and `yaw`
    rad about the up axis; with `inertial` the IMU is initialized at stage
    2 with gravity along +y (up is -y). Returns ([(calls, stats)] for the
    reference and the port, R_cm, t_cm)."""
    kw = dict(use_imu=True, imu_init_kfs=6, imu_init_time=0.5,
              loop_pitchroll_tol=0.05) if inertial else {}
    d = injected_state(atlas_cfg(package("port")).map, n_kf)
    d["kf_R"][[1, 3]] = np.eye(3)
    d["kf_t"][[1, 3]] = [[0.1, 0.0, 0.2], [0.4, -0.1, 0.3]]
    R_cm = Rotation.from_rotvec([pitch, -yaw, 0.0]).as_matrix()
    t_cm = np.array([0.05, -0.02, 0.3])
    out = []
    for name in ("ref", "port"):
        P = package(name)
        slam = P.System(atlas_cfg(P, **kw), **P.kw)
        set_state(P, slam, d)
        slam.n_kf = n_kf
        slam.kf_order = list(range(n_kf))
        slam.kf_maps = [0] * 2 + [1] * 8 if cross else [0] * n_kf
        slam.active_map = slam.kf_maps[3]
        if inertial:
            slam.imu_initialized = True
            slam._imu_stage = 2
            slam.gravity = np.array([0.0, 9.81, 0.0])
        lc = slam._loop_closer
        calls = []
        lc._merge_maps = lambda *a: calls.append(("merge",) + a)
        lc._correct_loop = lambda *a: calls.append(("loop",) + a)
        # S_lw = S_cm * T_mw with T_mw the matched keyframe's pose
        R_cw = R_cm @ d["kf_R"][1].astype(np.float64)
        t_cw = R_cm @ d["kf_t"][1].astype(np.float64) + t_cm
        lc._hyp = {"match": 1, "last_cur": 3, "S_lw": (1.0, R_cw, t_cw),
                   "n_coin": 3, "n_notfound": 0}
        lc._confirm(3)
        out.append((calls, dict(lc.stats)))
    return out, R_cm, t_cm



# ---------------------------------------------------------------------------
# the scripts themselves
# ---------------------------------------------------------------------------

def _blind_runs(script):
    runs, start = [], None
    for i, (_, v) in enumerate(script + [(None, True)]):
        if not v and start is None:
            start = i
        elif v and start is not None:
            runs.append((start, i - start))
            start = None
    return runs


def test_reference_scripts_as_the_reference_tests_build_them():
    """s1/s2/s3_script are the reference tests' own frame lists."""
    lap = synth.make_trajectory(80, "orbit")
    s1 = s1_script()
    assert len(s1) == 100 and _blind_runs(s1) == [(30, 22)]
    np.testing.assert_array_equal(s1[80][0], lap[0])
    s2 = s2_script()
    assert len(s2) == 30 + 22 + 20 + 3 + 12
    assert _blind_runs(s2) == [(30, 22), (72, 3)]
    np.testing.assert_array_equal(s2[75][0], lap[10])
    s3 = s3_script()
    assert len(s3) == 60 and _blind_runs(s3) == [(30, 8)]


def test_short_scripts_keep_the_phases():
    """The shortened scripts keep every phase: the atlas blackouts last the
    frames that pass t_recently_lost (0.3 s at 0.1 s a frame, and one for
    the pipeline's lag) plus the int(2 * fps) + 1 LOST frames that start a
    new map at 4 Hz, and S3's blackout stays under its 5 s grace."""
    s1 = s1_short_script()
    assert _blind_runs(s1) == [(12, 13)] and len(s1) == 58
    s2 = s2_short_script()
    assert _blind_runs(s2) == [(16, 13), (41, 3)] and len(s2) == 54
    assert 13 >= (round(0.3 / 0.1) + 1) + (int(2 * 4.0) + 1)
    s3 = s3_short_script()
    assert _blind_runs(s3) == [(20, 8)] and len(s3) == 36
    assert 0.1 * (8 + 8) < 5.0
