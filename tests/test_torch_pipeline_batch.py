"""The software pipeline's host rules, in both packages on scripted inputs,
and the port's prefetch on real frames.

Scripted (both Systems, nothing tracked: the in-flight queue is filled by
hand and the steps that would run the device are replaced):
- an event fired while completing the first frame of a batch (here
  `_redispatch_inflight`, which relocalization, a loop correction and the
  inertial map rescale call) gives the same sequence of re-dispatched
  frame ids: first the frames still queued, then the rest of the batch
  merged with them in frame order;
- a loss while completing a batch sends the queued frames, then the rest
  of the batch, through `_track_lost`, in the same order;
- `shutdown()` cancels the prefetch worker and drops a pending prefetch:
  the next call runs its own frontend;
- a prefetch that raised surfaces on the next call as RuntimeError naming
  that call's frame, with the worker's exception as its cause.

The port on 12 frames of tests/test_e2e.py's arc at 320x240 and 512
features: at depth 2, poses bit-identical with and without `next_images`
(and with MSSLAM_OBS_EVERY_FRAME); at depth 4, bit-identical between the
prefetch worker and MSSLAM_SYNC_PREFETCH. The frontend is deterministic
and the prefetch only moves where it runs, so nothing may change.
"""
import os
import threading
from contextlib import contextmanager
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.models.map_state import MapConfig as JMapConfig
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline import system as jsys
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu_torch.models.map_state import MapConfig
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline import system as tsys
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.utils import synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BASELINE = 240, 320, 260.0, 0.15
PIPE_VARS = ("MSSLAM_PIPELINE_DEPTH", "MSSLAM_FETCH_BATCH",
             "MSSLAM_SYNC_PREFETCH", "MSSLAM_OBS_EVERY_FRAME")


def _cfg(mod, calib_t, orb_t, map_t):
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                    width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
    return mod.SystemConfig(
        calib=calib, orb=orb_t(n_features=512, n_levels=4),
        map=map_t(max_kf=64, max_mp=8192, n_feat=512, local_mp_cap=2048,
                  window_kf=6),
        min_init_depth_points=100, max_frames_between_kf=8)


@contextmanager
def pipeline_env(**env):
    """Set the pipeline's variables (unset the others) while Systems are
    made."""
    saved = {k: os.environ.pop(k, None) for k in PIPE_VARS}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k in PIPE_VARS:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def _system(pkg, **env):
    with pipeline_env(**env):
        if pkg == "ref":
            return jsys.System(_cfg(jsys, JCalib, JOrbConfig, JMapConfig))
        return tsys.System(_cfg(tsys, Calib, OrbConfig, MapConfig),
                           device="cpu")


def _flight(pkg, fid, stats):
    mod = jsys if pkg == "ref" else tsys
    stats = jnp.asarray(stats) if pkg == "ref" else torch.from_numpy(stats)
    return mod.InFlight(frame_id=fid, timestamp=0.1 * fid, frame=None,
                        out=SimpleNamespace(stats=stats), imu_used=False)


def _queued(pkg, slam, fids, stats):
    slam.state = "OK"
    slam.frame_id = fids[-1]
    for f in fids:
        slam._inflight.append(_flight(pkg, f, stats))


PKGS = ["ref", "port"]


def _event_in_batch(pkg):
    slam = _system(pkg, MSSLAM_PIPELINE_DEPTH=4)
    assert (slam._pipeline_depth, slam._fetch_batch) == (4, 2)
    _queued(pkg, slam, [10, 11, 12, 13], np.zeros(33, np.float32))
    dispatched, completed = [], []

    def dispatch(frame, timestamp):
        dispatched.append(slam.frame_id)
        slam._inflight.append(_flight(pkg, slam.frame_id,
                                      np.zeros(33, np.float32)))

    def complete(fl=None, packed=None):
        completed.append(fl.frame_id)
        if fl.frame_id == 10:
            slam._redispatch_inflight()

    slam._dispatch_track = dispatch
    slam._complete_one = complete
    slam._complete_batch(2)
    return (dispatched, completed, [f.frame_id for f in slam._inflight],
            slam.frame_id, slam._state_gen)


def test_event_inside_a_batch_redispatches_alike():
    ref, port = _event_in_batch("ref"), _event_in_batch("port")
    assert port == ref
    assert port == ([12, 13, 11, 12, 13], [10], [11, 12, 13], 13, 1)


def _loss_in_batch(pkg):
    slam = _system(pkg, MSSLAM_PIPELINE_DEPTH=4)
    _queued(pkg, slam, [10, 11, 12, 13], np.zeros(33, np.float32))
    lost = []
    slam._relocalize = lambda frame: None
    slam._track_lost = lambda frame, ts, frame_id=None: lost.append(frame_id)
    slam._complete_batch(2)
    return (lost, slam.state, [(e.frame_id, e.lost) for e in slam.trajectory],
            len(slam._inflight), len(slam.timing["stats_fetch"]))


def test_loss_inside_a_batch_goes_to_track_lost():
    ref, port = _loss_in_batch("ref"), _loss_in_batch("port")
    assert port == ref
    assert port == ([12, 13, 11], "LOST", [(10, True)], 0, 1)


IMG = np.zeros((H, W), np.uint8)


@pytest.mark.parametrize("pkg", PKGS)
def test_shutdown_drops_a_pending_prefetch(pkg):
    slam = _system(pkg)
    gate = threading.Event()
    calls = []

    def frontend(img_l, img_r, *a, **k):
        calls.append(threading.current_thread().name)
        if len(calls) == 1:
            gate.wait(10)
            return "prefetched"
        return "fresh"

    slam._dispatch_frontend = frontend
    slam._next_images = (IMG, IMG)
    slam._prefetch_next()
    slam._next_images = None
    assert slam._prefetch_pool is not None
    slam.shutdown()
    gate.set()
    assert slam._prefetch_pool is None
    pending = (slam._prefetched_frame if pkg == "ref" else slam._prefetched)
    assert pending is None
    seen = []
    slam._advance = lambda frame, ts, init_fn=None: seen.append(frame)
    slam.track_stereo(IMG, IMG, 0.0)
    assert seen == ["fresh"] and len(calls) == 2
    assert calls[0].startswith("msslam-prefetch")


@pytest.mark.parametrize("pkg", PKGS)
def test_failed_prefetch_names_its_frame(pkg):
    slam = _system(pkg)

    def frontend(img_l, img_r, *a, **k):
        raise ValueError("frontend failed")

    slam._dispatch_frontend = frontend
    slam._next_images = (IMG, IMG)
    slam._prefetch_next()
    slam._next_images = None
    with pytest.raises(RuntimeError, match="prefetch for frame 0 failed") \
            as err:
        slam.track_stereo(IMG, IMG, 0.0)
    assert isinstance(err.value.__cause__, ValueError)
    slam.shutdown()


# ---------------------------------------------------------------------------
# the port's prefetch on real frames
# ---------------------------------------------------------------------------

N_FRAMES = 12


@pytest.fixture(scope="module")
def frames():
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    return [[np.clip(im, 0, 255).astype(np.uint8)
             for im in world.render_stereo(K, T, BASELINE, H, W)]
            for T in synth.make_trajectory(30, "arc")[:N_FRAMES]]


def _drive(frames, lookahead, **env):
    slam = _system("port", **env)
    for i, (l, r) in enumerate(frames):
        nxt = frames[i + 1] if lookahead and i + 1 < len(frames) else None
        slam.track_stereo(l, r, 0.1 * i, next_images=nxt)
    slam.shutdown()
    return slam, np.stack([T for _, T in slam.poses_wc()])


@pytest.fixture(scope="module")
def depth2(frames):
    return _drive(frames, False)


@pytest.mark.parametrize("env", [{}, {"MSSLAM_OBS_EVERY_FRAME": 1}])
def test_depth2_prefetch_changes_nothing(frames, depth2, env):
    base, P0 = depth2
    slam, P = _drive(frames, True, **env)
    assert slam.state == base.state == "OK"
    np.testing.assert_array_equal(P, P0)
    assert base.prefetch_hits == 0
    # frames 0 and 1 run their own frontend: frame 0 initializes the map,
    # and only a frame tracked in OK prefetches the next
    assert slam.prefetch_hits == N_FRAMES - 2
    assert len(slam.timing["prefetch_dispatch"]) == N_FRAMES - 1


def test_depth4_thread_and_sync_prefetch_agree(frames):
    a, Pa = _drive(frames, True, MSSLAM_PIPELINE_DEPTH=4)
    b, Pb = _drive(frames, True, MSSLAM_PIPELINE_DEPTH=4,
                   MSSLAM_SYNC_PREFETCH=1)
    assert a.state == b.state == "OK"
    np.testing.assert_array_equal(Pa, Pb)
    assert a.prefetch_hits == b.prefetch_hits == N_FRAMES - 2
    assert a._prefetch_pool is None and b._prefetch_pool is None
    # 11 tracked frames: four fetches of two in steady state, then the
    # last three one at a time when shutdown() flushes the pipeline
    assert len(a.timing["stats_fetch"]) == len(b.timing["stats_fetch"]) == 7
