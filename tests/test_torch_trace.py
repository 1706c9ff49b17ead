"""The port's host spans and sync counts (`ms_slam_tpu_torch/utils/trace.py`)
on tests/test_torch_pipeline_batch.py's 12-frame arc (320x240, 512
features, the default depth 2):

- every dispatched frame adds one event to each tracking stage
  (`track.motion`, `track.local_select`, `track.local`, `track.stats`) and
  to each of the two host branches (`sync.track_wide`,
  `sync.track_fallback`); `search` counts 2 plus the widened retry and
  `pose_opt` 2 plus the retry and the fallback, read from the flags of the
  frame's fetched stats; the stages sum to no more than `track_dispatch`;
- `stats_fetch` keeps one event a fetch and times the copy alone: a sleep
  in the keyframe-info integration lands in `kf_integrate`;
- with no profiler running no profiler range is entered; under one the
  `msslam.` ranges appear, nest as the spans do and carry the id of the
  frame whose work they do, and none is a user annotation (which the
  profiler would mirror on the device timeline);
- `track_full` gives the same bits with and without a `Timing`.
"""
import contextlib
import copy
import time

import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.models.map_state import MapConfig
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline import system as tsys
from ms_slam_tpu_torch.pipeline import tracking_ops as to
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.utils import synth, trace
from ms_slam_tpu_torch.utils.trace import PREFIX, Timing, span, sync

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BASELINE = 240, 320, 260.0, 0.15
N_FRAMES = 12
PROFILED = 2                   # the last frames run under torch.profiler
CAPTURED = (3, 9)              # frames whose track_full inputs are kept
SLEEP_S = 0.05
PIPE_VARS = ("MSSLAM_PIPELINE_DEPTH", "MSSLAM_FETCH_BATCH",
             "MSSLAM_SYNC_PREFETCH", "MSSLAM_OBS_EVERY_FRAME")
STAGES = ("track.motion", "track.local_select", "track.local", "track.stats")


def _system():
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                  width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
    cfg = tsys.SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=MapConfig(max_kf=64, max_mp=8192, n_feat=512, local_mp_cap=2048,
                      window_kf=6),
        min_init_depth_points=100, max_frames_between_kf=8)
    with pytest.MonkeyPatch.context() as mp:
        for k in PIPE_VARS:
            mp.delenv(k, raising=False)
        return tsys.System(cfg, device="cpu")


def _frames():
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    return [[np.clip(im, 0, 255).astype(np.uint8)
             for im in world.render_stereo(K, T, BASELINE, H, W)]
            for T in synth.make_trajectory(30, "arc")[:N_FRAMES]]


@pytest.fixture(scope="module")
def run():
    """Drive the arc with spies on the fetch, the keyframe-info integration
    and `track_full`; opening a range raises until the profiled frames."""
    slam = _system()
    tm = slam.timing
    packs, fetches, entered, captured, counts = {}, [], [], {}, {}
    fetch, integrate = slam._fetch_stats, slam._integrate_kf_info
    track_full = to.track_full

    def fetch_spy(fls):
        out = fetch(fls)
        fetches.append([fl.frame_id for fl in fls])
        packs.update({fl.frame_id: p for fl, p in zip(fls, out)})
        return out

    def integrate_slowly(slot, info):
        time.sleep(SLEEP_S)
        return integrate(slot, info)

    def track_full_spy(*a, **k):
        if slam.frame_id in CAPTURED:
            captured[slam.frame_id] = copy.deepcopy((a, k))
        return track_full(*a, **k)

    def no_range(*a, **k):
        entered.append(a)
        raise AssertionError("a range opened with no profiler")

    slam._fetch_stats = fetch_spy
    slam._integrate_kf_info = integrate_slowly
    frames = _frames()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsys.to, "track_full", track_full_spy)
        mp.setattr(trace, "_range", no_range)
        for i, (l, r) in enumerate(frames[:N_FRAMES - PROFILED]):
            before = {k: len(tm.get(k, [])) for k in ("search", "pose_opt")}
            slam.track_stereo(l, r, 0.1 * i)
            counts[i] = {k: len(tm.get(k, [])) - n for k, n in before.items()}
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(N_FRAMES - PROFILED, N_FRAMES):
            slam.track_stereo(*frames[i], 0.1 * i)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(PREFIX)]
    ranges = [(e.name()[len(PREFIX):], e.start_ns(),
               e.start_ns() + e.duration_ns()) for e in events]
    annotations = sum(e.is_user_annotation() for e in events)
    timing = {k: list(v) for k, v in tm.items()}
    n_fetches = len(fetches)
    assert slam.state == "OK"
    slam.shutdown()                 # fetches the last frame's stats
    return dict(timing=timing, packs=packs, n_fetches=n_fetches, counts=counts,
                entered=entered, captured=captured, ranges=ranges,
                annotations=annotations)


DISPATCHED = N_FRAMES - 1      # frame 0 initializes the map


@pytest.mark.parametrize("key", STAGES + ("sync.track_wide",
                                          "sync.track_fallback"))
def test_one_event_per_dispatched_frame(run, key):
    tm = run["timing"]
    assert len(tm["track_dispatch"]) == DISPATCHED
    assert len(tm[key]) == DISPATCHED


@pytest.mark.parametrize("key,flags", [("search", (13,)),
                                       ("pose_opt", (13, 14))])
def test_cascade_counts_follow_the_flags(run, key, flags):
    """Frame i's dispatch is in call i; its flags come with its stats:
    used_wide at 13, used_fallback at 14 of the packed layout."""
    checked = 0
    for fid, n in run["counts"].items():
        if fid == 0 or fid not in run["packs"]:
            continue
        used = sum(int(run["packs"][fid][j]) for j in flags)
        assert n[key] == 2 + used, (fid, key, n)
        checked += 1
    assert checked >= DISPATCHED - PROFILED - 1


def test_stages_within_the_dispatch(run):
    tm = run["timing"]
    for i, whole in enumerate(tm["track_dispatch"]):
        assert sum(tm[k][i] for k in STAGES) <= whole


def test_fetch_times_the_copy_not_the_integration(run):
    tm = run["timing"]
    assert len(tm["stats_fetch"]) == run["n_fetches"] == N_FRAMES - 2
    assert len(tm["sync.stats_fetch"]) == len(tm["stats_fetch"])
    assert tm["kf_integrate"] and min(tm["kf_integrate"]) >= SLEEP_S
    assert max(tm["stats_fetch"]) < SLEEP_S


def test_no_range_without_a_profiler(run):
    assert run["entered"] == []


def test_ranges_are_not_user_annotations(run):
    assert run["ranges"] and run["annotations"] == 0


def _by_frame(ranges, name):
    out = {}
    for label, s, e in ranges:
        nm, _, fid = label.partition("@")
        if nm == name:
            out.setdefault(int(fid), []).append((s, e))
    return out


@pytest.mark.parametrize("child,parents", [
    ("pose_opt", ("track.motion", "track.local")),
    ("search", ("track.motion", "track.local")),
    ("track.local", ("track_dispatch",)),
    ("sync.track_wide", ("track.motion",)),
    ("sync.stats_fetch", ("stats_fetch",)), ("stats_fetch", ("complete",)),
    ("track_dispatch", ("track",))])
def test_ranges_nest_with_their_frame(run, child, parents):
    """Each child range lies in a parent range of its own frame, and every
    parent range named holds one."""
    kids = _by_frame(run["ranges"], child)
    outer = [(fid, ps, pe) for p in parents
             for fid, rs in _by_frame(run["ranges"], p).items()
             for ps, pe in rs]
    assert kids and outer
    for fid, rs in kids.items():
        for s, e in rs:
            assert any(f == fid and ps <= s and e <= pe
                       for f, ps, pe in outer), (child, fid)
    for f, ps, pe in outer:
        assert any(ps <= s and e <= pe for s, e in kids.get(f, [])), \
            (child, f)


@pytest.mark.parametrize("name,shift", [("track_dispatch", 0),
                                        ("prefetch_dispatch", 1),
                                        ("complete", -1)])
def test_ranges_carry_the_frame_they_work_on(run, name, shift):
    """A call dispatches its frame, prefetches the next and completes the
    one before."""
    calls = range(N_FRAMES - PROFILED, N_FRAMES)
    assert sorted(_by_frame(run["ranges"], name)) == [i + shift
                                                       for i in calls]


@pytest.mark.parametrize("fid", CAPTURED)
def test_track_full_same_bits_with_and_without_timing(run, fid):
    a, k = run["captured"][fid]
    outs = []
    for timing in (None, Timing()):
        aa, kk = copy.deepcopy((a, k))
        outs.append(to.track_full(*aa, **{**kk, "timing": timing}))
        if timing is not None:
            assert set(STAGES) <= set(timing)
    for x, y in zip(*outs):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif x is not None:
            for u, v in zip(x, y):
                assert torch.equal(u, v)


@pytest.mark.parametrize("fail", [False, True])
def test_span_records_only_what_returns(fail):
    tm = Timing()
    with pytest.raises(ValueError) if fail else contextlib.nullcontext():
        with span(tm, "outer", 7):
            with sync(tm, "inner"):
                assert tm.open == [("outer", 7), ("sync.inner", 7)]
                if fail:
                    raise ValueError
    assert tm.open == []
    assert sorted(tm) == ([] if fail else ["outer", "sync.inner"])
    with span(None, "nothing"):
        pass
