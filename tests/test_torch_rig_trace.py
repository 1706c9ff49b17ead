"""A rectified stereo `System` is untouched by the right-camera rows:
tests/test_torch_trace.py's 12-frame arc (320x240, 512 features, the
default depth 2), with every right-row function made to raise.

Against the same run before the right rows existed (measured on the CPU):
the same sync sites with the same counts (so `system.syncs_per_frame`
reads 33 / 12), the same span keys (no `frontend.kb8_pair`, no
`rig.right_rows`), a 33-entry stats pack a frame, and the same last pose to
1e-6. No frame carries right keypoints and the pool's stay -1.

The whole-System run has this file to itself, so that `--dist loadfile`
gives it a worker of its own.
"""
import numpy as np
import pytest
import torch

from ms_slam_tpu_torch.ops import cameras

import test_torch_trace as tt

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

SYNCS = {"sync.stats_fetch": 11, "sync.track_fallback": 11,
         "sync.track_wide": 11}
KEYS = {"complete", "frontend", "keyframe_step", "kf_integrate", "pose_opt",
        "prefetch_dispatch", "search", "stats_fetch", "track", "track.local",
        "track.local_select", "track.motion", "track.stats",
        "track_dispatch"} | set(SYNCS)
LAST_POSE = np.array([
    [0.9853776097297668, -0.0024138090666383505, -0.17036749422550201,
     -0.8416913151741028],
    [0.002389685483649373, 0.999997079372406, -0.0003466577618382871,
     -0.20787440240383148],
    [0.17036782205104828, -6.553594721481204e-05, 0.9853805303573608,
     -0.7142127752304077],
    [0.0, 0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def run():
    slam = tt._system()
    packs, rights = [], []
    fetch, advance = slam._fetch_stats, slam._advance

    def fetch_spy(fls):
        out = fetch(fls)
        packs.extend(len(p) for p in out)
        return out

    def advance_spy(frame, *a, **k):
        rights.append(frame.right)
        return advance(frame, *a, **k)

    def leak(*a, **k):
        raise AssertionError("a right row in a rectified run")

    slam._fetch_stats = fetch_spy
    slam._advance = advance_spy
    with pytest.MonkeyPatch.context() as mp:
        for attr in ("rig_project", "right_info"):
            mp.setattr(cameras, attr, leak)
        for i, (left, right) in enumerate(tt._frames()):
            slam.track_stereo(left, right, 0.1 * i)
        slam.shutdown()
    return dict(slam=slam, packs=packs, rights=rights,
                timing={k: list(v) for k, v in slam.timing.items()})


def test_sync_sites_and_counts_unchanged(run):
    timing = run["timing"]
    got = {k: len(v) for k, v in timing.items() if k.startswith("sync.")}
    assert got == SYNCS
    assert len(timing["frontend"]) == tt.N_FRAMES


def test_span_keys_unchanged(run):
    assert set(run["timing"]) == KEYS


def test_stats_pack_unchanged(run):
    assert run["packs"] and set(run["packs"]) == {33}


def test_no_right_keypoints(run):
    assert len(run["rights"]) == tt.N_FRAMES
    assert all(r is None for r in run["rights"])
    assert (run["slam"].ms.kp_right == -1.0).all()


def test_last_pose_unchanged(run):
    np.testing.assert_allclose(run["slam"].current_pose(), LAST_POSE,
                               rtol=0, atol=1e-6)
