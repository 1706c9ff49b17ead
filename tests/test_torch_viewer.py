"""The port's viewer (`utils/viewer.py`) and the System's frame drawer
against the reference's.

- MapSnapshot on equal maps (the reference's MapState carried over by
  `map_state_from_numpy`): the PLY files equal byte for byte, the top-down
  figures pixel for pixel;
- draw_frame on the same inputs: the PNGs equal pixel for pixel;
- a 4-frame System with frame_draw_every=2, the port's on the CPU beside
  the reference's: the same file names in frame_draw_dir (their contents
  differ with the two frontends' keypoints).
"""
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.models import map_state as JM
from ms_slam_tpu.models.map_state import MapConfig as JMapConfig
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu.pipeline.system import System as JSystem
from ms_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from ms_slam_tpu.utils import viewer as jviewer
from ms_slam_tpu_torch.models.map_state import MapConfig, map_state_from_numpy
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
from ms_slam_tpu_torch.utils import synth, viewer

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BASELINE = 240, 320, 260.0, 0.15


class _Slam:
    """What MapSnapshot.from_system reads: `ms` and `poses_wc()`."""

    def __init__(self, ms):
        self.ms = ms

    def poses_wc(self):
        out = []
        for i in range(10):
            T = np.eye(4)
            T[:3, 3] = [0.1 * i, 0, 0.05 * i]
            out.append((0.1 * i, T))
        return out


@pytest.fixture(scope="module")
def maps():
    rng = np.random.default_rng(0)
    ms = JM.empty_map(JMapConfig(max_kf=8, max_mp=64, n_feat=16))
    R = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                  for _ in range(8)]).astype(np.float32)
    ms = ms._replace(
        kf_R=jnp.asarray(R),
        kf_t=jnp.asarray(rng.normal(size=(8, 3)).astype(np.float32)),
        mp_pos=jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32)),
        mp_valid=jnp.asarray(rng.random(64) > 0.3),
        mp_sparsified=jnp.asarray(rng.random(64) > 0.5),
        kf_valid=jnp.asarray(np.arange(8) < 5),
        kf_sparsified=jnp.asarray(np.arange(8) < 2))
    port = map_state_from_numpy({k: np.asarray(v)
                                 for k, v in ms._asdict().items()})
    return _Slam(ms), _Slam(port)


def test_snapshot_ply_bytes_equal(maps, tmp_path):
    ref, port = maps
    jviewer.MapSnapshot.from_system(ref).save_ply(str(tmp_path / "ref.ply"))
    snap = viewer.MapSnapshot.from_system(port)
    snap.save_ply(str(tmp_path / "port.ply"))
    got = (tmp_path / "port.ply").read_bytes()
    assert got == (tmp_path / "ref.ply").read_bytes()
    n = int(snap.mp_valid.sum() + snap.kf_valid.sum())
    assert f"element vertex {n}\n".encode() in got
    assert got.count(b"\n") == n + 10


def test_snapshot_topdown_pixels_equal(maps, tmp_path):
    ref, port = maps
    jviewer.MapSnapshot.from_system(ref).plot_topdown(str(tmp_path / "r.png"))
    viewer.MapSnapshot.from_system(port).plot_topdown(str(tmp_path / "p.png"))
    a = cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "r.png"), cv2.IMREAD_UNCHANGED)
    assert a is not None and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_draw_frame_pixels_equal(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (120, 160), dtype=np.uint8)
    n = 64
    xy = rng.uniform(0, [160, 120], (n, 2)).astype(np.float32)
    valid = rng.random(n) < 0.8
    tracked = rng.random(n) < 0.5
    for mod, name in ((jviewer, "r.png"), (viewer, "p.png")):
        mod.draw_frame(img, xy, valid, tracked, str(tmp_path / name),
                       state="OK")
    a = cv2.imread(str(tmp_path / "p.png"), cv2.IMREAD_UNCHANGED)
    b = cv2.imread(str(tmp_path / "r.png"), cv2.IMREAD_UNCHANGED)
    assert a.shape[:2] == (120, 160)
    np.testing.assert_array_equal(a, b)


def _cfg(calib_t, orb_t, map_t, cfg_t, **kw):
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                    width=W, height=H, th_depth=BASELINE * 40, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=64, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6),
                 min_init_depth_points=100, max_frames_between_kf=8, **kw)


def test_system_frame_drawer_file_names(tmp_path):
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    frames = [world.render_stereo(K, T, BASELINE, H, W)
              for T in synth.make_trajectory(30, "arc")[:4]]
    names = []
    for *types, cls, kw, d in (
            (JCalib, JOrbConfig, JMapConfig, JSystemConfig, JSystem, {},
             tmp_path / "ref"),
            (Calib, OrbConfig, MapConfig, SystemConfig, System,
             {"device": "cpu"}, tmp_path / "port")):
        slam = cls(_cfg(*types, frame_draw_every=2,
                        frame_draw_dir=str(d)), **kw)
        for i, (l, r) in enumerate(frames):
            slam.track_stereo(l, r, 0.1 * i)
        slam.shutdown()
        assert slam.state == "OK"
        names.append(sorted(os.listdir(d)))
    assert names[1] == names[0] == ["frame_000002.png"]
    img = cv2.imread(str(tmp_path / "port" / names[1][0]))
    assert img is not None and img.shape[:2] == (H, W)
