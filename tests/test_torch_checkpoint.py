"""Checkpoints move between the two packages (`utils/checkpoint.py`).

One reference System maps 20 frames of tests/test_checkpoint.py's orbit
(its configuration; 20 frames instead of 30) and `shutdown()` sparsifies,
filling the keyframe database. Then:

- the reference saves; the port loads on the CPU: every MapState array
  equals the file's in shape and value, and in dtype but for
  `mp_sparsified`, which both packages' zeroing writes as int64 and the map
  holds as bool; the database rows and the host cursors equal too; state
  LOST, equal keyframe and point counts;
- the port saves again: the same keys, dtypes, shapes and values as the
  reference's file (`meta_json` equal but for the state it records);
- the port relocalizes a frame from the mapped area (OK, camera centre
  within 0.35 m of the truth; the first camera is the world frame) and
  tracks five more frames, creating keyframes in slots the map freed;
- the reference loads the port's file and relocalizes too;
- md5_of_file agrees;
- both packages leave the database's codebook as constructed after a load
  (the format holds no codebook: reference behaviour, kept by the port).

The port also gives every loaded keyframe slot the active map's Atlas label;
the reference leaves the labels empty (checked here), so its first keyframe
that reuses a freed slot after a load raises IndexError.
"""
import json

import numpy as np
import pytest
import torch

from ms_slam_tpu.models.map_state import MapConfig as JMapConfig
from ms_slam_tpu.models.vocab import make_codebook as jmake_codebook
from ms_slam_tpu.ops.orb import OrbConfig as JOrbConfig
from ms_slam_tpu.pipeline.frontend import Calib as JCalib
from ms_slam_tpu.pipeline.system import System as JSystem
from ms_slam_tpu.pipeline.system import SystemConfig as JSystemConfig
from ms_slam_tpu.utils import checkpoint as jckpt
from ms_slam_tpu_torch.models.map_state import MapConfig, map_state_to_numpy
from ms_slam_tpu_torch.models.vocab import make_codebook
from ms_slam_tpu_torch.ops.orb import OrbConfig
from ms_slam_tpu_torch.pipeline.frontend import Calib
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig
from ms_slam_tpu_torch.utils import checkpoint, synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BL = 240, 320, 260.0, 0.15
N_FRAMES = 20
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


def _make(calib_t, orb_t, map_t, cfg_t, cls, **kw):
    """tests/test_checkpoint.py's System."""
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                    width=W, height=H, th_depth=BL * 45, fps=10.0)
    return cls(cfg_t(
        calib=calib, orb=orb_t(n_features=512, n_levels=4),
        map=map_t(max_kf=64, max_mp=8192, n_feat=512, local_mp_cap=2048,
                  window_kf=6, grid_w=16, grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=4,
        sparsify=True, sparsify_n=40, sparsify_window=4,
        sparsify_queue_min=2, nonlocal_kf=3, loop_closing=True), **kw)


def _ref_system():
    return _make(JCalib, JOrbConfig, JMapConfig, JSystemConfig, JSystem)


def _port_system():
    return _make(Calib, OrbConfig, MapConfig, SystemConfig, System,
                 device="cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    world = synth.BoxWorld(np.random.default_rng(0), half=7.0)
    poses = synth.make_trajectory(60, "orbit")
    slam = _ref_system()
    for i, T_wc in enumerate(poses[:N_FRAMES]):
        im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        slam.track_stereo(im_l, im_r, 0.1 * i)
    assert slam.state == "OK"
    slam.shutdown()
    ref_path = str(d / "ref.npz")
    jckpt.save_map(ref_path, slam)
    port = _port_system()
    checkpoint.load_map(ref_path, port)
    port_path = str(d / "port.npz")
    checkpoint.save_map(port_path, port)
    return {"ref": slam, "ref_path": ref_path, "port": port,
            "port_path": port_path, "world": world, "poses": poses}


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_port_loads_reference_arrays(run):
    ref, port = run["ref"], run["port"]
    data = _load(run["ref_path"])
    got = map_state_to_numpy(port.ms)
    assert {f"ms_{k}" for k in got} == {k for k in data
                                        if k.startswith("ms_")}
    for k, a in got.items():
        b = data[f"ms_{k}"]
        assert a.shape == b.shape, k
        assert a.dtype == (b.dtype if k != "mp_sparsified" else bool), k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert data["ms_mp_sparsified"].dtype == np.int64
    np.testing.assert_array_equal(port.kf_db.rows.numpy(), data["db_rows"])
    assert port.kf_db.rows.dtype == torch.float32
    assert port.state == "LOST"
    assert port.keyframes_in_map() == ref.keyframes_in_map() > 2
    assert port.map_points_in_map() == ref.map_points_in_map() > 100
    for k in ("n_kf", "n_mp", "kf_ord", "kf_free", "kf_order", "frame_id",
              "ref_kf"):
        assert getattr(port, k) == getattr(ref, k), k
    assert port._sparsifier.done == ref._sparsifier.done
    np.testing.assert_array_equal(port.kf_db.present, ref.kf_db.present)
    assert port.kf_db.present.any()


def test_port_file_equals_reference_file(run):
    a, b = _load(run["port_path"]), _load(run["ref_path"])
    assert set(a) == set(b)
    for k in b:
        if k == "meta_json":
            continue
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ma = json.loads(bytes(a["meta_json"]).decode())
    mb = json.loads(bytes(b["meta_json"]).decode())
    assert list(ma) == list(mb)
    assert (ma.pop("state"), mb.pop("state")) == ("LOST", "OK")
    assert ma == mb


def test_md5_of_file_agrees(run):
    for p in (run["ref_path"], run["port_path"]):
        assert checkpoint.md5_of_file(p) == jckpt.md5_of_file(p)
    assert checkpoint.md5_of_file(run["ref_path"]) != checkpoint.md5_of_file(
        run["port_path"])


def test_codebook_left_as_constructed_after_load(run, tmp_path):
    port = run["port"]
    ref = _ref_system()
    jckpt.load_map(run["port_path"], ref)
    for db in (port.kf_db, ref.kf_db):
        assert not db._trained and not db._retrained
        assert not db.has_row.any()
    np.testing.assert_array_equal(port.kf_db.codebook.numpy(),
                                  make_codebook().numpy())
    np.testing.assert_array_equal(np.asarray(ref.kf_db.codebook),
                                  np.asarray(jmake_codebook()))
    # the Atlas labels: the port labels every loaded slot, the reference
    # leaves them empty
    assert port.kf_maps == [port.active_map] * port.n_kf
    assert ref.kf_maps == []


def _centre_err(slam, T_wc):
    return float(np.linalg.norm(np.linalg.inv(slam.current_pose())[:3, 3]
                                - T_wc[:3, 3]))


def test_port_relocalizes_and_tracks_on(run):
    port, world, poses = run["port"], run["world"], run["poses"]
    kf_before = port.kf_ord
    errs = []
    for j, i in enumerate(range(10, 16)):
        im_l, im_r = world.render_stereo(K, poses[i], BL, H, W)
        port.track_stereo(im_l, im_r, 100.0 + 0.1 * j)
        port._flush_pipeline()
        assert port.state == "OK", (i, port.state)
        errs.append(_centre_err(port, poses[i]))
    assert errs[0] < 0.35, errs
    assert max(errs) < 0.35, errs
    assert port.kf_ord > kf_before            # keyframes made after the load
    assert not any(e.lost for e in port.trajectory)
    # the query encodes with the initial codebook, as the reference's does
    np.testing.assert_array_equal(port.kf_db.codebook.numpy(),
                                  make_codebook().numpy())


def test_reference_loads_port_file_and_relocalizes(run):
    ref = _ref_system()
    jckpt.load_map(run["port_path"], ref)
    assert ref.state == "LOST"
    assert ref.map_points_in_map() == run["ref"].map_points_in_map()
    T_wc = run["poses"][10]
    im_l, im_r = run["world"].render_stereo(K, T_wc, BL, H, W)
    ref.track_stereo(im_l, im_r, 100.0)
    assert ref.state == "OK"
    assert _centre_err(ref, T_wc) < 0.35
