"""The port's native host runtime (`utils/native.py` with its own copy of
`csrc/msslam_runtime.cpp`) and dataset readers (`utils/datasets.py`)
against cv2 and against the reference's.

- decode_gray: bit-exact against cv2.imread and the reference's decoder;
- remap: bit-exact against the reference's (same code); within 1 grey level
  of cv2.remap on interior pixels (cv2 interpolates in fixed point);
- PrefetchPipeline: in order, bit-exact against cv2 (decode only) and
  against the reference's pipeline (with rectification maps too); it never
  deadlocks, with a consumer that only takes frames (the reference's copy
  can: a worker holding frame i + depth may claim frame i's slot first, so
  its pipeline is read here with one worker, which cannot overtake itself);
- the readers KittiOdometry, EurocStereo (with rect_from_settings and the
  IMU rows) and TumRgbd yield the same timestamps, frames and IMU rows as
  the reference's on fabricated small directories, with prefetch on and off
  (exact: the same decoders on the same files);
- the build writes under ms_slam_tpu_torch/_build only and changes no file
  of either csrc/ directory; without cv2, a PNG sequence still reads
  through the native pipeline.
"""
import os
import sys
import threading

import cv2
import numpy as np
import pytest
import torch

from ms_slam_tpu.utils import datasets as jdatasets
from ms_slam_tpu.utils import native as jnative
from ms_slam_tpu.utils.config import Settings as JSettings
from ms_slam_tpu_torch.examples.stereo_euroc import rectification
from ms_slam_tpu_torch.utils import datasets, native
from ms_slam_tpu_torch.utils.config import Settings

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _runtimes():
    """Both runtimes build with g++ and libpng/libjpeg; a host without
    them has no native runtime to test (the readers then use cv2)."""
    if not (native.available() and jnative.available()):
        pytest.skip(f"native runtime not built: {native._load()[1]}")


def _pngs(d, n, h, w, rng, color=False):
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        shape = (h, w, 3) if color else (h, w)
        p = os.path.join(d, f"{i:06d}.png")
        cv2.imwrite(p, rng.integers(0, 255, size=shape, dtype=np.uint8))
        paths.append(p)
    return paths


def test_decode_gray_matches_cv2_and_reference(tmp_path, rng):
    gray = _pngs(str(tmp_path / "g"), 1, 60, 80, rng)[0]
    color = _pngs(str(tmp_path / "c"), 1, 60, 80, rng, color=True)[0]
    jpg = str(tmp_path / "j.jpg")
    cv2.imwrite(jpg, rng.integers(0, 255, (60, 80), dtype=np.uint8))
    for p in (gray, jpg):
        got = native.decode_gray(p, 80, 60)
        np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(got, jnative.decode_gray(p, 80, 60))
    # RGB to grey by libpng: the reference's decoder bit for bit
    np.testing.assert_array_equal(native.decode_gray(color, 80, 60),
                                  jnative.decode_gray(color, 80, 60))
    with pytest.raises(IOError):
        native.decode_gray(str(tmp_path / "missing.png"), 80, 60)


def test_remap_matches_reference_and_cv2(rng):
    src = rng.integers(0, 255, size=(40, 50), dtype=np.uint8)
    mx, my = np.meshgrid(np.arange(50, dtype=np.float32),
                         np.arange(40, dtype=np.float32))
    mx = mx + rng.uniform(-2, 2, mx.shape).astype(np.float32)
    my = my + rng.uniform(-2, 2, my.shape).astype(np.float32)
    got = native.remap(src, mx, my)
    np.testing.assert_array_equal(got, jnative.remap(src, mx, my))
    ref = cv2.remap(src, mx, my, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT)
    inner = (mx >= 0) & (my >= 0) & (mx < 48) & (my < 38)
    diff = np.abs(ref.astype(int) - got.astype(int))[inner]
    assert diff.max() <= 1
    with pytest.raises(ValueError):
        native.remap(src, mx[:-1], my)


def test_pipeline_order_and_content(tmp_path, rng):
    pl = _pngs(str(tmp_path / "l"), 12, 60, 80, rng)
    pr = _pngs(str(tmp_path / "r"), 12, 60, 80, rng)
    pipe = native.PrefetchPipeline(pl, pr, width=80, height=60, depth=4,
                                   n_workers=3)
    jpipe = jnative.PrefetchPipeline(pl, pr, width=80, height=60, depth=4,
                                     n_workers=1)
    n = 0
    for (l, r), (jl, jr), a, b in zip(pipe, jpipe, pl, pr):
        np.testing.assert_array_equal(l, cv2.imread(a, cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(r, cv2.imread(b, cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_array_equal(r, jr)
        n += 1
    assert n == 12
    pipe.close()
    jpipe.close()
    # mono, with rectification maps: the reference's pipeline bit for bit
    maps = np.stack(np.meshgrid(np.arange(80, dtype=np.float32) + 0.4,
                                np.arange(60, dtype=np.float32) - 0.3) * 2)
    mono = list(native.PrefetchPipeline(pl, width=80, height=60,
                                        rect_maps=maps))
    jmono = list(jnative.PrefetchPipeline(pl, width=80, height=60,
                                          rect_maps=maps, n_workers=1))
    assert len(mono) == 12
    for a, b in zip(mono, jmono):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        native.PrefetchPipeline(pl, width=80, height=60,
                                rect_maps=maps[:, :-1])


@pytest.mark.parametrize("depth,n_workers", [(1, 4), (2, 4), (4, 3), (8, 4)])
def test_pipeline_never_deadlocks(tmp_path, rng, depth, n_workers):
    """A consumer that only takes frames outpaces decoding, which is when a
    worker holding frame i + depth could claim frame i's slot before frame
    i's worker wakes. Each trial runs in a daemon thread (ctypes releases
    the GIL) and must deliver all 12 frames within 10 s."""
    pl = _pngs(str(tmp_path / "l"), 12, 60, 80, rng)
    pr = _pngs(str(tmp_path / "r"), 12, 60, 80, rng)
    first = [cv2.imread(p, cv2.IMREAD_GRAYSCALE) for p in (pl[0], pr[0])]
    for trial in range(20):
        got = []

        def consume():
            pipe = native.PrefetchPipeline(pl, pr, width=80, height=60,
                                           depth=depth, n_workers=n_workers)
            got.extend(pipe)
            pipe.close()
        t = threading.Thread(target=consume, daemon=True)
        t.start()
        t.join(10.0)
        assert not t.is_alive(), (
            f"trial {trial}: stuck after {len(got)} of 12 frames")
        assert len(got) == 12
        np.testing.assert_array_equal(got[0][0], first[0])
        np.testing.assert_array_equal(got[0][1], first[1])


def test_vmrss():
    assert native.vmrss_mb() > 10


def test_build_writes_only_under_build_dir(tmp_path, monkeypatch):
    """A fresh build goes to the build directory (here redirected to
    tmp_path) and leaves both csrc/ directories untouched."""
    watched = [os.path.join(REPO, "csrc"),
               os.path.join(REPO, "ms_slam_tpu_torch", "csrc")]

    def stamp():
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
                for d in watched for f in sorted(os.listdir(d))}
    before = stamp()
    assert os.path.dirname(native._LIB) == native.BUILD_DIR == os.path.join(
        REPO, "ms_slam_tpu_torch", "_build")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_LIB", str(tmp_path / "b" / "lib.so"))
    lib = native._build()
    assert lib == str(tmp_path / "b" / "lib.so") and os.path.getsize(lib)
    assert os.listdir(tmp_path / "b") == ["lib.so"]     # no temporary left
    assert stamp() == before


def _kitti(root, rng, n=6, h=48, w=64):
    seq = os.path.join(root, "kitti")
    _pngs(os.path.join(seq, "image_0"), n, h, w, rng)
    _pngs(os.path.join(seq, "image_1"), n, h, w, rng)
    with open(os.path.join(seq, "times.txt"), "w") as f:
        f.write("\n".join(f"{0.1 * i:.6e}" for i in range(n)) + "\n")
    return seq


def _euroc(root, rng, n=4, h=480, w=752):
    """EuRoC layout at the EuRoC geometry, with 200 Hz IMU rows."""
    mav = os.path.join(root, "mav0")
    ts = [1403636579763555584 + 50_000_000 * i for i in range(n)]
    for cam in ("cam0", "cam1"):
        d = os.path.join(mav, cam, "data")
        os.makedirs(d)
        for t in ts:
            cv2.imwrite(os.path.join(d, f"{t}.png"),
                        rng.integers(0, 255, (h, w), dtype=np.uint8))
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n"
                    + "".join(f"{t},{t}.png\n" for t in ts))
    os.makedirs(os.path.join(mav, "imu0"))
    t_imu = np.arange(ts[0] - 20_000_000, ts[-1] + 10_000_000, 5_000_000)
    rows = rng.normal(size=(len(t_imu), 6))
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp,w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t, r in zip(t_imu, rows):
            f.write(f"{t}," + ",".join(f"{v:.9f}" for v in r) + "\n")
    return mav


def _same_frames(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.timestamp == b.timestamp
        assert a.left.dtype == b.left.dtype == np.float32
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)
        if b.imu is None:
            assert a.imu is None
        else:
            np.testing.assert_array_equal(a.imu, b.imu)


class _Spy:
    """Counts the port's PrefetchPipeline constructions."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = native.PrefetchPipeline
        spy = self

        class Counted(real):
            def __init__(self, *a, **k):
                spy.n += 1
                super().__init__(*a, **k)
        monkeypatch.setattr(native, "PrefetchPipeline", Counted)


@pytest.mark.parametrize("prefetch", [True, False])
def test_kitti_reader_matches_reference(tmp_path, rng, monkeypatch,
                                        prefetch):
    seq = _kitti(str(tmp_path), rng)
    spy = _Spy(monkeypatch)
    got = list(datasets.KittiOdometry(seq).frames(prefetch=prefetch))
    assert spy.n == int(prefetch)
    _same_frames(got, list(jdatasets.KittiOdometry(seq).frames(
        prefetch=prefetch)))
    pairs = list(datasets.with_lookahead(iter(got)))
    assert pairs[-1][1] is None
    np.testing.assert_array_equal(pairs[0][1][0], got[1].left)


@pytest.mark.parametrize("prefetch", [True, False])
def test_euroc_reader_matches_reference(tmp_path, rng, prefetch):
    """At the EuRoC geometry with configs/EuRoC.yaml's rectification, and
    the IMU rows between frames."""
    mav = _euroc(str(tmp_path), rng)
    cfg = os.path.join(REPO, "configs", "EuRoC.yaml")
    rect = rectification(Settings(cfg))
    jst = JSettings(cfg)
    jrect = {k: jst.flat[k] for k in ("K_l", "K_r", "D_l", "D_r", "R_l",
                                      "R_r", "P_l", "P_r")}
    jrect["rows"], jrect["cols"] = 480, 752
    got = datasets.EurocStereo(mav, rect_from_settings=rect, with_imu=True)
    ref = jdatasets.EurocStereo(mav, rect_from_settings=jrect, with_imu=True)
    assert len(got) == len(ref) == 4
    np.testing.assert_array_equal(got.imu, ref.imu)
    frames = list(got.frames(prefetch=prefetch))
    _same_frames(frames, list(ref.frames(prefetch=prefetch)))
    assert frames[0].imu is not None and len(frames[1].imu) == 10


@pytest.mark.parametrize("prefetch", [True, False])
def test_euroc_reader_without_rectification(tmp_path, rng, monkeypatch,
                                            prefetch):
    """Rectified input: the port decodes through the native pipeline (the
    reference through cv2) and yields the same frames."""
    mav = _euroc(str(tmp_path), rng, h=60, w=80)
    spy = _Spy(monkeypatch)
    got = list(datasets.EurocStereo(mav, with_imu=True).frames(
        prefetch=prefetch))
    assert spy.n == int(prefetch)
    _same_frames(got, list(jdatasets.EurocStereo(mav, with_imu=True).frames(
        prefetch=prefetch)))


def test_png_sequences_read_without_cv2(tmp_path, rng, monkeypatch):
    seq = _kitti(str(tmp_path), rng)
    mav = _euroc(str(tmp_path), rng, h=60, w=80)
    ref_k = list(datasets.KittiOdometry(seq).frames(prefetch=False))
    ref_e = list(datasets.EurocStereo(mav, with_imu=True).frames(
        prefetch=False))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        import cv2 as _  # noqa: F401
    _same_frames(list(datasets.KittiOdometry(seq).frames()), ref_k)
    _same_frames(list(datasets.EurocStereo(mav, with_imu=True).frames()),
                 ref_e)


def test_tum_rgbd_reader_matches_reference(tmp_path, rng):
    seq = tmp_path / "tum"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    rgb_lines, dep_lines = ["# rgb"], ["# depth"]
    for i in range(5):
        t = 1305031102.175304 + 0.0333 * i
        cv2.imwrite(str(seq / "rgb" / f"{i}.png"),
                    rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
        cv2.imwrite(str(seq / "depth" / f"{i}.png"),
                    rng.integers(0, 40000, (48, 64), dtype=np.uint16))
        rgb_lines.append(f"{t:.6f} rgb/{i}.png")
        # one depth frame too far in time to associate
        dt = 0.005 if i != 3 else 0.03
        dep_lines.append(f"{t + dt:.6f} depth/{i}.png")
    (seq / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (seq / "depth.txt").write_text("\n".join(dep_lines) + "\n")
    got = datasets.TumRgbd(str(seq))
    ref = jdatasets.TumRgbd(str(seq))
    assert got.pairs == ref.pairs and len(got) == 4
    for (ta, ia, da), (tb, ib, db) in zip(got, ref):
        assert ta == tb
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(da, db)
        assert da.dtype == np.float32
