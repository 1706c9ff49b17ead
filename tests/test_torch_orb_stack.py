"""Parity of the port's padded-stack ORB extractor, the stack and list
stereo matchers, the per-cell detection branch and the small ORB leaves
with the reference.

Tolerances and why:
- on the same input arrays (the reference's stack or canvas handed to
  both): detection's planes, rows, columns, scores and valid flags exact;
  the patch gather exact (a copy through the same clamp); FAST scores
  exact; unpack_bits exact;
- the pyramid stack: level 0 exact, the others within 1e-3 grey levels
  (the same antialiased bilinear weights summed in another order, ~3e-5);
- the whole `extract_stack_multi` from the image: as tests/
  test_torch_orb.py holds the canvas path, >= 99% of keypoints at
  identical positions and octaves, level 0 identical, descriptor Hamming
  distance median 0 and <= 4 on >= 99%: a one-ulp resize difference can
  move a corner on a plateau of equal FAST scores;
- both stereo matchers on the same features and planes: the same matched
  set, u_right within 1e-3 px and depth within 5e-5 relative (the SAD
  means and the parabola fit in float32, ordered differently; measured
  1.4e-4 px and 1.0e-5).
"""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import orb as jorb
from ms_slam_tpu.ops import stereo as jst
from ms_slam_tpu_torch.ops import _native
from ms_slam_tpu_torch.ops import orb as torb
from ms_slam_tpu_torch.ops import stereo as tst
from ms_slam_tpu_torch.utils import synth

# the calls that took the gather's plain version, in _native.calls
PLAIN = "extract_patches_canvas"

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BL = 240, 320, 260.0, 0.15
CJ = jorb.OrbConfig(n_features=512, n_levels=4)
CT = torb.OrbConfig(*CJ)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    """A stereo pair of the arc scene, float32 (2, H, W)."""
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    Tw = synth.make_trajectory(30, "arc")[3]
    return np.stack([np.clip(im, 0, 255).astype(np.float32)
                     for im in world.render_stereo(K, Tw, BL, H, W)])


@pytest.fixture(scope="module")
def ref_stack(pair):
    fj, sj, _ = jorb.extract_stack_multi(jnp.asarray(pair), CJ)
    return fj, np.array(sj)


def test_build_pyramid_stack(pair):
    sj, shapes_j = jorb.build_pyramid_stack_multi(jnp.asarray(pair), CJ)
    st, shapes_t = torb.build_pyramid_stack_multi(T(pair), CT)
    assert shapes_t == shapes_j and st.shape == sj.shape
    sj = np.asarray(sj)
    np.testing.assert_array_equal(st.numpy()[::CJ.n_levels],
                                  sj[::CJ.n_levels])
    np.testing.assert_allclose(st.numpy(), sj, atol=1e-3)
    one_j, _ = jorb.build_pyramid_stack(jnp.asarray(pair[0]), CJ)
    one_t, _ = torb.build_pyramid_stack(T(pair[0]), CT)
    np.testing.assert_allclose(one_t.numpy(), np.asarray(one_j), atol=1e-3)
    np.testing.assert_array_equal(
        torb._level_masks(H, W, CT), jorb._level_masks(H, W, CJ))


def test_detect_stack_exact(pair):
    stack = np.array(jorb.build_pyramid_stack_multi(jnp.asarray(pair),
                                                    CJ)[0])
    dj = jorb.detect_stack(jnp.asarray(stack), CJ, n_images=2)
    dt = torb.detect_stack(T(stack), CT, n_images=2)
    for name, a, b in zip(("plane", "y", "x", "score", "valid"), dj, dt):
        assert b.numpy().dtype == np.asarray(a).dtype, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(dt[4].sum()) > 500


def test_extract_patches_exact(pair):
    stack = np.array(jorb.build_pyramid_stack_multi(jnp.asarray(pair),
                                                    CJ)[0])
    lv, ys, xs, _, _ = (np.asarray(a) for a in jorb.detect_stack(
        jnp.asarray(stack), CJ, n_images=2))
    # and centres on the low clip edge and on and beyond the high ones
    # (below R, lax.dynamic_slice reads a negative start as counted from the
    # far end; detection never comes closer than R + 1 to a plane's edge,
    # tests/test_torch_orb.py::test_patch_gather_plain_vs_dynamic_slice)
    R = torb.EXTRACT_R
    lv = np.concatenate([lv, [0, 7, 3, 5]]).astype(np.int32)
    ys = np.concatenate([ys, [R, H + 3, R, H - 1]]).astype(np.int32)
    xs = np.concatenate([xs, [W + 9, R, R, W - 1]]).astype(np.int32)
    pj = np.asarray(jorb.extract_patches(jnp.asarray(stack), jnp.asarray(lv),
                                         jnp.asarray(ys), jnp.asarray(xs)))
    before = _native.calls[PLAIN]
    pt = torb.extract_patches(T(stack), T(lv), T(ys), T(xs)).numpy()
    assert _native.calls[PLAIN] == before + 1
    np.testing.assert_array_equal(pt, pj)


def test_extract_stack_multi(pair, ref_stack):
    fj, sj = ref_stack
    ft, st, none = torb.extract_stack_multi(T(pair), CT)
    assert none is None and st.shape == sj.shape
    for b in range(2):
        xy_j, xy_t = np.asarray(fj.xy[b]), ft.xy[b].numpy()
        oc_j, oc_t = np.asarray(fj.octave[b]), ft.octave[b].numpy()
        kj = {(float(x), float(y), int(o)): i for i, ((x, y), o, ok) in
              enumerate(zip(xy_j, oc_j, np.asarray(fj.valid[b]))) if ok}
        kt = {(float(x), float(y), int(o)): i for i, ((x, y), o, ok) in
              enumerate(zip(xy_t, oc_t, ft.valid[b].numpy())) if ok}
        common = sorted(set(kj) & set(kt))
        assert len(common) >= 0.99 * len(kj) and len(kj) > 400
        assert all(k in kt for k in kj if k[2] == 0)
        ij = [kj[k] for k in common]
        it = [kt[k] for k in common]
        dj = np.asarray(fj.desc[b])[ij]
        dt = ft.desc[b].numpy()[it].view(np.uint32)
        ham = np.unpackbits(np.bitwise_xor(dj, dt).view(np.uint8),
                            axis=1).sum(1)
        assert np.median(ham) == 0 and (ham <= 4).mean() >= 0.99
    one, st1, _ = torb.extract_stack(T(pair[0]), CT)
    np.testing.assert_array_equal(one.xy.numpy(), ft.xy[0].numpy())
    np.testing.assert_array_equal(st1.numpy(), st[0].numpy())


def _features(fj):
    ft = torb.Features(*[T(np.asarray(a)) for a in fj])
    ft = ft._replace(desc=T(np.asarray(fj.desc).view(np.int32)))
    return ([jorb.Features(*[a[b] for a in fj]) for b in range(2)],
            [torb.Features(*[a[b] for a in ft]) for b in range(2)])


def _assert_match(mt, mj):
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    np.testing.assert_allclose(mt.u_right.numpy(), np.asarray(mj.u_right),
                               atol=1e-3)
    np.testing.assert_allclose(mt.depth.numpy(), np.asarray(mj.depth),
                               rtol=5e-5)
    assert int(mt.valid.sum()) > 300


def test_match_stereo_stack(ref_stack):
    fj, sj = ref_stack
    FJ, FT = _features(fj)
    args = (FX * BL, 0.5)
    mj = jst.match_stereo_stack(FJ[0], FJ[1], jnp.asarray(sj[0]),
                                jnp.asarray(sj[1]), *args, CJ)
    mt = tst.match_stereo_stack(FT[0], FT[1], T(sj[0]), T(sj[1]), *args, CT)
    _assert_match(mt, mj)


def test_match_stereo_level_lists(ref_stack):
    fj, sj = ref_stack
    FJ, FT = _features(fj)
    shapes = jorb.pyramid_shapes(H, W, CJ)
    lev = [[sj[i, l, :h, :w] for l, (h, w) in enumerate(shapes)]
           for i in range(2)]
    args = (FX * BL, 0.5)
    mj = jst.match_stereo(FJ[0], FJ[1], [jnp.asarray(a) for a in lev[0]],
                          [jnp.asarray(a) for a in lev[1]], *args, CJ)
    mt = tst.match_stereo(FT[0], FT[1], [T(a) for a in lev[0]],
                          [T(a) for a in lev[1]], *args, CT)
    _assert_match(mt, mj)


def test_fast_score_and_nms(rng):
    img = (rng.random((60, 80)) * 255).astype(np.float32)
    for th in (7.0, 20.0):
        sj = np.asarray(jorb.fast_score(jnp.asarray(img), th))
        st = torb.fast_score(T(img), th).numpy()
        np.testing.assert_array_equal(st, sj)
        np.testing.assert_array_equal(torb._nms3(T(sj)).numpy(),
                                      np.asarray(jorb._nms3(jnp.asarray(sj))))
    for r in (3, 15):
        for a, b in zip(torb._circular_offsets(r), jorb._circular_offsets(r)):
            np.testing.assert_array_equal(a, b)


def test_unpack_bits(rng):
    words = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
    bj = np.asarray(jorb.unpack_bits(jnp.asarray(words)))
    bt = torb.unpack_bits(T(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(
        torb.pack_bits(torch.from_numpy(bt)).numpy().view(np.uint32), words)


@pytest.mark.parametrize("case", ["no_subblock", "cell_20"])
def test_detect_canvas_per_cell_branch(pair, monkeypatch, case):
    """detect_canvas's per-cell top-k: under MSSLAM_NO_SUBBLOCK=1, and with
    a 20-pixel cell (not a multiple of 8), on the reference's canvas."""
    if case == "no_subblock":
        monkeypatch.setenv("MSSLAM_NO_SUBBLOCK", "1")
        cj = CJ
    else:
        monkeypatch.delenv("MSSLAM_NO_SUBBLOCK", raising=False)
        cj = CJ._replace(cell_size=20)
    canvas = np.array(jorb.build_canvas_multi(jnp.asarray(pair), cj))
    dj = jorb.detect_canvas(jnp.asarray(canvas), W, cj)
    dt = torb.detect_canvas(T(canvas), W, torb.OrbConfig(*cj))
    for name, a, b in zip(("level", "y", "x", "score", "valid"), dj, dt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(dt[4].sum()) > 900


def test_patch_gather_counted_from_many_threads():
    """Threads extract at once, as the prefetch worker and the main thread
    do: the counter of the plain version's calls (the CPU twin of the
    kernel's launch counter, under the same lock) sees every call. More
    threads than cores and a short switch interval give an unlocked
    read-modify-write its chances to lose an update."""
    rng = np.random.default_rng(3)
    canvas = T(rng.uniform(0, 255, (2, 64, 128)).astype(np.float32))
    bi, ys, xs = (T(a.astype(np.int32)) for a in (
        np.array([0, 1, 1, 0]), rng.integers(0, 64, 4),
        rng.integers(0, 128, 4)))
    ref = torb.extract_patches_canvas(canvas, bi, ys, xs)
    n_threads, n_calls = 16, 200
    before = _native.calls[PLAIN]
    errors = []

    def work():
        for _ in range(n_calls):
            if not torch.equal(torb.extract_patches_canvas(canvas, bi, ys,
                                                           xs), ref):
                errors.append("patches differ")

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert _native.calls[PLAIN] == before + n_threads * n_calls
