"""Parity of the port's ORB extraction and patch gather with the reference.

Tolerances and why:
- canvas: within 1e-3 grey levels. Both sides apply the same antialiased
  bilinear weights (JAX's formula), but sum the 2-3 nonzero taps in
  different orders, so levels > 0 differ by float32 rounding (~3e-5).
- patch gather: bit-exact (a copy). The plain version is held against the
  reference's vmapped dynamic_slice and against its Pallas kernel run in
  interpret mode on an f32 canvas (the route tests/test_orb.py:110 takes),
  with centres on and beyond all four clip edges.
- full `extract`: >= 99% of keypoints at identical positions and octaves,
  level 0 identical; on those keypoints descriptor Hamming distance median
  0 and <= 4 on >= 99%, angle error <= 1e-3 rad on >= 99%. The image is
  test_orb.py's mondrian with sensor noise (sigma 4 grey levels): on a
  noise-free piecewise-constant image the 3x3 NMS sees exact plateaus of
  equal FAST scores on the coarser levels, and a one-ulp resize difference
  decides which corner of a plateau survives (measured ~97-99% identical
  there, level 0 still identical).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import orb as jorb
from ms_slam_tpu_torch.ops import _native
from ms_slam_tpu_torch.ops import orb as torb
from test_orb import mondrian

# the gather's f32 entry point: its launches in _native.calls
F32 = "msslam_patch_gather_f32"

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

CFG_J = jorb.OrbConfig(n_features=512, n_levels=4)
CFG_T = torb.OrbConfig(*CFG_J)


def noisy_mondrian(rng):
    img = mondrian(rng)
    return (img + rng.normal(0, 4.0, img.shape)).astype(np.float32)


def test_canvas_layout_matches():
    for h, w in ((240, 320), (384, 1248)):
        for cfg in (CFG_T, torb.OrbConfig()):
            assert torb.canvas_layout(h, w, cfg) == jorb.canvas_layout(
                h, w, jorb.OrbConfig(*cfg))


def test_build_canvas(rng):
    imgs = np.stack([noisy_mondrian(rng) for _ in range(2)])
    cj = np.asarray(jorb.build_canvas_multi(jnp.asarray(imgs), CFG_J))
    ct = torb.build_canvas_multi(torch.from_numpy(imgs), CFG_T).numpy()
    assert cj.shape == ct.shape and cj.dtype == ct.dtype == np.float32
    W = imgs.shape[2]
    np.testing.assert_array_equal(ct[:, :, :W], cj[:, :, :W])   # level 0
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-3)


def _gather_inputs(rng, B=2, H=240, n=64):
    _, Wc, _ = jorb.canvas_layout(H, 320, CFG_J)
    canvas = rng.uniform(0, 255, (B, H, Wc)).astype(np.float32)
    ys = rng.integers(-6, H + 6, B * n).astype(np.int32)
    xs = rng.integers(-6, Wc + 6, B * n).astype(np.int32)
    # centres beyond each clip edge: top, bottom, left, right, corners
    ys[:6] = [0, H - 1, 100, 120, -4, H + 3]
    xs[:6] = [50, 60, 0, Wc - 1, -2, Wc + 5]
    bi = np.repeat(np.arange(B, dtype=np.int32), n)
    return canvas, bi, ys, xs


def test_patch_gather_plain_vs_dynamic_slice(rng):
    # lax.dynamic_slice reads a negative start as counted from the far end
    # (then clamps), so below R the reference's two gathers disagree; the
    # port follows the Pallas kernel's clip. Detected keypoints never come
    # closer than R+1 to a canvas edge, so compare that path from the
    # low clip edge (exactly R) upward and beyond the high edges.
    canvas, bi, ys, xs = _gather_inputs(rng)
    R = torb.EXTRACT_R
    ys, xs = np.maximum(ys, R), np.maximum(xs, R)
    ys[:2], xs[2:4] = R, R
    ref = np.asarray(jorb.extract_patches_canvas(
        jnp.asarray(canvas), jnp.asarray(bi), jnp.asarray(ys), jnp.asarray(xs)))
    args = [torch.from_numpy(a) for a in (canvas, bi, ys, xs)]
    np.testing.assert_array_equal(
        torb.extract_patches_canvas_plain(*args).numpy(), ref)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = _native.calls[F32]
    np.testing.assert_array_equal(torb.extract_patches_canvas(*args).numpy(),
                                  ref)
    assert _native.calls[F32] == before


def test_patch_gather_plain_vs_pallas_interpret(rng):
    canvas, bi, ys, xs = _gather_inputs(rng, n=40)
    ref = np.asarray(jorb.extract_patches_canvas_pallas(
        jnp.asarray(canvas), jnp.asarray(ys), jnp.asarray(xs)))
    out = torb.extract_patches_canvas_plain(
        *[torch.from_numpy(a) for a in (canvas, bi, ys, xs)]).numpy()
    assert out.shape == ref.shape == (len(ys), 45, 45)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_parity(seed):
    rng = np.random.default_rng(seed)
    img = noisy_mondrian(rng)
    fj = jorb.extract(jnp.asarray(img), CFG_J)
    ft = torb.extract(torch.from_numpy(img), CFG_T)
    xy_j, xy_t = np.asarray(fj.xy), ft.xy.numpy()
    oc_j, oc_t = np.asarray(fj.octave), ft.octave.numpy()
    v_j, v_t = np.asarray(fj.valid), ft.valid.numpy()
    assert v_j.sum() > 300

    def keys(xy, oc, v):
        return {(float(x), float(y), int(o)): i
                for i, ((x, y), o, ok) in enumerate(zip(xy, oc, v)) if ok}

    kj, kt = keys(xy_j, oc_j, v_j), keys(xy_t, oc_t, v_t)
    common = sorted(set(kj) & set(kt))
    assert len(common) >= 0.99 * len(kj), (len(common), len(kj))
    lvl0 = [k for k in kj if k[2] == 0]
    assert all(k in kt for k in lvl0)

    ij = np.asarray([kj[k] for k in common])
    it = np.asarray([kt[k] for k in common])
    dj = np.asarray(fj.desc)[ij]
    dt = ft.desc.numpy()[it].view(np.uint32)
    ham = np.unpackbits(np.bitwise_xor(dj, dt).view(np.uint8), axis=1).sum(1)
    assert np.median(ham) == 0
    assert (ham <= 4).mean() >= 0.99, np.sort(ham)[-10:]
    dang = np.abs(np.asarray(fj.angle)[ij] - ft.angle.numpy()[it])
    dang = np.minimum(dang, 2 * np.pi - dang)
    assert (dang <= 1e-3).mean() >= 0.99
    np.testing.assert_allclose(ft.response.numpy()[it],
                               np.asarray(fj.response)[ij], atol=1e-3)


def test_descriptor_bits_single_bin_equal_einsum(rng):
    """The single-bin pair difference gives the reference einsum's bits
    (on identical patches and angles, including every angle bin)."""
    patches = rng.uniform(0, 255, (90, 45, 45)).astype(np.float32)
    angle = np.linspace(-np.pi, np.pi, 90, dtype=np.float32)
    dj = np.asarray(jorb.descriptors_from_patches(jnp.asarray(patches),
                                                  jnp.asarray(angle)))
    dt = torb.descriptors_from_patches(torch.from_numpy(patches),
                                       torch.from_numpy(angle)).numpy()
    ham = np.unpackbits(np.bitwise_xor(dj, dt.view(np.uint32)).view(np.uint8),
                        axis=1).sum(1)
    # a bit may differ only where the two bf16-rounded blurred values tie
    # after a last-ulp blur difference
    assert np.median(ham) == 0 and ham.max() <= 2, ham.max()


def test_pack_bits_matches(rng):
    bits = rng.integers(0, 2, size=(32, 256)).astype(bool)
    pj = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    pt = torb.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(pt.view(np.uint32), pj)
