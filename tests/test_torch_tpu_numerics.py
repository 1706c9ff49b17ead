"""The reference's TPU numerics (MSSLAM_FORCE_TPU_NUMERICS=1) in the port:
the bf16 canvas through FAST, the patch gather and the stereo SAD windows.

Under the switch the reference casts its f32 pyramid canvas to bfloat16
(ms_slam_tpu/ops/orb.py:743-744), scores FAST on it, gathers the patches
with its Pallas kernel (which widens to f32) and reads the SAD windows
from it (stereo.py:158-163). The port does the same on the switch.

The reference reads the switch when a function is traced, and `jax.jit`
does not key its cache on the environment, so the `tpu_numerics` fixture
clears JAX's caches before it sets the switch and after it unsets it.
The reference's interpreted Pallas kernel costs ~16 s for 512 keypoints,
so it runs here at the kernel level only (40 keypoints), where it is held
bit for bit against the reference's plain gather; every larger reference
call takes that plain gather instead (installed by monkeypatch; no file of
the reference changes).

Tolerances and why:
- patch gather, FAST scores, detection on one bf16 canvas: bit-exact (a
  widening copy; the same bf16 arithmetic; the same integer packing);
- `extract_canvas_multi`: test_torch_orb.py::test_extract_parity's bars.
  The two packages' f32 canvases differ by float32 rounding (~3e-5), and
  one such difference can round to a neighbouring bf16 value (1.0 apart at
  128-255), so the canvases are not bit-equal;
- `process_stereo_stacked`: test_torch_frontend.py's bars from one f32
  canvas; from each package's own canvas the same bars on >= 99% of the
  matched slots (a slot whose SAD window reads a value one bf16 step apart
  moves by a few thousandths of a pixel; see the test);
- the switch unset: the f32 path bit for bit.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import orb as jorb
from ms_slam_tpu.pipeline import frontend as jfe
from ms_slam_tpu_torch.ops import _native
from ms_slam_tpu_torch.ops import orb as torb
from ms_slam_tpu_torch.pipeline import frontend as tfe
from test_torch_frontend import BASELINE, FX, H, W, _pair
from test_torch_orb import CFG_J, CFG_T, noisy_mondrian

# the calls that took the gather's plain version, in _native.calls
PLAIN = "extract_patches_canvas"

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

FLAG = "MSSLAM_FORCE_TPU_NUMERICS"
R = torb.EXTRACT_R


def _reference_plain_pallas(canvas, ys, xs, block=128):
    """The reference's plain gather in the Pallas kernel's place: image-major
    keypoints, f32 patches (held equal to the kernel below)."""
    del block
    B = canvas.shape[0]
    bi = jnp.repeat(jnp.arange(B, dtype=jnp.int32), ys.shape[0] // B)
    return jorb.extract_patches_canvas(canvas, bi, ys, xs).astype(jnp.float32)


@pytest.fixture
def tpu_numerics(monkeypatch):
    """The switch set for both packages, the reference's Pallas kernel
    replaced by its plain gather, JAX's traces dropped on both sides."""
    jax.clear_caches()
    monkeypatch.setenv(FLAG, "1")
    monkeypatch.setattr(jorb, "extract_patches_canvas_pallas",
                        _reference_plain_pallas)
    yield
    monkeypatch.undo()
    jax.clear_caches()


@pytest.mark.parametrize("value,on", [("1", True), ("0", False),
                                      ("true", False), (None, False)])
def test_switch_is_read_on_each_call(monkeypatch, value, on):
    """The reference's rule, `== "1"`, read when called."""
    if value is None:
        monkeypatch.delenv(FLAG, raising=False)
    else:
        monkeypatch.setenv(FLAG, value)
    assert torb._tpu_numerics() is on
    assert jorb._tpu_numerics() is on          # the CPU backend: no TPU clause


def _bf16_gather_inputs():
    """A (2, 64, 256) bf16 canvas (the Pallas kernel's aligned shape) and 40
    keypoints, image-major, with centres at the low clip edge (exactly R),
    on the high edges and beyond them. Below R the reference's
    dynamic_slice wraps where its kernel and the port clip; detection never
    goes there."""
    rng = np.random.default_rng(5)
    B, Hc, Wc, n = 2, 64, 256, 20
    canvas = rng.uniform(0, 255, (B, Hc, Wc)).astype(np.float32)
    ys = rng.integers(R, Hc + 6, B * n).astype(np.int32)
    xs = rng.integers(R, Wc + 6, B * n).astype(np.int32)
    ys[:6] = [R, R, Hc - R - 1, Hc - 1, 30, Hc + 4]
    xs[:6] = [R, 100, R, Wc - R - 1, Wc - 1, Wc + 3]
    ys[n:n + 2], xs[n:n + 2] = [R, Hc + 2], [Wc + 2, R]
    bi = np.repeat(np.arange(B, dtype=np.int32), n)
    return jnp.asarray(canvas).astype(jnp.bfloat16), bi, ys, xs


@pytest.fixture(scope="module")
def bf16_gather():
    canvas, bi, ys, xs = _bf16_gather_inputs()
    pallas = np.asarray(jorb.extract_patches_canvas_pallas(
        canvas, jnp.asarray(ys), jnp.asarray(xs)))
    plain = np.asarray(jorb.extract_patches_canvas(
        canvas, jnp.asarray(bi), jnp.asarray(ys), jnp.asarray(xs))
        .astype(jnp.float32))
    canvas_t = torch.from_numpy(np.array(canvas.astype(jnp.float32))).to(
        torch.bfloat16)
    return {"pallas": pallas, "plain": plain,
            "args": (canvas_t, *[torch.from_numpy(a) for a in (bi, ys, xs)])}


def test_patch_gather_bf16_vs_interpreted_pallas(bf16_gather):
    """The port's gather of a bf16 canvas (the wrapper on CPU tensors: the
    plain version, widened) against the reference's Pallas kernel, run
    interpreted on the input it is given on its chip."""
    before = _native.calls[PLAIN]
    out = torb.extract_patches_canvas(*bf16_gather["args"])
    assert _native.calls[PLAIN] == before + 1
    assert out.dtype == torch.float32 and out.shape == (40, 45, 45)
    assert bf16_gather["pallas"].dtype == np.float32
    np.testing.assert_array_equal(out.numpy(), bf16_gather["pallas"])


def test_reference_plain_gather_equals_its_kernel(bf16_gather):
    """What licenses the monkeypatch of the larger tests: the reference's
    plain gather, widened, is its Pallas kernel bit for bit; and the port's
    plain version gives the same."""
    np.testing.assert_array_equal(bf16_gather["plain"], bf16_gather["pallas"])
    out = torb.extract_patches_canvas_plain(*bf16_gather["args"])
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), bf16_gather["plain"])


@pytest.mark.parametrize("shape", [(1, 64, 96), (3, 40, 72)])
def test_fast_score_on_bf16_bit_exact(shape):
    """FAST-9 on a bf16 plane, against the reference's jitted scorer on the
    same plane (scoring the plane widened to f32 differs on ~6% of
    pixels, by up to 0.5)."""
    plane = np.random.default_rng(2).uniform(0, 255, shape).astype(np.float32)
    pj = jnp.asarray(plane).astype(jnp.bfloat16)
    sj = jax.jit(jorb.fast_score_batched, static_argnums=1)(pj, 7.0)
    st = torb.fast_score_batched(
        torch.from_numpy(np.asarray(pj.astype(jnp.float32))).to(
            torch.bfloat16), 7.0)
    assert st.dtype == torch.bfloat16 and sj.dtype == jnp.bfloat16
    np.testing.assert_array_equal(st.float().numpy(),
                                  np.asarray(sj.astype(jnp.float32)))


def test_detect_canvas_on_bf16_canvas():
    """Level, row, canvas column, score and validity on one bf16 canvas, as
    the reference gives them (scored in bf16, ranked in f32)."""
    img = noisy_mondrian(np.random.default_rng(0))
    cj = jorb.build_canvas_multi(jnp.asarray(img)[None], CFG_J).astype(
        jnp.bfloat16)
    ct = torch.from_numpy(np.array(cj.astype(jnp.float32))).to(
        torch.bfloat16)
    dj = jorb.detect_canvas(cj, img.shape[1], CFG_J)
    dt = torb.detect_canvas(ct, img.shape[1], CFG_T)
    for name, a, b in zip(("level", "y", "x", "score", "valid"), dj, dt):
        assert b.dtype != torch.bfloat16, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(dt[4].sum()) > 300


def _keys(xy, oc, v):
    return {(float(x), float(y), int(o)): i
            for i, ((x, y), o, ok) in enumerate(zip(xy, oc, v)) if ok}


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_canvas_multi_parity(tpu_numerics, seed):
    """Both packages' whole extraction under the switch, at
    test_extract_parity's bars; both return the bf16 canvas."""
    img = noisy_mondrian(np.random.default_rng(seed))
    fj, cj = jorb.extract_canvas_multi(jnp.asarray(img)[None], CFG_J)
    ft, ct = torb.extract_canvas_multi(torch.from_numpy(img)[None], CFG_T)
    assert cj.dtype == jnp.bfloat16 and ct.dtype == torch.bfloat16
    xy_j, xy_t = np.asarray(fj.xy[0]), ft.xy[0].numpy()
    oc_j, oc_t = np.asarray(fj.octave[0]), ft.octave[0].numpy()
    v_j, v_t = np.asarray(fj.valid[0]), ft.valid[0].numpy()
    assert v_j.sum() > 300
    kj, kt = _keys(xy_j, oc_j, v_j), _keys(xy_t, oc_t, v_t)
    common = sorted(set(kj) & set(kt))
    assert len(common) >= 0.99 * len(kj), (len(common), len(kj))
    assert all(k in kt for k in kj if k[2] == 0)

    ij = np.asarray([kj[k] for k in common])
    it = np.asarray([kt[k] for k in common])
    dj = np.asarray(fj.desc[0])[ij]
    dt = ft.desc[0].numpy()[it].view(np.uint32)
    ham = np.unpackbits(np.bitwise_xor(dj, dt).view(np.uint8), axis=1).sum(1)
    assert np.median(ham) == 0
    assert (ham <= 4).mean() >= 0.99, np.sort(ham)[-10:]
    dang = np.abs(np.asarray(fj.angle[0])[ij] - ft.angle[0].numpy()[it])
    dang = np.minimum(dang, 2 * np.pi - dang)
    assert (dang <= 1e-3).mean() >= 0.99
    np.testing.assert_allclose(ft.response[0].numpy()[it],
                               np.asarray(fj.response[0])[ij], atol=1e-3)


def test_canvas_is_f32_without_the_switch(monkeypatch):
    monkeypatch.delenv(FLAG, raising=False)
    img = noisy_mondrian(np.random.default_rng(0))[:96, :128]
    cfg = jorb.OrbConfig(n_features=64, n_levels=2)
    _, cj = jorb.extract_canvas_multi(jnp.asarray(img)[None], cfg)
    _, ct = torb.extract_canvas_multi(torch.from_numpy(img)[None],
                                      torb.OrbConfig(*cfg))
    assert cj.dtype == jnp.float32 and ct.dtype == torch.float32


def _f32_extract(imgs, cfg):
    """extract_canvas_multi as it was before the switch was read: the f32
    canvas, detection, the plain gather, orientation and BRIEF."""
    B, h, w = imgs.shape
    offs, _, _ = torb.canvas_layout(h, w, cfg)
    canvas = torb.build_canvas_multi(imgs, cfg).contiguous()
    lv, ys, xs, sc, va = torb.detect_canvas(canvas, w, cfg)
    n = cfg.n_features
    bi = torch.arange(B, dtype=torch.int32)[:, None].expand(B, n).reshape(-1)
    patches = torb.extract_patches_canvas_plain(
        canvas, bi, ys.reshape(-1).to(torch.int32),
        xs.reshape(-1).to(torch.int32))
    ang = torb.orientation_from_patches(patches)
    desc = torb.descriptors_from_patches(patches, ang)
    scales = torch.tensor(cfg.level_scales(), dtype=torch.float32)
    x_lvl = (xs - torch.tensor(offs, dtype=torch.int64)[lv]).to(torch.float32)
    xy0 = (torch.stack([x_lvl, ys.to(torch.float32)], -1)
           * scales[lv][..., None])
    return torb.Features(xy=xy0, response=sc, angle=ang.reshape(B, n),
                         octave=lv, desc=desc.reshape(B, n, 8),
                         valid=va), canvas


@pytest.mark.parametrize("value", [None, "0"])
def test_switch_off_is_the_f32_path_bit_for_bit(monkeypatch, value):
    """Unset (or anything but "1"), extraction and the stereo frontend give
    the f32 path's outputs bit for bit."""
    if value is None:
        monkeypatch.delenv(FLAG, raising=False)
    else:
        monkeypatch.setenv(FLAG, value)
    imgs = torch.from_numpy(np.stack(
        [noisy_mondrian(np.random.default_rng(s)) for s in (0, 1)]))
    got, canvas = torb.extract_canvas_multi(imgs, CFG_T)
    want, canvas0 = _f32_extract(imgs, CFG_T)
    assert torch.equal(canvas, canvas0)
    for name, a, b in zip(torb.Features._fields, got, want):
        assert torch.equal(a, b), name

    l, r = _pair()
    calib = tfe.Calib(model=0, params=(FX, FX, W / 2, H / 2),
                      bf=FX * BASELINE, width=W, height=H, th_depth=6.0)
    orb_cfg = torb.OrbConfig(n_features=256, n_levels=4)
    pair = torch.from_numpy(np.stack([l, r]))
    got = tfe.process_stereo_stacked(pair, calib, orb_cfg)
    monkeypatch.setattr(torb, "extract_canvas_multi", _f32_extract)
    want = tfe.process_stereo_stacked(pair, calib, orb_cfg)
    for name, a, b in zip(("feats", "u_right", "depth", "sigma2"), got, want):
        for x, y in zip(a if name == "feats" else [a],
                        b if name == "feats" else [b]):
            assert torch.equal(x, y), name


def _stereo_frontends(monkeypatch, same_canvas):
    """process_stereo_stacked of both packages on one rendered pair (the
    reference jitted, as its System runs it); with same_canvas the port's
    pyramid is replaced by the reference's f32 canvas, so both cast the
    same values to bf16."""
    l, r = _pair()
    cj = jfe.Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                   width=W, height=H, th_depth=6.0)
    oj = jorb.OrbConfig(n_features=256, n_levels=4)
    pair = np.stack([l, r])
    if same_canvas:
        monkeypatch.setattr(torb, "build_canvas_multi", lambda imgs, cfg:
                            torch.from_numpy(np.array(jorb.build_canvas_multi(
                                jnp.asarray(imgs.numpy()), oj))))
    fj = jfe.process_stereo_stacked(jnp.asarray(pair), cj, oj)
    ft = tfe.process_stereo_stacked(torch.from_numpy(pair), tfe.Calib(*cj),
                                    torb.OrbConfig(*oj))
    same = ((np.asarray(fj.feats.xy) == ft.feats.xy.numpy()).all(1)
            & (np.asarray(fj.feats.octave) == ft.feats.octave.numpy())
            & (np.asarray(fj.feats.valid) == ft.feats.valid.numpy()))
    assert same.mean() >= 0.99, same.mean()
    mj = np.asarray(fj.depth) > 0
    mt = ft.depth.numpy() > 0
    assert mj.sum() > 100
    assert (mj != mt).mean() <= 0.01, (mj != mt).sum()
    both = mj & mt & same
    return {name: (getattr(ft, name).numpy()[both],
                   np.asarray(getattr(fj, name))[both])
            for name in ("u_right", "depth")}


def test_process_stereo_stacked_parity_same_canvas(tpu_numerics,
                                                   monkeypatch):
    """The stereo frontend under the switch from one f32 canvas, both
    packages, at test_torch_frontend.py's bars: >= 99% of keypoints
    identical, matched sets differing on <= 1% of slots, u_right and depth
    within 1e-3 relative where both match. The SAD windows are gathered
    from the bf16 canvases and widened first."""
    for name, (t, j) in _stereo_frontends(monkeypatch, True).items():
        np.testing.assert_allclose(t, j, rtol=1e-3, err_msg=name)


def test_process_stereo_stacked_parity_own_canvases(tpu_numerics,
                                                    monkeypatch):
    """The same, each package from its own pyramid. The two f32 canvases
    differ by float32 rounding (~3e-5), which moves 10 of this pair's
    344,064 canvas values to the neighbouring bf16 value; a match whose SAD
    window reads one of them moves by a few thousandths of a pixel (one
    slot of 239 here: depth 1.2e-3 relative; given the reference's canvas
    the port's matcher is within 4e-6). So the 1e-3 bar holds on >= 99% of
    the slots both match, and every slot stays within 1e-2."""
    for name, (t, j) in _stereo_frontends(monkeypatch, False).items():
        rel = np.abs(t - j) / np.abs(j)
        assert (rel <= 1e-3).mean() >= 0.99, (name, np.sort(rel)[-5:])
        assert rel.max() <= 1e-2, (name, rel.max())


def test_stereo_sad_reads_the_bf16_canvas_widened(tpu_numerics):
    """match_stereo_canvas on the bf16 canvases equals the matcher on the
    same canvases widened to f32 beforehand, bit for bit: the windows are
    widened before the means and sums, as the reference does."""
    from ms_slam_tpu_torch.ops import stereo
    l, r = _pair()
    orb_cfg = torb.OrbConfig(n_features=256, n_levels=4)
    calib = tfe.Calib(model=0, params=(FX, FX, W / 2, H / 2),
                      bf=FX * BASELINE, width=W, height=H)
    imgs = torch.from_numpy(np.stack([l, r])).float()
    feats, canvases = torb.extract_canvas_multi(imgs, orb_cfg)
    assert canvases.dtype == torch.bfloat16
    fl, fr = (torb.Features(*[a[b] for a in feats]) for b in range(2))
    args = (W, calib.bf, calib.min_z, orb_cfg)
    a = stereo.match_stereo_canvas(fl, fr, canvases[0], canvases[1], *args)
    b = stereo.match_stereo_canvas(fl, fr, canvases[0].float(),
                                   canvases[1].float(), *args)
    assert int(a.valid.sum()) > 100
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_prefetched_frontend_needs_nothing_new(tpu_numerics):
    """The System's prefetch hands FrameData across threads, and FrameData
    holds no canvas: under the switch the frame a worker thread makes is
    the synchronous frontend's bit for bit, and none of its tensors is
    bf16 (the canvas never leaves the frontend)."""
    from ms_slam_tpu_torch.pipeline.system import (System, SystemConfig,
                                                   _tensors)
    from ms_slam_tpu_torch.models.map_state import MapConfig
    l, r = _pair()
    calib = tfe.Calib(model=0, params=(FX, FX, W / 2, H / 2),
                      bf=FX * BASELINE, width=W, height=H, th_depth=6.0)
    slam = System(SystemConfig(
        calib=calib, orb=torb.OrbConfig(n_features=256, n_levels=4),
        map=MapConfig(max_kf=8, max_mp=1024, n_feat=256, local_mp_cap=512)),
        device="cpu")
    got = {}
    worker = threading.Thread(
        target=lambda: got.update(pre=slam._prefetch_frontend(l, r)))
    worker.start()
    worker.join()
    frame, event = got["pre"]
    assert event is None
    sync = slam._dispatch_frontend(l, r)
    tensors = list(_tensors(frame))
    assert tensors and all(t.dtype != torch.bfloat16 for t in tensors)
    for x, y in zip(tensors, _tensors(sync)):
        assert torch.equal(x, y)
