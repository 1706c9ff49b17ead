"""Parity of the port's monocular, RGB-D and stereo-fisheye frontends with the
reference, at 320x240 with 512 features and 4 levels.

Tolerances and why (the bars of test_torch_frontend.py):
- >= 99% of keypoints identical (position, octave, valid), and sigma2
  equal on them. Rendered images get sensor noise (sigma 2 grey levels)
  before the uint8 cast: a noise-free render of a piecewise-constant
  texture holds exact FAST-score plateaus, where a one-ulp difference in the
  pyramid resize picks another corner;
- RGB-D: depth bit for bit on the shared keypoints (a lookup at the
  rounded pixel, half to even in both); u_right within 2.5e-7 relative
  (two float32 ulps). The reference's own u_right differs from its own
  `xy[:, 0] - bf / depth` in the last bit on ~16% of keypoints (XLA fuses
  the keypoint coordinate's arithmetic into that fusion), so no formula
  over the outputs reproduces it bit for bit; the port's is the exact
  float32 `x - bf / d`;
- fisheye: the matched (depth > 0) sets differ on <= 1% of slots, and the
  depth is within 1e-3 relative on matches both made (KB8 unprojection,
  DLT and two Gauss-Newton steps in float32 each);
- the port's fisheye depths against the rendered geometry: the bars of
  tests/test_fisheye.py::test_fisheye_frontend_triangulates (median
  relative error < 7%, < 15% on more than 75% of matches, > 100 matches),
  on its noise-free render.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import orb as jorb
from ms_slam_tpu.pipeline import frontend as jfe
from ms_slam_tpu_torch.ops import orb as torb
from ms_slam_tpu_torch.pipeline import frontend as tfe
from ms_slam_tpu_torch.utils import synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BL = 240, 320, 260.0, 0.15
ORB = dict(n_features=512, n_levels=4)
# tests/test_fisheye.py's rig
FFX, FBL = 150.0, 0.4
KB8P = (FFX, FFX, W / 2, H / 2, 0.02, -0.005, 0.001, -0.0002)


def _noisy(rng, im):
    return np.clip(im + rng.normal(0, 2.0, im.shape), 0, 255).astype(np.uint8)


def _pinhole_calib(mod):
    return mod.Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                     width=W, height=H, th_depth=BL * 40)


def _fisheye_calib(mod):
    return mod.Calib(model=1, params=KB8P, bf=FFX * FBL, width=W, height=H,
                     th_depth=FBL * 40, fps=10.0, params2=KB8P,
                     T_rl=(1.0, 0.0, 0.0, -FBL, 0.0, 1.0, 0.0, 0.0,
                           0.0, 0.0, 1.0, 0.0),
                     lapping=(0, W - 1, 0, W - 1))


def _same_keypoints(fj, ft):
    same = ((np.asarray(fj.feats.xy) == ft.feats.xy.numpy()).all(1)
            & (np.asarray(fj.feats.octave) == ft.feats.octave.numpy())
            & (np.asarray(fj.feats.valid) == ft.feats.valid.numpy()))
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_array_equal(ft.sigma2.numpy()[same],
                                  np.asarray(fj.sigma2)[same])
    return same


def _plane_world_view(seed, T_index=3):
    rng = np.random.default_rng(seed)
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    return rng, world, K, synth.make_trajectory(30, "arc")[T_index]


def test_process_mono_parity():
    rng, world, K, T = _plane_world_view(0)
    img = _noisy(rng, world.render(K, T, H, W))
    fj = jfe.process_mono(jnp.asarray(img), _pinhole_calib(jfe),
                          jorb.OrbConfig(**ORB))
    ft = tfe.process_mono(torch.from_numpy(img), _pinhole_calib(tfe),
                          torb.OrbConfig(**ORB))
    same = _same_keypoints(fj, ft)
    assert int(ft.feats.valid.sum()) > 400
    for name in ("u_right", "depth"):
        assert (getattr(ft, name).numpy() == -1.0).all()
    # descriptors of the shared keypoints: bit-exact
    np.testing.assert_array_equal(
        ft.feats.desc.numpy().view(np.uint32)[same],
        np.asarray(fj.feats.desc)[same])
    np.testing.assert_allclose(ft.feats.angle.numpy()[same],
                               np.asarray(fj.feats.angle)[same], rtol=1e-3,
                               atol=1e-3)


def test_process_rgbd_parity():
    rng, world, K, T = _plane_world_view(1)
    img, depth = world.render_rgbd(K, T, H, W)
    img = _noisy(rng, img)
    depth = depth.astype(np.float32)
    fj = jfe.process_rgbd(jnp.asarray(img), jnp.asarray(depth),
                          _pinhole_calib(jfe), jorb.OrbConfig(**ORB))
    ft = tfe.process_rgbd(torch.from_numpy(img), torch.from_numpy(depth),
                          _pinhole_calib(tfe), torb.OrbConfig(**ORB))
    same = _same_keypoints(fj, ft)
    assert (np.asarray(fj.depth)[same] > 0).sum() > 400
    np.testing.assert_array_equal(ft.depth.numpy()[same],
                                  np.asarray(fj.depth)[same])
    np.testing.assert_allclose(ft.u_right.numpy()[same],
                               np.asarray(fj.u_right)[same], rtol=2.5e-7)
    ok = ft.depth.numpy() > 0
    xt = ft.feats.xy.numpy()[:, 0]
    np.testing.assert_array_equal(
        ft.u_right.numpy()[ok],
        xt[ok] - np.float32(FX * BL) / ft.depth.numpy()[ok])


def test_rgbd_depth_lookup_rounds_half_to_even():
    """A keypoint at x.5 reads the even column, as jnp.round does."""
    depth = np.tile(np.arange(8, dtype=np.float32) + 1.0, (4, 1))
    xy = torch.tensor([[2.5, 1.0], [3.5, 1.0], [0.4, 2.5]])
    ui = torch.round(xy[:, 0]).long()
    assert ui.tolist() == np.round([2.5, 3.5, 0.4]).astype(int).tolist()
    assert torch.from_numpy(depth)[torch.round(xy[:, 1]).long(),
                                   ui].tolist() == [3.0, 5.0, 1.0]


@pytest.fixture(scope="module")
def fisheye_pair():
    rng = np.random.default_rng(0)
    world = synth.BoxWorld(rng, half=6.0)
    T = synth.make_trajectory(25, "arc")[5]
    return rng, world, T


def test_process_stereo_fisheye_parity(fisheye_pair):
    rng, world, T = fisheye_pair
    ims = np.stack([_noisy(rng, im) for im in
                    world.render_fisheye_stereo(KB8P, T, FBL, H, W)])
    fj = jfe.process_stereo_fisheye(jnp.asarray(ims), _fisheye_calib(jfe),
                                    jorb.OrbConfig(**ORB))
    ft = tfe.process_stereo_fisheye(torch.from_numpy(ims),
                                    _fisheye_calib(tfe),
                                    torb.OrbConfig(**ORB))
    same = _same_keypoints(fj, ft)
    mj = np.asarray(fj.depth) > 0
    mt = ft.depth.numpy() > 0
    assert mj.sum() > 100
    assert (mj != mt).mean() <= 0.01, (mj != mt).sum()
    both = mj & mt & same
    np.testing.assert_allclose(ft.depth.numpy()[both],
                               np.asarray(fj.depth)[both], rtol=1e-3)
    assert (ft.u_right.numpy() == -1.0).all()


def test_fisheye_frontend_triangulates(fisheye_pair):
    """tests/test_fisheye.py's check on the port: the frontend's KB8 depths
    against the rendered geometry, first camera at the origin."""
    world = synth.BoxWorld(np.random.default_rng(0), half=6.0)
    T = np.eye(4)
    im_l, im_r = world.render_fisheye_stereo(KB8P, T, FBL, H, W)
    fd = tfe.process_stereo_fisheye(
        torch.from_numpy(np.stack([im_l, im_r]).astype(np.uint8)),
        _fisheye_calib(tfe), torb.OrbConfig(**ORB))
    depth, xy = fd.depth.numpy(), fd.feats.xy.numpy()
    ok = depth > 0
    assert ok.sum() > 100, ok.sum()
    rays = synth.kb8_rays(KB8P, H, W)
    d = rays @ T[:3, :3].T
    gt_depth = np.full((H, W), np.inf)
    for ax, val, _, _ in world.iter_planes():
        da = d[..., ax]
        da_s = np.where(np.abs(da) > 1e-9, da, 1e-9)
        t = np.where(np.abs(da) > 1e-9, (val - T[ax, 3]) / da_s, -1)
        gt_depth = np.where((t > 0.1) & (t < gt_depth), t, gt_depth)
    ui = np.clip(np.round(xy[ok, 0]).astype(int), 0, W - 1)
    vi = np.clip(np.round(xy[ok, 1]).astype(int), 0, H - 1)
    rel = np.abs(depth[ok] - gt_depth[vi, ui]) / gt_depth[vi, ui]
    assert np.median(rel) < 0.07, np.median(rel)
    assert (rel < 0.15).mean() > 0.75, (rel < 0.15).mean()


def test_params2_array():
    c = _fisheye_calib(tfe)
    np.testing.assert_array_equal(c.params2_array().numpy(),
                                  np.asarray(_fisheye_calib(jfe)
                                             .params2_array()))
    plain = _pinhole_calib(tfe)
    assert torch.equal(plain.params2_array(), plain.params_array())
