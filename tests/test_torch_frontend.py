"""Parity of the port's Hamming matrix and stereo frontend with the reference.

Tolerances and why:
- hamming_matrix: bit-exact (integer results of an exact ±1 f32 matmul).
- process_stereo on a rendered synth.PlaneWorld pair at 192x256 with 256
  features: >= 99% of keypoints identical (position + octave); on keypoints
  both sides match, u_right and depth within 1e-3 relative (the 11-tap SAD
  means sum in another order); the matched sets differ on <= 1% of slots.
  The rendered pair gets sensor noise (sigma 2 grey levels) before the
  uint8 cast: a noise-free render of a piecewise-constant texture holds
  exact FAST-score plateaus, where a one-ulp difference in the pyramid
  resize picks a different plateau corner (see test_torch_orb.py).
"""
import jax.numpy as jnp
import numpy as np
import torch

from ms_slam_tpu.ops import hamming as jham
from ms_slam_tpu.ops import orb as jorb
from ms_slam_tpu.pipeline import frontend as jfe
from ms_slam_tpu_torch.ops import hamming as tham
from ms_slam_tpu_torch.ops import orb as torb
from ms_slam_tpu_torch.pipeline import frontend as tfe
from ms_slam_tpu_torch.utils import synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

H, W, FX, BASELINE = 192, 256, 200.0, 0.15


def test_hamming_matrix_bit_exact(rng):
    a = rng.integers(0, 2 ** 32, size=(64, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=(48, 8), dtype=np.uint32)
    hj = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    ht = tham.hamming_matrix(torch.from_numpy(a.view(np.int32)),
                             torch.from_numpy(b.view(np.int32))).numpy()
    np.testing.assert_array_equal(ht, hj)
    pop = tham.hamming_pop(torch.from_numpy(a[:48].view(np.int32)),
                           torch.from_numpy(b.view(np.int32))).numpy()
    np.testing.assert_array_equal(pop, np.diag(hj[:48]))


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    world = synth.PlaneWorld(rng, z_wall=14.0, y_floor=2.0)
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    T = synth.make_trajectory(30, "arc")[3]
    ims = world.render_stereo(K, T, BASELINE, H, W)
    return [np.clip(im + rng.normal(0, 2.0, im.shape), 0, 255)
            .astype(np.uint8) for im in ims]


def test_frame_data_parity():
    l, r = _pair()
    cj = jfe.Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BASELINE,
                   width=W, height=H, th_depth=6.0)
    oj = jorb.OrbConfig(n_features=256, n_levels=4)
    fj = jfe.process_stereo(jnp.asarray(l), jnp.asarray(r), cj, oj)
    ft = tfe.process_stereo(torch.from_numpy(l), torch.from_numpy(r),
                            tfe.Calib(*cj), torb.OrbConfig(*oj))

    same = ((np.asarray(fj.feats.xy) == ft.feats.xy.numpy()).all(1)
            & (np.asarray(fj.feats.octave) == ft.feats.octave.numpy())
            & (np.asarray(fj.feats.valid) == ft.feats.valid.numpy()))
    assert same.mean() >= 0.99, same.mean()
    mj = np.asarray(fj.depth) > 0
    mt = ft.depth.numpy() > 0
    assert mj.sum() > 100
    assert (mj != mt).mean() <= 0.01, (mj != mt).sum()
    both = mj & mt & same
    for name in ("u_right", "depth"):
        np.testing.assert_allclose(getattr(ft, name).numpy()[both],
                                   np.asarray(getattr(fj, name))[both],
                                   rtol=1e-3)
    np.testing.assert_array_equal(ft.sigma2.numpy()[same],
                                  np.asarray(fj.sigma2)[same])


def test_frame_data_numpy_roundtrip():
    l, r = _pair(1)
    ft = tfe.process_stereo(torch.from_numpy(l), torch.from_numpy(r),
                            tfe.Calib(model=0, params=(FX, FX, W / 2, H / 2),
                                      bf=FX * BASELINE, width=W, height=H),
                            torb.OrbConfig(n_features=256, n_levels=4))
    d = tfe.frame_data_to_numpy(ft)
    assert d["desc"].dtype == np.uint32
    back = tfe.frame_data_from_numpy(d)
    for a, b in zip(back.feats, ft.feats):
        assert torch.equal(a, b)
    assert torch.equal(back.depth, ft.depth)
