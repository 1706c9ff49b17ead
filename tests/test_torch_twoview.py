"""Parity of the port's two-view reconstruction (`ops/twoview.py`) with the
reference, on the scenes of tests/test_twoview.py.

Tolerances and why:
- `_essential_8pt` and `_homography_dlt`: equal up to sign and scale (the
  SVD's null vector has no fixed sign), compared after unit-norm scaling
  and a sign fix, at 1e-4. Float64 inputs.
- `_epi_errs2` and `_h_errs`: 1e-4 relative (plus 1e-9 absolute for the
  zero distances of exact matches).
- `_decompose_homography`: the eight (R, t) pairs match as a set within
  1e-4.
- `reconstruct`: the reference's random draw is replaced by an injected
  (256, 8) table (`jax.random.choice` patched under the unjitted
  `reconstruct.__wrapped__`), and the port solves from the same table
  through `reconstruct_from_hypotheses`. Held: `ok`, the chosen family
  (E or H, from which candidate block the chosen rotation comes), the
  rotation within 1e-3 rad, the translation direction within 1e-3, and at
  most 1% of the inlier flags differing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ms_slam_tpu.ops import twoview as jtv
from ms_slam_tpu_torch.ops import twoview as ttv

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

FX, W, H = 260.0, 320, 240
PARAMS = np.asarray([FX, FX, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def _project(X, R, t):
    Xc = X @ R.T + t
    return np.stack([FX * Xc[:, 0] / Xc[:, 2] + W / 2,
                     FX * Xc[:, 1] / Xc[:, 2] + H / 2], -1), Xc[:, 2]


def _scene(rng, kind, N=400, noise=0.3):
    """tests/test_twoview.py's three scenes: (xy1, xy2, valid, R, t)."""
    if kind == "planar":
        X = np.stack([rng.uniform(-5, 5, N), rng.uniform(-4, 4, N),
                      np.full(N, 10.0)], -1)
    else:
        X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                      rng.uniform(6, 16, N)], -1)
    if kind == "rotation":
        R2, t2 = Rotation.from_euler("y", 0.08).as_matrix(), np.zeros(3)
    else:
        R2 = Rotation.from_euler("y", 0.05).as_matrix()
        t2 = np.array([-0.6, 0.05, 0.1])
    xy1, z1 = _project(X, np.eye(3), np.zeros(3))
    xy2, z2 = _project(X, R2, t2)
    ok = ((z2 > 0.1) & (xy2[:, 0] > 0) & (xy2[:, 0] < W)
          & (xy2[:, 1] > 0) & (xy2[:, 1] < H))
    if kind != "rotation":
        ok &= ((z1 > 0.1) & (xy1[:, 0] > 0) & (xy1[:, 0] < W)
               & (xy1[:, 1] > 0) & (xy1[:, 1] < H))
        xy1 = xy1 + rng.normal(0, noise, xy1.shape)
        xy2 = xy2 + rng.normal(0, noise, xy2.shape)
    return (xy1.astype(np.float32), xy2.astype(np.float32), ok, R2, t2)


def _bearings(rng, n):
    x1 = np.concatenate([rng.normal(0, 0.4, (n, 2)), np.ones((n, 1))], 1)
    x2 = x1 + np.concatenate([rng.normal(0, 0.05, (n, 2)),
                              np.zeros((n, 1))], 1)
    return x1, x2


def _unit_up_to_sign(M):
    v = M.reshape(M.shape[0], -1)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    i = np.argmax(np.abs(v), axis=1)
    return v * np.sign(v[np.arange(len(v)), i])[:, None]


@pytest.mark.parametrize("fn", ["_essential_8pt", "_homography_dlt"])
def test_minimal_solvers_up_to_sign(rng, fn):
    """16 eight-point samples at once, then an inlier-weighted refit over 200
    rows; the same null space up to sign and scale."""
    x1, x2 = _bearings(rng, 200)
    # distinct rows: a repeated index leaves a 2-D null space
    idx = np.stack([rng.choice(200, 8, replace=False) for _ in range(16)])
    mj = np.stack([np.asarray(getattr(jtv, fn)(jnp.asarray(x1[i]),
                                                jnp.asarray(x2[i])))
                   for i in idx])
    mt = getattr(ttv, fn)(torch.from_numpy(x1)[idx],
                          torch.from_numpy(x2)[idx]).numpy()
    np.testing.assert_allclose(_unit_up_to_sign(mt), _unit_up_to_sign(mj),
                               atol=1e-4)
    w = (rng.random(200) > 0.3).astype(np.float64)
    rj = np.asarray(getattr(jtv, fn)(jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.asarray(w)))
    rt = getattr(ttv, fn)(torch.from_numpy(x1), torch.from_numpy(x2),
                          torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(_unit_up_to_sign(rt[None]),
                               _unit_up_to_sign(rj[None]), atol=1e-4)


@pytest.mark.parametrize("fn", ["_epi_errs2", "_h_errs"])
def test_transfer_errors(rng, fn):
    x1, x2 = _bearings(rng, 300)
    M = Rotation.from_euler("xyz", [0.02, 0.1, -0.03]).as_matrix()
    if fn == "_epi_errs2":
        t = np.array([0.3, -0.05, 0.1])
        M = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                      [-t[1], t[0], 0]]) @ M
    M = M + rng.normal(0, 1e-3, (3, 3))
    oj = getattr(jtv, fn)(jnp.asarray(M), jnp.asarray(x1), jnp.asarray(x2),
                          FX)
    ot = getattr(ttv, fn)(torch.from_numpy(M), torch.from_numpy(x1),
                          torch.from_numpy(x2), FX)
    for a, b in zip(oj, ot):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-9)


def test_decompose_homography_as_a_set():
    R = Rotation.from_euler("yxz", [0.2, -0.1, 0.05]).as_matrix()
    t = np.array([0.3, -0.1, 0.2])
    n = np.array([0.1, -0.05, 1.0])
    Hm = R + np.outer(t, n / np.linalg.norm(n)) / 5.0
    Rj, tj = (np.asarray(a) for a in jtv._decompose_homography(
        jnp.asarray(Hm)))
    Rt, tt = (a.numpy() for a in ttv._decompose_homography(
        torch.from_numpy(Hm)))
    used = set()
    for k in range(8):
        gap = [np.abs(Rt[k] - Rj[m]).max() + np.abs(tt[k] - tj[m]).max()
               for m in range(8)]
        m = int(np.argmin(gap))
        assert gap[m] < 1e-4, (k, gap)
        used.add(m)
    assert len(used) == 8
    # and one of them is the motion (tests/test_twoview.py's check)
    err = [np.abs(Rt[k] - R).max() + np.abs(tt[k] - t / np.linalg.norm(t)
                                            ).max() for k in range(8)]
    assert min(err) < 1e-4


def _recording(monkeypatch, mod, seen):
    """Record the 8 homography candidates each `reconstruct` decomposes: the
    chosen rotation is one of them exactly when the H family was picked."""
    fn = mod._decompose_homography

    def rec(Hm):
        out = fn(Hm)
        seen.append(np.asarray(out[0]))
        return out
    monkeypatch.setattr(mod, "_decompose_homography", rec)


def _family(R, seen):
    gap = np.abs(seen[-1] - np.asarray(R)[None]).reshape(8, -1).max(1)
    return "H" if gap.min() == 0.0 else "E"


def _rot_angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("kind", ["general", "planar", "rotation"])
def test_reconstruct_injected_table(rng, monkeypatch, kind):
    xy1, xy2, valid, R2, t2 = _scene(rng, kind)
    idx = rng.choice(np.flatnonzero(valid), (256, 8)).astype(np.int32)
    seen_j, seen_t = [], []
    _recording(monkeypatch, jtv, seen_j)
    _recording(monkeypatch, ttv, seen_t)
    monkeypatch.setattr(jax.random, "choice",
                        lambda *a, **k: jnp.asarray(idx))
    rj = jtv.reconstruct.__wrapped__(
        0, jnp.asarray(PARAMS), jnp.asarray(xy1), jnp.asarray(xy2),
        jnp.asarray(valid), jax.random.PRNGKey(3))
    rt = ttv.reconstruct_from_hypotheses(
        0, torch.from_numpy(PARAMS), torch.from_numpy(xy1),
        torch.from_numpy(xy2), torch.from_numpy(valid),
        torch.from_numpy(idx))
    assert bool(rt.ok) == bool(rj.ok)
    if kind == "rotation":
        assert not bool(rt.ok)
        return
    assert bool(rt.ok)
    assert _family(rt.R.numpy(), seen_t) == _family(rj.R, seen_j)
    if kind == "planar":
        assert _family(rt.R.numpy(), seen_t) == "H"
    Rj, Rt_ = np.asarray(rj.R, np.float64), rt.R.numpy().astype(np.float64)
    tj, tt = np.asarray(rj.t, np.float64), rt.t.numpy().astype(np.float64)
    assert _rot_angle(Rt_, Rj) < 1e-3
    assert np.linalg.norm(tt - tj) < 1e-3
    inl_j, inl_t = np.asarray(rj.inlier), rt.inlier.numpy()
    assert (inl_j != inl_t).mean() <= 0.01, (inl_j != inl_t).sum()
    # and the motion is tests/test_twoview.py's: 1 degree, 5 degrees
    assert np.degrees(_rot_angle(Rt_, R2)) < 1.0
    t_gt = t2 / np.linalg.norm(t2)
    assert np.degrees(np.arccos(min(1.0, abs(tt @ t_gt)))) < 5.0


def test_draw_hypotheses_uniform_over_valid():
    valid = torch.zeros(1000, dtype=torch.bool)
    valid[::7] = True
    g = torch.Generator().manual_seed(3)
    idx = ttv.draw_hypotheses(valid, 256, g)
    assert idx.shape == (256, 8)
    assert bool(valid[idx].all())
    counts = torch.bincount(idx.reshape(-1), minlength=1000)[valid]
    assert counts.min() > 0 and counts.max() < 3 * counts.float().mean()
    # same seed, same table; nothing valid: still a table
    g2 = torch.Generator().manual_seed(3)
    assert torch.equal(idx, ttv.draw_hypotheses(valid, 256, g2))
    none = ttv.draw_hypotheses(torch.zeros(10, dtype=torch.bool), 4, g)
    assert none.shape == (4, 8)
