"""Parity of the port's place recognition and prior-free PnP with the JAX
reference: `models/vocab.py`, `ops/pnp.py`, `tracking_ops.track_by_pnp`.

Inputs are made with numpy from a seed and passed as uint32/int32/float32
to both sides (descriptor words keep their bits; the port holds them as
int32).

Tolerances and why:
- make_codebook: bit-exact (the same numpy draw);
- refine_codebook, bow_vector, place_scores: exact. Hamming distances are
  exact integers on both sides, argmin ties go to the first index in both
  frameworks (pinned below), histograms are multiples of 0.5;
- tfidf_scores and KeyFrameDatabase query scores: rtol 1e-5 (log, norms and
  a matvec in float32, summed in another order); the candidate lists are
  identical;
- pnp_ransac: test_pnp.py's outcome bars (R within 5e-3, t within 2e-2 of
  the truth; the degenerate input is not ok). The random streams differ;
- pnp with injected hypotheses: the same (n_hyp, 6) index table into both
  (the reference unjitted, `jax.random.choice` patched to return it). In
  float64: the best hypothesis's inlier count equal, R within 1e-4, t
  within 1e-3. In float32, R 5e-4, t 5e-3, inliers +-2: the two LAPACKs
  round the 12x12 eigenproblem differently (1.2e-4 in R measured). The
  port fixes the smallest eigenvector's sign and the reference keeps
  LAPACK's (ms_slam_tpu_torch/ops/pnp.py), so the table holds clean
  hypotheses the reference solves with its own sign, screened one at a
  time, plus hypotheses with outliers; one at a time, the port agrees with
  every hypothesis the reference solves right;
- track_by_pnp on a rendered frame: >= 15 inliers and the pose within the
  same bars against the rendered ground truth.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ms_slam_tpu.models import vocab as jv
from ms_slam_tpu.ops import cameras as jcam
from ms_slam_tpu.ops import pnp as jpnp
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.models import vocab as tv
from ms_slam_tpu_torch.ops import cameras as tcam
from ms_slam_tpu_torch.ops import orb as torb
from ms_slam_tpu_torch.ops import pnp as tpnp
from ms_slam_tpu_torch.pipeline import frontend as tfe
from ms_slam_tpu_torch.pipeline import mapping_ops as tmo
from ms_slam_tpu_torch.pipeline import tracking_ops as tto
from ms_slam_tpu_torch.utils import synth

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

PIN = np.asarray([300.0, 300.0, 160.0, 120.0, 0, 0, 0, 0], np.float32)


def _t(a):
    """numpy -> torch, uint32 descriptor words as int32 bits."""
    a = np.array(a)                  # a private, writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _u32(x):
    return x.numpy().view(np.uint32)


def _descs(rng, n, flip_from=None, n_flip=8):
    """(n,8) uint32 descriptors; with flip_from, noisy copies of its rows."""
    if flip_from is None:
        return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    d = flip_from.copy()
    for i in range(n):
        for b in rng.choice(256, n_flip, replace=False):
            d[i, b // 32] ^= np.uint32(1 << (b % 32))
    return d


def test_make_codebook_bit_exact():
    np.testing.assert_array_equal(_u32(tv.make_codebook(512)),
                                  np.asarray(jv.make_codebook(512)))
    np.testing.assert_array_equal(_u32(tv.make_codebook(64, seed=7)),
                                  np.asarray(jv.make_codebook(64, seed=7)))


def test_refine_codebook_exact(rng):
    cb = np.asarray(jv.make_codebook(256))
    descs = _descs(rng, 600)
    valid = rng.random(600) > 0.1
    rj = jv.refine_codebook(jnp.asarray(cb), jnp.asarray(descs),
                            jnp.asarray(valid))
    rt = tv.refine_codebook(_t(cb), _t(descs), _t(valid))
    assert (np.asarray(rj) != cb).any()
    np.testing.assert_array_equal(_u32(rt), np.asarray(rj))


@pytest.mark.parametrize("soft", [True, False])
def test_bow_vector_exact(rng, soft):
    cb = np.asarray(jv.make_codebook(512))
    # half the descriptors are noisy copies of codewords: real near-hits
    descs = np.concatenate([_descs(rng, 200),
                            _descs(rng, 200, flip_from=cb[:200], n_flip=6)])
    valid = rng.random(400) > 0.2
    hj = np.asarray(jv.bow_vector(jnp.asarray(cb), jnp.asarray(descs),
                                  jnp.asarray(valid), soft=soft))
    ht = tv.bow_vector(_t(cb), _t(descs), _t(valid), soft=soft).numpy()
    np.testing.assert_array_equal(ht, hj)
    # the batched form the database re-encodes with gives the same rows
    hb = tv.bow_vectors(_t(cb), _t(np.stack([descs, descs[::-1]])),
                        _t(np.stack([valid, valid[::-1]])), soft=soft)
    np.testing.assert_array_equal(hb[0].numpy(), hj)


def test_argmin_ties_first_index(rng):
    """Both frameworks return the first index of a tied minimum: on tied
    integer rows, and through bow_vector with duplicated codewords."""
    d = rng.integers(0, 4, (64, 50)).astype(np.int32)
    d[:, [5, 9]] = -1                       # a tie at the row minimum
    np.testing.assert_array_equal(torch.argmin(_t(d), dim=1).numpy(),
                                  np.asarray(jnp.argmin(jnp.asarray(d), 1)))
    assert (torch.argmin(_t(d), dim=1).numpy() == 5).all()
    cb = np.array(jv.make_codebook(16))
    cb[7] = cb[3]                           # words 3 and 7 tie exactly
    q = cb[[3, 3]]
    valid = np.array([True, True])
    hj = np.asarray(jv.bow_vector(jnp.asarray(cb), jnp.asarray(q),
                                  jnp.asarray(valid)))
    ht = tv.bow_vector(_t(cb), _t(q), _t(valid)).numpy()
    np.testing.assert_array_equal(ht, hj)
    assert ht[3] == pytest.approx(2 / 3) and ht[7] == pytest.approx(1 / 3)


def _kf_tables(rng, K=12, N=96):
    pool = _descs(rng, 400)
    kf_desc = np.stack([_descs(rng, N, flip_from=pool[rng.choice(400, N)])
                        for _ in range(K)])
    kf_valid = rng.random((K, N)) > 0.3
    q = _descs(rng, 128, flip_from=pool[rng.choice(400, 128)])
    return kf_desc, kf_valid, q, rng.random(128) > 0.1


def test_place_scores_exact(rng):
    kf_desc, kf_valid, q, qv = _kf_tables(rng)
    mask = rng.random(len(kf_desc)) > 0.25
    sj = np.asarray(jv.place_scores(*[jnp.asarray(a) for a in
                                      (kf_desc, kf_valid, mask, q, qv)]))
    st = tv.place_scores(*[_t(a) for a in (kf_desc, kf_valid, mask, q, qv)])
    assert (sj[mask] > 0).all() and (sj[~mask] == -1).all()
    # the reference divides in float64 here (x64 on); a correctly rounded
    # float32 quotient equals its float64 quotient rounded to float32
    np.testing.assert_array_equal(st.numpy(), sj.astype(np.float32))


def test_tfidf_scores(rng):
    rows = rng.random((20, 256)).astype(np.float32)
    rows[rows < 0.7] = 0
    present = rng.random(20) > 0.3
    q = rng.random(256).astype(np.float32) * (rng.random(256) > 0.6)
    sj = np.asarray(jv.tfidf_scores(jnp.asarray(rows), jnp.asarray(present),
                                    jnp.asarray(q)))
    st = tv.tfidf_scores(_t(rows), _t(present), _t(q)).numpy()
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-7)


def test_keyframe_database_sequence(rng):
    """The same set_row / add / erase sequence through the 4- and
    24-keyframe fits: identical codebooks, rows and flags, the same
    candidate lists from query and query_rescored, scores within 1e-5."""
    K, N, n_kf = 32, 96, 28
    pool = _descs(rng, 60 * n_kf)
    dj, dt = jv.KeyFrameDatabase(max_kf=K), tv.KeyFrameDatabase(max_kf=K)
    kp_desc = np.zeros((K, N, 8), np.uint32)
    kp_valid = np.zeros((K, N), bool)

    def put(fn, k, desc, valid):
        kp_desc[k], kp_valid[k] = desc, valid
        getattr(dj, fn)(k, jnp.asarray(desc), jnp.asarray(valid))
        getattr(dt, fn)(k, _t(desc), _t(valid))

    def check(label):
        np.testing.assert_array_equal(_u32(dt.codebook),
                                      np.asarray(dj.codebook), label)
        np.testing.assert_array_equal(dt.rows.numpy(), np.asarray(dj.rows),
                                      label)
        np.testing.assert_array_equal(dt.present, dj.present, label)
        np.testing.assert_array_equal(dt.has_row, dj.has_row, label)
        for k0 in (3, n_kf // 2, n_kf - 2):
            lm = np.arange(60 * k0, 60 * k0 + N)
            qd = _descs(rng, N, flip_from=pool[lm % len(pool)])
            qv = rng.random(N) > 0.1
            cj, sj = dj.query(jnp.asarray(qd), jnp.asarray(qv), k=6)
            ct, st = dt.query(_t(qd), _t(qv), k=6)
            assert ct == cj, label
            np.testing.assert_allclose(st, sj, rtol=1e-5)
            args_j = (jnp.asarray(kp_desc), jnp.asarray(kp_valid),
                      jnp.asarray(qd), jnp.asarray(qv))
            args_t = (_t(kp_desc), _t(kp_valid), _t(qd), _t(qv))
            cj, sj = dj.query_rescored(*args_j, exclude={k0}, k=3)
            ct, st = dt.query_rescored(*args_t, exclude={k0}, k=3)
            assert ct == cj, label
            np.testing.assert_allclose(st, sj, rtol=1e-5)

    fits = []
    for k in range(n_kf):
        # keyframe k sees a sliding band of landmarks
        lm = np.arange(60 * k, 60 * k + N) % len(pool)
        put("set_row", k, _descs(rng, N, flip_from=pool[lm]),
            rng.random(N) > 0.1)
        if k >= 4 and k % 2 == 0:
            # sparsify an older keyframe: compact its feature slots
            s = k - 4
            put("add", s, kp_desc[s], kp_valid[s] & (rng.random(N) > 0.5))
        if k == 14:
            for db in (dj, dt):
                db.erase(5)
            kp_valid[5] = False
        fits.append((dt._trained, dt._retrained))
        assert (dj._trained, dj._retrained) == fits[-1]
        if k in (6, n_kf - 1):
            check(f"after keyframe {k}")
    assert fits[2] == (False, False) and fits[6] == (True, False)
    assert fits[-1] == (True, True)


def _scene(rng, n=200, outlier_frac=0.3, noise=0.3):
    """test_pnp.py's scene, projected with numpy, as float32."""
    X = rng.uniform(-4, 4, (n, 3))
    X[:, 2] += 9.0
    R = Rotation.from_euler("xyz", [0.4, -0.7, 0.25]).as_matrix()
    t = np.array([0.6, -0.4, 1.2])
    Xc = X @ R.T + t
    uv = np.stack([PIN[0] * Xc[:, 0] / Xc[:, 2] + PIN[2],
                   PIN[1] * Xc[:, 1] / Xc[:, 2] + PIN[3]], -1)
    uv += rng.normal(0, noise, uv.shape)
    out_idx = rng.choice(n, int(outlier_frac * n), replace=False)
    uv[out_idx] += rng.uniform(-80, 80, (len(out_idx), 2))
    return X.astype(np.float32), uv.astype(np.float32), R, t, out_idx


def test_unproject_pnp_rays(rng):
    """The rays pnp_ransac builds its DLT rows from, outliers (pixels off
    the image) included: the same float32 operations, exact."""
    _, uv, _, _, _ = _scene(rng)
    rj = np.asarray(jcam.unproject(0, jnp.asarray(PIN), jnp.asarray(uv)))
    rt = tcam.unproject(0, _t(PIN), _t(uv)).numpy()
    assert ((uv < 0) | (uv > 320)).any()
    np.testing.assert_array_equal(rt, rj)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_pnp_recovers_pose_far_from_prior(rng):
    X, uv, R, t, out_idx = _scene(rng)
    n = len(X)
    res = tpnp.pnp_ransac(0, _t(PIN), _t(X), _t(uv), torch.ones(n),
                          torch.ones(n, dtype=torch.bool), _gen(1))
    assert bool(res.ok)
    np.testing.assert_allclose(res.R.numpy(), R, atol=5e-3)
    np.testing.assert_allclose(res.t.numpy(), t, atol=2e-2)
    assert res.inlier.numpy()[out_idx].mean() < 0.1


def test_pnp_rejects_degenerate(rng):
    X = rng.uniform(-4, 4, (100, 3))
    X[:, 2] += 9.0
    uv = rng.uniform(0, 320, (100, 2))
    res = tpnp.pnp_ransac(0, _t(PIN), _t(X.astype(np.float32)),
                          _t(uv.astype(np.float32)), torch.ones(100),
                          torch.ones(100, dtype=torch.bool), _gen(2),
                          min_inliers=25)
    assert not bool(res.ok)


def _ref_pnp(monkeypatch, idx, X, uv, n_hyp):
    """The reference's pnp_ransac, unjitted, drawing `idx`."""
    n = len(X)
    monkeypatch.setattr(jax.random, "choice",
                        lambda *a, **k: jnp.asarray(idx))
    return jpnp.pnp_ransac.__wrapped__(
        0, jnp.asarray(PIN, X.dtype), jnp.asarray(X), jnp.asarray(uv),
        jnp.ones(n, X.dtype), jnp.ones(n, bool), jax.random.PRNGKey(0),
        n_hyp=n_hyp, min_inliers=10)


def _port_pnp(idx, X, uv):
    n = len(X)
    dt = torch.float64 if X.dtype == np.float64 else torch.float32
    return tpnp.pnp_from_hypotheses(
        0, _t(PIN).to(dt), _t(X), _t(uv), torch.ones(n, dtype=dt),
        torch.ones(n, dtype=torch.bool), _t(idx))


def _right(R_est, R):
    return np.abs(np.asarray(R_est) - R).max() < 0.05


# (R atol, t atol, inlier-count slack) per working type. In float64 the
# same hypothesis gives the same pose to rounding; in float32 the two
# eigensolvers' rounding of the 12x12 problem differs by up to 1.2e-4 in R
# (measured), which a chi2 gate can turn into a one- or two-inlier change.
PNP_TOL = {np.float64: (1e-4, 1e-3, 0), np.float32: (5e-4, 5e-3, 2)}


def _scene_as(rng, dtype):
    X, uv, R, t, out_idx = _scene(rng)
    return X.astype(dtype), uv.astype(dtype), R, t, out_idx


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pnp_single_hypotheses_agree(rng, monkeypatch, dtype):
    """One clean hypothesis at a time, noisy scene: wherever the
    reference's eigenvector sign gives the right rotation, the port's pose
    and inlier count match it, and the port gets at least as many right."""
    r_tol, t_tol, n_tol = PNP_TOL[dtype]
    X, uv, R, t, out_idx = _scene_as(rng, dtype)
    clean = np.setdiff1d(np.arange(len(X)), out_idx)
    n_ref_right = n_port_right = 0
    for _ in range(12):
        one = rng.choice(clean, (1, 6), replace=False).astype(np.int32)
        rj = _ref_pnp(monkeypatch, one, X, uv, 1)
        rt = _port_pnp(one, X, uv)
        n_port_right += _right(rt.R.numpy(), R)
        if _right(rj.R, R):
            n_ref_right += 1
            np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R),
                                       atol=r_tol)
            np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t),
                                       atol=t_tol)
            assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= max(n_tol, 1)
    assert n_port_right >= n_ref_right >= 2


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pnp_injected_hypotheses(rng, monkeypatch, dtype):
    """The same table into both: clean hypotheses that the reference
    solves with its own eigenvector sign (screened one at a time), mixed
    with hypotheses that hold outliers. Both must pick the same best."""
    r_tol, t_tol, n_tol = PNP_TOL[dtype]
    X, uv, R, t, out_idx = _scene_as(rng, dtype)
    n = len(X)
    clean = np.setdiff1d(np.arange(n), out_idx)
    rows = []
    while len(rows) < 6:
        one = rng.choice(clean, (1, 6), replace=False).astype(np.int32)
        if _right(_ref_pnp(monkeypatch, one, X, uv, 1).R, R):
            rows.append(one[0])
    rows += [np.r_[rng.choice(out_idx, 2), rng.choice(clean, 4)]
             for _ in range(10)]
    idx = np.stack(rows).astype(np.int32)[rng.permutation(len(rows))]
    rj = _ref_pnp(monkeypatch, idx, X, uv, len(idx))
    rt = _port_pnp(idx, X, uv)
    assert int(rj.n_inliers) >= 0.5 * n
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= n_tol
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=r_tol)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=t_tol)


def test_track_by_pnp_rendered_frame():
    """Relocalize a rendered frame against a keyframe made from another
    frame 0.36 m and 8 degrees away, with no pose prior. The map is one
    keyframe's stereo depths, which bound the pose error (the reference
    measured 0.0024 rotation, 0.0168 m translation on this pair)."""
    H, W, FX, BL = 240, 320, 260.0, 0.15
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    calib = tfe.Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                      width=W, height=H, th_depth=BL * 40, fps=10.0)
    orb_cfg = torb.OrbConfig(n_features=512, n_levels=4)
    world = synth.PlaneWorld(np.random.default_rng(0), z_wall=14.0,
                             y_floor=2.0)
    T0 = np.eye(4)
    Tq = np.eye(4)
    Tq[:3, :3] = Rotation.from_euler("y", np.deg2rad(8)).as_matrix()
    Tq[:3, 3] = [0.3, 0.0, 0.2]

    def frame(T):
        ims = [np.clip(im, 0, 255).astype(np.uint8)
               for im in world.render_stereo(K, T, BL, H, W)]
        return tfe.process_stereo(*[torch.from_numpy(im) for im in ims],
                                  calib, orb_cfg)

    ms = TM.empty_map(TM.MapConfig(max_kf=8, max_mp=4096, n_feat=512,
                                   local_mp_cap=2048))
    ms, n_new = tmo.create_keyframe(
        ms, calib, 0, frame(T0), torch.eye(3), torch.zeros(3),
        torch.full((512,), -1, dtype=torch.int32), 0, 0, 1e9)
    assert int(n_new) > 200
    out = tto.track_by_pnp(ms, calib, frame(Tq), 0, _gen(0xE10C))
    T_cw = np.linalg.inv(Tq)                 # the keyframe is the world
    assert int(out.n_inliers) >= 15
    np.testing.assert_allclose(out.R.numpy(), T_cw[:3, :3], atol=5e-3)
    np.testing.assert_allclose(out.t.numpy(), T_cw[:3, 3], atol=2e-2)
