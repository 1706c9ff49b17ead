"""Parity of the port's loop-closing solvers with the JAX reference:
`ops/sim3.py`, `ops/pose_graph.py`, `ops/ba.py::ba_alternate`,
`models/map_state.py::covisibility_matrix`, and the LoopCloser's host logic
on stubbed results.

Inputs are made with numpy from a seed and go to both sides as float32 /
int32 / uint32 (conftest.py enables x64 on the JAX side, so every float is
cast explicitly). The reference's jitted functions run on the CPU as its own
tests run them.

What the comparison has to account for:

- Random draws. The reference draws RANSAC triples with `jax.random.choice`;
  torch cannot replay that stream. The port splits the draw from the solve
  (`sim3.sim3_from_hypotheses`, the `idx`/`idx_tables` arguments of
  `_verify_pair`/`detect_and_verify`), and the tests hand the reference the
  same table by patching `jax.random.choice` under its unjitted functions.
- Degenerate triples. A triple that repeats an index gives Horn a matrix of
  rank <= 1 and a rotation that depends on the SVD's arbitrary vectors, so
  per-hypothesis results are compared on triples of distinct points only;
  the chosen result is compared on the whole table.

Tolerances:
- horn: R, s 1e-5, t 1e-4 (a 3x3 SVD in float32 by two LAPACK builds);
- sim3 RANSAC with an injected table: inlier masks identical, s/R 1e-5,
  t 1e-4;
- sim3_refine / sim3_refine_world: ten Gauss-Newton steps, each a 6x6 or
  7x7 solve of float32 normal equations: R 1e-4, t 1e-3, s 1e-4, inlier
  counts equal. sim3_refine_world with free scale has a gauge freedom
  ((s, t) -> (a s, a t)), so there only the port's rotation and camera
  centre are held against the truth;
- sim3_guided_match, covisibility_matrix: exact integers;
- pose graphs (10 iterations of a dense (K*D)^2 float32 solve): rotations
  2e-4, translations 2e-3 on a ring of radius 10, final cost rtol 2e-2 +
  atol 1e-4; padded and exact edge tables agree to 1e-5 / 1e-4;
- ba_alternate: R 1e-4, t and points 1e-3;
- the tests that need a map from a reference run (`_verify_pair`,
  `detect_and_verify`, `refine_hypothesis`, the corrections and the slice as
  a whole) are in test_torch_loop_slice.py, a file of its own so that
  `--dist loadfile` gives the whole-slice fixture a worker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ms_slam_tpu.models import map_state as JM
from ms_slam_tpu.ops import ba as jba
from ms_slam_tpu.ops import pose_graph as jpg
from ms_slam_tpu.ops import sim3 as jsim3
from ms_slam_tpu_torch.models import map_state as TM
from ms_slam_tpu_torch.ops import ba as tba
from ms_slam_tpu_torch.ops import pose_graph as tpg
from ms_slam_tpu_torch.ops import sim3 as tsim3

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

PIN = np.asarray([300.0, 300.0, 160.0, 120.0, 0, 0, 0, 0], np.float32)


def _t(a):
    """numpy (or jax) -> torch, uint32 descriptor words as int32 bits."""
    a = np.array(a)                  # a private, writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _j(a):
    return jnp.asarray(a)


def _rot_close(Ra, Rb, tol):
    np.testing.assert_allclose(np.asarray(Ra), np.asarray(Rb), atol=tol)


# ---------------------------------------------------------------------------
# ops/sim3.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_scale", [False, True])
def test_horn(rng, with_scale):
    X = rng.normal(size=(4, 32, 3)).astype(np.float32)
    R_true = Rotation.from_rotvec([0.2, 0.3, -0.1]).as_matrix()
    s_true = 1.7 if with_scale else 1.0
    Y = (s_true * X @ R_true.T + np.array([1.0, -2.0, 0.5])).astype(
        np.float32)
    w = (rng.random((4, 32)) > 0.2).astype(np.float32)
    sj, Rj, tj = jsim3.horn(_j(X), _j(Y), _j(w), with_scale=with_scale)
    st, Rt, tt = tsim3.horn(_t(X), _t(Y), _t(w), with_scale=with_scale)
    assert Rt.dtype == torch.float32 and np.asarray(Rj).dtype == np.float32
    _rot_close(Rt, Rj, 1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    _rot_close(Rt[0], R_true, 1e-4)
    np.testing.assert_allclose(st.numpy(), s_true, atol=1e-4)


def _ransac_scene(rng, N=96, n_out=25, scale=1.0):
    Xc2 = rng.uniform(-2, 2, (N, 3))
    Xc2[:, 2] += 6.0
    R = Rotation.from_rotvec([0.05, 0.1, -0.08]).as_matrix()
    t = np.array([0.3, -0.2, 0.1])
    Xc1 = scale * Xc2 @ R.T + t
    Xc1[:n_out] = rng.uniform(-2, 2, (n_out, 3)) + [0, 0, 6]
    valid = np.ones(N, bool)
    valid[-5:] = False
    s2 = (1.2 ** rng.integers(0, 4, N)).astype(np.float32) ** 2
    return (Xc1.astype(np.float32), Xc2.astype(np.float32), s2, valid,
            R, t)


def _ref_ransac(monkeypatch, idx, Xc1, Xc2, s2, valid, with_scale):
    """The reference's sim3_ransac, unjitted, drawing `idx`."""
    monkeypatch.setattr(jax.random, "choice", lambda *a, **k: _j(idx))
    return jsim3.sim3_ransac.__wrapped__(
        0, _j(PIN), _j(Xc1), _j(Xc2), _j(s2), _j(s2), _j(valid),
        jax.random.PRNGKey(0), n_hyp=len(idx), with_scale=with_scale)


@pytest.mark.parametrize("with_scale", [False, True])
def test_sim3_ransac_injected_table(rng, monkeypatch, with_scale):
    """The same (128, 3) table into both, with repeated-index triples left
    in: the chosen hypothesis, its refit and the inlier mask agree."""
    scale = 1.3 if with_scale else 1.0
    Xc1, Xc2, s2, valid, R, t = _ransac_scene(rng, scale=scale)
    idx = rng.choice(np.flatnonzero(valid), (128, 3)).astype(np.int32)
    idx[:4, 1] = idx[:4, 0]                  # degenerate triples stay in
    rj = _ref_ransac(monkeypatch, idx, Xc1, Xc2, s2, valid, with_scale)
    rt = tsim3.sim3_from_hypotheses(0, _t(PIN), _t(Xc1), _t(Xc2), _t(s2),
                                    _t(s2), _t(valid), _t(idx),
                                    with_scale=with_scale)
    assert int(rj.n_inliers) >= 96 - 25 - 5 - 5
    assert int(rt.n_inliers) == int(rj.n_inliers)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    _rot_close(rt.R, rj.R, 1e-5)
    np.testing.assert_allclose(float(rt.s), float(rj.s), atol=1e-5)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    _rot_close(rt.R, R, 1e-3)
    np.testing.assert_allclose(rt.t.numpy(), t, atol=1e-2)
    np.testing.assert_allclose(float(rt.s), scale, atol=1e-3)


def test_sim3_single_hypotheses_distinct_triples(rng, monkeypatch):
    """One hypothesis of three distinct points at a time: same pose and
    inlier count. (A triple with a repeated index is not comparable.)"""
    Xc1, Xc2, s2, valid, _, _ = _ransac_scene(rng)
    for _ in range(8):
        one = rng.choice(np.flatnonzero(valid), (1, 3),
                         replace=False).astype(np.int32)
        rj = _ref_ransac(monkeypatch, one, Xc1, Xc2, s2, valid, False)
        rt = tsim3.sim3_from_hypotheses(0, _t(PIN), _t(Xc1), _t(Xc2), _t(s2),
                                        _t(s2), _t(valid), _t(one))
        assert int(rt.n_inliers) == int(rj.n_inliers)
        _rot_close(rt.R, rj.R, 2e-5)
        np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=2e-4)


def test_sim3_ransac_own_draws(rng):
    """With the port's own generator: the outcome bars of the reference's
    test_recovers_rigid_transform; no valid pair gives 0 inliers."""
    Xc1, Xc2, s2, valid, R, t = _ransac_scene(rng)
    g = torch.Generator().manual_seed(0)
    res = tsim3.sim3_ransac(0, _t(PIN), _t(Xc1), _t(Xc2), _t(s2), _t(s2),
                            _t(valid), g)
    assert int(res.n_inliers) >= 96 - 25 - 5 - 5
    _rot_close(res.R, R, 1e-3)
    np.testing.assert_allclose(res.t.numpy(), t, atol=1e-2)
    idx = tsim3.draw_hypotheses(_t(valid), 128, g)
    assert idx.shape == (128, 3) and bool(_t(valid)[idx].all())
    none = tsim3.sim3_ransac(0, _t(PIN), _t(Xc1), _t(Xc2), _t(s2), _t(s2),
                             torch.zeros(96, dtype=torch.bool), g)
    assert int(none.n_inliers) == 0


def _project(X):
    return np.stack([PIN[0] * X[:, 0] / X[:, 2] + PIN[2],
                     PIN[1] * X[:, 1] / X[:, 2] + PIN[3]], -1)


@pytest.mark.parametrize("with_scale", [False, True])
def test_sim3_refine(rng, with_scale):
    N = 128
    scale = 1.15 if with_scale else 1.0
    Xc2 = rng.uniform(-2, 2, (N, 3)) + [0, 0, 6.0]
    R = Rotation.from_rotvec([0.04, -0.06, 0.03]).as_matrix()
    t = np.array([0.25, -0.1, 0.15])
    Xc1 = scale * Xc2 @ R.T + t
    uv1 = _project(Xc1) + rng.normal(0, 0.5, (N, 2))
    uv2 = _project(Xc2) + rng.normal(0, 0.5, (N, 2))
    uv1[:10] += rng.uniform(-40, 40, (10, 2))          # outliers
    mask = rng.random(N) > 0.1
    s2 = (1.2 ** rng.integers(0, 3, N)).astype(np.float32) ** 2
    R0 = Rotation.from_rotvec([0.02, -0.03, 0.0]).as_matrix()
    t0 = t + 0.05
    args = [a.astype(np.float32) for a in (Xc1, Xc2, uv1, uv2)] \
        + [s2, s2, mask, np.float32(1.0), R0.astype(np.float32),
           t0.astype(np.float32)]
    rj = jsim3.sim3_refine(0, _j(PIN), *[_j(a) for a in args],
                           with_scale=with_scale)
    rt = tsim3.sim3_refine(0, _t(PIN), *[_t(a) for a in args],
                           with_scale=with_scale)
    assert rt.R.dtype == torch.float32
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 90
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    _rot_close(rt.R, rj.R, 1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-3)
    np.testing.assert_allclose(float(rt.s), float(rj.s), atol=1e-4)
    _rot_close(rt.R, R, 5e-3)


@pytest.mark.parametrize("with_scale", [False, True])
def test_sim3_refine_world(rng, with_scale):
    N = 160
    Xw = rng.uniform(-3, 3, (N, 3)) + [0, 0, 7.0]
    R = Rotation.from_rotvec([0.03, 0.05, -0.02]).as_matrix()
    t = np.array([-0.2, 0.1, 0.3])
    uv = _project(Xw @ R.T + t) + rng.normal(0, 0.5, (N, 2))
    uv[:12] += rng.uniform(-40, 40, (12, 2))
    mask = rng.random(N) > 0.15
    s2 = (1.2 ** rng.integers(0, 3, N)).astype(np.float32) ** 2
    args = [Xw.astype(np.float32), uv.astype(np.float32), s2, mask,
            np.float32(1.0), np.eye(3, dtype=np.float32),
            (t + 0.04).astype(np.float32)]
    rt = tsim3.sim3_refine_world(0, _t(PIN), *[_t(a) for a in args],
                                 with_scale=with_scale)
    if with_scale:
        # from world points alone (s, t) -> (a s, a t) leaves every
        # projection unchanged: the 7-DoF normal matrix is singular along
        # that direction and each package's step along it is rounding noise
        # over the 1e-6 damping. Only what the gauge leaves alone is held,
        # and for the port alone: the rotation and the camera centre.
        assert int(rt.n_inliers) >= 100
        _rot_close(rt.R, R, 5e-3)
        centre = -(rt.R.numpy().T @ rt.t.numpy()) / float(rt.s)
        np.testing.assert_allclose(centre, -R.T @ t, atol=5e-2)
        return
    rj = jsim3.sim3_refine_world(0, _j(PIN), *[_j(a) for a in args],
                                 with_scale=with_scale)
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 100
    _rot_close(rt.R, rj.R, 1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-3)
    np.testing.assert_allclose(float(rt.s), float(rj.s), atol=1e-4)


def test_sim3_guided_match_exact(rng):
    """Exact integers, ties included: duplicated keyframe-1 descriptors at
    one pixel make the argmin tie, and the first index wins on both sides."""
    N1, N2 = 200, 150
    X2 = (rng.uniform(-2, 2, (N2, 3)) + [0, 0, 6.0]).astype(np.float32)
    R = Rotation.from_rotvec([0.02, -0.04, 0.01]).as_matrix().astype(
        np.float32)
    t = np.array([0.1, 0.05, -0.1], np.float32)
    uv = _project(X2 @ R.T + t).astype(np.float32)
    desc2 = rng.integers(0, 2 ** 32, (N2, 8), dtype=np.uint32)
    desc1 = rng.integers(0, 2 ** 32, (N1, 8), dtype=np.uint32)
    xy1 = rng.uniform(0, 320, (N1, 2)).astype(np.float32)
    take = rng.choice(N2, 100, replace=False)
    xy1[:100] = uv[take] + rng.normal(0, 2.0, (100, 2)).astype(np.float32)
    desc1[:100] = desc2[take]
    desc1[:100, 0] ^= rng.integers(0, 2 ** 12, 100, dtype=np.uint32)
    xy1[100:110] = xy1[:10]                     # exact ties
    desc1[100:110] = desc1[:10]
    oct1 = rng.integers(0, 4, N1).astype(np.int32)
    v1 = rng.random(N1) > 0.05
    v1[:10] = v1[100:110] = True
    v2 = rng.random(N2) > 0.05
    args = [np.float32(1.0), R, t, X2, v2, desc2, xy1, oct1, desc1, v1]
    gj = jsim3.sim3_guided_match(0, _j(PIN), *[_j(a) for a in args],
                                 _j(np.float32(320)), _j(np.float32(240)))
    gt = tsim3.sim3_guided_match(0, _t(PIN), *[_t(a) for a in args], 320.0,
                                 240.0)
    assert gt.dtype == torch.int32
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert (gt.numpy() >= 0).sum() >= 60
    assert not np.isin(gt.numpy(), np.arange(100, 110)).any()


# ---------------------------------------------------------------------------
# models/map_state.py::covisibility_matrix
# ---------------------------------------------------------------------------

def _random_map(rng, K=10, N=64, Mc=300, n_valid_kf=8):
    """A reference MapState (numpy dict) with random observations; one
    keyframe observes a point twice, two keyframes are not valid."""
    ms = {k: np.array(v) for k, v in JM.empty_map(
        JM.MapConfig(max_kf=K, max_mp=Mc, n_feat=N))._asdict().items()}
    obs = np.where(rng.random((K, N)) < 0.7,
                   rng.integers(0, 120, (K, N)), -1).astype(np.int32)
    obs[3, :2] = 7                             # a duplicate observation
    ms["obs_mp"] = obs
    ms["kf_valid"] = np.arange(K) < n_valid_kf
    ms["kp_valid"] = np.ones((K, N), bool)
    ms["mp_valid"] = np.arange(Mc) < 120
    return ms


def test_covisibility_matrix_exact(rng):
    d = _random_map(rng)
    cj = np.asarray(JM.covisibility_matrix(JM.MapState(
        **{k: _j(v) for k, v in d.items()})))
    mt = TM.map_state_from_numpy(d)
    ct = TM.covisibility_matrix(mt)
    assert ct.dtype == torch.int32
    np.testing.assert_array_equal(ct.numpy(), cj)
    assert ct.numpy()[:8, :8].max() > 10 and (ct.numpy()[8:] == 0).all()
    # each row is covisibility_counts of that keyframe among valid ones
    for q in (0, 3):
        np.testing.assert_array_equal(
            ct[q].numpy(), TM.covisibility_counts(mt, q).numpy())


# ---------------------------------------------------------------------------
# ops/pose_graph.py: a drifted ring with one loop edge
# ---------------------------------------------------------------------------

def _ring(rng, K=16, radius=10.0, pad_to=None):
    """Ground-truth ring of K camera-from-world poses; odometry edges from
    the truth plus noise, integrated into a drifted estimate; one loop edge
    (K-1 -> 0) from the truth. Slot K-1+1.. up to `pad_to` edges are padding
    (0, 0, weight 0, invalid)."""
    Rs, ts = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        Rwc = Rotation.from_euler("y", a).as_matrix()
        c = np.array([radius * np.sin(a), 0.0, radius * (1 - np.cos(a))])
        Rs.append(Rwc.T)
        ts.append(-Rwc.T @ c)
    Rs, ts = np.stack(Rs), np.stack(ts)

    def rel(Ri, ti, Rj, tj):
        Rz = Ri @ Rj.T
        return Rz, ti - Rz @ tj

    e_i, e_j, e_R, e_t, e_w = [], [], [], [], []
    R_est, t_est = [Rs[0]], [ts[0]]
    for k in range(1, K):
        Rz, tz = rel(Rs[k], ts[k], Rs[k - 1], ts[k - 1])
        Rz = Rotation.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix() @ Rz
        tz = tz + rng.normal(0, 0.03, 3)
        e_i.append(k), e_j.append(k - 1), e_R.append(Rz), e_t.append(tz)
        e_w.append(10.0)
        R_est.append(Rz @ R_est[-1])
        t_est.append(Rz @ t_est[-1] + tz)
    Rz, tz = rel(Rs[K - 1], ts[K - 1], Rs[0], ts[0])
    e_i.append(K - 1), e_j.append(0), e_R.append(Rz), e_t.append(tz)
    e_w.append(20.0)
    n_live = len(e_i)
    E = pad_to or n_live
    pad = E - n_live
    out = dict(
        R=np.stack(R_est).astype(np.float32),
        t=np.stack(t_est).astype(np.float32),
        fixed=np.arange(K) == 0,
        e_i=np.array(e_i + [0] * pad, np.int32),
        e_j=np.array(e_j + [0] * pad, np.int32),
        e_R=np.concatenate([np.stack(e_R), np.tile(np.eye(3), (pad, 1, 1))]
                           ).astype(np.float32),
        e_t=np.concatenate([np.stack(e_t), np.zeros((pad, 3))]
                           ).astype(np.float32),
        e_w=np.array(e_w + [0.0] * pad, np.float32),
        e_valid=np.arange(E) < n_live)
    return out, Rs, ts


def _centres(R, t):
    return -np.einsum("kji,kj->ki", np.asarray(R), np.asarray(t))


def test_pose_graph_se3(rng):
    g, Rs, ts = _ring(rng)
    keys = ("R", "t", "fixed", "e_i", "e_j", "e_R", "e_t", "e_w", "e_valid")
    rj = jpg.optimize_pose_graph(*[_j(g[k]) for k in keys], n_iters=10)
    rt = tpg.optimize_pose_graph(*[_t(g[k]) for k in keys], n_iters=10)
    assert rt.R.dtype == torch.float32
    _rot_close(rt.R, rj.R, 2e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=2e-3)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost),
                               rtol=2e-2, atol=1e-4)
    # the loop edge pulls the drifted end back
    before = np.linalg.norm(_centres(g["R"], g["t"])[-1]
                            - _centres(Rs, ts)[-1])
    after = np.linalg.norm(_centres(rt.R.numpy(), rt.t.numpy())[-1]
                           - _centres(Rs, ts)[-1])
    assert after < 0.5 * before
    np.testing.assert_array_equal(rt.R[0].numpy(), g["R"][0])   # fixed


def test_pose_graph_padded_equals_exact(rng):
    """The reference pads its edge tables to a power of two >= 256 with
    weight-0 edges (0, 0); the port builds exact tables. Both must give the
    same result."""
    g, _, _ = _ring(rng)
    gp, _, _ = _ring(np.random.default_rng(0), pad_to=256)
    keys = ("R", "t", "fixed", "e_i", "e_j", "e_R", "e_t", "e_w", "e_valid")
    exact = tpg.optimize_pose_graph(*[_t(g[k]) for k in keys], n_iters=10)
    padded = tpg.optimize_pose_graph(*[_t(gp[k]) for k in keys], n_iters=10)
    _rot_close(padded.R, exact.R, 1e-5)
    np.testing.assert_allclose(padded.t.numpy(), exact.t.numpy(), atol=1e-4)
    rj = jpg.optimize_pose_graph(*[_j(gp[k]) for k in keys], n_iters=10)
    _rot_close(exact.R, rj.R, 2e-4)
    np.testing.assert_allclose(exact.t.numpy(), np.asarray(rj.t), atol=2e-3)


def test_pose_graph_4dof(rng):
    g, _, _ = _ring(rng)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    keys = ("fixed", "e_i", "e_j", "e_R", "e_t", "e_w", "e_valid")
    rj = jpg.optimize_pose_graph_4dof(_j(g["R"]), _j(g["t"]), _j(up),
                                      *[_j(g[k]) for k in keys], n_iters=10)
    rt = tpg.optimize_pose_graph_4dof(_t(g["R"]), _t(g["t"]), _t(up),
                                      *[_t(g[k]) for k in keys], n_iters=10)
    _rot_close(rt.R, rj.R, 2e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=2e-3)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost),
                               rtol=2e-2, atol=1e-4)
    # only yaw about `up` moved: R_new = R_old Rz^T keeps the up axis
    dR = np.einsum("kji,kjl->kil", g["R"], rt.R.numpy())
    np.testing.assert_allclose(dR @ up, np.tile(up, (16, 1)), atol=1e-4)


def test_pose_graph_sim3(rng):
    g, _, _ = _ring(rng)
    K, E = 16, len(g["e_i"])
    s = np.ones(K, np.float32)
    e_s = np.ones(E, np.float32)
    e_s[-1] = 1.05                       # the loop edge carries scale drift

    def run(mod, cv):
        return mod.optimize_pose_graph_sim3(
            cv(s), cv(g["R"]), cv(g["t"]), cv(g["fixed"]), cv(g["e_i"]),
            cv(g["e_j"]), cv(e_s), cv(g["e_R"]), cv(g["e_t"]), cv(g["e_w"]),
            cv(g["e_valid"]), n_iters=10)
    rj, rt = run(jpg, _j), run(tpg, _t)
    _rot_close(rt.R, rj.R, 2e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=2e-3)
    np.testing.assert_allclose(rt.s.numpy(), np.asarray(rj.s), atol=2e-4)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost),
                               rtol=2e-2, atol=1e-4)
    assert abs(float(rt.s[-1]) - 1.0) > 5e-3     # scale was redistributed


def test_relative_pose(rng):
    g, _, _ = _ring(rng)
    Rj, tj = jax.vmap(jpg.relative_pose)(_j(g["R"][1:]), _j(g["t"][1:]),
                                         _j(g["R"][:-1]), _j(g["t"][:-1]))
    Rt, tt = tpg.relative_pose(_t(g["R"][1:]), _t(g["t"][1:]),
                               _t(g["R"][:-1]), _t(g["t"][:-1]))
    _rot_close(Rt, Rj, 1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)


# ---------------------------------------------------------------------------
# ops/ba.py::ba_alternate
# ---------------------------------------------------------------------------

def _ba_problem(rng, C=6, P=80, bf=45.0):
    X = (rng.uniform(-3, 3, (P, 3)) + [0, 0, 8.0])
    Rs = np.stack([Rotation.from_rotvec(rng.normal(0, 0.05, 3)).as_matrix()
                   for _ in range(C)])
    ts = rng.normal(0, 0.3, (C, 3))
    f_cam = np.repeat(np.arange(C), P).astype(np.int32)
    f_pt = np.tile(np.arange(P), C).astype(np.int32)
    Xc = np.einsum("fij,fj->fi", Rs[f_cam], X[f_pt]) + ts[f_cam]
    uv = _project(Xc) + rng.normal(0, 0.4, (C * P, 2))
    ur = uv[:, 0] - bf / Xc[:, 2]
    ur[rng.random(C * P) < 0.3] = -1.0         # monocular factors
    f_valid = rng.random(C * P) > 0.2
    s2 = (1.2 ** rng.integers(0, 3, C * P)).astype(np.float32) ** 2
    R0 = np.stack([Rotation.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix()
                   @ R for R in Rs])
    cam_opt = np.arange(C) != 0
    R0[0] = Rs[0]
    t0 = ts + rng.normal(0, 0.03, ts.shape) * cam_opt[:, None]
    X0 = X + rng.normal(0, 0.05, X.shape)
    pt_opt = rng.random(P) > 0.05
    f32 = np.float32
    return (np.float32(bf), R0.astype(f32), t0.astype(f32), cam_opt,
            X0.astype(f32), pt_opt, f_cam, f_pt, uv.astype(f32),
            ur.astype(f32), s2, f_valid), (Rs, ts, X)


def test_ba_alternate(rng):
    args, _ = _ba_problem(rng)
    Rj, tj, Pj = jba.ba_alternate(0, _j(PIN), *[_j(a) for a in args],
                                  n_sweeps=2)
    Rt, tt, Pt = tba.ba_alternate(0, _t(PIN), *[_t(a) for a in args],
                                  n_sweeps=2)
    assert Rt.dtype == torch.float32
    _rot_close(Rt, Rj, 1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-3)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-3)
    # the fixed camera only goes through normalize_rotation
    np.testing.assert_allclose(Rt[0].numpy(), args[1][0], atol=1e-6)
    assert np.abs(Pt.numpy() - args[4]).max() > 1e-2           # it moved
    fixed_pt = ~args[5]
    np.testing.assert_array_equal(Pt.numpy()[fixed_pt], args[4][fixed_pt])


# ---------------------------------------------------------------------------
# pipeline/loop_closing.py: the LoopCloser's host logic, the whole-System orbit
# ---------------------------------------------------------------------------

from ms_slam_tpu_torch.ops.orb import OrbConfig                 # noqa: E402
from ms_slam_tpu_torch.pipeline import loop_closing as tlc      # noqa: E402
from ms_slam_tpu_torch.pipeline.frontend import Calib           # noqa: E402
from ms_slam_tpu_torch.pipeline.system import System, SystemConfig  # noqa: E402
from ms_slam_tpu_torch.utils import synth                       # noqa: E402

H, W, FX, BL = 240, 320, 260.0, 0.15
N_EARLY = 6
DRIFT_R = Rotation.from_rotvec([0.01, 0.05, -0.01]).as_matrix()
DRIFT_T = np.array([0.25, -0.05, 0.15])


def _cfg(calib_t, orb_t, map_t, cfg_t, **kw):
    """tests/test_loop_closing.py's orbit configuration, with a smaller
    keyframe pool and a keyframe every other frame."""
    calib = calib_t(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                    width=W, height=H, th_depth=BL * 45, fps=10.0)
    return cfg_t(calib=calib, orb=orb_t(n_features=512, n_levels=4),
                 map=map_t(max_kf=24, max_mp=8192, n_feat=512,
                           local_mp_cap=2048, window_kf=6, grid_w=16,
                           grid_h=12),
                 min_init_depth_points=100, max_frames_between_kf=2, **kw)


# ---------------------------------------------------------------------------
# LoopCloser's host logic with stubbed packed arrays
# ---------------------------------------------------------------------------

class _Packed:
    def __init__(self, a):
        self.a = np.asarray(a, np.float32)

    def get(self):
        return self.a


def _stub_closer(n_kf=8):
    slam = System(_cfg(Calib, OrbConfig, TM.MapConfig, SystemConfig,
                       loop_closing=True), device="cpu")
    slam.kf_order = list(range(n_kf))
    slam.kf_maps = [0] * n_kf
    slam.n_kf = n_kf
    lc = slam._loop_closer
    lc.confirmed = []
    lc._confirm = lambda slot: lc.confirmed.append(slot)
    lc.dispatched = []
    lc._dispatch_query = lambda slot: lc.dispatched.append(slot)
    return slam, lc


def _query_row(c, n_inl):
    return np.r_[c, 0.4, n_inl, 1.0, 0.1, 0.2, 0.3, np.eye(3).ravel()]


def _refine_row(n_proj, n_opt, n_rep):
    return np.r_[n_proj, n_opt, n_rep, 1.0, 0.4, 0.5, 0.6, np.eye(3).ravel()]


def test_hypothesis_ladder_confirms():
    """_flush_query starts the hypothesis (best row by inliers, >= 20),
    two accepted refinements reach 3 coincidences and confirm."""
    slam, lc = _stub_closer()
    assert (lc.th_proj, lc.th_opt, lc.th_rep) == (10, 14, 26)
    lc._pending = ("query", 5, _Packed([_query_row(1, 12), _query_row(2, 40),
                                        _query_row(3, 0)]))
    lc.flush()
    h = lc._hyp
    assert (h["match"], h["last_cur"], h["n_coin"]) == (2, 5, 1)
    assert lc.stats["verified"] == 1 and lc._pending is None
    # S_cw = S_cm * T_mw with the matched keyframe at the identity
    np.testing.assert_allclose(h["S_lw"][2], [0.1, 0.2, 0.3], atol=1e-7)
    for slot, n_coin in ((6, 2), (7, 3)):
        lc._pending = ("refine", slot, _Packed(_refine_row(10, 15, 26)))
        lc.flush()
        assert lc._hyp["n_coin"] == n_coin and lc._hyp["last_cur"] == slot
        np.testing.assert_allclose(lc._hyp["S_lw"][2], [0.4, 0.5, 0.6])
    assert lc.confirmed == [7] and lc.stats["verified"] == 3
    assert lc.dispatched == []


def test_hypothesis_ladder_too_few_inliers_or_culled():
    slam, lc = _stub_closer()
    lc._pending = ("query", 5, _Packed([_query_row(2, 19)] * 3))
    lc.flush()
    assert lc._hyp is None and lc.stats["verified"] == 0
    slam.kf_order.remove(2)                       # the candidate was culled
    lc._pending = ("query", 5, _Packed([_query_row(2, 40)] * 3))
    lc.flush()
    assert lc._hyp is None


def test_hypothesis_ladder_two_misses_drop():
    """A refinement under any rung of the ladder is a miss: it dispatches a
    database query in the same call; the second miss in a row drops the
    hypothesis, a hit in between resets the count."""
    slam, lc = _stub_closer()
    lc._pending = ("query", 4, _Packed([_query_row(2, 40)] * 3))
    lc.flush()
    lc._pending = ("refine", 5, _Packed(_refine_row(10, 14, 26)))  # n_opt
    lc.flush()
    assert lc._hyp["n_notfound"] == 1 and lc.dispatched == [5]
    lc._pending = ("refine", 6, _Packed(_refine_row(10, 15, 26)))  # a hit
    lc.flush()
    assert lc._hyp["n_notfound"] == 0 and lc._hyp["n_coin"] == 2
    lc._pending = ("refine", 7, _Packed(_refine_row(9, 15, 26)))
    lc.flush()
    assert lc._hyp is not None
    slam.kf_order.append(8)
    lc._pending = ("refine", 8, _Packed(_refine_row(10, 15, 25)))
    lc.flush()
    assert lc._hyp is None and lc.dispatched == [5, 7, 8]
    assert lc.confirmed == []


def test_insert_keyframe_dispatches_and_defers():
    """No database candidate: nothing is dispatched. With a hypothesis
    whose endpoints live, a refinement is dispatched and stays pending
    until the next keyframe or flush(); a culled endpoint drops it."""
    slam, lc = _stub_closer()
    lc.insert_keyframe(3)
    assert lc._pending is None and lc.dispatched == [3]
    lc._hyp = {"match": 1, "last_cur": 2,
               "S_lw": (1.0, np.eye(3, dtype=np.float32),
                        np.zeros(3, np.float32)),
               "n_coin": 1, "n_notfound": 0}
    lc.insert_keyframe(4)
    kind, slot, packed = lc._pending
    assert (kind, slot) == ("refine", 4) and lc.stats["refines"] == 1
    assert packed.get().shape == (16,)
    slam.shutdown()                               # flushes the closer too
    assert lc._pending is None
    lc._hyp = {"match": 99, "last_cur": 2, "S_lw": None, "n_coin": 1,
               "n_notfound": 0}
    lc.insert_keyframe(5)
    assert lc._hyp is None and lc.dispatched[-1] == 5


def test_inertial_yaw_only_loop_gate():
    """Counterpart of the reference's test of the same name: with gravity
    observed a correction whose world rotation has pitch/roll beyond
    0.008 rad is rejected; yaw-only corrections under 0.349 rad pass. The
    gate opens with inertial stage 2, which is also what sends a correction
    through the 4-DoF graph and the full inertial BA
    (test_torch_loop_slice.py::test_correct_loop_inertial_4dof)."""
    slam, lc = _stub_closer()
    slam.gravity = np.array([0.0, -9.81, 0.0], np.float32)
    up = np.array([0.0, 1.0, 0.0])

    def rot(v):
        return Rotation.from_rotvec(v).as_matrix()
    R_pitch = rot([0.05, 0.0, 0.0])
    assert lc._inertial_gate_ok(0, 1, R_pitch)      # no IMU: gate inactive
    slam.cfg.use_imu = True
    slam.imu_initialized = True
    slam._imu_stage = 2
    assert lc._inertial_gate_ok(0, 1, rot(up * 0.1))
    assert not lc._inertial_gate_ok(0, 1, R_pitch)
    assert lc.stats.get("yaw_rejected", 0) == 1
    assert not lc._inertial_gate_ok(0, 1, rot(up * 0.5))
    assert lc._inertial_gate_ok(0, 1, rot(up * 0.5), tol_scale=2.0)
    assert lc._inertial_ready()
    slam._imu_stage = 1                 # gravity not settled yet: gate off
    assert not lc._inertial_ready()
    assert lc._inertial_gate_ok(0, 1, R_pitch)


def test_deferred_fetch_cpu():
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    d = tlc._Deferred(t)
    np.testing.assert_array_equal(d.get(), t.numpy())


@pytest.mark.slow
def test_loop_closure_in_box_world():
    """Counterpart of the reference's slow test of the same name, scene and
    bars: a full orbit inside a textured room at 512 features, then 32
    frames into a second lap, through the port's System on the CPU. The
    revisit must be detected and corrected, and tracking against the
    corrected sparsified map must stay tight."""
    from ms_slam_tpu_torch.utils.evaluate import ate_rmse
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    calib = Calib(model=0, params=(FX, FX, W / 2, H / 2), bf=FX * BL,
                  width=W, height=H, th_depth=BL * 45, fps=10.0)
    cfg = SystemConfig(
        calib=calib, orb=OrbConfig(n_features=512, n_levels=4),
        map=TM.MapConfig(max_kf=96, max_mp=12288, n_feat=512,
                         local_mp_cap=2048, window_kf=6, grid_w=16,
                         grid_h=12),
        min_init_depth_points=100, max_frames_between_kf=3, sparsify=True,
        sparsify_n=40, sparsify_window=4, sparsify_queue_min=2,
        nonlocal_kf=3, loop_closing=True, loop_covis_min=30)
    slam = System(cfg, device="cpu")
    world = synth.BoxWorld(np.random.default_rng(0), half=7.0)
    poses = synth.make_trajectory(80, "orbit")
    poses = poses + poses[:32]
    for i, T_wc in enumerate(poses):
        im_l, im_r = world.render_stereo(K, T_wc, BL, H, W)
        slam.track_stereo(im_l, im_r, timestamp=0.1 * i)
    lc = slam._loop_closer
    assert lc.stats["queries"] > 0
    assert lc.stats["refines"] >= 2, lc.stats
    assert lc.stats["loops"] >= 1, lc.stats
    assert slam.state == "OK"
    slam.shutdown()
    gt_by_ts = {round(0.1 * i, 6): T for i, T in enumerate(poses)}
    rows = slam.poses_wc()
    est_xyz = np.stack([T[:3, 3] for _, T in rows])
    gt_xyz = np.stack([gt_by_ts[round(ts, 6)][:3, 3] for ts, _ in rows])
    path_len = np.sum(np.linalg.norm(np.diff(gt_xyz, axis=0), axis=1))
    assert ate_rmse(est_xyz, gt_xyz) < 0.09 * path_len
    lap2 = [(ts, T) for ts, T in rows if ts > 0.1 * 80 - 1e-6]
    assert len(lap2) >= 10
    err2 = [np.linalg.norm(T[:3, 3] - gt_by_ts[round(ts, 6)][:3, 3])
            for ts, T in lap2]
    assert float(np.mean(err2[-12:])) < 0.10 * path_len


@pytest.mark.parametrize("with_scale", [False, True])
def test_refinement_jacobians_against_autodiff(rng, with_scale):
    """The hand-written Jacobians of the two projection residuals equal
    `torch.func.jacfwd` of the same residuals, at a state away from zero
    (rtol 1e-3 of each Jacobian's largest entry: float32 through a
    projection with fx = 300)."""
    N = 40
    X = _t((rng.uniform(-2, 2, (N, 3)) + [0, 0, 6.0]).astype(np.float32))
    uv = _t(rng.uniform(0, 300, (N, 2)).astype(np.float32))
    sd = _t((1.2 ** rng.integers(0, 3, (N, 1))).astype(np.float32))
    s0 = torch.tensor(1.1)
    R0 = _t(Rotation.from_rotvec([0.1, -0.2, 0.05]).as_matrix().astype(
        np.float32))
    t0 = _t(np.array([0.2, -0.1, 0.3], np.float32))
    x = _t(np.array([0.05, -0.08, 0.03, 0.1, -0.05, 0.02, 0.04][
        :7 if with_scale else 6], np.float32))
    for fn in (tsim3._proj_res_jac, tsim3._inv_proj_res_jac):
        def res(x_):
            return fn(0, _t(PIN), x_, X, uv, sd, s0, R0, t0, with_scale)[0]
        J = fn(0, _t(PIN), x, X, uv, sd, s0, R0, t0, with_scale)[1]
        J_ad = torch.func.jacfwd(res)(x)
        assert J.shape == J_ad.shape == (N, 2, len(x))
        np.testing.assert_allclose(J.numpy(), J_ad.numpy(),
                                   atol=1e-3 * float(J_ad.abs().max()))
