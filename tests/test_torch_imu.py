"""Parity of the port's IMU preintegration (`ms_slam_tpu_torch/ops/imu.py`,
the SO(3) right Jacobians of `ops/lie.py`) with the JAX reference.

Inputs are tests/test_imu.py's `simulate` rows, made from a numpy seed and
cast explicitly to float32 or float64 for both sides (conftest.py enables
x64 on the JAX side).

Tolerances, relative to each field's largest entry:
- `integrate`: float64 1e-12 (the same recurrences in another order of
  rounding); float32 5e-5 (80 rows of float32 recurrences; the bias
  Jacobians JRg/JVg/JPg lose the most, measured 5e-6 to 9e-6);
- getters, `predict_state`, `inertial_residual`: 1e-5 absolute in float32,
  1e-12 in float64;
- the written-out Jacobians of the residual against `jax.jacfwd` of the
  reference's residual under left perturbations: 1e-10 in float64;
- `information` inverts a covariance of order 1e-8 with a regularizer
  relative to its trace; LAPACK builds round differently, so it is held by
  info @ C_reg = I (2e-3 in float32) and against the reference at 1e-4 of
  the norm, and the Cholesky factor through the whitened residual L^T r at
  1e-3 of its norm, not element by element.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import imu as jimu
from ms_slam_tpu.ops import lie as jlie
from ms_slam_tpu_torch.ops import imu, lie

from test_imu import simulate

torch.set_num_threads(1)       # one thread per test process: xdist workers
try:                            # would otherwise fight over the cores
    torch.set_num_interop_threads(1)
except RuntimeError:
    pass

NOISE = (1e-3, 1e-2, 1e-6, 1e-5)
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def _rel(a, b):
    a = np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max() / max(np.abs(a).max(),
                                                       1e-30))


def _jint(bias, meas, valid, npdt):
    return jimu.integrate(jnp.asarray(bias.astype(npdt)),
                          jnp.asarray(meas.astype(npdt)), jnp.asarray(valid),
                          *[jnp.asarray(n, npdt) for n in NOISE])


def _tint(bias, meas, valid, npdt, **kw):
    return imu.integrate(torch.tensor(bias.astype(npdt)),
                         torch.tensor(meas.astype(npdt)),
                         torch.tensor(valid), *NOISE, **kw)


def _scenario(rng, n=60, pad=20):
    meas, Rs, vs, ps = simulate(rng, n=n, bg=np.array([0.01, -0.02, 0.005]),
                                ba=np.array([0.05, 0.02, -0.03]))
    meas = np.concatenate([meas, np.zeros((pad, 7))])
    valid = np.arange(n + pad) < n
    bias = np.array([0.008, -0.015, 0.004, 0.04, 0.02, -0.02])
    return meas, valid, bias, Rs, vs, ps


@pytest.mark.parametrize("w", [[0.0, 0.0, 0.0], [1e-6, -2e-6, 1e-6],
                               [0.3, -0.2, 0.5], [1.5, 2.0, -1.0]])
def test_so3_right_jacobians(w):
    """tests/test_lie.py:54-64's cases against the reference, float64 1e-12,
    and J_r J_r^-1 = I."""
    jw = jnp.asarray(w, jnp.float64)
    tw = torch.tensor(w, dtype=torch.float64)
    np.testing.assert_allclose(lie.so3_right_jacobian(tw).numpy(),
                               np.asarray(jlie.so3_right_jacobian(jw)),
                               atol=1e-12)
    np.testing.assert_allclose(lie.so3_right_jacobian_inv(tw).numpy(),
                               np.asarray(jlie.so3_right_jacobian_inv(jw)),
                               atol=1e-12)
    np.testing.assert_allclose(
        (lie.so3_right_jacobian(tw) @ lie.so3_right_jacobian_inv(tw)).numpy(),
        np.eye(3), atol=1e-9)


@pytest.mark.parametrize("prec", ["float32", "float64"])
def test_integrate_parity_with_masked_rows(rng, prec):
    npdt, _ = DTYPES[prec]
    meas, valid, bias, *_ = _scenario(rng)
    js = _jint(bias, meas, valid, npdt)
    ts = _tint(bias, meas, valid, npdt)
    tol = 5e-5 if prec == "float32" else 1e-12
    for k in imu.PreintState._fields:
        assert getattr(ts, k).numpy().dtype == npdt, k
        assert _rel(getattr(js, k), getattr(ts, k).numpy()) < tol, k
    # the masked tail changes nothing, and the loop may stop before it
    short = _tint(bias, meas[:60], valid[:60], npdt)
    cut = _tint(bias, meas, valid, npdt, n_rows=60)
    for k in imu.PreintState._fields:
        # (a masked row re-orthonormalizes dR once more: last bits move)
        for other in (cut, short):
            assert _rel(getattr(other, k).numpy(),
                        getattr(ts, k).numpy()) < tol / 10, k


def test_integrate_batched_against_vmap(rng):
    """A leading batch axis (one preintegration per keyframe interval, with
    different row counts) against the reference's vmap."""
    meas, _, bias, *_ = _scenario(rng, n=96, pad=0)
    segs = meas.reshape(4, 24, 7).copy()
    valid = np.ones((4, 24), bool)
    valid[1, 20:] = False
    valid[3, 5:] = False
    segs[~valid] = 0.0
    js = jax.vmap(lambda m, v: _jint(bias, m, v, np.float64))(
        jnp.asarray(segs), jnp.asarray(valid))
    ts = _tint(bias, segs, valid, np.float64)
    for k in imu.PreintState._fields:
        assert getattr(ts, k).shape == np.asarray(getattr(js, k)).shape, k
        assert _rel(getattr(js, k), getattr(ts, k).numpy()) < 1e-12, k


@pytest.mark.parametrize("prec", ["float32", "float64"])
def test_getters_predict_and_residual(rng, prec):
    npdt, tdt = DTYPES[prec]
    tol = 1e-5 if prec == "float32" else 1e-12
    meas, valid, bias, Rs, vs, ps = _scenario(rng)
    js = _jint(bias, meas, valid, npdt)
    ts = _tint(bias, meas, valid, npdt)
    bg, ba = bias[:3] + 0.001, bias[3:] - 0.002
    jb = [jnp.asarray(b.astype(npdt)) for b in (bg, ba)]
    tb = [torch.tensor(b.astype(npdt)) for b in (bg, ba)]
    np.testing.assert_allclose(imu.delta_rotation(ts, tb[0]).numpy(),
                               jimu.delta_rotation(js, jb[0]), atol=tol)
    np.testing.assert_allclose(imu.delta_velocity(ts, *tb).numpy(),
                               jimu.delta_velocity(js, *jb), atol=tol)
    np.testing.assert_allclose(imu.delta_position(ts, *tb).numpy(),
                               jimu.delta_position(js, *jb), atol=tol)
    g = np.array([0.1, 9.7, 0.3])
    for gg in (None, g):
        jp = jimu.predict_state(
            js, *[jnp.asarray(a.astype(npdt)) for a in (Rs[0], vs[0], ps[0])],
            *jb, None if gg is None else jnp.asarray(gg.astype(npdt)))
        tp = imu.predict_state(
            ts, *[torch.tensor(a.astype(npdt)) for a in (Rs[0], vs[0], ps[0])],
            *tb, None if gg is None else torch.tensor(gg.astype(npdt)))
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), a, atol=tol)
    R2 = Rs[60] @ np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.015])))
    args = [Rs[0], vs[0], ps[0], R2, vs[60] + 0.01, ps[60] - 0.02, bg, ba, g]
    jr = jimu.inertial_residual(js, *[jnp.asarray(a.astype(npdt))
                                      for a in args])
    tr = imu.inertial_residual(ts, *[torch.tensor(a.astype(npdt))
                                     for a in args])
    assert tr.dtype == tdt
    np.testing.assert_allclose(tr.numpy(), jr, atol=tol * 3)


def test_residual_jacobians_against_jacfwd(rng):
    """The Forster Jacobians of `inertial_residual_jac` against
    `jax.jacfwd` of the reference's residual, rotations perturbed on the
    left, float64."""
    meas, valid, bias, Rs, vs, ps = _scenario(rng)
    js = _jint(bias, meas, valid, np.float64)
    ts = _tint(bias, meas, valid, np.float64)
    R2 = Rs[60] @ np.asarray(jlie.so3_exp(jnp.asarray([0.05, -0.08, 0.04])))
    args = [Rs[0], vs[0], ps[0], R2, vs[60] + 0.01, ps[60] - 0.02,
            bias[:3] + 0.001, bias[3:] - 0.002, np.array([0.1, 9.7, 0.3])]
    ja = [jnp.asarray(a) for a in args]

    def f(d):
        th1, v1, p1, th2, v2, p2, bg, ba, g = [d[3 * i:3 * i + 3]
                                               for i in range(9)]
        return jimu.inertial_residual(
            js, jlie.so3_exp(th1) @ ja[0], ja[1] + v1, ja[2] + p1,
            jlie.so3_exp(th2) @ ja[3], ja[4] + v2, ja[5] + p2, ja[6] + bg,
            ja[7] + ba, ja[8] + g)

    J_ref = np.asarray(jax.jacfwd(f)(jnp.zeros(27)))
    _, J = imu.inertial_residual_jac(ts, *[torch.tensor(a) for a in args])
    np.testing.assert_allclose(torch.cat(list(J), -1).numpy(), J_ref,
                               atol=1e-10)


@pytest.mark.parametrize("prec", ["float32", "float64"])
def test_information_and_whitening(rng, prec):
    npdt, _ = DTYPES[prec]
    meas, valid, bias, *_ = _scenario(rng)
    js = _jint(bias, meas, valid, npdt)
    ts = _tint(bias, meas, valid, npdt)
    info = imu.information(ts).numpy()
    C = np.asarray(js.C[:9, :9], np.float64)
    C = 0.5 * (C + C.T)
    C_reg = C + 1e-4 * max(np.trace(C) / 9.0, 1e-12) * np.eye(9)
    tol = 2e-3 if prec == "float32" else 1e-9
    np.testing.assert_allclose(info.astype(np.float64) @ C_reg, np.eye(9),
                               atol=tol)
    j_info = np.asarray(jimu.information(js))
    assert np.linalg.norm(info - j_info) < 1e-4 * np.linalg.norm(j_info)
    r = (rng.normal(size=9) * 1e-3).astype(npdt)
    wj = np.asarray(jimu.sqrt_information(js)).T @ r
    wt = imu.sqrt_information(ts).numpy().T @ r
    assert np.linalg.norm(wj - wt) < 1e-3 * np.linalg.norm(wj)


def test_preint_numpy_round_trip(rng):
    """A reference PreintState crosses into the port and back unchanged."""
    meas, valid, bias, *_ = _scenario(rng)
    js = _jint(bias, meas, valid, np.float32)
    ts = imu.preint_from_numpy({k: np.asarray(v)
                                for k, v in js._asdict().items()})
    back = imu.preint_to_numpy(ts)
    for k in imu.PreintState._fields:
        assert getattr(ts, k).dtype == torch.float32
        np.testing.assert_array_equal(back[k], np.asarray(getattr(js, k)))
    z = imu.init_state(torch.zeros(6))
    assert z.C.shape == (15, 15) and float(z.dT) == 0.0
    assert imu.preint_from_numpy(back, dtype=torch.float64).dR.dtype \
        == torch.float64
