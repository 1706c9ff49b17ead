"""Parity of the port's geometry primitives with the JAX reference.

Both sides get the same float32 numpy inputs (the JAX side runs on the CPU
with x64 enabled by conftest.py, so inputs are cast explicitly). Tolerance
rtol=1e-5, atol=1e-6: a few float32 ulps of O(1..1e3) values — the two
frameworks evaluate sin/cos/atan2 and small matrix products with different
instruction sequences, so results agree to rounding, not bit for bit. The
DLT triangulation is held at rtol=5e-5: its 3x3 normal equations square the
condition number, and each side alone lies ~1e-5 (relative) from the
float64 solution on this case. `so3_log` is held at atol=1e-5: it goes
through a quaternion and atan2, and near pi one float32 ulp of the ~3.1 rad
result is already 2.4e-7.
The cases mirror tests/test_lie.py and tests/test_cameras.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ms_slam_tpu.ops import cameras as jcam
from ms_slam_tpu.ops import lie as jlie
from ms_slam_tpu.ops import robust as jrob
from ms_slam_tpu.ops import triangulate as jtri
from ms_slam_tpu_torch.ops import cameras as tcam
from ms_slam_tpu_torch.ops import lie as tlie
from ms_slam_tpu_torch.ops import robust as trob
from ms_slam_tpu_torch.ops import triangulate as ttri

RTOL, ATOL = 1e-5, 1e-6
PIN = np.asarray([718.856, 718.856, 607.1928, 185.2157, 0, 0, 0, 0],
                 np.float32)


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def both(fn_j, fn_t, *args):
    """Run the JAX and torch functions on the same float32 numpy args."""
    out_j = fn_j(*[jnp.asarray(a) for a in args])
    out_t = fn_t(*[torch.from_numpy(a) for a in args])
    if isinstance(out_j, tuple):
        return [np.asarray(o) for o in out_j], [o.numpy() for o in out_t]
    return [np.asarray(out_j)], [out_t.numpy()]


def check(fn_j, fn_t, *args, rtol=RTOL, atol=ATOL):
    oj, ot = both(fn_j, fn_t, *args)
    for a, b in zip(oj, ot):
        assert a.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


def rand_points(rng, n=64):
    X = rng.normal(size=(n, 3))
    X[:, 2] = np.abs(X[:, 2]) + 1.0
    return X.astype(np.float32)


def near_pi(rng):
    axis = rng.normal(size=(8, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    return (axis * (np.pi - 1e-3)).astype(np.float32)


W_CASES = {
    "random": lambda rng: f32(rng, 32, 3, scale=2.0),
    "unit": lambda rng: f32(rng, 32, 3, scale=1.0),
    "small": lambda rng: np.asarray([[1e-10, 0, 0], [0, 0, 0], [1e-5, 2e-5, 0]],
                                    np.float32),
    "near_pi": near_pi,
}


@pytest.mark.parametrize("case", sorted(W_CASES))
def test_so3_exp(rng, case):
    check(jlie.so3_exp, tlie.so3_exp, W_CASES[case](rng))


@pytest.mark.parametrize("case", ["unit", "near_pi"])
def test_so3_log(rng, case):
    R = np.asarray(jlie.so3_exp(jnp.asarray(W_CASES[case](rng))))
    check(jlie.so3_log, tlie.so3_log, R.astype(np.float32), atol=1e-5)


def test_rot_to_quat(rng):
    R = np.asarray(jlie.so3_exp(jnp.asarray(f32(rng, 32, 3, scale=2.0))))
    check(jlie.rot_to_quat, tlie.rot_to_quat, R)


def test_normalize_rotation(rng):
    R = np.asarray(jlie.so3_exp(jnp.asarray(f32(rng, 16, 3))))
    R = (R + f32(rng, 16, 3, 3, scale=1e-3)).astype(np.float32)
    check(jlie.normalize_rotation, tlie.normalize_rotation, R)


def test_se3_exp(rng):
    check(jlie.se3_exp, tlie.se3_exp, f32(rng, 32, 6))


def test_se3_compose_inv_apply(rng):
    Ra, ta = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(f32(rng, 8, 6))))
    Rb, tb = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(f32(rng, 8, 6))))
    X = f32(rng, 8, 3, scale=5.0)
    check(jlie.se3_compose, tlie.se3_compose, Ra, ta, Rb, tb)
    check(jlie.se3_inv, tlie.se3_inv, Ra, ta)
    check(jlie.se3_apply, tlie.se3_apply, Ra, ta, X)


def test_inv_solve3x3(rng):
    A = f32(rng, 16, 3, 3) + 3 * np.eye(3, dtype=np.float32)
    b = f32(rng, 16, 3)
    check(jlie.inv3x3, tlie.inv3x3, A)
    check(jlie.solve3x3, tlie.solve3x3, A, b)


def test_solve_psd6(rng):
    G = f32(rng, 8, 6, 6)
    A = (G @ G.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
         ).astype(np.float32)
    check(jlie.solve_psd6, tlie.solve_psd6, A, f32(rng, 8, 6))


def test_hat_vee(rng):
    w = f32(rng, 16, 3)
    check(jlie.hat, tlie.hat, w)
    check(jlie.vee, tlie.vee, np.asarray(jlie.hat(jnp.asarray(w))))


def test_pinhole_project_unproject(rng):
    X = rand_points(rng)
    check(lambda p, x: jcam.project(jcam.PINHOLE, p, x),
          lambda p, x: tcam.project(tcam.PINHOLE, p, x), PIN, X)
    uv = np.asarray(jcam.pinhole_project(jnp.asarray(PIN), jnp.asarray(X)))
    check(lambda p, u: jcam.unproject(jcam.PINHOLE, p, u),
          lambda p, u: tcam.unproject(tcam.PINHOLE, p, u), PIN,
          uv.astype(np.float32))


def test_pinhole_jacobian(rng):
    check(lambda p, x: jcam.project_jac(jcam.PINHOLE, p, x),
          lambda p, x: tcam.project_jac(tcam.PINHOLE, p, x), PIN,
          rand_points(rng, 16))


def test_kb8_not_ported():
    with pytest.raises(NotImplementedError):
        tcam.project(tcam.KB8, torch.zeros(8), torch.ones(1, 3))


def test_huber_weight(rng):
    chi2 = np.abs(f32(rng, 64, scale=10.0))
    for delta2 in (jrob.CHI2_2DOF, jrob.CHI2_3DOF):
        check(lambda c: jrob.huber_weight(c, delta2),
              lambda c: trob.huber_weight(c, delta2), chi2)


def test_triangulate_dlt(rng):
    X = rand_points(rng, 32) + np.asarray([0, 0, 4.0], np.float32)
    R2, t2 = (np.asarray(a, np.float32) for a in jlie.se3_exp(
        jnp.asarray([0.5, 0.02, 0.01, 0.01, -0.03, 0.02], jnp.float32)))
    P1 = np.broadcast_to(np.concatenate([np.eye(3), np.zeros((3, 1))], 1),
                         (32, 3, 4)).astype(np.float32)
    P2 = np.broadcast_to(np.concatenate([R2, t2[:, None]], 1),
                         (32, 3, 4)).astype(np.float32)
    Xc2 = X @ R2.T + t2
    x1 = (X / X[:, 2:3]).astype(np.float32)
    x2 = (Xc2 / Xc2[:, 2:3]).astype(np.float32)
    check(jtri.triangulate_dlt, ttri.triangulate_dlt, x1, x2, P1, P2,
          rtol=5e-5)
