"""Unit oracles for SE3 ops: scipy.spatial.transform as ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from gmmloc.geometry import se3


def random_quat(rng, n=None):
    shape = (4,) if n is None else (n, 4)
    q = rng.standard_normal(shape)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float64)


def to_scipy(q):
    # ours: (w,x,y,z); scipy: (x,y,z,w)
    return Rotation.from_quat(np.roll(np.asarray(q), -1, axis=-1))


def test_quat_mul_matches_scipy(rng):
    a, b = random_quat(rng, 16), random_quat(rng, 16)
    ours = se3.quat_mul(jnp.array(a), jnp.array(b))
    ref = (to_scipy(a) * to_scipy(b)).as_quat()
    ref = np.roll(ref, 1, axis=-1)
    # quaternions are sign-ambiguous
    sign = np.sign(np.sum(np.asarray(ours) * ref, axis=-1, keepdims=True))
    np.testing.assert_allclose(np.asarray(ours), ref * sign, atol=1e-6)


def test_quat_rotate_matches_matrix(rng):
    q = random_quat(rng, 16)
    v = rng.standard_normal((16, 3))
    ours = se3.quat_rotate(jnp.array(q), jnp.array(v))
    ref = np.einsum("nij,nj->ni", to_scipy(q).as_matrix(), v)
    np.testing.assert_allclose(np.asarray(ours), ref, atol=1e-6)


def test_quat_matrix_roundtrip(rng):
    q = random_quat(rng, 64)
    R = se3.quat_to_matrix(jnp.array(q))
    np.testing.assert_allclose(np.asarray(R), to_scipy(q).as_matrix(), atol=1e-6)
    q2 = se3.matrix_to_quat(R)
    sign = np.sign(np.sum(np.asarray(q2) * q, axis=-1, keepdims=True))
    np.testing.assert_allclose(np.asarray(q2) * sign, q, atol=1e-6)


def test_compose_inverse_identity(rng):
    q, t = jnp.array(random_quat(rng, 8)), jnp.array(rng.standard_normal((8, 3)))
    qi, ti = se3.inverse(q, t)
    qc, tc = se3.compose(q, t, qi, ti)
    np.testing.assert_allclose(np.abs(np.asarray(qc[..., 0])), 1.0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(tc), 0.0, atol=1e-6)


def test_apply_compose_consistency(rng):
    qa, ta = jnp.array(random_quat(rng, 8)), jnp.array(rng.standard_normal((8, 3)))
    qb, tb = jnp.array(random_quat(rng, 8)), jnp.array(rng.standard_normal((8, 3)))
    x = jnp.array(rng.standard_normal((8, 3)))
    qc, tc = se3.compose(qa, ta, qb, tb)
    np.testing.assert_allclose(
        np.asarray(se3.apply(qc, tc, x)),
        np.asarray(se3.apply(qa, ta, se3.apply(qb, tb, x))),
        atol=1e-5,
    )


def test_exp_log_roundtrip(rng):
    xi = rng.standard_normal((32, 6)) * 0.7
    q, t = se3.exp(jnp.array(xi))
    xi2 = se3.log(q, t)
    np.testing.assert_allclose(np.asarray(xi2), xi, atol=1e-5)


def test_exp_small_angle(rng):
    xi = rng.standard_normal((8, 6)) * 1e-8
    q, t = se3.exp(jnp.array(xi, dtype=jnp.float64))
    np.testing.assert_allclose(np.asarray(t), xi[:, 3:], atol=1e-12)
    np.testing.assert_allclose(np.asarray(q[:, 0]), 1.0, atol=1e-12)


def test_so3_exp_matches_scipy(rng):
    w = rng.standard_normal((16, 3))
    q = se3.so3_exp(jnp.array(w))
    ref = Rotation.from_rotvec(w).as_quat()
    ref = np.roll(ref, 1, axis=-1)
    sign = np.sign(np.sum(np.asarray(q) * ref, axis=-1, keepdims=True))
    np.testing.assert_allclose(np.asarray(q), ref * sign, atol=1e-6)


def test_adjoint_property(rng):
    """Ad_T xi == log(T * exp(xi) * T^-1) for small xi."""
    with jax.enable_x64(True):
        q, t = se3.exp(jnp.array(rng.standard_normal(6) * 0.5, dtype=jnp.float64))
        xi = jnp.array(rng.standard_normal(6) * 1e-4, dtype=jnp.float64)
        dq, dt = se3.exp(xi)
        qi, ti = se3.inverse(q, t)
        qc, tc = se3.compose(*se3.compose(q, t, dq, dt), qi, ti)
        lhs = se3.log(qc, tc)
        rhs = se3.adjoint(q, t) @ xi
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), rtol=1e-4, atol=1e-9)


def test_jit_vmap_compatible(rng):
    f = jax.jit(jax.vmap(lambda xi: se3.log(*se3.exp(xi))))
    xi = jnp.array(rng.standard_normal((128, 6)) * 0.3, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(f(xi)), np.asarray(xi), atol=1e-4)
