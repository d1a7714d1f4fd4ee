"""Batched SE(3) operations on quaternion+translation arrays.

JAX replacement for g2o::SE3Quat (ref:
/root/reference/gmmloc/include/gmmloc/common/common.h:30-38 and the g2o
types used throughout tracking_opt.cpp / localization_opt.cpp).

Representation: a pose is a pair of arrays
    q : (..., 4)  unit quaternion, Hamilton convention, (w, x, y, z)
    t : (..., 3)  translation
mapping points as  x' = R(q) @ x + t.

All functions broadcast over leading batch dimensions and are jit/vmap
friendly. The se(3) tangent convention matches g2o::SE3Quat::log/exp:
xi = [omega, upsilon] (rotation first), t = V(omega) @ upsilon.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# quaternion primitives
# ---------------------------------------------------------------------------


def quat_identity(dtype=jnp.float32):
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q, v):
    """Rotate vectors v (...,3) by quaternions q (...,4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(qv, v)
    uuv = jnp.cross(qv, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_to_matrix(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix (...,3,3) -> quaternion (w,x,y,z). Shepperd's method,
    branch-free via selecting the max-trace variant with where()."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22

    # four candidate solutions, each numerically good in its own region
    def cand_w():
        s = jnp.sqrt(jnp.clip(tr + 1.0, 1e-12)) * 2.0
        return jnp.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)

    def cand_x():
        s = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, 1e-12)) * 2.0
        return jnp.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], -1)

    def cand_y():
        s = jnp.sqrt(jnp.clip(1.0 + m11 - m00 - m22, 1e-12)) * 2.0
        return jnp.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], -1)

    def cand_z():
        s = jnp.sqrt(jnp.clip(1.0 + m22 - m00 - m11, 1e-12)) * 2.0
        return jnp.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], -1)

    qw, qx, qy, qz = cand_w(), cand_x(), cand_y(), cand_z()
    use_w = tr > 0.0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = jnp.where(
        use_w[..., None], qw,
        jnp.where(use_x[..., None], qx, jnp.where(use_y[..., None], qy, qz)),
    )
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SE3 ops
# ---------------------------------------------------------------------------


def identity(dtype=jnp.float32):
    return quat_identity(dtype), jnp.zeros(3, dtype=dtype)


def compose(qa, ta, qb, tb):
    """(qa,ta) * (qb,tb): apply b first, then a."""
    return quat_mul(qa, qb), quat_rotate(qa, tb) + ta


def inverse(q, t):
    qi = quat_conj(q)
    return qi, -quat_rotate(qi, t)


def apply(q, t, x):
    """Map points x (...,3)."""
    return quat_rotate(q, x) + t


def skew(v):
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], -1),
            jnp.stack([v[..., 2], z, -v[..., 0]], -1),
            jnp.stack([-v[..., 1], v[..., 0], z], -1),
        ],
        axis=-2,
    )


def so3_exp(omega):
    """Rodrigues: omega (...,3) -> quaternion."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta = jnp.sqrt(jnp.clip(theta2, 1e-24))
    small = theta2 < 1e-12
    half = 0.5 * theta
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    s = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    return quat_normalize(jnp.concatenate([w, omega * s], axis=-1))


def so3_log(q):
    """Quaternion -> rotation vector omega (...,3)."""
    q = jnp.where(q[..., :1] < 0, -q, q)  # take shortest arc
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    vn = jnp.linalg.norm(v, axis=-1, keepdims=True)
    theta = 2.0 * jnp.arctan2(vn, w)
    small = vn < 1e-9
    scale = jnp.where(small, 2.0 / jnp.clip(w, 1e-9), theta / jnp.clip(vn, 1e-24))
    return v * scale


def _v_matrix(omega):
    """Left-Jacobian V(omega) of SO(3), used by SE3 exp (g2o convention)."""
    theta2 = jnp.sum(omega * omega, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.clip(theta2, 1e-24))
    Om = skew(omega)
    Om2 = Om @ Om
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), Om.shape)
    small = theta2 < 1e-12
    a = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.clip(theta2, 1e-24))
    b = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / jnp.clip(theta2 * theta, 1e-24),
    )
    return eye + a * Om + b * Om2


def _v_matrix_inv(omega):
    theta2 = jnp.sum(omega * omega, axis=-1)[..., None, None]
    theta = jnp.sqrt(jnp.clip(theta2, 1e-24))
    Om = skew(omega)
    Om2 = Om @ Om
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), Om.shape)
    small = theta2 < 1e-12
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - 0.5 * theta * jnp.cos(0.5 * theta) / jnp.clip(jnp.sin(0.5 * theta), 1e-24))
        / jnp.clip(theta2, 1e-24),
    )
    return eye - 0.5 * Om + coef * Om2


def exp(xi):
    """se(3) exp, g2o convention: xi = [omega, upsilon] (...,6)."""
    omega, upsilon = xi[..., :3], xi[..., 3:]
    q = so3_exp(omega)
    t = jnp.einsum("...ij,...j->...i", _v_matrix(omega), upsilon)
    return q, t


def log(q, t):
    """SE3 -> [omega, upsilon] (...,6), inverse of exp."""
    omega = so3_log(q)
    upsilon = jnp.einsum("...ij,...j->...i", _v_matrix_inv(omega), t)
    return jnp.concatenate([omega, upsilon], axis=-1)


def adjoint(q, t):
    """Adjoint of SE3 for xi=[omega, upsilon] ordering: (...,6,6).

    Ad * [w;u] = [R w ; skew(t) R w + R u].
    """
    R = quat_to_matrix(q)
    Z = jnp.zeros_like(R)
    top = jnp.concatenate([R, Z], axis=-1)
    bot = jnp.concatenate([skew(t) @ R, R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def boxplus(q, t, xi):
    """Left-multiplicative update: exp(xi) * (q,t) — the GN pose update.

    The composed quaternion is renormalized: solver iteration chains in
    f32 (and bf16-staged paths) drift the norm, and downstream
    quat_to_matrix assumes unit quaternions.
    """
    dq, dt = exp(xi)
    qn, tn = compose(dq, dt, q, t)
    qn = qn / jnp.linalg.norm(qn, axis=-1, keepdims=True)
    return qn, tn
