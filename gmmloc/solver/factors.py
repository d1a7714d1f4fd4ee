"""Batched residual/Jacobian kernels for the factor zoo.

JAX replacement for the g2o edge types used by the reference
(ref: /root/reference/gmmloc/src/gmm/factors.cpp plus the stock
EdgeSE3ProjectXYZ / EdgeStereoSE3ProjectXYZ / *OnlyPose types from g2o):

  - mono / stereo reprojection (pose- and point-Jacobians)
  - point-to-Gaussian (3D, sqrt-info whitened)        [EdgePt2Gaussian]
  - point-to-plane along dominant normal (1D)         [EdgePt2GaussianDeg]
  - SE3 pose prior                                    [EdgeSE3QuatPrior]
  - Huber robust weights

Conventions: poses are T_cw as (q, t); the camera-frame point is
pc = R(q) x + t. Pose updates are left-multiplicative, xi = [omega,
upsilon], matching g2o::VertexSE3Expmap::oplusImpl. Residuals are
r = predicted - observed, so the GN step solves (JtWJ) dx = -JtWr.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3


# ---------------------------------------------------------------------------
# reprojection factors
# ---------------------------------------------------------------------------


def reproj_residual(cam, q_cw, t_cw, x_w, obs_uvr, is_stereo):
    """Unified mono/stereo reprojection residual as a 3-vector.

    Mono observations (is_stereo=False) zero out the third (u_right)
    component, so one batched kernel covers both edge types. Returns
    (r (...,3), pc (...,3), depth_ok (...,)).
    """
    pc = se3.apply(q_cw, t_cw, x_w)
    pred, _ = cam_mod.project_stereo(cam, pc)
    r = pred - obs_uvr
    mask3 = jnp.stack(
        [jnp.ones_like(r[..., 0]), jnp.ones_like(r[..., 0]),
         is_stereo.astype(r.dtype)], axis=-1,
    )
    return r * mask3, pc, pc[..., 2] > 0.0


def stereo_proj_jac_point(cam, q_cw, pc, is_stereo):
    """d r / d x_w: (...,3,3) for the unified residual.

    Ref: EdgeProjectXYZOnlyStereo::linearizeOplus (factors.cpp:137-168)
    — here dr/dpc @ R with rows [du;dv;dur], mono rows zero the third.
    """
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zr = jnp.zeros_like(x)
    du = jnp.stack([cam.fx * iz, zr, -cam.fx * x * iz2], axis=-1)
    dv = jnp.stack([zr, cam.fy * iz, -cam.fy * y * iz2], axis=-1)
    dur = du + jnp.stack([zr, zr, cam.bf * iz2], axis=-1)
    dur = dur * is_stereo[..., None]
    dpc = jnp.stack([du, dv, dur], axis=-2)          # (...,3,3)
    R = se3.quat_to_matrix(q_cw)
    return dpc @ R


def stereo_proj_jac_pose(cam, pc, is_stereo):
    """d r / d xi for left-multiplicative pose update, xi=[omega,upsilon].

    d pc / d xi = [-skew(pc) | I]  (...,3,6).
    """
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zr = jnp.zeros_like(x)
    du = jnp.stack([cam.fx * iz, zr, -cam.fx * x * iz2], axis=-1)
    dv = jnp.stack([zr, cam.fy * iz, -cam.fy * y * iz2], axis=-1)
    dur = du + jnp.stack([zr, zr, cam.bf * iz2], axis=-1)
    dur = dur * is_stereo[..., None]
    dpc = jnp.stack([du, dv, dur], axis=-2)          # (...,3,3)
    dpc_dxi = jnp.concatenate(
        [-se3.skew(pc), jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))],
        axis=-1,
    )                                                 # (...,3,6)
    return dpc @ dpc_dxi


# ---------------------------------------------------------------------------
# GMM structure factors
# ---------------------------------------------------------------------------


def pt2gaussian_residual(x, mean, sqrt_info):
    """3D whitened point-to-Gaussian: r = L^T (x - mean).

    Ref: EdgePt2Gaussian (factors.cpp:5-17); J = L^T.
    """
    return jnp.einsum("...ji,...j->...i", sqrt_info, x - mean)


def pt2plane_residual(x, mean, normal):
    """1D point-to-plane along the dominant normal: r = n^T (x - mean).

    Ref: EdgePt2GaussianDeg (factors.cpp:55-64); J = n^T.
    """
    return jnp.einsum("...i,...i->...", x - mean, normal)


def anchor_point_world(q_cw, t_cw, x_c):
    """World position of a camera-frame-measured point under T_cw:
    x_w = R_cw^T (x_c - t_cw). Returns (x_w, R_wc)."""
    R_cw = se3.quat_to_matrix(q_cw)
    R_wc = jnp.swapaxes(R_cw, -1, -2)
    x_w = jnp.einsum("...ij,...j->...i", R_wc, x_c - t_cw)
    return x_w, R_wc


def anchor_jac_pose(R_wc, x_c):
    """d x_w / d xi for left-multiplicative update of T_cw:
    x_w(xi) = T_wc exp(-xi) x_c  =>  J = R_wc [skew(x_c) | -I]  (...,3,6).

    This is the pose-side counterpart of the reference's point-side
    structure edges (EdgePt2Gaussian{,Deg}, factors.cpp:5-17,55-64): the
    measured camera-frame point is fixed and the POSE carries it onto the
    prior-map component (per-frame structure-consistent tracking)."""
    sk = se3.skew(x_c)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=x_c.dtype), x_c.shape[:-1] + (3, 3))
    return jnp.einsum("...ij,...jk->...ik", R_wc, jnp.concatenate([sk, -eye], -1))


# ---------------------------------------------------------------------------
# SE3 prior factor
# ---------------------------------------------------------------------------


def se3_prior_residual(q, t, q_prior, t_prior):
    """r = log(T_prior^-1 * T)  (ref: EdgeSE3QuatPrior, factors.cpp:19-27)."""
    qi, ti = se3.inverse(q_prior, t_prior)
    qd, td = se3.compose(qi, ti, q, t)
    return se3.log(qd, td)


def se3_prior_jacobian(q, t, q_prior, t_prior):
    """d r / d xi for left-multiplicative update (autodiff; one per BA)."""

    def f(xi):
        qq, tt = se3.boxplus(q, t, xi)
        return se3_prior_residual(qq, tt, q_prior, t_prior)

    return jax.jacfwd(f)(jnp.zeros(6, dtype=t.dtype))


# ---------------------------------------------------------------------------
# robust weights
# ---------------------------------------------------------------------------


def huber_weight(chi2, delta):
    """g2o RobustKernelHuber effective IRLS weight: 1 if sqrt(chi2)<=delta
    else delta/sqrt(chi2)."""
    s = jnp.sqrt(jnp.clip(chi2, 1e-24))
    return jnp.where(s <= delta, 1.0, delta / s)
