"""Batched 3D/2D Gaussian-component math.

JAX replacement for GaussianComponent / GaussianComponent2d
(ref: /root/reference/gmmloc/src/gmm/gaussian.cpp,
include/gmmloc/gmm/gaussian.h:14-162). Components live as struct-of-arrays;
every op is batched over the component axis instead of per-object methods.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def decompose(covs):
    """Batched eigendecomposition of 3x3 covariances.

    Returns dict with (ascending eigenvalues, eigenvectors as columns) plus
    derived quantities, mirroring GaussianComponent::decompose
    (gaussian.cpp:36-63) and the ctor-level cov_inv/det:
      axis[..., :, 0] = smallest-eigenvalue direction (plane normal when
      degenerate), scale = eigenvalues, is_degenerated = scale_0 < 1e-4,
      is_salient = scale_1 > 0.2 and scale_2 > 0.2.
    """
    evals, evecs = jnp.linalg.eigh(covs)  # ascending
    cov_inv = jnp.linalg.inv(covs)
    det = jnp.linalg.det(covs)
    return {
        "scale": evals,
        "axis": evecs,
        "cov_inv": cov_inv,
        "det": det,
        "normal": evecs[..., :, 0],
    }


def degenerate_flags(scale, eig_thresh=1e-4, salient_thresh=0.2):
    is_deg = scale[..., 0] < eig_thresh
    is_sal = (scale[..., 1] > salient_thresh) & (scale[..., 2] > salient_thresh)
    return is_deg, is_sal


def sqrt_info(cov_inv):
    """Lower Cholesky factor L of cov^-1 (ref: gaussian.cpp:47-49).

    The whitened point-to-Gaussian residual is L^T (x - mean)
    (ref: factors.cpp EdgePt2Gaussian::computeError).
    """
    return jnp.linalg.cholesky(cov_inv)


def chi2(mean, cov_inv, x):
    """Squared Mahalanobis distance (ref: gaussian.cpp:65-70).

    Broadcasts: mean/cov_inv (...,3)/(...,3,3), x (...,3).
    """
    d = x - mean
    return jnp.einsum("...i,...ij,...j->...", d, cov_inv, d)


def pdf(mean, cov_inv, det, x):
    """Gaussian density (ref: gaussian.cpp:72-77)."""
    dim = mean.shape[-1]
    norm = (2.0 * jnp.pi) ** (-0.5 * dim) / jnp.sqrt(jnp.clip(det, 1e-300))
    return norm * jnp.exp(-0.5 * chi2(mean, cov_inv, x))


# ---------------------------------------------------------------------------
# 2x2 closed forms (projected 2D components) — no LAPACK needed on device
# ---------------------------------------------------------------------------


def eig2x2(covs2d):
    """Closed-form eigendecomposition of symmetric 2x2 matrices.

    Returns (evals ascending (...,2), theta (...,) angle of the *largest*
    axis? No — matches GaussianComponent2d::decompose (gaussian.cpp:17-33):
    theta = atan(v1/v0) of the first (smallest-eigenvalue) eigenvector.
    """
    a = covs2d[..., 0, 0]
    b = covs2d[..., 0, 1]
    c = covs2d[..., 1, 1]
    tr = a + c
    disc = jnp.sqrt(jnp.clip(0.25 * (a - c) ** 2 + b * b, 0.0))
    lam0 = 0.5 * tr - disc
    lam1 = 0.5 * tr + disc
    # eigenvector for lam0: (b, lam0 - a) unless b ~ 0
    vx = jnp.where(jnp.abs(b) > 1e-12, b, jnp.where(a <= c, 1.0, 0.0))
    vy = jnp.where(jnp.abs(b) > 1e-12, lam0 - a, jnp.where(a <= c, 0.0, 1.0))
    theta = jnp.arctan2(vy, vx)
    evals = jnp.stack([lam0, lam1], axis=-1)
    return evals, theta


def inv2x2(covs2d):
    a = covs2d[..., 0, 0]
    b = covs2d[..., 0, 1]
    c = covs2d[..., 1, 0]
    d = covs2d[..., 1, 1]
    det = a * d - b * c
    det_safe = jnp.where(jnp.abs(det) < 1e-24, 1e-24, det)
    inv = jnp.stack(
        [
            jnp.stack([d, -b], -1),
            jnp.stack([-c, a], -1),
        ],
        axis=-2,
    )
    return inv / det_safe[..., None, None], det


def mdist2_2d(mean2d, cov2d_inv, x2d):
    d = x2d - mean2d
    return jnp.einsum("...i,...ij,...j->...", d, cov2d_inv, d)


# ---------------------------------------------------------------------------
# Bhattacharyya distance (templated BHCoefficient, gmm_utils.h:30-52)
# ---------------------------------------------------------------------------


def bhattacharyya_3d(mean_a, cov_a, det_a, mean_b, cov_b, det_b):
    """Pairwise-broadcastable BH distance for 3D components."""
    cov = 0.5 * (cov_a + cov_b)
    delta = mean_b - mean_a
    sol = jnp.linalg.solve(cov, delta[..., None])[..., 0]
    d0 = jnp.einsum("...i,...i->...", delta, sol) / 8.0
    det_c = jnp.linalg.det(cov)
    d1 = 0.5 * jnp.log(
        jnp.clip(det_c, 1e-300) / jnp.sqrt(jnp.clip(det_a * det_b, 1e-300))
    )
    return d0 + d1


def bhattacharyya_2d(mean_a, cov_a, mean_b, cov_b):
    """BH distance for 2D (projected) components; closed-form 2x2 inverse."""
    cov = 0.5 * (cov_a + cov_b)
    inv, det_c = inv2x2(cov)
    delta = mean_b - mean_a
    d0 = mdist2_2d(jnp.zeros_like(delta), inv, delta) / 8.0
    det_a2 = cov_a[..., 0, 0] * cov_a[..., 1, 1] - cov_a[..., 0, 1] * cov_a[..., 1, 0]
    det_b2 = cov_b[..., 0, 0] * cov_b[..., 1, 1] - cov_b[..., 0, 1] * cov_b[..., 1, 0]
    d1 = 0.5 * jnp.log(
        jnp.clip(det_c, 1e-30) / jnp.sqrt(jnp.clip(det_a2 * det_b2, 1e-60))
    )
    return d0 + d1
