"""Batched tiny point-only Gauss-Newton solves (3x3 normal equations).

JAX replacement for two reference mini-optimizations:

  1. GMMLoc::optimizePoint (ref: /root/reference/gmmloc/src/gmmloc_opt.cpp:
     260-352): one 3D point vertex, one stereo reprojection edge + one
     point-to-plane edge with info = tri_lambda2 * z^2, 5 GN iterations,
     chi2 gates. Used for stereo map-point creation with GMM association
     — run here as ONE vmapped batch over (points x candidate comps).

  2. Localization::optimizeTriangulationVec (ref: localization_opt.cpp:
     27-204): one point vertex, two reprojection edges (mono or stereo,
     one per observing keyframe) + a swapped point-to-plane edge per
     candidate degenerate component, 20 GN iterations; keep the passing
     component with minimal reprojection error. Run as a vmapped batch
     over (matches x candidate comps).

The per-candidate sequential removeEdge/addEdge loop of the reference
becomes solve-all-candidates-then-argmin (SURVEY.md §7 hard part 2).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from . import factors


def _solve3(H, b, damping=1e-8):
    # closed-form adjugate inverse in place of a batched jnp.linalg.solve
    # (same choice as local_ba._inv3; GPU comparison not measured yet)
    from .local_ba import _inv3

    H = H + jnp.eye(3, dtype=H.dtype) * damping
    Hinv, _ = _inv3(H)
    return jnp.einsum("...ij,...j->...i", Hinv, b)


class PointOptResult(NamedTuple):
    x: jax.Array          # (...,3) optimized point
    chi2_proj: jax.Array  # (...)
    chi2_str: jax.Array   # (...)
    ok: jax.Array         # (...) bool — passed both gates


@functools.partial(
    jax.jit,
    static_argnames=("cam", "iters", "tri_check_str_chi2"),
)
def optimize_point_stereo(
    cam: cam_mod.CameraParams,
    x0,              # (...,3) initial world point
    q_cw, t_cw,      # pose of the observing KF; broadcastable leading dims
    obs_uvr,         # (...,3) stereo measurement
    sigma2_inv,      # (...)
    plane_normal,    # (...,3) candidate component dominant normal
    plane_mean,      # (...,3)
    str_info,        # (...) = tri_lambda2 * proj_z^2 (gmmloc_opt.cpp:303)
    chi2_proj_thresh: float = 7.815,
    str_chi2_thresh: float = jnp.inf,  # = tri_str_thresh * tri_lambda2
    iters: int = 5,
    tri_check_str_chi2: bool = True,
) -> PointOptResult:
    """Batched GMMLoc::optimizePoint. All leading dims are batch."""

    is_stereo = jnp.ones(obs_uvr.shape[:-1], dtype=bool)

    def gn_iter(_, x):
        r, pc, _ = factors.reproj_residual(cam, q_cw, t_cw, x, obs_uvr, is_stereo)
        Jp = factors.stereo_proj_jac_point(cam, q_cw, pc, is_stereo)  # (...,3,3)
        rs = factors.pt2plane_residual(x, plane_mean, plane_normal)    # (...)
        H = (
            jnp.einsum("...ij,...ik->...jk", Jp, Jp) * sigma2_inv[..., None, None]
            + str_info[..., None, None]
            * plane_normal[..., :, None] * plane_normal[..., None, :]
        )
        b = (
            jnp.einsum("...ij,...i->...j", Jp, r) * sigma2_inv[..., None]
            + (str_info * rs)[..., None] * plane_normal
        )
        dx = -_solve3(H, b)
        return x + dx

    x = jax.lax.fori_loop(0, iters, gn_iter, x0)

    r, _, _ = factors.reproj_residual(cam, q_cw, t_cw, x, obs_uvr, is_stereo)
    chi2_proj = jnp.sum(r * r, axis=-1) * sigma2_inv
    rs = factors.pt2plane_residual(x, plane_mean, plane_normal)
    chi2_str = rs * rs * str_info
    # gates (gmmloc_opt.cpp:337-348): proj chi2 <= 7.815, and str chi2
    # against tri_str_thresh * tri_lambda2 (threshold has no z^2 factor
    # even though the edge information does).
    ok = chi2_proj <= chi2_proj_thresh
    if tri_check_str_chi2:
        ok = ok & (chi2_str <= str_chi2_thresh)
    return PointOptResult(x, chi2_proj, chi2_str, ok)


@functools.partial(jax.jit, static_argnames=("cam", "iters"))
def optimize_triangulation(
    cam: cam_mod.CameraParams,
    x0,               # (...,3) initial DLT/stereo point
    q1, t1, obs1, stereo1, sigma2_inv1,   # KF1 edge
    q2, t2, obs2, stereo2, sigma2_inv2,   # KF2 edge
    plane_normal, plane_mean,             # candidate degenerate component
    tri_lambda2: float,
    iters: int = 20,
):
    """Batched Localization::optimizeTriangulationVec inner solve.

    Returns (x, chi2_kf1, chi2_kf2, chi2_str). Gating/argmin over
    candidates is done by the caller.

    NOTE the reference passes sigma2_inv1 for BOTH edges
    (localization_opt.cpp:130-137 uses sigma2_inv1 in addEdge for kp2);
    we accept separate values but callers may replicate that behavior.
    """

    def gn_iter(_, x):
        r1, pc1, _ = factors.reproj_residual(cam, q1, t1, x, obs1, stereo1)
        J1 = factors.stereo_proj_jac_point(cam, q1, pc1, stereo1)
        r2, pc2, _ = factors.reproj_residual(cam, q2, t2, x, obs2, stereo2)
        J2 = factors.stereo_proj_jac_point(cam, q2, pc2, stereo2)
        rs = factors.pt2plane_residual(x, plane_mean, plane_normal)
        H = (
            jnp.einsum("...ij,...ik->...jk", J1, J1) * sigma2_inv1[..., None, None]
            + jnp.einsum("...ij,...ik->...jk", J2, J2) * sigma2_inv2[..., None, None]
            + tri_lambda2 * plane_normal[..., :, None] * plane_normal[..., None, :]
        )
        b = (
            jnp.einsum("...ij,...i->...j", J1, r1) * sigma2_inv1[..., None]
            + jnp.einsum("...ij,...i->...j", J2, r2) * sigma2_inv2[..., None]
            + (tri_lambda2 * rs)[..., None] * plane_normal
        )
        dx = -_solve3(H, b)
        return x + dx

    x = jax.lax.fori_loop(0, iters, gn_iter, x0)

    r1, _, _ = factors.reproj_residual(cam, q1, t1, x, obs1, stereo1)
    r2, _, _ = factors.reproj_residual(cam, q2, t2, x, obs2, stereo2)
    rs = factors.pt2plane_residual(x, plane_mean, plane_normal)
    chi2_1 = jnp.sum(r1 * r1, axis=-1) * sigma2_inv1
    chi2_2 = jnp.sum(r2 * r2, axis=-1) * sigma2_inv2
    chi2_str = rs * rs * tri_lambda2
    return x, chi2_1, chi2_2, chi2_str
