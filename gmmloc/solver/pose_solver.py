"""Pose-only Gauss-Newton/LM solver with staged inlier reclassification.

JAX replacement for Tracking::optimizeCurrentPose
(ref: /root/reference/gmmloc/src/modules/tracking_opt.cpp:21-227):
one SE3 vertex, N mono/stereo reprojection edges with Huber kernels,
4 rounds x 10 iterations, chi2 reclassification (5.991 mono / 7.815
stereo) between rounds, robust kernel dropped for the final round.

The whole schedule runs inside one jit: edges are fixed-capacity arrays
with validity masks, outliers are mask updates, and each LM iteration is
a batched 6x6 normal-equation solve fed by one fused residual/Jacobian
pass over all edges (einsum reductions).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from . import factors


class PoseOptResult(NamedTuple):
    q: jax.Array           # (4,) optimized T_cw rotation
    t: jax.Array           # (3,) optimized T_cw translation
    is_outlier: jax.Array  # (N,) bool, per input edge
    num_inliers: jax.Array  # () int32 — valid edges - outliers
    chi2: jax.Array        # (N,) final per-edge chi2


CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def _chol_solve6(H, b):
    """Unrolled 6x6 Cholesky solve: the damped normal matrix is SPD, so
    36 static scalar ops that XLA fuses into one kernel replace a pivoting
    LU (jnp.linalg.solve)."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = H[i, i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-20))
        for j in range(i + 1, 6):
            s2 = H[j, i]
            for k in range(i):
                s2 = s2 - L[j][k] * L[i][k]
            L[j][i] = s2 / L[i][i]
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def _edge_terms(cam, q, t, x_w, obs_uvr, is_stereo, sigma2_inv, weight_extra):
    """Residual, pose-Jacobian, chi2 for all edges in one pass."""
    r, pc, _ = factors.reproj_residual(cam, q, t, x_w, obs_uvr, is_stereo)
    J = factors.stereo_proj_jac_pose(cam, pc, is_stereo)      # (N,3,6)
    chi2 = jnp.sum(r * r, axis=-1) * sigma2_inv
    w = sigma2_inv * weight_extra                             # (N,)
    H = jnp.einsum("nij,n,nik->jk", J, w, J)                  # (6,6)
    b = jnp.einsum("nij,n,ni->j", J, w, r)                    # (6,)
    return chi2, H, b


@functools.partial(
    jax.jit, static_argnames=("cam", "rounds", "iters", "step_tol")
)
def optimize_pose(
    cam: cam_mod.CameraParams,
    q0,
    t0,
    x_w,
    obs_uvr,
    is_stereo,
    sigma2_inv,
    valid,
    rounds: int = 4,
    iters: int = 10,
    step_tol: float = 1e-8,
) -> PoseOptResult:
    """Run the 4x10 staged pose-only solve.

    Args:
      x_w: (N,3) landmark positions (world).
      obs_uvr: (N,3) measurements (u, v, u_right); u_right ignored for mono.
      is_stereo: (N,) bool.
      sigma2_inv: (N,) per-edge information scale (pyramid octave).
      valid: (N,) bool — edge exists (has an associated landmark).
    """
    delta_mono = jnp.sqrt(CHI2_MONO)
    delta_stereo = jnp.sqrt(CHI2_STEREO)
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    huber_delta = jnp.where(is_stereo, delta_stereo, delta_mono)

    def round_body(rd, carry):
        q, t, outlier = carry
        active = valid & ~outlier
        use_huber = rd < 3  # robust kernel removed at it==2 (tracking_opt.cpp:181,207)
        # each round restarts from the frame's initial pose with the refined
        # outlier set (tracking_opt.cpp:157 setEstimate(curr->getTcw())) —
        # this breaks robust-outlier basin locking
        q, t = q0, t0

        # GN iterations are latency-bound (sequential small kernels); the
        # step norm collapses after a handful of iterations, so terminate
        # on |dx|_inf < step_tol instead of always burning the full budget
        # (g2o's optimize(10) also stops when the update stalls)
        def gn_cond(carry):
            _, _, it, done = carry
            return (it < iters) & ~done

        def gn_iter(carry):
            q_i, t_i, it, _ = carry
            r, pc, _ = factors.reproj_residual(cam, q_i, t_i, x_w, obs_uvr, is_stereo)
            J = factors.stereo_proj_jac_pose(cam, pc, is_stereo)
            chi2 = jnp.sum(r * r, axis=-1) * sigma2_inv
            hw = jnp.where(
                use_huber, factors.huber_weight(chi2, huber_delta), 1.0
            )
            w = sigma2_inv * hw * active.astype(r.dtype)
            H = jnp.einsum("nij,n,nik->jk", J, w, J)
            b = jnp.einsum("nij,n,ni->j", J, w, r)
            H = H + jnp.eye(6, dtype=H.dtype) * 1e-6  # mild LM damping
            dx = -_chol_solve6(H, b)
            q_n, t_n = se3.boxplus(q_i, t_i, dx)
            # reject a diverged step (singular H / NaN residuals): keep the
            # previous estimate rather than poisoning the remaining iters
            ok = jnp.all(jnp.isfinite(q_n)) & jnp.all(jnp.isfinite(t_n))
            q_n = jnp.where(ok, q_n, q_i)
            t_n = jnp.where(ok, t_n, t_i)
            done = ~ok | (jnp.max(jnp.abs(dx)) < step_tol)
            return q_n, t_n, it + 1, done

        q, t, _, _ = jax.lax.while_loop(
            gn_cond, gn_iter, (q, t, jnp.int32(0), jnp.array(False))
        )

        # reclassify ALL valid edges (outliers can come back; tracking_opt:163-178)
        r, _, _ = factors.reproj_residual(cam, q, t, x_w, obs_uvr, is_stereo)
        chi2 = jnp.sum(r * r, axis=-1) * sigma2_inv
        # ~(chi2 <= th): NaN chi2 classifies as OUTLIER (a diverged pose
        # must not count every edge as an inlier)
        outlier = valid & ~(chi2 <= chi2_th)
        return q, t, outlier

    outlier0 = jnp.zeros_like(valid)
    q, t, outlier = jax.lax.fori_loop(
        0, rounds, round_body, (q0, t0, outlier0)
    )

    r, _, _ = factors.reproj_residual(cam, q, t, x_w, obs_uvr, is_stereo)
    chi2 = jnp.sum(r * r, axis=-1) * sigma2_inv
    num_inliers = jnp.sum(valid & ~outlier).astype(jnp.int32)
    return PoseOptResult(q, t, outlier, num_inliers, chi2)


class PoseAnchorResult(NamedTuple):
    q: jax.Array
    t: jax.Array
    is_outlier: jax.Array      # (N,) reprojection-edge outliers
    num_inliers: jax.Array     # () int32
    chi2: jax.Array            # (N,) final reprojection chi2
    anc_outlier: jax.Array     # (N,) anchor-edge outliers
    num_anchors: jax.Array     # () int32 surviving anchors


ANCHOR_NONE = 0
ANCHOR_DEG = 1      # 1D point-to-plane along the dominant normal
ANCHOR_NONDEG = 2   # 3D sqrt-info whitened


@functools.partial(
    jax.jit, static_argnames=("cam", "rounds", "iters", "step_tol")
)
def optimize_pose_anchored(
    cam: cam_mod.CameraParams,
    q0,
    t0,
    x_w,
    obs_uvr,
    is_stereo,
    sigma2_inv,
    valid,
    anc_xc,          # (N,3) camera-frame measured points (stereo unprojection)
    anc_mean,        # (N,3) associated component mean (world)
    anc_normal,      # (N,3) dominant normal (deg)
    anc_sqrt_info,   # (N,3,3) cov^-1 cholesky (nondeg)
    anc_type,        # (N,) int32 ANCHOR_*
    anc_weight,      # (N,) info scale (deg: lambda*z^2-style; nondeg: multiplier)
    anc_chi2_th,     # () gate for anchor reclassification between rounds
    rounds: int = 4,
    iters: int = 10,
    step_tol: float = 1e-8,
) -> PoseAnchorResult:
    """Staged pose-only solve with per-frame GMM structure anchors.

    Capability extension over the reference (which uses structure factors
    only in per-keyframe point optimization and BA,
    localization_opt.cpp:650-683): each tracked feature whose map point
    carries a GMM association contributes a pose edge tying the frame's
    OWN stereo measurement to the prior-map component. This restores
    observability along pose directions the reprojection edges barely see
    (all landmarks at similar depth -> lateral translation + compensating
    rotation is near-invisible), which otherwise drift under the
    constant-velocity feedback."""
    delta_mono = jnp.sqrt(CHI2_MONO)
    delta_stereo = jnp.sqrt(CHI2_STEREO)
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    huber_delta = jnp.where(is_stereo, delta_stereo, delta_mono)
    dtype = obs_uvr.dtype

    anc_exists = anc_type != ANCHOR_NONE
    anc_huber_delta = jnp.sqrt(anc_chi2_th)

    def anchor_terms(q, t, active_anc, use_huber=False):
        x_w_a, R_wc = factors.anchor_point_world(q, t, anc_xc)
        Jx = factors.anchor_jac_pose(R_wc, anc_xc)            # (N,3,6)
        d = x_w_a - anc_mean
        is_deg = anc_type == ANCHOR_DEG
        # deg: 1D residual in row 0; nondeg: 3D whitened rows
        r_deg = jnp.einsum("ni,ni->n", d, anc_normal)
        J_deg = jnp.einsum("ni,nij->nj", anc_normal, Jx)      # (N,6)
        r_nd = jnp.einsum("nji,nj->ni", anc_sqrt_info, d)     # (N,3)
        J_nd = jnp.einsum("nji,njk->nik", anc_sqrt_info, Jx)  # (N,3,6)
        r3 = jnp.where(
            is_deg[:, None],
            jnp.concatenate([r_deg[:, None], jnp.zeros_like(r_nd[:, :2])], -1),
            r_nd,
        )
        J3 = jnp.where(
            is_deg[:, None, None],
            jnp.concatenate([J_deg[:, None, :], jnp.zeros_like(J_nd[:, :2])], 1),
            J_nd,
        )
        chi2 = jnp.sum(r3 * r3, axis=-1) * anc_weight
        # robust pull (rounds 0-2): a drifted pose keeps being attracted to
        # the prior map instead of losing all its anchors to the hard gate
        hw = jnp.where(
            use_huber, factors.huber_weight(chi2, anc_huber_delta), 1.0
        )
        w = anc_weight * hw * active_anc.astype(dtype)
        H = jnp.einsum("nij,n,nik->jk", J3, w, J3)
        b = jnp.einsum("nij,n,ni->j", J3, w, r3)
        return chi2, H, b

    def round_body(rd, carry):
        q, t, outlier, anc_out = carry
        active = valid & ~outlier
        use_huber = rd < 3
        # robust rounds keep every anchor alive under Huber; the final
        # round uses the hard-gated set only
        active_anc = anc_exists & (use_huber | ~anc_out)
        q, t = q0, t0  # per-round restart (tracking_opt.cpp:157)

        def gn_cond(carry):
            _, _, it, done = carry
            return (it < iters) & ~done

        def gn_iter(carry):
            q_i, t_i, it, _ = carry
            r, pc, _ = factors.reproj_residual(cam, q_i, t_i, x_w, obs_uvr, is_stereo)
            J = factors.stereo_proj_jac_pose(cam, pc, is_stereo)
            chi2 = jnp.sum(r * r, axis=-1) * sigma2_inv
            hw = jnp.where(use_huber, factors.huber_weight(chi2, huber_delta), 1.0)
            w = sigma2_inv * hw * active.astype(r.dtype)
            H = jnp.einsum("nij,n,nik->jk", J, w, J)
            b = jnp.einsum("nij,n,ni->j", J, w, r)
            _, Ha, ba = anchor_terms(q_i, t_i, active_anc, use_huber)
            H = H + Ha + jnp.eye(6, dtype=H.dtype) * 1e-6
            b = b + ba
            dx = -_chol_solve6(H, b)
            q_n, t_n = se3.boxplus(q_i, t_i, dx)
            ok = jnp.all(jnp.isfinite(q_n)) & jnp.all(jnp.isfinite(t_n))
            q_n = jnp.where(ok, q_n, q_i)
            t_n = jnp.where(ok, t_n, t_i)
            done = ~ok | (jnp.max(jnp.abs(dx)) < step_tol)
            return q_n, t_n, it + 1, done

        q, t, _, _ = jax.lax.while_loop(
            gn_cond, gn_iter, (q, t, jnp.int32(0), jnp.array(False))
        )

        r, _, _ = factors.reproj_residual(cam, q, t, x_w, obs_uvr, is_stereo)
        chi2 = jnp.sum(r * r, axis=-1) * sigma2_inv
        outlier = valid & ~(chi2 <= chi2_th)
        chi2_a, _, _ = anchor_terms(q, t, anc_exists)
        anc_out = anc_exists & ~(chi2_a <= anc_chi2_th)
        return q, t, outlier, anc_out

    outlier0 = jnp.zeros_like(valid)
    anc_out0 = jnp.zeros_like(anc_exists)
    q, t, outlier, anc_out = jax.lax.fori_loop(
        0, rounds, round_body, (q0, t0, outlier0, anc_out0)
    )

    r, _, _ = factors.reproj_residual(cam, q, t, x_w, obs_uvr, is_stereo)
    chi2 = jnp.sum(r * r, axis=-1) * sigma2_inv
    num_inliers = jnp.sum(valid & ~outlier).astype(jnp.int32)
    num_anchors = jnp.sum(anc_exists & ~anc_out).astype(jnp.int32)
    return PoseAnchorResult(q, t, outlier, num_inliers, chi2, anc_out, num_anchors)
