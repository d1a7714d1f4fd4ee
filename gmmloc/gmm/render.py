"""View rendering + feature-to-component association kernels.

JAX replacement for GMM::renderView / searchCorrespondence /
queryPoint (ref: /root/reference/gmmloc/src/gmm/gaussian_mixture.cpp:
271-371, 484-534, 536-576) and GMMUtility::projectGaussian
(gmm_utils.cpp:121-146).

Instead of a per-component loop + nanoflann KD-trees, the whole map is
processed as one batched pass: project all K components, apply the
visibility gates as masks, resolve occlusion with a pairwise
keep-nearest suppression, and associate features with a dense masked
top-k over the N x K distance matrix.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from . import gaussian


class Render2D(NamedTuple):
    """Projected 2D components, index-aligned with the GMMMap arrays."""

    mean2d: jax.Array     # (K, 2)
    cov2d: jax.Array      # (K, 2, 2)
    cov2d_inv: jax.Array  # (K, 2, 2)
    depth: jax.Array      # (K,) camera-frame z of the 3D mean
    visible: jax.Array    # (K,) bool — survived all gates incl. occlusion


@functools.partial(jax.jit, static_argnames=("cam", "view_cos_deg", "cov2d_scale_thresh", "occlusion_bh_thresh"))
def render_view(
    gmap,
    cam: cam_mod.CameraParams,
    q_cw,
    t_cw,
    view_cos_deg: float = 78.0,
    cov2d_scale_thresh: float = 4.0,
    occlusion_bh_thresh: float = 0.8,
) -> Render2D:
    """Project all 3D components into the camera with visibility gates.

    Gate order mirrors renderView (gaussian_mixture.cpp:271-371):
      0. degenerate comps: view-cos of plane normal vs viewing ray >= cos(78°)
      1. mean projects inside the image with z > 0
      2. 2D scale gate: keep if max eigenvalue of cov2d >= 4.0
      3. occlusion: among overlapping pairs (BH2d < 0.8) keep the nearest.

    The reference's sequential replace-if-nearer list (":327-355") becomes a
    symmetric suppression: i is occluded if some visible j overlaps it and
    is strictly nearer (ties broken by index).
    """
    means = gmap.means
    K = means.shape[0]

    # STEP 0: view-cos gate for degenerate components
    q_wc, t_wc = se3.inverse(q_cw, t_cw)
    po = means - t_wc
    po = po / jnp.clip(jnp.linalg.norm(po, axis=-1, keepdims=True), 1e-12)
    view_cos = jnp.abs(jnp.einsum("ki,ki->k", po, gmap.normal))
    cos_thresh = math.cos(math.radians(view_cos_deg))
    pass_viewcos = jnp.where(gmap.is_degenerated, view_cos >= cos_thresh, True)

    # STEP 1: projection of means (+ Jacobian pushforward of covariances)
    pc = se3.apply(q_cw, t_cw, means)
    uv, vis_proj = cam_mod.project(cam, pc)
    J = cam_mod.project_jacobian(cam, pc)          # (K, 2, 3)
    R = se3.quat_to_matrix(q_cw)                    # (3, 3)
    JR = jnp.einsum("kij,jl->kil", J, R)
    cov2d = jnp.einsum("kil,klm,kjm->kij", JR, gmap.covs, JR)

    # STEP 2: 2D scale gate (ref keeps when either eigenvalue >= thresh)
    scale2d, _ = gaussian.eig2x2(cov2d)
    pass_scale = scale2d[..., 1] >= cov2d_scale_thresh

    depth = pc[..., 2]
    alive = gmap.valid & pass_viewcos & vis_proj & pass_scale

    # STEP 3: pairwise occlusion suppression (keep nearest of overlap pair).
    # Blocked over rows so the (K, K) pass never materializes at once —
    # at stress scale (10x components) the dense form would need tens of
    # GB of intermediates.
    BLOCK = 512
    n_blocks = -(-K // BLOCK)
    pad = n_blocks * BLOCK - K
    uv_p = jnp.pad(uv, ((0, pad), (0, 0)))
    depth_p = jnp.pad(depth, (0, pad))
    alive_p = jnp.pad(alive, (0, pad))
    idx_p = jnp.arange(n_blocks * BLOCK)
    # scalar 2x2 components (a=xx, b=xy, c=yy): the pairwise BH below
    # runs on flat (BLOCK, K) scalar grids that XLA fuses into ONE
    # kernel per block — the matrix-shaped form materialized
    # (BLOCK, K, 2, 2) broadcast intermediates (~270 MB/block at the
    # 33k-component stress scale)
    ca_p = jnp.pad(cov2d[:, 0, 0], (0, pad))
    cb_p = jnp.pad(cov2d[:, 0, 1], (0, pad))
    cc_p = jnp.pad(cov2d[:, 1, 1], (0, pad))
    det_p = jnp.clip(ca_p * cc_p - cb_p * cb_p, 1e-30)

    def block_body(b, occ):
        s = b * BLOCK
        sl = lambda v: jax.lax.dynamic_slice_in_dim(v, s, BLOCK)
        uv_b, d_b, a_b, i_b = sl(uv_p), sl(depth_p), sl(alive_p), sl(idx_p)
        ca_b, cb_b, cc_b, det_b = sl(ca_p), sl(cb_p), sl(cc_p), sl(det_p)
        # mean Sigma = (S1+S2)/2, elementwise over the (BLOCK, K) grid
        A = 0.5 * (ca_b[:, None] + ca_p[None, :])
        Bc = 0.5 * (cb_b[:, None] + cb_p[None, :])
        C = 0.5 * (cc_b[:, None] + cc_p[None, :])
        det_c = jnp.clip(A * C - Bc * Bc, 1e-30)
        du = uv_p[None, :, 0] - uv_b[:, None, 0]
        dv = uv_p[None, :, 1] - uv_b[:, None, 1]
        md2 = (C * du * du - 2.0 * Bc * du * dv + A * dv * dv) / det_c
        bh = md2 / 8.0 + 0.5 * jnp.log(
            det_c / jnp.sqrt(jnp.clip(det_b[:, None] * det_p[None, :], 1e-60))
        )
        overlap = (bh < occlusion_bh_thresh) & a_b[:, None] & alive_p[None, :]
        nearer = (depth_p[None, :] < d_b[:, None]) | (
            (depth_p[None, :] == d_b[:, None]) & (idx_p[None, :] < i_b[:, None])
        )
        occ_b = jnp.any(
            overlap & nearer & (idx_p[None, :] != i_b[:, None]), axis=1
        )
        return jax.lax.dynamic_update_slice_in_dim(occ, occ_b, s, 0)

    occluded = jax.lax.fori_loop(
        0, n_blocks, block_body, jnp.zeros(n_blocks * BLOCK, bool)
    )[:K]
    visible = alive & ~occluded

    cov2d_inv, _ = gaussian.inv2x2(cov2d)
    return Render2D(uv, cov2d, cov2d_inv, depth, visible)


@functools.partial(jax.jit, static_argnames=("knn", "mdist2_thresh"))
def search_correspondence(
    render: Render2D,
    feat_uv,
    feat_valid,
    knn: int = 5,
    mdist2_thresh: float = 9.0,
):
    """Per-feature candidate 2D components.

    Ref: GMM::searchCorrespondence (gaussian_mixture.cpp:484-534): 5-NN by
    euclidean distance over projected means, then Mahalanobis gate 9.0.
    Returns (N, knn) int32 component indices, -1 where gated out, ordered
    by increasing euclidean distance (KD-tree knn order).
    """
    d2 = jnp.sum((feat_uv[:, None, :] - render.mean2d[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(render.visible[None, :], d2, jnp.inf)
    neg_top, cand = jax.lax.top_k(-d2, knn)          # (N, knn)
    found = jnp.isfinite(-neg_top)

    mu = render.mean2d[cand]                          # (N, knn, 2)
    ci = render.cov2d_inv[cand]
    md2 = gaussian.mdist2_2d(mu, ci, feat_uv[:, None, :])
    keep = found & (md2 < mdist2_thresh) & feat_valid[:, None]
    return jnp.where(keep, cand, -1)


@functools.partial(jax.jit, static_argnames=("knn",))
def query_point_3d(gmap, pts, pts_valid, knn: int = 5):
    """Nearest 3D component by euclidean mean distance.

    Ref: GMM::queryPoint (gaussian_mixture.cpp:545-576) — despite computing
    Mahalanobis over the 5 candidates it returns ret_index[0], i.e. the
    euclidean-nearest component. We mirror that.
    Returns (N,) int32 indices (-1 when invalid).
    """
    d2 = jnp.sum((pts[:, None, :] - gmap.means[None, :, :]) ** 2, axis=-1)
    d2 = jnp.where(gmap.valid[None, :], d2, jnp.inf)
    nearest = jnp.argmin(d2, axis=1).astype(jnp.int32)
    return jnp.where(pts_valid, nearest, -1)
