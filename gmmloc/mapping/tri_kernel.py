"""Fused triangulation: epipolar search + init + GMM-constrained solve +
acceptance gates in ONE device program.

JAX replacement for Localization::createMapPoints +
optimizeTriangulationVec (ref: /root/reference/gmmloc/src/modules/
localization_opt.cpp:206-455). The round-4 orchestration ran this as
four device boundaries per keyframe (sync + search-fetch + 13-array
upload + solve-fetch); every host
step between them — match flattening, DLT/stereo init, candidate
assembly, gate evaluation, first-wins selection — is dense masked
arithmetic on data already resident in the device-world mirror, so the
chain fuses into one program with one packed fetch of per-match records.

The host's 4x4 SVD DLT init is replaced by an adjugate power iteration
on A^T A (the null vector of a near-rank-3 system is the dominant
eigenvector of adj(A^T A)) in place of a batched jnp.linalg.svd, which
the first platform ran as a serialized loop (GPU cost not measured yet,
ROADMAP C5).
Row-normalizing A keeps the f32 cofactor products conditioned; two
adj-matvec sharpening steps give parity with the f64 host SVD at the
acceptance-gate level (tests/test_fused_tri.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..features import matching
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..solver import point_solver


def _adj4(M):
    """Batched adjugate of a 4x4 matrix (...,4,4) via 3x3 cofactors."""

    def det3(r, c):
        rows = [i for i in range(4) if i != r]
        cols = [j for j in range(4) if j != c]
        a = M[..., rows[0], cols[0]]
        b = M[..., rows[0], cols[1]]
        c_ = M[..., rows[0], cols[2]]
        d = M[..., rows[1], cols[0]]
        e = M[..., rows[1], cols[1]]
        f = M[..., rows[1], cols[2]]
        g = M[..., rows[2], cols[0]]
        h = M[..., rows[2], cols[1]]
        i = M[..., rows[2], cols[2]]
        return a * (e * i - f * h) - b * (d * i - f * g) + c_ * (d * h - e * g)

    # adj(M)[i,j] = (-1)^{i+j} * minor(j,i)  (transposed cofactor matrix)
    cols = []
    for i in range(4):
        col = []
        for j in range(4):
            col.append(((-1.0) ** (i + j)) * det3(j, i))
        cols.append(jnp.stack(col, axis=-1))
    return jnp.stack(cols, axis=-2)  # (...,4,4) rows i, cols j


def _dlt_null(A):
    """Approximate null vector of (...,4,4) A.

    adj(A) = V diag(prod_{j!=i} sigma_j) U^T, so for a near-rank-3 A it
    is ~ sigma1*sigma2*sigma3 * v4 u4^T — its column space IS the null
    direction. Forming the Gram matrix of A directly (A^T A) SQUARES the
    condition number and f32 loses the small-sigma subspace (measured:
    3 cm median point error vs the f64 SVD); the Gram of adj(A) instead
    has the spectrum inverted — its DOMINANT eigenvector is v4, which
    f32 power iteration recovers safely."""
    # row-normalize (doesn't change the null space; conditions f32)
    A = A / jnp.clip(
        jnp.linalg.norm(A, axis=-1, keepdims=True), 1e-12
    )
    G = _adj4(A)
    # adj(A) = +-V adj(Sigma) U^T, so G G^T = V adj(Sigma)^2 V^T and its
    # DOMINANT eigenvector is v4 (G^T G would give u4 instead)
    B = jnp.einsum("...ik,...jk->...ij", G, G)
    diag = jnp.diagonal(B, axis1=-2, axis2=-1)
    j = jnp.argmax(diag, axis=-1)
    v = jnp.take_along_axis(B, j[..., None, None].repeat(4, -2), axis=-1)[..., 0]
    for _ in range(2):
        v = v / jnp.clip(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
        v = jnp.einsum("...ij,...j->...i", B, v)
    n = jnp.linalg.norm(v, axis=-1, keepdims=True)
    return v / jnp.clip(n, 1e-30)


@functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "m_tri", "tri_lambda2", "tri_opt_iters",
        "tri_check_str_chi2", "tri_str_thresh", "ratio_factor",
    ),
)
def triangulate_kernel(
    cam: cam_mod.CameraParams,
    kf1,              # scalar int32
    kf2_idx,          # (TP,) int32 neighbor keyframes (padded; job_ok masks)
    job_ok,           # (TP,) bool
    free1,            # (F,) bool
    free2,            # (TP,F) bool
    fmat,             # (TP,3,3)
    epipole2,         # (TP,2)
    sigma2_tab,       # (L,)
    sigma2_inv_tab,   # (L,)
    sf_tab,           # (L,) scale factors
    # device-world mirror
    kf_q, kf_t,
    kf_uv, kf_ur, kf_desc, kf_oct, kf_angle, kf_depth, kf_cand,
    # gmm map tables
    g_means, g_normal, g_deg,
    *,
    m_tri: int,
    tri_lambda2: float,
    tri_opt_iters: int,
    tri_check_str_chi2: bool,
    tri_str_thresh: float,
    ratio_factor: float,
):
    """Returns per-match records over a fixed m_tri budget:
    (win, idx1, idx2, pair_t, pts, has_str, str_comp, from_mono,
    n_matches). Matches beyond the budget are dropped pair-major-last
    (n_matches confesses the overflow; budget sized ~4x the observed
    per-KF match count)."""
    TP, F = free2.shape
    KN = kf_cand.shape[2]
    CK = 2 * KN

    # ---- epipolar search over all neighbor pairs (existing kernel) ------
    match = jax.vmap(
        matching.search_for_triangulation,
        in_axes=(None, None, None, None, None, None,
                 0, 0, 0, 0, 0, 0, 0, 0, None),
    )(
        kf_uv[kf1], kf_ur[kf1], kf_desc[kf1], kf_oct[kf1], kf_angle[kf1],
        free1,
        kf_uv[kf2_idx], kf_ur[kf2_idx], kf_desc[kf2_idx], kf_oct[kf2_idx],
        kf_angle[kf2_idx], free2 & job_ok[:, None], fmat, epipole2,
        sigma2_tab,
    )                                                   # (TP, F)

    # ---- compact matches to the m_tri budget, pair-major order ----------
    flat_ok = (match >= 0).reshape(-1)
    n_matches = jnp.sum(flat_ok.astype(jnp.int32))
    order = jnp.argsort(~flat_ok, stable=True)          # valid first
    take = order[:m_tri]
    m_ok = flat_ok[take]
    pair_t = (take // F).astype(jnp.int32)
    idx1 = (take % F).astype(jnp.int32)
    idx2 = jnp.maximum(match.reshape(-1)[take], 0)
    kf2_of = kf2_idx[pair_t]                            # (M,)

    # ---- per-match geometry --------------------------------------------
    q1, t1 = kf_q[kf1], kf_t[kf1]
    q2, t2 = kf_q[kf2_of], kf_t[kf2_of]                 # (M,4),(M,3)
    R1 = se3.quat_to_matrix(q1)                         # (3,3)
    R2 = jax.vmap(se3.quat_to_matrix)(q2)               # (M,3,3)
    t1_wc = -R1.T @ t1
    t2_wc = -jnp.einsum("mji,mj->mi", R2, t2)

    uv1 = kf_uv[kf1, idx1]
    uv2 = kf_uv[kf2_of, idx2]
    ur1 = kf_ur[kf1, idx1]
    ur2 = kf_ur[kf2_of, idx2]
    z1 = kf_depth[kf1, idx1]
    z2 = kf_depth[kf2_of, idx2]
    oct1 = kf_oct[kf1, idx1]
    oct2 = kf_oct[kf2_of, idx2]
    st1 = ur1 >= 0
    st2 = ur2 >= 0
    M = idx1.shape[0]

    one = jnp.ones(M, jnp.float32)
    xn1 = jnp.stack(
        [(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy, one], -1
    )
    xn2 = jnp.stack(
        [(uv2[:, 0] - cam.cx) / cam.fx, (uv2[:, 1] - cam.cy) / cam.fy, one], -1
    )
    ray1 = xn1 @ R1                                     # rows (R1^T xn1)^T
    ray2 = jnp.einsum("mi,mij->mj", xn2, R2)
    cos_rays = jnp.sum(ray1 * ray2, -1) / (
        jnp.linalg.norm(ray1, axis=1) * jnp.linalg.norm(ray2, axis=1)
    )
    b = cam.bf / cam.fx
    cos_st1 = jnp.where(
        st1, jnp.cos(2 * jnp.arctan2(b / 2, jnp.maximum(z1, 1e-6))),
        cos_rays + 1,
    )
    cos_st2 = jnp.where(
        st2, jnp.cos(2 * jnp.arctan2(b / 2, jnp.maximum(z2, 1e-6))),
        cos_rays + 1,
    )
    cos_stereo = jnp.minimum(cos_st1, cos_st2)

    use_dlt = (cos_rays < cos_stereo) & (cos_rays > 0) & (
        st1 | st2 | (cos_rays < 0.9998)
    )
    use_s1 = ~use_dlt & st1 & (cos_st1 < cos_st2)
    use_s2 = ~use_dlt & st2 & (cos_st2 <= cos_st1) & ~use_s1
    usable = (use_dlt | use_s1 | use_s2) & m_ok
    from_mono = use_dlt

    # ---- init: DLT (adjugate null vector) or stereo unproject -----------
    T1r = jnp.concatenate([R1, t1[:, None]], axis=1)    # (3,4)
    T2r = jnp.concatenate([R2, t2[..., None]], axis=2)  # (M,3,4)
    A = jnp.stack(
        [
            xn1[:, 0, None] * T1r[2][None, :] - T1r[0][None, :],
            xn1[:, 1, None] * T1r[2][None, :] - T1r[1][None, :],
            xn2[:, 0, None] * T2r[:, 2] - T2r[:, 0],
            xn2[:, 1, None] * T2r[:, 2] - T2r[:, 1],
        ],
        axis=1,
    )                                                   # (M,4,4)
    v = _dlt_null(A)
    dlt_bad = jnp.abs(v[:, 3]) < 1e-9
    pts_dlt = v[:, :3] / jnp.where(dlt_bad, 1.0, v[:, 3])[:, None]
    usable = usable & ~(use_dlt & dlt_bad)

    pts_s1 = (xn1 * z1[:, None] - t1) @ R1
    pts_s2 = jnp.einsum(
        "mi,mij->mj", xn2 * z2[:, None] - t2, R2
    )
    pts0 = jnp.where(
        use_dlt[:, None], pts_dlt,
        jnp.where(use_s1[:, None], pts_s1, pts_s2),
    )

    # ---- candidate degenerate components (union of both features') ------
    cand1 = kf_cand[kf1, idx1]                          # (M,KN)
    cand2 = kf_cand[kf2_of, idx2]
    cands = jnp.concatenate([cand1, cand2], axis=1)     # (M,CK)
    cands = jnp.where(
        (cands >= 0) & g_deg[jnp.maximum(cands, 0)], cands, -1
    )

    # ---- GMM-constrained solve over all (match x candidate) pairs -------
    obs1 = jnp.concatenate([uv1, ur1[:, None]], -1)
    obs2 = jnp.concatenate([uv2, ur2[:, None]], -1)
    s2i1 = sigma2_inv_tab[oct1]
    s2i2 = s2i1  # reference uses sigma2_inv1 for both edges (:130-137)
    safe_c = jnp.maximum(cands, 0)
    bc = lambda a: jnp.broadcast_to(a[:, None, ...], (M, CK) + a.shape[1:])
    x_opt, c1o, c2o, cso = point_solver.optimize_triangulation(
        cam,
        bc(pts0),
        jnp.broadcast_to(q1, (M, CK, 4)), jnp.broadcast_to(t1, (M, CK, 3)),
        bc(obs1), bc(st1), bc(s2i1),
        bc(q2), bc(t2), bc(obs2), bc(st2), bc(s2i2),
        g_normal[safe_c].astype(jnp.float32),
        g_means[safe_c].astype(jnp.float32),
        tri_lambda2=tri_lambda2,
        iters=tri_opt_iters,
    )                                                   # (M,CK,...)

    th1 = jnp.where(st1, 7.8, 5.991)[:, None]
    th2 = jnp.where(st2, 7.8, 5.991)[:, None]
    ok = (cands >= 0) & (c1o <= th1) & (c2o <= th2)
    if tri_check_str_chi2:
        ok = ok & (cso <= tri_str_thresh * tri_lambda2)
    err_sum = jnp.where(ok, c1o + c2o, jnp.inf)
    best = jnp.argmin(err_sum, axis=1)
    has_str = jnp.isfinite(
        jnp.take_along_axis(err_sum, best[:, None], 1)[:, 0]
    )
    str_comp = jnp.where(
        has_str, jnp.take_along_axis(cands, best[:, None], 1)[:, 0], -1
    )
    pts = jnp.where(
        has_str[:, None],
        jnp.take_along_axis(x_opt, best[:, None, None], 1)[:, 0],
        pts0,
    )

    # ---- acceptance gates (localization_opt.cpp:358-412) ----------------
    def reproj_ok(pc, uvk, urk, stk):
        z = pc[:, 2]
        zs = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v_ = cam.fy * pc[:, 1] / zs + cam.cy
        err = (u - uvk[:, 0]) ** 2 + (v_ - uvk[:, 1]) ** 2
        errs = err + (u - cam.bf / zs - urk) ** 2
        e = jnp.where(stk, errs, err)
        th = jnp.where(stk, 7.8, 5.991)
        # reference scales both gates by sigma2[kp1.octave] (:371,:382)
        return (z > 0) & (e <= th * sigma2_tab[oct1])

    ok_pt = usable & reproj_ok(pts @ R1.T + t1, uv1, ur1, st1)
    pc2 = jnp.einsum("mij,mj->mi", R2, pts) + t2
    ok_pt &= reproj_ok(pc2, uv2, ur2, st2)
    d1 = jnp.linalg.norm(pts - t1_wc, axis=1)
    d2 = jnp.linalg.norm(pts - t2_wc, axis=1)
    ok_pt &= (d1 >= 1e-9) & (d2 >= 1e-9)
    ratio_dist = d2 / jnp.maximum(d1, 1e-9)
    ratio_oct = sf_tab[oct1] / sf_tab[oct2]
    ok_pt &= (ratio_dist * ratio_factor >= ratio_oct) & (
        ratio_dist <= ratio_oct * ratio_factor
    )

    # ---- first-wins per kf1 feature across pairs (covisibility order) ---
    BIG = jnp.int32(1 << 20)
    score = jnp.where(ok_pt, pair_t, BIG)
    best_for_feat = jnp.full((F,), BIG, jnp.int32).at[idx1].min(score)
    win = ok_pt & (score == best_for_feat[idx1]) & (score < BIG)

    return (
        win, idx1, idx2, pair_t, pts, has_str, str_comp, from_mono,
        n_matches,
    )
