"""Descriptor matching kernels: Hamming distances + guided search strategies.

JAX replacement for ORBmatcher (ref:
/root/reference/gmmloc/src/cv/orb_matcher.cpp). The reference's per-query
grid-bucket candidate scans become dense masked (N x M) passes: one
XOR+popcount distance matrix, window/level/ratio
gates as masks, argmin per query, and the rotation-consistency histogram
as a batched bincount + top-3 filter (orb_matcher.cpp:544-576).

Thresholds TH_LOW=50 / TH_HIGH=100 (orb_matcher.cpp:20-22).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30


def _hamming_matrix_xla(desc_a, desc_b):
    x = jax.lax.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return jnp.sum(jax.lax.population_count(x).astype(jnp.int32), axis=-1)


def hamming_matrix(desc_a, desc_b):
    """(N,32)x(M,32) uint8 descriptors -> (N,M) int32 Hamming distances.

    Replaces the bit-hack popcount loop (orb_matcher.cpp:580-594). XLA
    fuses the xor, popcount and byte sum into one reduction without
    materialising the (N, M, 32) tensor.
    """
    return _hamming_matrix_xla(desc_a, desc_b)


def rotation_consistency_mask(angle_a, angle_b, matched, bins: int = HISTO_LENGTH):
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (ref: ComputeThreeMaxima + rotHist filter,
    orb_matcher.cpp:544-576).

    angle_a/angle_b in degrees; `matched` bool mask over pairs.
    """
    rot = angle_a - angle_b
    rot = jnp.where(rot < 0.0, rot + 360.0, rot)
    factor = 1.0 / (360.0 / bins)
    bin_idx = jnp.round(rot * factor).astype(jnp.int32)
    bin_idx = jnp.where(bin_idx == bins, 0, bin_idx)
    counts = jnp.zeros(bins, jnp.int32).at[bin_idx].add(matched.astype(jnp.int32))
    top3 = jax.lax.top_k(counts, 3)[0]
    # reference drops bins 2/3 when much smaller than max (<0.1*max)
    mx = top3[0]
    keep_count = jnp.where(
        top3 > 0.1 * mx, top3, -1
    )
    good_bin = (
        (counts[bin_idx] == top3[0])
        | ((counts[bin_idx] == top3[1]) & (keep_count[1] >= 0))
        | ((counts[bin_idx] == top3[2]) & (keep_count[2] >= 0))
    )
    return matched & good_bin


@functools.partial(jax.jit, static_argnames=("use_rotation",))
def search_by_projection(
    proj_uv,        # (N,2) projected query positions in the current frame
    proj_ur,        # (N,) projected right-u (<0 -> no stereo gate)
    query_desc,     # (N,32) uint8
    query_octave,   # (N,) int32 predicted/source octave
    query_angle,    # (N,) degrees (for rotation consistency; 0s if unused)
    query_valid,    # (N,) bool
    radius,         # (N,) search radius in px (already octave-scaled)
    level_lo,       # (N,) min feature octave (inclusive)
    level_hi,       # (N,) max feature octave (inclusive)
    feat_uv,        # (M,2) current-frame features
    feat_ur,        # (M,)
    feat_desc,      # (M,32)
    feat_octave,    # (M,)
    feat_angle,     # (M,)
    feat_valid,     # (M,) bool
    feat_taken,     # (M,) bool — already has a landmark (skip as target)
    desc_thresh: int = TH_HIGH,
    nn_ratio: float = 1.0,
    use_rotation: bool = False,
    dist_precomputed=None,  # (N,M) Hamming matrix (shared across retries)
):
    """Generic guided projection search.

    Covers both reference variants:
      - map-point-to-frame (orb_matcher.cpp:27-110): ratio test between
        best/second-best when they sit on the same level.
      - frame-to-frame motion model (:410-542): stereo right-u gate +
        rotation histogram.

    Returns (match_idx (N,) int32 feature index or -1, best_dist (N,)).
    """
    d_uv = feat_uv[None, :, :] - proj_uv[:, None, :]
    in_window = (
        (jnp.abs(d_uv[..., 0]) < radius[:, None])
        & (jnp.abs(d_uv[..., 1]) < radius[:, None])
    )
    in_level = (feat_octave[None, :] >= level_lo[:, None]) & (
        feat_octave[None, :] <= level_hi[:, None]
    )
    # stereo gate (orb_matcher.cpp:468-476): |proj_ur - feat_ur| < radius
    stereo_ok = jnp.where(
        (proj_ur[:, None] >= 0.0) & (feat_ur[None, :] >= 0.0),
        jnp.abs(proj_ur[:, None] - feat_ur[None, :]) < radius[:, None],
        True,
    )
    cand = (
        in_window
        & in_level
        & stereo_ok
        & feat_valid[None, :]
        & ~feat_taken[None, :]
        & query_valid[:, None]
    )

    dist = (
        hamming_matrix(query_desc, feat_desc)
        if dist_precomputed is None else dist_precomputed
    )
    dist = jnp.where(cand, dist, 1 << 20)

    best_dist, best_idx = jax.lax.top_k(-dist, 2)
    best_dist = -best_dist
    best = best_idx[:, 0]
    # ratio test applies when best and runner-up are on the same octave
    # (orb_matcher.cpp:96-104)
    same_level = feat_octave[best_idx[:, 0]] == feat_octave[best_idx[:, 1]]
    ratio_ok = jnp.where(
        same_level & (best_dist[:, 1] < (1 << 19)),
        best_dist[:, 0].astype(jnp.float32)
        <= nn_ratio * best_dist[:, 1].astype(jnp.float32),
        True,
    )
    matched = (best_dist[:, 0] <= desc_thresh) & ratio_ok & query_valid

    if use_rotation:
        matched = rotation_consistency_mask(
            query_angle, feat_angle[best], matched
        )

    # resolve duplicate targets: keep the query with the smallest distance
    # (the sequential reference implicitly keeps the last writer; we keep
    # the best match per feature instead)
    N = proj_uv.shape[0]
    M = feat_uv.shape[0]
    d0 = jnp.where(matched, best_dist[:, 0], 1 << 20)
    best_for_feat = jnp.full((M,), 1 << 20, jnp.int32).at[best].min(d0)
    winner = matched & (d0 == best_for_feat[best])
    # among equal-distance duplicates keep lowest query index
    first_q = jnp.full((M,), N, jnp.int32).at[
        jnp.where(winner, best, M - 1)
    ].min(jnp.where(winner, jnp.arange(N), N))
    winner = winner & (first_q[best] == jnp.arange(N))

    return jnp.where(winner, best, -1), jnp.where(winner, d0, -1)


@jax.jit
def mutual_best_match(desc_a, valid_a, desc_b, valid_b, max_dist: int = TH_LOW):
    """Simple mutual-nearest-neighbor matching over full descriptor sets.

    Device-side replacement for BoW-bucketed matching (searchByBoW,
    orb_matcher.cpp:295-408): with the full (N,M) Hamming matrix on the
    device there is no need for the vocabulary acceleration structure.
    Returns (N,) index into b or -1.
    """
    dist = hamming_matrix(desc_a, desc_b)
    dist = jnp.where(valid_a[:, None] & valid_b[None, :], dist, 1 << 20)
    best_b = jnp.argmin(dist, axis=1)
    best_a = jnp.argmin(dist, axis=0)
    d = jnp.take_along_axis(dist, best_b[:, None], axis=1)[:, 0]
    mutual = best_a[best_b] == jnp.arange(desc_a.shape[0])
    ok = mutual & (d <= max_dist) & valid_a
    return jnp.where(ok, best_b, -1), jnp.where(ok, d, -1)


@functools.partial(jax.jit, static_argnames=("use_rotation",))
def search_for_triangulation(
    uv1, ur1, desc1, octave1, angle1, free1,   # KF1 features (no landmark yet)
    uv2, ur2, desc2, octave2, angle2, free2,   # KF2 features
    fmat,          # (3,3) fundamental matrix F with l2 = F^T p1
    epipole2,      # (2,) projection of KF1 center into KF2
    sigma2,        # (L,) per-octave sigma^2 table
    use_rotation: bool = False,
):
    """Epipolar-constrained descriptor matching for triangulation.

    Ref: ORBmatcher::searchForTriangulation (orb_matcher.cpp:141-293) +
    checkEpipolarDist (:119-139). The DBoW2 FeatureVector node-bucket
    iteration is an acceleration structure only — the dense masked
    (N1, N2) Hamming pass on the device replaces it wholesale.

    Returns (match12 (N1,) int32 -> index into KF2 or -1).
    """
    dist = hamming_matrix(desc1, desc2)

    # epipolar line of p1 in image 2: l = F^T [u1, v1, 1]
    p1h = jnp.concatenate([uv1, jnp.ones_like(uv1[:, :1])], axis=-1)  # (N1,3)
    line = p1h @ fmat                                                  # (N1,3)
    num = (
        line[:, None, 0] * uv2[None, :, 0]
        + line[:, None, 1] * uv2[None, :, 1]
        + line[:, None, 2]
    )
    den = line[:, 0] ** 2 + line[:, 1] ** 2
    dsqr = num * num / jnp.clip(den[:, None], 1e-12)
    epi_ok = (den[:, None] > 0) & (
        dsqr < 3.84 * sigma2[octave2][None, :]
    )

    # mono-mono pairs too close to the epipole are rejected (:225-231)
    stereo1 = ur1 >= 0
    stereo2 = ur2 >= 0
    d_epi = jnp.sum((uv2 - epipole2[None, :]) ** 2, axis=-1)           # (N2,)
    sf2 = jnp.sqrt(sigma2)[octave2]  # scale_factors == sqrt(sigma2)
    epipole_ok = jnp.where(
        (~stereo1[:, None]) & (~stereo2[None, :]),
        d_epi[None, :] >= 100.0 * sf2[None, :],
        True,
    )

    cand = (
        free1[:, None]
        & free2[None, :]
        & epi_ok
        & epipole_ok
        & (dist <= TH_LOW)
    )
    dist = jnp.where(cand, dist, 1 << 20)
    best2 = jnp.argmin(dist, axis=1)
    d0 = jnp.take_along_axis(dist, best2[:, None], axis=1)[:, 0]
    matched = d0 <= TH_LOW

    if use_rotation:
        matched = rotation_consistency_mask(angle1, angle2[best2], matched)

    # uniqueness on KF2 side (matched2[] in the reference): keep best
    N1, N2 = uv1.shape[0], uv2.shape[0]
    dd = jnp.where(matched, d0, 1 << 20)
    best_for_2 = jnp.full((N2,), 1 << 20, jnp.int32).at[best2].min(dd)
    winner = matched & (dd == best_for_2[best2])
    first_q = jnp.full((N2,), N1, jnp.int32).at[
        jnp.where(winner, best2, N2 - 1)
    ].min(jnp.where(winner, jnp.arange(N1), N1))
    winner = winner & (first_q[best2] == jnp.arange(N1))
    return jnp.where(winner, best2, -1)


def fundamental_matrix(q1, t1, q2, t2, K1, K2):
    """F with l2 = F^T p1 for poses T_c1_w, T_c2_w.

    Ref: MathUtils::computeFundamentalMatrix (math_utils.cpp:17-44):
    E = skew(t_c1_c2) @ R_c1_c2, F = K1^-T E K2^-1.
    """
    from ..geometry import se3 as _se3

    q12 = _se3.quat_mul(q1, _se3.quat_conj(q2))
    t12 = -_se3.quat_rotate(q12, t2) + t1
    E = _se3.skew(t12) @ _se3.quat_to_matrix(q12)
    return jnp.linalg.inv(K1).T @ E @ jnp.linalg.inv(K2)


@jax.jit
def fuse_match(
    proj_uv,        # (P,2) projected point positions in the target KF
    proj_ur,        # (P,) projected right-u
    pt_desc,        # (P,32) uint8 distinctive point descriptors
    pred_level,     # (P,) int32 predicted octave
    radius,         # (P,) search radius in px (octave-scaled)
    pt_valid,       # (P,) bool
    feat_uv,        # (M,2) target-KF features
    feat_ur,        # (M,)
    feat_desc,      # (M,32)
    feat_octave,    # (M,)
    feat_valid,     # (M,) bool
    sigma2_inv,     # (n_levels,) per-octave information
):
    """Batched landmark->keyframe fusion matching
    (ref: Localization::fuseObservations, localization.cpp:226-325):
    window + level gate [pred-1, pred], per-candidate reprojection chi2
    gate (5.99 mono / 7.8 stereo), Hamming argmin <= TH_LOW.

    Duplicate feature targets are NOT deduplicated: several points
    matching the same feature is the duplicate-landmark case that fusion
    exists to merge — the host surgery loop resolves each collision via
    the add-or-replace rule (:300-318). Returns (P,) feature idx or -1.
    """
    du = feat_uv[None, :, 0] - proj_uv[:, None, 0]
    dv = feat_uv[None, :, 1] - proj_uv[:, None, 1]
    in_window = (jnp.abs(du) < radius[:, None]) & (jnp.abs(dv) < radius[:, None])
    in_level = (feat_octave[None, :] >= pred_level[:, None] - 1) & (
        feat_octave[None, :] <= pred_level[:, None]
    )
    is_st = feat_ur[None, :] >= 0
    err2 = du * du + dv * dv
    dur = feat_ur[None, :] - proj_ur[:, None]
    e = jnp.where(is_st, err2 + dur * dur, err2) * sigma2_inv[feat_octave][None, :]
    chi2_ok = e <= jnp.where(is_st, 7.8, 5.99)
    cand = in_window & in_level & chi2_ok & feat_valid[None, :] & pt_valid[:, None]

    dist = hamming_matrix(pt_desc, feat_desc)
    dist = jnp.where(cand, dist, 1 << 20)
    best = jnp.argmin(dist, axis=1)
    d0 = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
    matched = (d0 <= TH_LOW) & pt_valid
    return jnp.where(matched, best, -1)


# vmapped variant: one dispatch for ALL covisible neighbor pairs of a new
# keyframe (the per-neighbor loop cost T device round-trips per KF).
# KF1's features are broadcast; KF2 features / F / epipole carry the batch
# axis. Returns (T, N1) match tables.
search_for_triangulation_batch = jax.jit(
    jax.vmap(
        search_for_triangulation,
        in_axes=(None, None, None, None, None, None,
                 0, 0, 0, 0, 0, 0, 0, 0, None),
    )
)

# vmapped fusion matching over all target KFs of searchInNeighbors: query
# sets and target features both carry the batch axis. Returns (T, P).
fuse_match_batch = jax.jit(
    jax.vmap(fuse_match, in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, None))
)


@jax.jit
def search_for_triangulation_gather(
    kf1,            # scalar int32
    kf2_idx,        # (T,) int32 neighbor keyframes
    free1,          # (F,) bool — kf1 features without a landmark
    free2,          # (T,F) bool
    fmat,           # (T,3,3)
    epipole2,       # (T,2)
    sigma2,         # (L,)
    kf_uv, kf_ur, kf_desc, kf_oct, kf_angle,      # device KF feature tables
):
    """search_for_triangulation_batch with KF feature tables gathered from
    the device-resident mirror instead of re-uploaded per keyframe
    (mapping/device_world.py). Only the small free/geometry inputs cross
    the host link. Returns (T, F) match tables."""
    return jax.vmap(
        search_for_triangulation,
        in_axes=(None, None, None, None, None, None,
                 0, 0, 0, 0, 0, 0, 0, 0, None),
    )(
        kf_uv[kf1], kf_ur[kf1], kf_desc[kf1], kf_oct[kf1], kf_angle[kf1],
        free1,
        kf_uv[kf2_idx], kf_ur[kf2_idx], kf_desc[kf2_idx], kf_oct[kf2_idx],
        kf_angle[kf2_idx], free2, fmat, epipole2, sigma2,
    )


@functools.partial(jax.jit, static_argnames=("cam",))
def fuse_project_match_gather(
    cam,
    kf_idx,         # (T,) int32 target keyframes
    job_ok,         # (T,) bool — padded tier rows are False
    q_pid,          # (T,B) int32 PER-JOB query landmark ids
    q_ok,           # (T,B) bool
    skip,           # (T,B) bool — landmark already observed by that target
    kf_q, kf_t,     # (MK,4),(MK,3) device poses (T_cw)
    kf_uv, kf_ur, kf_desc, kf_oct, kf_fvalid,     # device KF feature tables
    pt_pos, pt_normal, pt_mind, pt_maxd, pt_desc, pt_valid,  # device pt tables
    sigma2_inv,     # (L,)
    scale_factors,  # (L,)
    log_sf,         # f32 scalar
    th=3.0,
):
    """fuseObservations with the world resident in HBM: per-target
    projection, scale/view-cos gates and level prediction run ON DEVICE
    from gathered mirror rows (ref: Localization::fuseObservations,
    localization.cpp:226-325 — the reference reads these tables from
    shared memory; re-uploading them per keyframe would cost far more
    host-link traffic, see mapping/device_world.py).

    Query ids are PER JOB (r5): the forward fusion jobs (current-KF
    landmarks against each covisible target) and the reverse job (all
    2nd-ring landmarks against the current KF) land in ONE dispatch
    instead of two (each cost a sync + dispatch + fetch round trip).

    Returns (T, B) feature index into each target KF, or -1.
    """
    n_levels = scale_factors.shape[0]

    def per_target(kfi, jok, q_pid_t, q_ok_t, skip_t):
        pos = pt_pos[q_pid_t]                         # (B,3)
        nrm = pt_normal[q_pid_t]
        dmin = pt_mind[q_pid_t]
        dmax = pt_maxd[q_pid_t]
        desc = pt_desc[q_pid_t]
        ok0 = q_ok_t & pt_valid[q_pid_t]
        q = kf_q[kfi]
        t = kf_t[kfi]
        w_, x_, y_, z_ = q[0], q[1], q[2], q[3]
        R = jnp.array(
            [
                [1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_), 2 * (x_ * z_ + w_ * y_)],
                [2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - w_ * x_)],
                [2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_), 1 - 2 * (x_ * x_ + y_ * y_)],
            ]
        )
        pc = pos @ R.T + t
        z = pc[:, 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        ur = u - cam.bf / zs
        inside = (z > 0) & (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height)
        t_wc = -R.T @ t
        vdir = pos - t_wc
        dist = jnp.linalg.norm(vdir, axis=-1)
        ok = ok0 & ~skip_t & inside
        ok &= (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax) & (dist > 1e-9)
        vc = jnp.sum(vdir * nrm, -1) / jnp.clip(dist, 1e-9)
        ok &= vc >= 0.5
        lvl = jnp.ceil(
            jnp.log(jnp.clip(dmax / jnp.clip(dist, 1e-9), 1e-9)) / log_sf
        ).astype(jnp.int32)
        lvl = jnp.clip(lvl, 0, n_levels - 1)
        radius = th * scale_factors[lvl]
        m = fuse_match(
            jnp.stack([u, v], -1), ur, desc, lvl, radius, ok,
            kf_uv[kfi], kf_ur[kfi], kf_desc[kfi], kf_oct[kfi],
            kf_fvalid[kfi], sigma2_inv,
        )
        return jnp.where(jok, m, -1)

    return jax.vmap(per_target)(kf_idx, job_ok, q_pid, q_ok, skip)
