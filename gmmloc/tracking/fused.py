"""Fused per-frame track step: one jitted megakernel per frame.

The 20 Hz loop must not be dispatch-bound (SURVEY.md §7 hard part 4):
this kernel fuses the whole per-frame compute —

  project last-frame landmarks -> guided motion-model match (with the
  reference's widened-window retry, tracking.cpp:345-350) -> staged
  pose solve -> project + gate local-map points (scale/view-cos,
  mappoint.cpp:257-299) -> guided local match -> second staged pose
  solve -> inlier stats

— into a single XLA program with static shapes. The host passes the
last-frame set, the current frame's features, and a fixed-capacity local
map snapshot; it gets back the pose, per-feature point assignments and
stats in one device round-trip.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..features import matching
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..solver import pallas_pose, pose_solver

POSE_IMPLS = ("auto", "xla", "pallas")


def use_pose_kernel(pose_impl: str) -> bool:
    """Resolve TrackingConfig.pose_impl at trace time: True runs the
    single-program Pallas pose kernel (Triton route), False the XLA op
    chain. "auto" is the kernel on the GPU and XLA on the CPU; any other
    platform is an error."""
    if pose_impl not in POSE_IMPLS:
        raise ValueError(f"pose_impl={pose_impl!r} not in {POSE_IMPLS}")
    if pose_impl != "auto":
        return pose_impl == "pallas"
    backend = jax.default_backend()
    if backend not in ("gpu", "cpu"):
        raise RuntimeError(f"pose_impl: no route for platform {backend!r}")
    return backend == "gpu"


class FusedTrackResult(NamedTuple):
    q: jax.Array              # (4,) optimized T_cw
    t: jax.Array              # (3,)
    feat_point: jax.Array     # (F,) int32 — local-map/last-frame point slot
    feat_from_local: jax.Array  # (F,) bool — True if slot indexes local map
    is_outlier: jax.Array     # (F,)
    num_inliers: jax.Array    # ()
    n_motion_matches: jax.Array  # ()
    map_in_view: jax.Array    # (P,) bool — local points passing the gates
    num_anchors: jax.Array    # () int32 — surviving GMM anchors (0 if off)


def _track_core(
    cam: cam_mod.CameraParams,
    q0, t0,                       # const-velocity init T_cw
    # last-frame landmark queries (slot-aligned with its features)
    last_pts,                     # (F,3) world positions (0 if none)
    last_desc, last_octave, last_angle, last_ur, last_valid,
    # current frame features
    feat_uv, feat_ur, feat_desc, feat_octave, feat_angle, feat_valid,
    feat_sigma2_inv,
    # local-map snapshot (fixed capacity P)
    map_pts,                      # (P,3)
    map_desc,                     # (P,32)
    map_normal,                   # (P,3)
    map_min_dist, map_max_dist,   # (P,)
    map_valid,                    # (P,)
    scale_factors,                # (L,)
    log_scale_factor: float,
    num_levels: int,
    motion_radius: float = 7.0,
    local_radius: float = 3.0,
    # GMM structure anchors, keyed by point slot (see pose_solver
    # optimize_pose_anchored; classic path _gather_anchors). last_anc_*
    # are F-aligned (last-frame slots), map_anc_* are P-aligned.
    use_anchors: bool = False,
    last_anc_type=None, last_anc_mean=None, last_anc_normal=None,
    last_anc_sqrt_info=None,
    map_anc_type=None, map_anc_mean=None, map_anc_normal=None,
    map_anc_sqrt_info=None,
    anchor_lambda2: float = 400.0,
    anchor_chi2_gate: float = 2.56,
    anchor_min_edges: int = 10,
    pose_impl: str = "auto",
) -> FusedTrackResult:
    F = feat_uv.shape[0]
    P = map_pts.shape[0]

    # staged pose solves: the single-program Pallas kernel
    # (solver/pallas_pose.py) or the XLA op chain (solver/pose_solver.py)
    use_pl = use_pose_kernel(pose_impl)
    opt_pose = pallas_pose.optimize_pose if use_pl else pose_solver.optimize_pose
    opt_pose_anchored = (
        pallas_pose.optimize_pose_anchored if use_pl
        else pose_solver.optimize_pose_anchored
    )

    def project(q, t, pts):
        pc = se3.apply(q, t, pts)
        z = pc[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * pc[..., 0] / zs + cam.cx
        v = cam.fy * pc[..., 1] / zs + cam.cy
        ur = u - cam.bf / zs
        inside = (z > 0) & (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height)
        return jnp.stack([u, v], -1), ur, z, inside

    # ---- stage 1: motion-model guided match ----------------------------
    uv_p, ur_p, _, inside = project(q0, t0, last_pts)
    q_valid = last_valid & inside

    # ONE Hamming matrix shared by the narrow and widened-window retry
    # (the masks differ, the distances don't — saves a full (F,F)
    # XOR+popcount pass per frame)
    dist_motion = matching.hamming_matrix(last_desc, feat_desc)

    def run_match(th):
        radius = th * scale_factors[last_octave]
        m, _ = matching.search_by_projection(
            uv_p, jnp.where(last_ur >= 0, ur_p, -1.0), last_desc,
            last_octave, last_angle, q_valid, radius,
            last_octave - 1, last_octave + 1,
            feat_uv, feat_ur, feat_desc, feat_octave, feat_angle,
            feat_valid, jnp.zeros(F, bool),
            desc_thresh=matching.TH_HIGH, nn_ratio=1.0, use_rotation=True,
            dist_precomputed=dist_motion,
        )
        return m

    m1 = run_match(motion_radius)
    n1 = jnp.sum(m1 >= 0)
    m1b = run_match(2.0 * motion_radius)
    match_motion = jnp.where(n1 < 20, m1b, m1)          # (F queries,) feat idx
    n_motion = jnp.sum(match_motion >= 0)

    # feature -> last-frame slot assignment (scatter, F = scratch slot)
    qidx = jnp.arange(F, dtype=jnp.int32)
    tgt = jnp.where(match_motion >= 0, match_motion, F)
    feat_point = jnp.full((F + 1,), -1, jnp.int32).at[tgt].set(qidx)[:F]
    has1 = feat_point >= 0

    # ---- first pose solve ---------------------------------------------
    x1 = last_pts[jnp.clip(feat_point, 0)]
    obs = jnp.concatenate([feat_uv, feat_ur[:, None]], -1)
    res1 = opt_pose(
        cam, q0, t0, x1, obs, feat_ur >= 0, feat_sigma2_inv,
        has1 & feat_valid,
    )
    inl1 = has1 & feat_valid & ~res1.is_outlier

    # ---- stage 2: local-map gates + guided match -----------------------
    q1, t1 = res1.q, res1.t
    q_wc, t_wc = se3.inverse(q1, t1)
    uv_m, ur_m, z_m, inside_m = project(q1, t1, map_pts)
    v = map_pts - t_wc
    dist = jnp.linalg.norm(v, axis=-1)
    ok = (
        map_valid & inside_m
        & (dist >= 0.8 * map_min_dist) & (dist <= 1.2 * map_max_dist)
        & (dist > 1e-9)
    )
    view_cos = jnp.einsum("pi,pi->p", v, map_normal) / jnp.clip(dist, 1e-9)
    ok = ok & (view_cos >= 0.5)
    lvl = jnp.ceil(
        jnp.log(jnp.clip(map_max_dist / jnp.clip(dist, 1e-9), 1e-9))
        / log_scale_factor
    ).astype(jnp.int32)
    lvl = jnp.clip(lvl, 0, num_levels - 1)

    m2, _ = matching.search_by_projection(
        uv_m, ur_m, map_desc, lvl, jnp.zeros(P, jnp.float32), ok,
        local_radius * scale_factors[lvl], lvl - 1, lvl,
        feat_uv, feat_ur, feat_desc, feat_octave, feat_angle,
        feat_valid, inl1,
        desc_thresh=matching.TH_HIGH, nn_ratio=0.8, use_rotation=False,
    )
    # merge: features matched in stage 2 get local-map slots
    tgt2 = jnp.where(m2 >= 0, m2, F)
    pidx = jnp.arange(P, dtype=jnp.int32)
    add2 = jnp.full((F + 1,), -1, jnp.int32).at[tgt2].set(pidx)[:F]
    use2 = (add2 >= 0) & ~inl1
    feat_from_local = use2
    feat_point = jnp.where(use2, add2, feat_point)
    has = (feat_point >= 0) & (inl1 | use2)

    # ---- second pose solve --------------------------------------------
    x2 = jnp.where(
        use2[:, None], map_pts[jnp.clip(feat_point, 0)],
        last_pts[jnp.clip(feat_point, 0)],
    )
    if use_anchors:
        # per-feature structure anchors gathered at the final assignment
        # (classic path: tracker._gather_anchors on frame.mappoint).
        # Anchor the feature's OWN stereo measurement to the matched
        # point's vetted GMM component.
        fpc = jnp.clip(feat_point, 0)
        sel = use2[:, None]
        a_type = jnp.where(use2, map_anc_type[fpc], last_anc_type[fpc])
        a_mean = jnp.where(sel, map_anc_mean[fpc], last_anc_mean[fpc])
        a_norm = jnp.where(sel, map_anc_normal[fpc], last_anc_normal[fpc])
        a_sqi = jnp.where(
            sel[:, :, None], map_anc_sqrt_info[fpc], last_anc_sqrt_info[fpc]
        )
        stereo_ok = feat_ur >= 0
        zs = jnp.where(
            jnp.abs(obs[:, 0] - obs[:, 2]) < 1e-6,
            1e9, cam.bf / jnp.clip(obs[:, 0] - obs[:, 2], 1e-6),
        )
        anc_ok = (
            (a_type != pose_solver.ANCHOR_NONE)
            & has & feat_valid & stereo_ok & (zs > 0) & (zs < 1e3)
        )
        a_type = jnp.where(anc_ok, a_type, pose_solver.ANCHOR_NONE)
        # all-or-nothing gate: below min_edges the anchors add bias, not
        # observability (classic host gate, anchor_min_edges)
        enough = jnp.sum(a_type != pose_solver.ANCHOR_NONE) >= anchor_min_edges
        a_type = jnp.where(enough, a_type, pose_solver.ANCHOR_NONE)
        anc_xc = jnp.stack(
            [
                (obs[:, 0] - cam.cx) / cam.fx * zs,
                (obs[:, 1] - cam.cy) / cam.fy * zs,
                zs,
            ],
            -1,
        )
        zc = jnp.maximum(zs, 1.0)
        a_weight = jnp.where(
            a_type == pose_solver.ANCHOR_DEG, anchor_lambda2 * zc * zc, 1.0
        ).astype(jnp.float32)
        res2 = opt_pose_anchored(
            cam, q1, t1, x2, obs, feat_ur >= 0, feat_sigma2_inv,
            has & feat_valid,
            anc_xc, a_mean, a_norm, a_sqi, a_type, a_weight,
            jnp.float32(anchor_chi2_gate),
        )
    else:
        res2 = opt_pose(
            cam, q1, t1, x2, obs, feat_ur >= 0, feat_sigma2_inv,
            has & feat_valid,
        )
    inliers = has & feat_valid & ~res2.is_outlier

    n_anc = (
        res2.num_anchors if use_anchors else jnp.int32(0)
    )
    return FusedTrackResult(
        q=res2.q, t=res2.t,
        feat_point=jnp.where(has, feat_point, -1),
        feat_from_local=feat_from_local,
        is_outlier=res2.is_outlier,
        num_inliers=jnp.sum(inliers),
        n_motion_matches=n_motion,
        map_in_view=ok,
        num_anchors=n_anc,
    )


fused_track_step = functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "num_levels", "use_anchors", "anchor_lambda2",
        "anchor_chi2_gate", "anchor_min_edges", "pose_impl",
    ),
)(_track_core)


# ---------------------------------------------------------------------------
# packed-IO variant: minimal per-frame transfer through the host link
# ---------------------------------------------------------------------------
#
# Every host<->device transfer has a fixed cost per array plus a cost
# per byte; the unpacked step moves ~25 arrays and >1 MB per frame. The
# packed variant moves THREE small f32 arrays per frame (current-frame features with
# descriptor bytes bitcast into f32 lanes, last-frame slot dynamics,
# pose/scalars) plus a per-refresh local-map table and two static
# tables (GMM anchor geometry, pyramid scales) uploaded once, and
# returns ONE packed f32 vector. Bitcast transport is bit-exact; every
# computation is _track_core, identical to the unpacked path
# (tests/test_fused_track.py::test_packed_matches_unpacked).

CUR_W = 16      # uv(2) ur(1) angle(1) s2i(1) valid(1) octave(1) pad(1) desc(8)
DYN_W = 8       # last_pts(3) q_valid(1) comp(1) pid(1) pad(2)
MAP_W = 24      # pts(3) normal(3) min(1) max(1) valid(1) comp(1) pid(1) pad(1) desc(8) pad(8->0)
GMM_W = 16      # mean(3) normal(3) sqrt_info(9) deg(1)


def _desc_bits(packed_f32):
    """(N,8) f32 lanes -> (N,32) uint8 descriptor (pure bit transport)."""
    u8 = jax.lax.bitcast_convert_type(packed_f32, jnp.uint8)  # (N,8,4)
    return u8.reshape(packed_f32.shape[0], 32)


@functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "num_levels", "use_anchors", "map_is_stale",
        "anchor_lambda2", "anchor_chi2_gate", "anchor_min_edges",
        "pose_impl",
    ),
)
def fused_track_step_packed(
    cam: cam_mod.CameraParams,
    scal,            # (16,) f32: q0(4) t0(3) motion_radius(1) local_radius(1)
    cur,             # (F,CUR_W) f32 current frame (see CUR_W layout)
    last_cur,        # (F,CUR_W) f32 previous frame's `cur` (device-resident)
    last_dyn,        # (F,DYN_W) f32 last-frame slot dynamics
    map_tab,         # (P,MAP_W) f32 local-map snapshot
    gmm_tab,         # (K,GMM_W) f32 static GMM component geometry
    scale_factors,   # (L,) f32 static pyramid scales
    log_scale_factor: float,
    num_levels: int,
    use_anchors: bool = False,
    map_is_stale: bool = False,
    anchor_lambda2: float = 400.0,
    anchor_chi2_gate: float = 2.56,
    anchor_min_edges: int = 10,
    pose_impl: str = "auto",
):
    F = cur.shape[0]
    P = map_tab.shape[0]
    q0, t0 = scal[:4], scal[4:7]
    motion_radius, local_radius = scal[7], scal[8]

    feat_uv = cur[:, 0:2]
    feat_ur = cur[:, 2]
    feat_angle = cur[:, 3]
    feat_s2i = cur[:, 4]
    feat_valid = cur[:, 5] > 0.5
    feat_octave = cur[:, 6].astype(jnp.int32)
    feat_desc = _desc_bits(cur[:, 8:16])

    last_ur = last_cur[:, 2]
    last_angle = last_cur[:, 3]
    last_octave = last_cur[:, 6].astype(jnp.int32)
    last_desc = _desc_bits(last_cur[:, 8:16])

    last_pts = last_dyn[:, 0:3]
    last_valid = last_dyn[:, 3] > 0.5
    last_comp = last_dyn[:, 4].astype(jnp.int32)
    last_pid = last_dyn[:, 5].astype(jnp.int32)

    map_pts = map_tab[:, 0:3]
    map_normal = map_tab[:, 3:6]
    map_min = map_tab[:, 6]
    map_max = map_tab[:, 7]
    map_valid = map_tab[:, 8] > 0.5
    map_comp = map_tab[:, 9].astype(jnp.int32)
    map_pid = map_tab[:, 10].astype(jnp.int32)
    map_desc = _desc_bits(map_tab[:, 16:24])

    if map_is_stale:
        # the snapshot predates the last frame's matches: drop map slots
        # whose point is already carried by a last-frame slot (the host
        # does this exclusion itself when it refreshes every frame)
        carried = (map_pid[:, None] == last_pid[None, :]) & last_valid[None, :]
        map_valid = map_valid & ~jnp.any(carried, axis=1)

    anc_kw = {}
    if use_anchors:
        gmm_mean = gmm_tab[:, 0:3]
        gmm_normal = gmm_tab[:, 3:6]
        gmm_sqi = gmm_tab[:, 6:15].reshape(-1, 3, 3)
        gmm_deg = gmm_tab[:, 15] > 0.5

        def slot_tables(comp):
            k = jnp.clip(comp, 0)
            a_type = jnp.where(
                comp >= 0,
                jnp.where(gmm_deg[k], pose_solver.ANCHOR_DEG,
                          pose_solver.ANCHOR_NONDEG),
                pose_solver.ANCHOR_NONE,
            ).astype(jnp.int32)
            return a_type, gmm_mean[k], gmm_normal[k], gmm_sqi[k]

        lt, lm, ln, ls = slot_tables(last_comp)
        mt, mm, mn, msq = slot_tables(map_comp)
        anc_kw = dict(
            use_anchors=True,
            last_anc_type=lt, last_anc_mean=lm, last_anc_normal=ln,
            last_anc_sqrt_info=ls,
            map_anc_type=mt, map_anc_mean=mm, map_anc_normal=mn,
            map_anc_sqrt_info=msq,
            anchor_lambda2=anchor_lambda2,
            anchor_chi2_gate=anchor_chi2_gate,
            anchor_min_edges=anchor_min_edges,
        )

    r = _track_core(
        cam, q0, t0,
        last_pts, last_desc, last_octave, last_angle, last_ur, last_valid,
        feat_uv, feat_ur, feat_desc, feat_octave, feat_angle, feat_valid,
        feat_s2i,
        map_pts, map_desc, map_normal, map_min, map_max, map_valid,
        scale_factors, log_scale_factor, num_levels,
        motion_radius=motion_radius, local_radius=local_radius,
        pose_impl=pose_impl,
        **anc_kw,
    )
    # ONE packed output: [q(4) t(3) n_inl n_motion n_anc | feat_point(F)
    # | from_local(F) | is_outlier(F) | map_in_view(P)]  (ints < 2^24
    # are exact in f32)
    out = jnp.concatenate([
        r.q, r.t,
        jnp.stack([
            r.num_inliers.astype(jnp.float32),
            r.n_motion_matches.astype(jnp.float32),
            r.num_anchors.astype(jnp.float32),
        ]),
        r.feat_point.astype(jnp.float32),
        r.feat_from_local.astype(jnp.float32),
        r.is_outlier.astype(jnp.float32),
        r.map_in_view.astype(jnp.float32),
    ])
    return out


# ---------------------------------------------------------------------------
# device-chained variant: dispatch frame N+1 without draining frame N
# ---------------------------------------------------------------------------
#
# The packed step still forces one host round trip per frame: the host
# must FETCH frame N's result to build frame N+1's inputs (pose init via
# the velocity model; the last-frame landmark table from the matched
# point ids), so the readback round trip bounds the frame rate. The
# chained step removes the dependency: it
# computes ALL of frame N+1's dispatch inputs on device from frame N's
# (un-fetched) packed output plus the device world mirror —
#
#   pose chain: EMA/damped constant-velocity model (system.init_pose_guess)
#   landmark chain: feat_point -> pid via the dyn/map pid columns, with
#     positions refreshed from the device world mirror (BA updates)
#   temporal points: re-synthesized from the last frame's own stereo
#     depths at its solved pose (tracker._create_temporal_points rule)
#
# so the host only uploads the new frame's packed feature table and
# drains results with a lag of `pipeline_depth` frames — the readback
# RTT hides behind k dispatches. Results are drained IN ORDER and all
# host bookkeeping (observation counters, KF policy, mapping) runs at
# drain time, k frames behind the dispatch front — the same bounded
# staleness contract as the reference's online tracking/mapping split
# (gmmloc.cpp:56-59; mapping consumes keyframes asynchronously).

TEMP_PID = -2.0   # dyn pid sentinel: slot holds a synthesized temporal point


def _chain_prep(
    cam: cam_mod.CameraParams,
    prev_out,        # (10+3F+P [+7],) previous packed output (un-fetched)
    prev_cur,        # (F, CUR_W) previous frame's feature table
    prev_dyn,        # (F, DYN_W) previous dispatch's landmark table
    prev_map_tab,    # (P, MAP_W) map table used at the previous dispatch
    pose_prev2,      # (7,) pose of frame N-2 (q,t)
    vel,             # (8,) vel_q(4) vel_t(3) has_vel(1)
    pt_pos,          # (MP,3) device world mirror
    pt_valid,        # (MP,)
    pt_comp,         # (MP,) vetted GMM component per point (-1 none)
    velocity_ema: float,
    velocity_damping: float,
    th_depth: float,
    temp_cap: int,
):
    """Compute frame N+1's dispatch inputs from frame N's output."""
    F = prev_cur.shape[0]
    q1, t1 = prev_out[0:4], prev_out[4:7]
    fp = prev_out[10:10 + F].astype(jnp.int32)
    fl = prev_out[10 + F:10 + 2 * F] > 0.5
    outl = prev_out[10 + 2 * F:10 + 3 * F] > 0.5

    # ---- landmark chain (tracker.fused_complete's fp -> pid mapping) --
    fpc = jnp.clip(fp, 0)
    src_pid = jnp.where(fl, prev_map_tab[fpc, 10], prev_dyn[fpc, 5])
    matched = (fp >= 0) & ~outl
    pid = jnp.where(matched, src_pid, -1.0)
    pidi = jnp.clip(pid, 0).astype(jnp.int32)
    real = pid >= 0
    has_real = matched & real & pt_valid[pidi]
    pos = pt_pos[pidi]                              # refreshed (BA moves pts)

    # ---- temporal points (tracker._create_temporal_points rule) -------
    # depth-sorted prefix: process until the first rank where z > th_depth
    # AND rank+1 > cap; create for slots without a persistent landmark
    # (the host clears temp matches at cleanup, so p < 0 is the rule)
    u, v, ur = prev_cur[:, 0], prev_cur[:, 1], prev_cur[:, 2]
    valid_feat = prev_cur[:, 5] > 0.5
    disp = u - ur
    z = jnp.where(
        (ur >= 0) & (disp > 1e-6) & valid_feat,
        cam.bf / jnp.clip(disp, 1e-6), -1.0,
    )
    zkey = jnp.where(z > 0, z, jnp.inf)
    order = jnp.argsort(zkey)
    rank = jnp.zeros(F, jnp.int32).at[order].set(jnp.arange(F, dtype=jnp.int32))
    zo = zkey[order]
    n_good = jnp.sum(z > 0)
    stop = (zo > th_depth) & (jnp.arange(1, F + 1) > temp_cap) & jnp.isfinite(zo)
    n_proc = jnp.where(jnp.any(stop), jnp.argmax(stop) + 1, n_good)
    sel_temp = (z > 0) & (rank < n_proc) & ~has_real
    pc_x = (u - cam.cx) / cam.fx * z
    pc_y = (v - cam.cy) / cam.fy * z
    R1 = se3.quat_to_matrix(q1)                     # R_cw
    pc = jnp.stack([pc_x, pc_y, z], -1) - t1[None, :]
    temp_pos = pc @ R1                              # R_cw^T (pc - t) = x_w

    dyn = jnp.zeros((F, DYN_W), jnp.float32)
    dyn = dyn.at[:, 0:3].set(
        jnp.where(has_real[:, None], pos,
                  jnp.where(sel_temp[:, None], temp_pos, 0.0))
    )
    dyn = dyn.at[:, 3].set((has_real | sel_temp).astype(jnp.float32))
    dyn = dyn.at[:, 4].set(jnp.where(has_real, pt_comp[pidi], -1.0))
    dyn = dyn.at[:, 5].set(
        jnp.where(has_real, pid, jnp.where(sel_temp, TEMP_PID, -1.0))
    )

    # ---- velocity model + pose prediction (system.init_pose_guess) ----
    q2, t2 = pose_prev2[0:4], pose_prev2[4:7]
    ql_wc, tl_wc = se3.inverse(q2, t2)
    dq, dt = se3.compose(q1, t1, ql_wc, tl_wc)
    vel_q, vel_t, has_vel = vel[0:4], vel[4:7], vel[7] > 0.5
    a = velocity_ema
    use_ema = has_vel if a < 1.0 else jnp.array(False)
    dq_s = jnp.where(jnp.dot(vel_q, dq) < 0, -dq, dq)
    dq_e = (1.0 - a) * vel_q + a * dq_s
    dq_e = dq_e / jnp.linalg.norm(dq_e)
    dt_e = (1.0 - a) * vel_t + a * dt
    dq = jnp.where(use_ema, dq_e, dq)
    dt = jnp.where(use_ema, dt_e, dt)
    g = velocity_damping
    if g < 1.0:
        dt = dt * g
        dq = dq.at[1:].multiply(g)
        dq = dq / jnp.linalg.norm(dq)
    vel_new = jnp.concatenate([dq, dt, jnp.ones(1, jnp.float32)])
    q0, t0 = se3.compose(dq, dt, q1, t1)
    return q0, t0, dyn, vel_new


@functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "num_levels", "use_anchors",
        "anchor_lambda2", "anchor_chi2_gate", "anchor_min_edges",
        "velocity_ema", "velocity_damping", "th_depth", "temp_cap",
        "motion_radius", "local_radius", "pose_impl",
    ),
)
def fused_track_step_chained(
    cam: cam_mod.CameraParams,
    prev_out, prev_cur, prev_dyn, prev_map_tab, pose_prev2, vel,
    pt_pos, pt_valid, pt_comp,
    cur,             # (F, CUR_W) — the ONLY per-frame upload
    map_tab,         # (P, MAP_W) current map table (kf-cadence cached)
    gmm_tab, scale_factors,
    log_scale_factor: float,
    num_levels: int,
    use_anchors: bool = False,
    anchor_lambda2: float = 400.0,
    anchor_chi2_gate: float = 2.56,
    anchor_min_edges: int = 10,
    velocity_ema: float = 0.5,
    velocity_damping: float = 1.0,
    th_depth: float = 35.0,
    temp_cap: int = 100,
    motion_radius: float = 7.0,
    local_radius: float = 3.0,
    pose_impl: str = "auto",
):
    """Chained packed track step. Returns (out_ext, dyn, vel, pose_prev)
    where out_ext = packed result + [q_pred(4) t_pred(3)], dyn/vel feed
    the NEXT chained call, and pose_prev = this frame's predecessor pose
    (the next call's pose_prev2). All four outputs stay device-resident;
    the host fetches out_ext with a pipeline_depth lag."""
    q0, t0, dyn, vel_new = _chain_prep(
        cam, prev_out, prev_cur, prev_dyn, prev_map_tab, pose_prev2, vel,
        pt_pos, pt_valid, pt_comp,
        velocity_ema, velocity_damping, th_depth, temp_cap,
    )
    scal = jnp.concatenate([
        q0, t0,
        jnp.array([motion_radius, local_radius], jnp.float32),
        jnp.zeros(7, jnp.float32),
    ])
    out = fused_track_step_packed(
        cam, scal, cur, prev_cur, dyn, map_tab, gmm_tab, scale_factors,
        log_scale_factor, num_levels,
        use_anchors=use_anchors, map_is_stale=True,
        anchor_lambda2=anchor_lambda2,
        anchor_chi2_gate=anchor_chi2_gate,
        anchor_min_edges=anchor_min_edges,
        pose_impl=pose_impl,
    )
    out_ext = jnp.concatenate([out, q0, t0])
    return out_ext, dyn, vel_new, prev_out[0:7]


def unpack_result(out: "np.ndarray", F: int, P: int):
    """Host-side unpack of fused_track_step_packed's output vector into
    the FusedTrackResult field order (numpy)."""
    import numpy as np

    q = out[0:4].astype(np.float64)
    t = out[4:7].astype(np.float64)
    n_inl, n_motion, n_anc = (int(out[7]), int(out[8]), int(out[9]))
    o = 10
    feat_point = out[o:o + F].astype(np.int32); o += F
    from_local = out[o:o + F] > 0.5; o += F
    is_outlier = out[o:o + F] > 0.5; o += F
    in_view = out[o:o + P] > 0.5
    return q, t, feat_point, from_local, is_outlier, n_inl, n_motion, in_view, n_anc
