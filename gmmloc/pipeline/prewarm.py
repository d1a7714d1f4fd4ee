"""Pre-compile every shape-tier executable the pipeline can hit mid-run.

The solvers use tiered static shapes (small windows compile to small
programs: localization.py joint_optimization tiers, fuse/triangulation
pow2 buckets). Tiers that first occur deep into a sequence would
otherwise pay their jit compile inside the measured window (seconds per
executable).
`prewarm(cfg, cam)` touches each (tier, static-arg) combination with
zero-filled inputs so the in-process jit cache is hot before frame 0.

No reference counterpart (the reference is an interpreter-free C++
binary); this is XLA-specific infrastructure.
"""

from __future__ import annotations

import numpy as np

from ..config import SystemConfig
from ..features import matching
from ..geometry import camera as cam_mod
from ..solver import local_ba


def _dummy_ba_problem(L: int, F_CAP: int, P: int, MO: int):
    import jax.numpy as jnp

    C = L + F_CAP
    cam_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (C, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.arange(C) * 0.05
    cam_valid = np.zeros(C, bool)
    cam_valid[: min(4, C)] = True
    pts = np.zeros((P, 3), np.float32)
    pts[:, 2] = 5.0
    pt_valid = np.zeros(P, bool)
    pt_valid[: min(64, P)] = True
    obs_cam = np.zeros((P, MO), np.int32)
    obs_uvr = np.zeros((P, MO, 3), np.float32)
    obs_uvr[..., :2] = 300.0
    obs_valid = np.zeros((P, MO), bool)
    obs_valid[: min(64, P), :2] = True
    return local_ba.BAProblem(
        cam_q=jnp.array(cam_q), cam_t=jnp.array(cam_t),
        cam_valid=jnp.array(cam_valid),
        pts=jnp.array(pts), pt_valid=jnp.array(pt_valid),
        obs_cam=jnp.array(obs_cam), obs_uvr=jnp.array(obs_uvr),
        obs_stereo=jnp.array(obs_valid), obs_sigma2_inv=jnp.ones((P, MO), jnp.float32),
        obs_valid=jnp.array(obs_valid),
        str_type=jnp.zeros(P, jnp.int32),
        str_normal=jnp.tile(jnp.array([0.0, 0, 1], jnp.float32), (P, 1)),
        str_mean=jnp.array(pts),
        str_sqrt_info=jnp.tile(jnp.eye(3, dtype=jnp.float32), (P, 1, 1)),
        prior_q=jnp.array(cam_q[0]), prior_t=jnp.array(cam_t[0]),
        has_prior=jnp.array(True),
    )


def ba_tiers(cfg: SystemConfig):
    caps = cfg.caps
    return [
        (8, 16, 2048),
        (16, 32, 4096),
        (caps.local_ba_kfs, caps.fixed_ba_kfs, caps.local_ba_points),
    ]


def prewarm_ba(cfg: SystemConfig, cam: cam_mod.CameraParams, log=None) -> int:
    """Compile the staged Schur LM solve at every window tier, with the
    exact static args joint_optimization passes (same jit cache keys)."""
    from ..utils.fetch import fetch

    n = 0
    sig_rot = np.deg2rad(cfg.loc.prior_sigma_rot_deg)
    for (L, F_CAP, P) in ba_tiers(cfg):
        prob = _dummy_ba_problem(L, F_CAP, P, cfg.caps.ba_obs_per_point)
        res = local_ba.solve_local_ba(
            cam, prob, n_free=L,
            ba_lambda2=cfg.loc.ba_lambda2,
            tri_str_thresh=cfg.loc.tri_str_thresh,
            prior_rot_info=1.0 / sig_rot**2,
            prior_trans_info=1.0 / cfg.loc.prior_sigma_trans**2,
            iters1=cfg.loc.ba_iters_stage1,
            iters2=cfg.loc.ba_iters_stage2,
            iters3=cfg.loc.ba_iters_stage3,
            term_gain=cfg.loc.ba_term_gain,
            schur_impl=cfg.loc.ba_schur_impl,
            linear_solver=cfg.loc.ba_linear_solver,
            cg_iters=cfg.loc.ba_cg_iters,
        )
        fetch((res.n_iters,))
        n += 1
        if log:
            log(f"prewarm ba tier L={L} P={P}")
    return n


def prewarm_fuse(cfg: SystemConfig, tp_tiers=(1, 2, 4, 8, 16),
                 buckets=(256, 512), log=None) -> int:
    """Compile fuse_match_batch over its (pow2 job count, pow2 query
    bucket) tier grid (localization._fuse_jobs shapes)."""
    import jax.numpy as jnp

    from ..utils.fetch import fetch

    F = cfg.frame.feat_cap
    n = 0
    for TP in tp_tiers:
        for B in buckets:
            m = matching.fuse_match_batch(
                jnp.zeros((TP, B, 2), jnp.float32),
                jnp.full((TP, B), -1.0, jnp.float32),
                jnp.zeros((TP, B, 32), jnp.uint8),
                jnp.zeros((TP, B), jnp.int32),
                jnp.ones((TP, B), jnp.float32),
                jnp.zeros((TP, B), bool),
                jnp.zeros((TP, F, 2), jnp.float32),
                jnp.full((TP, F), -1.0, jnp.float32),
                jnp.zeros((TP, F, 32), jnp.uint8),
                jnp.zeros((TP, F), jnp.int32),
                jnp.zeros((TP, F), bool),
                jnp.ones(cfg.frame.num_levels, jnp.float32),
            )
            fetch((m,))
            n += 1
    if log:
        log(f"prewarm fuse: {n} tier programs")
    return n


def prewarm_point_solvers(
    cfg: SystemConfig, cam: cam_mod.CameraParams,
    buckets=(256, 512, 1024, 2048, 4096, 8192), log=None,
) -> int:
    """Compile optimize_point_stereo / optimize_triangulation at every
    pow2 bucket the association/triangulation paths can hit (uncompiled
    buckets show up as multi-second spikes inside measured windows)."""
    import jax.numpy as jnp

    from ..solver import point_solver
    from ..utils.fetch import fetch

    loc = cfg.loc
    n = 0
    for B in buckets:
        x0 = jnp.zeros((B, 3), jnp.float32).at[:, 2].set(5.0)
        q = jnp.tile(jnp.array([1.0, 0, 0, 0], jnp.float32), (B, 1))
        t = jnp.zeros((B, 3), jnp.float32)
        obs = jnp.full((B, 3), 300.0, jnp.float32)
        nrm = jnp.tile(jnp.array([0.0, 0, 1], jnp.float32), (B, 1))
        res = point_solver.optimize_point_stereo(
            cam, x0, q, t, obs,
            jnp.ones(B, jnp.float32), nrm, x0, jnp.ones(B, jnp.float32),
            chi2_proj_thresh=loc.chi2_stereo,
            str_chi2_thresh=loc.tri_str_thresh * loc.tri_lambda2,
            iters=loc.point_opt_iters,
            tri_check_str_chi2=loc.tri_check_str_chi2,
        )
        fetch((res.ok,))
        out = point_solver.optimize_triangulation(
            cam, x0, q, t, obs, jnp.zeros(B, bool), jnp.ones(B, jnp.float32),
            q, t, obs, jnp.zeros(B, bool), jnp.ones(B, jnp.float32),
            nrm, x0, tri_lambda2=loc.tri_lambda2, iters=loc.tri_opt_iters,
        )
        fetch((out[0],))
        n += 2
    if log:
        log(f"prewarm point solvers: {n} bucket programs")
    return n


def _dummy_gmap(cfg: SystemConfig):
    """Zero-filled GMMMap with the configured pad size (shape/dtype-only
    jit cache keys; values irrelevant)."""
    import jax.numpy as jnp

    from ..gmm.mixture import GMMMap

    K = cfg.caps.gmm_components_pad
    NB = cfg.gmm.neighbor_cap
    eye = jnp.tile(jnp.eye(3, dtype=jnp.float32), (K, 1, 1))
    return GMMMap(
        means=jnp.zeros((K, 3), jnp.float32), covs=eye, cov_inv=eye,
        det=jnp.ones(K, jnp.float32),
        scale=jnp.ones((K, 3), jnp.float32), axis=eye,
        normal=jnp.tile(jnp.array([0.0, 0, 1], jnp.float32), (K, 1)),
        sqrt_info=eye,
        is_degenerated=jnp.zeros(K, bool), is_salient=jnp.zeros(K, bool),
        valid=jnp.zeros(K, bool),
        neighbors=jnp.full((K, NB), -1, jnp.int32),
    )


def prewarm_device_world(
    cfg: SystemConfig, cam: cam_mod.CameraParams,
    fwd_tiers=(1, 2, 4, 8, 16, 32), fwd_buckets=(256, 512, 1024, 2048),
    log=None,
) -> int:
    """Compile the device-world gather kernels (merged fusion tier grid,
    the fused triangulation program, the fused KF-association program,
    the assemble+solve BA tiers) against a zero-filled mirror."""
    import jax.numpy as jnp

    from ..features import matching
    from ..mapping import ba_assemble
    from ..mapping.association import associate_and_check_kernel
    from ..mapping.device_world import DeviceWorld
    from ..mapping.map_state import MapState
    from ..mapping.tri_kernel import triangulate_kernel
    from ..utils.fetch import fetch

    world = MapState(cfg)
    dv = DeviceWorld(world)
    dv.sync()
    dv.prewarm_scatters(pt_buckets=(256, 512, 1024, 2048, 4096, 8192))
    s2i = jnp.ones(cfg.frame.num_levels, jnp.float32)
    sf = jnp.ones(cfg.frame.num_levels, jnp.float32)
    n = 0
    for TP in fwd_tiers:
        for B in fwd_buckets:
            m = matching.fuse_project_match_gather(
                cam,
                jnp.zeros(TP, jnp.int32), jnp.zeros(TP, bool),
                jnp.zeros((TP, B), jnp.int32), jnp.zeros((TP, B), bool),
                jnp.zeros((TP, B), bool),
                dv.kf_q, dv.kf_t,
                dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
                dv.kf_feat_octave, dv.kf_feat_valid,
                dv.pt_pos, dv.pt_normal, dv.pt_min_dist, dv.pt_max_dist,
                dv.pt_desc, dv.pt_valid,
                s2i, sf, jnp.float32(0.18),
            )
            fetch((m,))
            n += 1
    F = cfg.frame.feat_cap
    T = 10  # create_map_points' fixed neighbor tier
    gmap = _dummy_gmap(cfg)
    lc = cfg.loc
    if lc.fused_tri:
        r = triangulate_kernel(
            cam, jnp.int32(0), jnp.zeros(T, jnp.int32), jnp.zeros(T, bool),
            jnp.zeros(F, bool), jnp.zeros((T, F), bool),
            jnp.zeros((T, 3, 3), jnp.float32), jnp.zeros((T, 2), jnp.float32),
            s2i, s2i, sf,
            dv.kf_q, dv.kf_t,
            dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
            dv.kf_feat_octave, dv.kf_feat_angle, dv.kf_feat_depth,
            dv.kf_comp_cand,
            gmap.means, gmap.normal, gmap.is_degenerated,
            m_tri=cfg.caps.tri_match_budget,
            tri_lambda2=lc.tri_lambda2,
            tri_opt_iters=lc.tri_opt_iters,
            tri_check_str_chi2=lc.tri_check_str_chi2,
            tri_str_thresh=lc.tri_str_thresh,
            ratio_factor=1.5 * cfg.frame.scale_factor,
        )
        fetch((r[0],))
        n += 1
    else:
        m = matching.search_for_triangulation_gather(
            jnp.int32(0), jnp.zeros(T, jnp.int32),
            jnp.zeros(F, bool), jnp.zeros((T, F), bool),
            jnp.zeros((T, 3, 3), jnp.float32), jnp.zeros((T, 2), jnp.float32),
            s2i,
            dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
            dv.kf_feat_octave, dv.kf_feat_angle,
        )
        fetch((m,))
        n += 1
    if lc.fused_kf_assoc:
        g = cfg.gmm
        r = associate_and_check_kernel(
            gmap, cam,
            jnp.array([1.0, 0, 0, 0], jnp.float32), jnp.zeros(3, jnp.float32),
            jnp.zeros((F, 2), jnp.float32), jnp.full(F, -1.0, jnp.float32),
            jnp.zeros(F, jnp.int32), jnp.zeros(F, bool),
            jnp.full(F, -1.0, jnp.float32), s2i,
            knn=g.assoc_knn, mdist2_thresh=g.assoc_mdist2_thresh,
            view_cos_deg=g.view_cos_deg,
            cov2d_scale_thresh=g.cov2d_scale_thresh,
            occlusion_bh_thresh=g.occlusion_bh_thresh,
            tri_lambda2=lc.tri_lambda2, chi2_stereo=lc.chi2_stereo,
            str_chi2_thresh=lc.tri_str_thresh * lc.tri_lambda2,
            chi2_assoc_3d=lc.chi2_assoc_3d, iters=lc.point_opt_iters,
            tri_check_str_chi2=lc.tri_check_str_chi2,
        )
        fetch((r[1],))
        n += 1
    if lc.ba_device_assembly:
        sig_rot = np.deg2rad(lc.prior_sigma_rot_deg)
        for (L, F_CAP, P) in ba_tiers(cfg):
            res, okfid, nobs = ba_assemble.assemble_and_solve(
                cam,
                jnp.full(L, -1, jnp.int32), jnp.full(F_CAP, -1, jnp.int32),
                jnp.full(P, -1, jnp.int32),
                jnp.full(world.MK, -1, jnp.int32),
                jnp.array(False), jnp.int32(0),
                dv.kf_q, dv.kf_t,
                dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_octave,
                dv.pt_pos, dv.pt_obs_kf, dv.pt_obs_feat, dv.pt_acomp,
                gmap.means, gmap.normal, gmap.sqrt_info,
                gmap.is_degenerated, s2i,
                n_free=L, n_cams=L + F_CAP, n_pts=P,
                mo=cfg.caps.ba_obs_per_point,
                ba_lambda2=lc.ba_lambda2,
                tri_str_thresh=lc.tri_str_thresh,
                prior_rot_info=1.0 / sig_rot**2,
                prior_trans_info=1.0 / lc.prior_sigma_trans**2,
                iters1=lc.ba_iters_stage1, iters2=lc.ba_iters_stage2,
                iters3=lc.ba_iters_stage3, term_gain=lc.ba_term_gain,
                schur_impl=lc.ba_schur_impl,
                linear_solver=lc.ba_linear_solver, cg_iters=lc.ba_cg_iters,
            )
            fetch((res.n_iters,))
            n += 1
    if log:
        log(f"prewarm device-world kernels: {n} programs")
    return n


def prewarm_chained(cfg: SystemConfig, cam: cam_mod.CameraParams,
                    log=None) -> int:
    """Compile the device-chained track step (fused_track_step_chained)
    with the exact static args fused_dispatch_chained passes."""
    import jax.numpy as jnp

    from ..mapping.map_state import MapState
    from ..tracking import fused
    from ..utils.fetch import fetch

    tk = cfg.tracking
    if tk.pipeline_depth <= 1 or not tk.fused_packed_io:
        return 0
    w = MapState(cfg)
    F = cfg.frame.feat_cap
    P = tk.fused_local_map_cap
    MP = w.MP
    pyr = w.pyr
    out0 = jnp.zeros(10 + 3 * F + P, jnp.float32)
    cur0 = jnp.zeros((F, fused.CUR_W), jnp.float32)
    dyn0 = jnp.zeros((F, fused.DYN_W), jnp.float32)
    map0 = jnp.zeros((P, fused.MAP_W), jnp.float32)
    gmm0 = jnp.zeros((cfg.caps.gmm_components_pad, fused.GMM_W), jnp.float32)
    kw = dict(
        use_anchors=tk.use_gmm_pose_anchor,
        anchor_lambda2=float(tk.anchor_lambda2),
        anchor_chi2_gate=float(tk.anchor_chi2_gate),
        anchor_min_edges=int(tk.anchor_min_edges),
        velocity_ema=float(tk.velocity_ema),
        velocity_damping=float(tk.velocity_damping),
        th_depth=float(pyr["th_depth"]),
        temp_cap=int(tk.temporal_points_cap),
        motion_radius=float(tk.motion_search_radius),
        local_radius=float(tk.local_search_radius),
    )
    n = 0
    for out in (out0, jnp.zeros(10 + 3 * F + P + 7, jnp.float32)):
        r = fused.fused_track_step_chained(
            cam, out, cur0, dyn0, map0,
            jnp.zeros(7, jnp.float32), jnp.zeros(8, jnp.float32),
            jnp.zeros((MP, 3), jnp.float32), jnp.zeros(MP, bool),
            jnp.full(MP, -1.0, jnp.float32),
            cur0, map0, gmm0,
            jnp.ones(cfg.frame.num_levels, jnp.float32),
            float(pyr["log_scale_factor"]), cfg.frame.num_levels,
            **kw,
        )
        fetch((r[0],))
        n += 1
    if log:
        log(f"prewarm chained track step: {n} programs")
    return n


def prewarm(cfg: SystemConfig, cam: cam_mod.CameraParams, log=None) -> int:
    """Warm the tier grid a long run can hit after its opening frames."""
    n = 0
    if not (cfg.loc.use_device_world and cfg.loc.ba_device_assembly):
        # solve-only tiers; with device assembly the fused
        # assemble+solve programs (prewarm_device_world) subsume them
        n += prewarm_ba(cfg, cam, log=log)
    if cfg.loc.use_device_world:
        n += prewarm_device_world(cfg, cam, log=log)
    else:
        n += prewarm_fuse(cfg, log=log)
    n += prewarm_point_solvers(cfg, cam, log=log)
    n += prewarm_chained(cfg, cam, log=log)
    return n
