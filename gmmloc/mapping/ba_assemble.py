"""On-device local-BA problem assembly from the DeviceWorld mirror.

JAX replacement for the g2o graph-building loop of
Localization::jointOptimization (ref: /root/reference/gmmloc/src/modules/
localization_opt.cpp:456-560 — per-vertex/per-edge addVertex/addEdge over
shared-memory pointers). The round-4 host assembly gathered the window's
observation tables in numpy and uploaded 17 (P,MO)-shaped arrays per
solve (~1 MB and 17 transfers); the mirror already holds every input, so assembly is pure
device gathering — the host uploads only the window's slot lists (~20 KB)
and ONE program assembles AND solves.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..solver import local_ba


@functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "n_free", "n_cams", "n_pts", "mo",
        "ba_lambda2", "tri_str_thresh", "prior_rot_info",
        "prior_trans_info", "iters1", "iters2", "iters3", "term_gain",
        "schur_impl", "linear_solver", "cg_iters", "weak_obs_thresh",
    ),
)
def assemble_and_solve(
    cam: cam_mod.CameraParams,
    local_kfs,        # (L,) int32 keyframe ids, -1 padded
    fixed_kfs,        # (F_CAP,) int32, -1 padded
    pts_ids,          # (P,) int32 point ids, -1 padded
    slot_lut,         # (MK,) int32 kf id -> camera slot (-1 outside window)
    has_prior,        # () bool
    first_kf,         # () int32 (clamped >= 0)
    # device-world mirror
    kf_q, kf_t,
    kf_feat_uv, kf_feat_ur, kf_feat_octave,
    pt_pos, pt_obs_kf, pt_obs_feat, pt_acomp,
    # gmm map tables
    g_means, g_normal, g_sqrt_info, g_deg,
    sigma2_inv_tab,   # (L_pyr,)
    *,
    n_free: int,
    n_cams: int,
    n_pts: int,
    mo: int,
    ba_lambda2: float,
    tri_str_thresh: float,
    prior_rot_info: float,
    prior_trans_info: float,
    iters1: int,
    iters2: int,
    iters3: int,
    term_gain: float,
    schur_impl: str,
    linear_solver: str,
    cg_iters: int,
    weak_obs_thresh: int = 10,
):
    """Assemble the BAProblem from mirror gathers and solve it in the
    SAME program. Returns (BAResult, obs_kfid (P,mo), n_obs_pt (P,)).

    Matches the host assembly in localization.joint_optimization
    bit-for-bit (tests/test_ba_assembly.py): same stable compaction
    order, same weak-KF demotion, same str-factor selection."""
    L, C, P = n_free, n_cams, n_pts

    # ---- camera slots ----------------------------------------------------
    slots = jnp.concatenate([local_kfs[:L], fixed_kfs[: C - L]])
    slot_ok = slots >= 0
    safe_slots = jnp.maximum(slots, 0)
    cam_q = jnp.where(
        slot_ok[:, None], kf_q[safe_slots],
        jnp.array([1.0, 0, 0, 0], jnp.float32)[None, :],
    )
    cam_t = jnp.where(slot_ok[:, None], kf_t[safe_slots], 0.0)

    # ---- per-point observation compaction (stable, first-MO columns) ----
    pt_ok = pts_ids >= 0
    safe_p = jnp.maximum(pts_ids, 0)
    okf = pt_obs_kf[safe_p]                              # (P, MO_world)
    oft = pt_obs_feat[safe_p]
    oslot = jnp.where(okf >= 0, slot_lut[jnp.maximum(okf, 0)], -1)
    use = (okf >= 0) & (oslot >= 0) & pt_ok[:, None]
    order = jnp.argsort(~use, axis=1, stable=True)[:, :mo]
    use_c = jnp.take_along_axis(use, order, axis=1)
    okf_c = jnp.where(use_c, jnp.take_along_axis(okf, order, axis=1), 0)
    oft_c = jnp.where(use_c, jnp.take_along_axis(oft, order, axis=1), 0)
    obs_cam = jnp.where(
        use_c, jnp.take_along_axis(oslot, order, axis=1), -1
    ).astype(jnp.int32)
    uv = kf_feat_uv[okf_c, oft_c]                        # (P, mo, 2)
    urr = kf_feat_ur[okf_c, oft_c]
    obs_uvr = jnp.concatenate([uv, urr[..., None]], -1)
    obs_st = use_c & (urr >= 0)
    obs_s2i = jnp.where(
        use_c, sigma2_inv_tab[kf_feat_octave[okf_c, oft_c]], 1.0
    )
    obs_kfid = jnp.where(use_c, okf_c, -1).astype(jnp.int32)
    n_obs_pt = jnp.sum(use_c, axis=1).astype(jnp.int32)

    # ---- weak-KF demotion (obs count per local slot < thresh -> fixed) --
    onehot = (
        (obs_cam[..., None] == jnp.arange(C)[None, None, :]) & use_c[..., None]
    )
    obs_per_cam = jnp.sum(onehot, axis=(0, 1))
    weak = (jnp.arange(C) < L) & slot_ok & (obs_per_cam < weak_obs_thresh)
    weak = weak.at[0].set(weak[0] & ~has_prior)  # prior-anchored KF stays free
    cam_valid = slot_ok & ~weak

    # ---- structure factors ----------------------------------------------
    comp = jnp.where(pt_ok, pt_acomp[safe_p], -1)
    has_c = comp >= 0
    cs = jnp.maximum(comp, 0)
    is_deg = has_c & g_deg[cs]
    is_nd = has_c & ~g_deg[cs]
    str_type = jnp.where(
        is_deg, local_ba.STR_DEG, jnp.where(is_nd, local_ba.STR_NONDEG, 0)
    ).astype(jnp.int32)
    str_normal = jnp.where(
        is_deg[:, None], g_normal[cs].astype(jnp.float32),
        jnp.array([0.0, 0, 1], jnp.float32)[None, :],
    )
    str_mean = jnp.where(has_c[:, None], g_means[cs].astype(jnp.float32), 0.0)
    str_sqrt = jnp.where(
        is_nd[:, None, None], g_sqrt_info[cs].astype(jnp.float32),
        jnp.eye(3, dtype=jnp.float32)[None],
    )

    fk = jnp.maximum(first_kf, 0)
    prob = local_ba.BAProblem(
        cam_q=cam_q.astype(jnp.float32),
        cam_t=cam_t.astype(jnp.float32),
        cam_valid=cam_valid,
        pts=jnp.where(pt_ok[:, None], pt_pos[safe_p], 0.0).astype(jnp.float32),
        pt_valid=pt_ok,
        obs_cam=obs_cam,
        obs_uvr=obs_uvr.astype(jnp.float32),
        obs_stereo=obs_st,
        obs_sigma2_inv=obs_s2i.astype(jnp.float32),
        obs_valid=use_c,
        str_type=str_type,
        str_normal=str_normal,
        str_mean=str_mean,
        str_sqrt_info=str_sqrt,
        prior_q=kf_q[fk].astype(jnp.float32),
        prior_t=kf_t[fk].astype(jnp.float32),
        has_prior=has_prior,
    )
    res = local_ba.solve_local_ba(
        cam, prob, n_free=L,
        ba_lambda2=ba_lambda2,
        tri_str_thresh=tri_str_thresh,
        prior_rot_info=prior_rot_info,
        prior_trans_info=prior_trans_info,
        iters1=iters1, iters2=iters2, iters3=iters3,
        term_gain=term_gain,
        schur_impl=schur_impl,
        linear_solver=linear_solver,
        cg_iters=cg_iters,
    )
    return res, obs_kfid, n_obs_pt
