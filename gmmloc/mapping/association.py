"""Keyframe-side GMM association: render, candidate search, batched
point-to-component optimization with neighbor refinement.

JAX replacement for GMMLoc::{associateMapElements,
checkMapAssociation, optimizePoint, createMapPointsFromStereo}
(ref: /root/reference/gmmloc/src/gmmloc_opt.cpp:19-352).

The reference's per-feature, per-candidate sequential mini g2o solves
with early exits become one vmapped solve over ALL (feature x candidate)
pairs followed by masked argmin selection, then one more vmapped solve
for the neighbor-refinement switch (SURVEY.md §7 hard part 2).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SystemConfig
from ..geometry import camera as cam_mod
from ..gmm import gaussian, mixture, render as render_mod
from ..mapping import map_state as ms
from ..solver import point_solver
from ..utils.fetch import fetch
from ..utils.timing import Timer


def bucket_size(n: int, lo: int = 256) -> int:
    """Round batch sizes up to power-of-2 buckets so the vmapped solvers
    compile once per bucket instead of once per call (jit cache churn was
    ~60% of host wall time in r1 profiling)."""
    b = lo
    while b < n:
        b <<= 1
    return b


@functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "knn", "mdist2_thresh", "view_cos_deg", "cov2d_scale_thresh",
        "occlusion_bh_thresh", "tri_lambda2", "chi2_stereo", "str_chi2_thresh",
        "chi2_assoc_3d", "iters", "tri_check_str_chi2",
    ),
)
def associate_and_check_kernel(
    gmap,
    cam: cam_mod.CameraParams,
    q_cw, t_cw,            # (4,), (3,) keyframe pose
    uv,                    # (F,2) feature positions
    ur,                    # (F,)
    octave,                # (F,) int32
    valid,                 # (F,) bool
    depth,                 # (F,) stereo depth (<0 = none)
    sigma2_inv_tab,        # (L,) per-octave information
    *,
    knn: int,
    mdist2_thresh: float,
    view_cos_deg: float,
    cov2d_scale_thresh: float,
    occlusion_bh_thresh: float,
    tri_lambda2: float,
    chi2_stereo: float,
    str_chi2_thresh: float,
    chi2_assoc_3d: float,
    iters: int,
    tri_check_str_chi2: bool,
):
    """ONE dispatch for the whole per-keyframe association chain:
    renderView + searchCorrespondence + batched checkMapAssociation
    incl. neighbor refinement and the 3D queryPoint fallback
    (ref: associateMapElements gmmloc_opt.cpp:115-153 +
    checkMapAssociation :156-258 + queryPoint gaussian_mixture.cpp:545).

    The previous orchestration ran this as 4-6 separate dispatch+fetch
    round trips per keyframe; every host-side decision between the stages (argmin select, switch
    mask, fallback gating) is dense masked arithmetic, so the chain
    fuses into one program with one small fetch.

    Returns (cand (F,knn) int32, assoc (F,) int32 or -1, pt_out (F,3)).
    """
    F = uv.shape[0]

    # --- renderView + searchCorrespondence (existing kernels, inlined) ---
    r2d = render_mod.render_view(
        gmap, cam, q_cw, t_cw,
        view_cos_deg=view_cos_deg,
        cov2d_scale_thresh=cov2d_scale_thresh,
        occlusion_bh_thresh=occlusion_bh_thresh,
    )
    cand = render_mod.search_correspondence(
        r2d, uv, valid, knn=knn, mdist2_thresh=mdist2_thresh
    )                                                   # (F, knn)

    # --- unproject stereo features; per-feature edge terms ---------------
    feat_ok = valid & (depth > 0)
    z = jnp.where(feat_ok, depth, 1.0)
    xn = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy,
         jnp.ones(F, jnp.float32)], -1,
    )
    from ..geometry import se3 as _se3

    q_wc, t_wc = _se3.inverse(q_cw, t_cw)
    pts0 = _se3.apply(q_wc, t_wc, xn * z[:, None])      # (F,3) world
    obs_uvr = jnp.concatenate([uv, ur[:, None]], -1)
    s2i = sigma2_inv_tab[octave]
    # proj_z^2 with z clamped >= 1 (gmmloc_opt.cpp:171-174)
    str_info = tri_lambda2 * jnp.maximum(z, 1.0) ** 2

    def chi2_comp(comp, pts):
        """Component Mahalanobis^2 at pts; comp broadcast over leading."""
        safe = jnp.maximum(comp, 0)
        d = pts - gmap.means[safe]
        ci = gmap.cov_inv[safe]
        return jnp.einsum("...i,...ij,...j->...", d, ci, d)

    def run_opt(comp, pts_init):
        """optimize_point_stereo for one comp per row (broadcast pose)."""
        safe = jnp.maximum(comp, 0)
        res = point_solver.optimize_point_stereo(
            cam,
            pts_init,
            jnp.broadcast_to(q_cw, pts_init.shape[:-1] + (4,)),
            jnp.broadcast_to(t_cw, pts_init.shape[:-1] + (3,)),
            jnp.broadcast_to(obs_uvr[..., None, :] if pts_init.ndim == 3 else obs_uvr, pts_init.shape[:-1] + (3,)),
            jnp.broadcast_to(s2i[..., None] if pts_init.ndim == 3 else s2i, pts_init.shape[:-1]),
            gmap.normal[safe].astype(jnp.float32),
            gmap.means[safe].astype(jnp.float32),
            jnp.broadcast_to(str_info[..., None] if pts_init.ndim == 3 else str_info, pts_init.shape[:-1]).astype(jnp.float32),
            chi2_proj_thresh=chi2_stereo,
            str_chi2_thresh=str_chi2_thresh,
            iters=iters,
            tri_check_str_chi2=tri_check_str_chi2,
        )
        return res.x, res.chi2_proj, res.ok & (comp >= 0)

    # --- pass 1: all (feature x candidate) pairs -------------------------
    pts0_k = jnp.broadcast_to(pts0[:, None, :], (F, knn, 3))
    x1, c1, ok1 = run_opt(cand, pts0_k)                 # (F,knn,...)
    c1 = jnp.where(ok1 & feat_ok[:, None], c1, jnp.inf)
    best = jnp.argmin(c1, axis=1)
    found = jnp.isfinite(jnp.take_along_axis(c1, best[:, None], 1)[:, 0])
    best_comp = jnp.take_along_axis(cand, best[:, None], 1)[:, 0]
    best_pt = jnp.take_along_axis(x1, best[:, None, None], 1)[:, 0]

    # --- neighbor refinement (gmmloc_opt.cpp:209-228) --------------------
    g = jnp.maximum(best_comp, 0)
    ll = chi2_comp(g, best_pt)                          # (F,)
    nbs = gmap.neighbors[g]                             # (F, NB)
    ln = chi2_comp(jnp.maximum(nbs, 0), best_pt[:, None, :])
    ln = jnp.where(nbs >= 0, ln, jnp.inf)
    nb_best = jnp.argmin(ln, axis=1)
    nb_ll = jnp.take_along_axis(ln, nb_best[:, None], 1)[:, 0]
    switch = found & (nb_ll < ll)
    nb_comp = jnp.take_along_axis(nbs, nb_best[:, None], 1)[:, 0]
    chosen = jnp.where(switch, nb_comp, best_comp)
    x2, _, ok2 = run_opt(jnp.where(switch, chosen, -1), pts0)
    # failed re-opts fall back to the original comp/solution
    best_pt = jnp.where((switch & ok2)[:, None], x2, best_pt)
    chosen = jnp.where(switch & ~ok2, best_comp, chosen)

    ll_final = chi2_comp(jnp.maximum(chosen, 0), best_pt)
    accept = found & (ll_final <= chi2_assoc_3d)
    assoc = jnp.where(accept, chosen, -1).astype(jnp.int32)
    pt_out = jnp.where(accept[:, None], best_pt, pts0)

    # --- 3D queryPoint fallback for all-candidates-failed features -------
    # (gmmloc_opt.cpp:237-254: refines the position, keeps assoc = -1)
    has_cand = (cand >= 0).any(axis=1)
    miss = feat_ok & has_cand & ~found
    nearest = render_mod.query_point_3d(gmap, pts0, miss)
    deg_ok = miss & (nearest >= 0) & gmap.is_degenerated[jnp.maximum(nearest, 0)]
    x3, _, ok3 = run_opt(jnp.where(deg_ok, nearest, -1), pts0)
    pt_out = jnp.where((deg_ok & ok3)[:, None], x3, pt_out)

    return cand, assoc, pt_out


class GMMAssociator:
    def __init__(self, cfg: SystemConfig, cam: cam_mod.CameraParams, gmap: mixture.GMMMap):
        self.cfg = cfg
        self.cam = cam
        self.gmap = gmap
        hv = mixture.host_view(gmap)
        self._means = hv["means"]
        self._cov_inv = hv["cov_inv"]
        self._normal = hv["normal"]
        self._sqrt_info = hv["sqrt_info"]
        self._neighbors = hv["neighbors"]
        self._deg = hv["is_degenerated"]
        # per-KF (assoc, pt_out) staged by associate_and_check_keyframe,
        # consumed by create_map_points_from_stereo (fused single-dispatch
        # KF association path)
        self._fused_check: dict = {}

    # ------------------------------------------------------------------

    def associate_and_check_keyframe(self, world: ms.MapState, kf: int) -> None:
        """Fused single-dispatch variant of associate_keyframe + the
        checkMapAssociation batch: render + candidate search + per-feature
        association checks land in ONE device program with ONE fetch
        (associate_and_check_kernel). Stages (assoc, pt_out) for the
        subsequent create_map_points_from_stereo call."""
        cfg = self.cfg
        g = cfg.gmm
        lc = cfg.loc
        from ..utils.fetch import AsyncFetch

        with Timer("kf/assoc_check"):
            pend = AsyncFetch(
                associate_and_check_kernel(
                    self.gmap,
                    self.cam,
                    jnp.array(world.kf_q[kf], jnp.float32),
                    jnp.array(world.kf_t[kf], jnp.float32),
                    jnp.array(world.kf_feat_uv[kf], jnp.float32),
                    jnp.array(world.kf_feat_ur[kf], jnp.float32),
                    jnp.array(world.kf_feat_octave[kf], jnp.int32),
                    jnp.array(world.kf_feat_valid[kf]),
                    jnp.array(world.kf_feat_depth[kf], jnp.float32),
                    jnp.array(world.pyr["sigma2_inv"], jnp.float32),
                    knn=g.assoc_knn,
                    mdist2_thresh=g.assoc_mdist2_thresh,
                    view_cos_deg=g.view_cos_deg,
                    cov2d_scale_thresh=g.cov2d_scale_thresh,
                    occlusion_bh_thresh=g.occlusion_bh_thresh,
                    tri_lambda2=lc.tri_lambda2,
                    chi2_stereo=lc.chi2_stereo,
                    str_chi2_thresh=lc.tri_str_thresh * lc.tri_lambda2,
                    chi2_assoc_3d=lc.chi2_assoc_3d,
                    iters=lc.point_opt_iters,
                    tri_check_str_chi2=lc.tri_check_str_chi2,
                )
            )
        # deferred fetch: the readback overlaps the caller's host work
        # (observation binding) until create_map_points_from_stereo or
        # _consume_fused_check materializes it
        self._fused_check[kf] = pend

    def _consume_fused_check(self, world: ms.MapState, kf: int):
        ent = self._fused_check.pop(kf, None)
        if ent is None:
            return None
        with Timer("kf/assoc_fetch"):
            cand, assoc, pt_out = ent.get()
        world.kf_comp_cand[kf] = cand
        # re-mark: a device-world sync may have scattered this KF's row
        # before the candidate table was filled (chained tracking path)
        world.dirty_kf.add(kf)
        return assoc, pt_out

    def associate_keyframe(self, world: ms.MapState, kf: int) -> None:
        """renderView + searchCorrespondence -> kf_comp_cand
        (ref: associateMapElements, gmmloc_opt.cpp:115-153)."""
        g = self.cfg.gmm
        t_rv = Timer("loc/render_view").start()
        r2d = render_mod.render_view(
            self.gmap,
            self.cam,
            jnp.array(world.kf_q[kf], jnp.float32),
            jnp.array(world.kf_t[kf], jnp.float32),
            view_cos_deg=g.view_cos_deg,
            cov2d_scale_thresh=g.cov2d_scale_thresh,
            occlusion_bh_thresh=g.occlusion_bh_thresh,
        )
        t_rv.stop()
        t_sc = Timer("map/search_corr").start()
        cand = render_mod.search_correspondence(
            r2d,
            jnp.array(world.kf_feat_uv[kf], jnp.float32),
            jnp.array(world.kf_feat_valid[kf]),
            knn=g.assoc_knn,
            mdist2_thresh=g.assoc_mdist2_thresh,
        )
        world.kf_comp_cand[kf] = fetch(cand)
        world.dirty_kf.add(kf)  # mirror row must carry the candidate table
        t_sc.stop()

    # ------------------------------------------------------------------

    def _chi2_np(self, comp_ids, pts):
        """Host-side component chi2 (Mahalanobis^2) for selected comps."""
        d = pts - self._means[comp_ids]
        return np.einsum("ni,nij,nj->n", d, self._cov_inv[comp_ids], d)

    def check_map_association_batch(
        self, world: ms.MapState, kf: int, feat_idx: np.ndarray, pts0: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched checkMapAssociation (gmmloc_opt.cpp:156-258).

        Args:
          feat_idx: (M,) feature indices with stereo depth and >=1 candidate.
          pts0: (M,3) unprojected initial points (world frame).
        Returns (assoc_comp (M,) int32 or -1, pt_out (M,3)).
        """
        cfg = self.cfg.loc
        M = len(feat_idx)
        K = self.cfg.gmm.assoc_knn
        cand = world.kf_comp_cand[kf][feat_idx]            # (M, K) comp ids
        q_cw = world.kf_q[kf].astype(np.float32)
        t_cw = world.kf_t[kf].astype(np.float32)

        uv = world.kf_feat_uv[kf][feat_idx]
        ur = world.kf_feat_ur[kf][feat_idx]
        obs_uvr = np.concatenate([uv, ur[:, None]], -1)
        sigma2_inv = world.pyr["sigma2_inv"][world.kf_feat_octave[kf][feat_idx]]

        # proj_z^2 with z clamped at >= 1 (gmmloc_opt.cpp:171-174)
        R = ms._quat_to_mat(world.kf_q[kf])
        z = (pts0 @ R.T + world.kf_t[kf])[:, 2]
        z = np.maximum(z, 1.0)
        str_info = cfg.tri_lambda2 * z * z

        def run_opt(comp_ids_flat, pts_flat, obs_flat, s2i_flat, sinfo_flat):
            n = len(comp_ids_flat)
            B = bucket_size(n)

            def padb(a, fill=0.0):
                out = np.full((B,) + np.asarray(a).shape[1:], fill,
                              np.asarray(a).dtype)
                out[:n] = a
                return out

            safe = np.maximum(padb(comp_ids_flat, 0), 0)
            with Timer("kf/point_opt"):
                res = point_solver.optimize_point_stereo(
                    self.cam,
                    jnp.array(padb(pts_flat), jnp.float32),
                    jnp.tile(jnp.array(q_cw), (B, 1)),
                    jnp.tile(jnp.array(t_cw), (B, 1)),
                    jnp.array(padb(obs_flat), jnp.float32),
                    jnp.array(padb(s2i_flat, 1.0), jnp.float32),
                    jnp.array(self._normal[safe], jnp.float32),
                    jnp.array(self._means[safe], jnp.float32),
                    jnp.array(padb(sinfo_flat, 1.0), jnp.float32),
                    chi2_proj_thresh=cfg.chi2_stereo,
                    str_chi2_thresh=cfg.tri_str_thresh * cfg.tri_lambda2,
                    iters=cfg.point_opt_iters,
                    tri_check_str_chi2=cfg.tri_check_str_chi2,
                )
                x, c, ok = fetch((res.x, res.chi2_proj, res.ok))
            return x[:n], c[:n], ok[:n] & (comp_ids_flat >= 0)

        # pass 1: all (feature x candidate) pairs
        flat_comp = cand.reshape(-1)
        x1, c1, ok1 = run_opt(
            flat_comp,
            np.repeat(pts0, K, axis=0),
            np.repeat(obs_uvr, K, axis=0),
            np.repeat(sigma2_inv, K),
            np.repeat(str_info, K),
        )
        x1 = x1.reshape(M, K, 3)
        c1 = np.where(ok1, c1, np.inf).reshape(M, K)
        best = np.argmin(c1, axis=1)
        found = np.isfinite(c1[np.arange(M), best])
        best_comp = cand[np.arange(M), best]
        best_pt = x1[np.arange(M), best]

        assoc = np.full(M, -1, np.int32)
        pt_out = pts0.copy()

        # neighbor refinement (gmmloc_opt.cpp:209-228): switch to a neighbor
        # with lower chi2 at the solution, re-optimize with it.
        fi = np.where(found)[0]
        if len(fi):
            g = best_comp[fi]
            ll = self._chi2_np(g, best_pt[fi])
            nbs = self._neighbors[g]                      # (m, NB)
            nb_safe = np.maximum(nbs, 0)
            d = best_pt[fi][:, None, :] - self._means[nb_safe]
            ln = np.einsum("mki,mkij,mkj->mk", d, self._cov_inv[nb_safe], d)
            ln = np.where(nbs >= 0, ln, np.inf)
            nb_best = np.argmin(ln, axis=1)
            nb_ll = ln[np.arange(len(fi)), nb_best]
            switch = nb_ll < ll
            chosen = np.where(switch, nbs[np.arange(len(fi)), nb_best], g)

            if switch.any():
                si = np.where(switch)[0]
                x2, c2, ok2 = run_opt(
                    chosen[si],
                    pts0[fi][si],
                    obs_uvr[fi][si],
                    sigma2_inv[fi][si],
                    str_info[fi][si],
                )
                # failed re-opts fall back to the original comp/solution
                for j, sj in enumerate(si):
                    if ok2[j]:
                        best_pt[fi[sj]] = x2[j]
                    else:
                        chosen[sj] = g[sj]

            ll_final = self._chi2_np(chosen, best_pt[fi])
            accept = ll_final <= cfg.chi2_assoc_3d
            assoc[fi[accept]] = chosen[accept]
            pt_out[fi[accept]] = best_pt[fi[accept]]

        # 3D KD-tree fallback for features whose candidates all failed
        # (gmmloc_opt.cpp:237-254): accepts the refined position but keeps
        # assoc = -1 (the reference returns nullptr there too).
        miss = np.where(~found)[0]
        if len(miss):
            with Timer("kf/query3d"):
                # pow2 bucket: a raw len(miss) shape would compile a new
                # executable per keyframe
                Bq = bucket_size(len(miss))
                ptsq = np.zeros((Bq, 3), np.float32)
                ptsq[: len(miss)] = pts0[miss]
                okq = np.zeros(Bq, bool)
                okq[: len(miss)] = True
                nearest = fetch(
                    render_mod.query_point_3d(
                        self.gmap, jnp.array(ptsq), jnp.array(okq)
                    )
                )[: len(miss)]
            deg_ok = self._deg[np.maximum(nearest, 0)] & (nearest >= 0)
            di = miss[deg_ok]
            if len(di):
                x3, c3, ok3 = run_opt(
                    nearest[deg_ok],
                    pts0[di],
                    obs_uvr[di],
                    sigma2_inv[di],
                    str_info[di],
                )
                upd = np.where(ok3)[0]
                pt_out[di[upd]] = x3[upd]

        return assoc, pt_out

    # ------------------------------------------------------------------

    def create_map_points_from_stereo(
        self, world: ms.MapState, frame, kf: int, check_depth: bool = True
    ) -> int:
        """Ref: createMapPointsFromStereo (gmmloc_opt.cpp:36-113).

        Depth-sorted stereo features; features with GMM candidates must pass
        association (else no point); near-depth quota 100.
        """
        cfg = self.cfg
        # materialize the deferred fused-association readback (fills
        # kf_comp_cand, which the candidate gating below reads)
        staged = self._consume_fused_check(world, kf)
        th_depth = world.pyr["th_depth"]
        depth = frame.depth.copy()
        depth[~frame.valid] = -1
        order = np.argsort(np.where(depth > 0, depth, np.inf), kind="stable")
        order = order[depth[order] > 0]
        if len(order) == 0:
            return 0

        # candidate set: features needing a new point (vectorized)
        p_all = frame.mappoint[order]
        need_mask = (p_all < 0) | (world.pt_n_obs[np.maximum(p_all, 0)] < 1)
        frame.mappoint[order[need_mask & (p_all >= 0)]] = -1

        # apply the depth/quota cutoff over the sorted order (:108-111):
        # stop after the first position where depth > th and count > 100
        if check_depth:
            zo = depth[order]
            stop = (zo > th_depth) & (np.arange(1, len(order) + 1) > 100)
            n_proc = int(np.argmax(stop)) + 1 if stop.any() else len(order)
        else:
            n_proc = len(order)
        kept = order[:n_proc][need_mask[:n_proc]]
        if len(kept) == 0:
            return 0

        # unproject all kept features
        q_wc, t_wc = ms._inverse(world.kf_q[kf], world.kf_t[kf])
        R_wc = ms._quat_to_mat(q_wc)
        uv = world.kf_feat_uv[kf][kept]
        zs = depth[kept]
        pc = np.stack(
            [
                (uv[:, 0] - self.cam.cx) / self.cam.fx * zs,
                (uv[:, 1] - self.cam.cy) / self.cam.fy * zs,
                zs,
            ],
            -1,
        )
        pw = pc @ R_wc.T + t_wc

        has_cand = (world.kf_comp_cand[kf][kept] >= 0).any(axis=1)
        assoc = np.full(len(kept), -1, np.int32)
        pts = pw.copy()
        ci = np.where(has_cand)[0]
        if len(ci):
            if staged is not None:
                # fused path: per-feature results were computed in the
                # associate_and_check_kernel dispatch (selection-independent
                # — association depends only on the feature itself)
                a_all, p_all = staged
                assoc[ci] = a_all[kept[ci]]
                pts[ci] = p_all[kept[ci]]
            else:
                a, p_new = self.check_map_association_batch(
                    world, kf, kept[ci], pw[ci]
                )
                assoc[ci] = a
                pts[ci] = p_new

        ok = ~(has_cand & (assoc < 0))   # gated out (gmmloc_opt.cpp:79-81)
        sel = np.where(ok)[0]
        if len(sel) == 0:
            return 0
        pids = np.array(
            [
                world.alloc_point(
                    pts[j], ref_kf=kf, created_kf_idx=world.kf_frame_idx[kf]
                )
                for j in sel
            ],
            np.int64,
        )
        a = assoc[sel]
        world.pt_assoc_comp[pids[a >= 0]] = a[a >= 0]
        world.pt_type[pids] = np.where(
            a >= 0, ms.PT_FROM_DEPTH_GMM, ms.PT_FROM_DEPTH
        ).astype(world.pt_type.dtype)
        world.add_observations_batch(pids, kf, kept[sel])
        world.compute_distinctive_descriptor_batch(pids)
        world.update_normal_and_depth_batch(pids)
        frame.mappoint[kept[sel]] = pids
        return len(pids)
