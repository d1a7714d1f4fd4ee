"""Back-end: keyframe processing, culling, triangulation, fusion, local BA.

JAX replacement for Localization (ref:
/root/reference/gmmloc/src/modules/localization.cpp, localization_opt.cpp).
Offline-synchronous pipeline (spinOnce, localization.cpp:65-122):

  processNewKeyFrame -> removeMapPoints -> createMapPoints ->
  searchInNeighbors -> jointOptimization -> removeKeyFrames

The heavy stages — triangulation search/solve and the staged local BA —
run as jitted batched kernels; map surgery stays on the host registry.
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from ..config import SystemConfig
from ..features import matching
from ..geometry import camera as cam_mod
from ..solver import local_ba, point_solver
from ..utils.fetch import fetch
from ..utils.timing import Timer
from . import map_state as ms
from .association import GMMAssociator


class Localization:
    def __init__(
        self,
        cfg: SystemConfig,
        cam: cam_mod.CameraParams,
        world: ms.MapState,
        associator: GMMAssociator,
    ):
        self.cfg = cfg
        self.cam = cam
        self.world = world
        self.assoc = associator
        self.queue: List[int] = []
        self.candidate_points: List[int] = []
        # per-BA-solve shape/occupancy stats (host-side, for perf tuning)
        self.ba_stats: List[dict] = []
        # per-KF fused-triangulation match counts (budget sizing record)
        self.tri_stats: List[int] = []
        self.curr_kf: int = -1
        self.is_idle = True
        self.abort_ba = False
        K = np.array(
            [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]]
        )
        self._K = K
        self.dev_world = None
        if cfg.loc.use_device_world:
            from .device_world import DeviceWorld

            self.dev_world = DeviceWorld(world)

    # ------------------------------------------------------------------

    def insert_keyframe(self, kf: int) -> None:
        self.queue.append(kf)
        self.abort_ba = True

    def count_queue(self) -> int:
        return len(self.queue)

    def spin_once(self) -> None:
        """Ref: spinOnce (localization.cpp:65-122)."""
        if not self.queue:
            return
        self.is_idle = False
        with Timer("loc"):
            with Timer("loc/miscs"):
                with Timer("loc/proc_kf"):
                    self.process_new_keyframe()
                with Timer("loc/cull_pts"):
                    self.remove_map_points()
                with Timer("loc/triangulate"):
                    self.create_map_points()
                if not self.queue:
                    with Timer("loc/fuse"):
                        self.search_in_neighbors()
            self.abort_ba = False
            if not self.queue:
                if self.world.n_keyframes() > 2:
                    with Timer("loc/ba"):
                        self.joint_optimization()
                with Timer("loc/cull_kfs"):
                    self.remove_keyframes()
        self.is_idle = True

    # ------------------------------------------------------------------

    def process_new_keyframe(self) -> None:
        """Bind observations, update covisibility (localization.cpp:412-447)."""
        w = self.world
        kf = self.queue.pop(0)
        self.curr_kf = kf
        obs = w.kf_obs_point[kf]
        idx = np.where(obs >= 0)[0]
        p = obs[idx]
        bad = ~w.pt_valid[p]
        w.kf_obs_point[kf, idx[bad]] = -1
        idx, p = idx[~bad], p[~bad]
        already = (w.pt_obs_kf[p] == kf).any(axis=1)
        # duplicate bindings of one point within this KF: first wins (the
        # reference loop routes later ones to candidate_points)
        _, first = np.unique(p, return_index=True)
        dup = np.ones(len(p), bool)
        dup[first] = False
        self.candidate_points.extend(p[already | dup].tolist())
        keep = ~already & ~dup
        new_pts, new_idx = p[keep], idx[keep]
        # clear the to-be-bound slots so add_observations_batch's identity
        # check doesn't skip them (they were pre-staged by process_keyframe)
        w.kf_obs_point[kf, new_idx] = -1
        w.add_observations_batch(new_pts, kf, new_idx)
        w.compute_distinctive_descriptor_batch(new_pts)
        w.update_normal_and_depth_batch(new_pts)
        w.update_connections(kf)

    def remove_map_points(self) -> None:
        """Cull recent map points (localization.cpp:127-150)."""
        w = self.world
        curr_idx = w.kf_frame_idx[self.curr_kf]
        cand = np.array(sorted(set(self.candidate_points)), np.int64)
        if len(cand) == 0:
            return
        cand = cand[w.pt_valid[cand]]
        found_ratio = w.pt_num_found[cand] / np.maximum(1, w.pt_num_visible[cand])
        age = curr_idx - w.pt_created_kf_idx[cand]
        cull = (found_ratio < self.cfg.loc.cull_found_ratio) | (
            (age >= 2) & (w.pt_n_obs[cand] <= self.cfg.loc.cull_min_obs)
        )
        for p in cand[cull]:
            w.remove_point(p)
        keep = ~cull & (age < 3)  # mature (age>=3) points stop being monitored
        self.candidate_points = cand[keep].tolist()

    # ------------------------------------------------------------------

    def _fundamental_np(self, q1, t1, q2, t2) -> np.ndarray:
        """Host F with l2 = F^T p1 (ref: math_utils.cpp:17-44). 3x3 math —
        not worth a device round trip."""
        q12, t12 = ms._compose(q1, t1, *ms._inverse(q2, t2))
        R12 = ms._quat_to_mat(q12)
        tx = np.array(
            [
                [0, -t12[2], t12[1]],
                [t12[2], 0, -t12[0]],
                [-t12[1], t12[0], 0],
            ]
        )
        Kinv = np.linalg.inv(self._K)
        return Kinv.T @ (tx @ R12) @ Kinv

    def create_map_points(self) -> int:
        """Triangulate new points with covisible KFs
        (localization_opt.cpp:206-455).

        The reference's per-neighbor loop (10 sequential searches + solves)
        is batched: ONE vmapped epipolar search over all neighbor pairs and
        ONE batched triangulation solve over all candidate matches, with
        first-wins-by-covisibility-order selection replacing the sequential
        free-feature update between pairs."""
        w = self.world
        cfg = self.cfg
        kf1 = self.curr_kf
        neigh = w.best_covisible(kf1, 10)
        sigma2 = w.pyr["sigma2"]
        ratio_factor = 1.5 * cfg.frame.scale_factor

        q1, t1 = w.kf_q[kf1], w.kf_t[kf1]
        q1_wc, t1_wc = ms._inverse(q1, t1)
        baseline_min = self.cam.bf / self.cam.fx

        kf2s, fmats, eps = [], [], []
        for kf2 in neigh:
            R2 = ms._quat_to_mat(w.kf_q[kf2])
            t2 = w.kf_t[kf2]
            t2_wc = -R2.T @ t2
            if np.linalg.norm(t2_wc - t1_wc) < baseline_min:
                continue  # too-short baseline (:259-262)
            fmats.append(self._fundamental_np(q1, t1, w.kf_q[kf2], t2))
            # epipole of KF1 center in KF2 (:156-161)
            C2 = R2 @ t1_wc + t2
            eps.append(
                [
                    self.cam.fx * C2[0] / C2[2] + self.cam.cx,
                    self.cam.fy * C2[1] / C2[2] + self.cam.cy,
                ]
            )
            kf2s.append(int(kf2))
        if not kf2s:
            return 0
        T = len(kf2s)
        TP = 10  # fixed batch tier: one compiled program for all KF counts
        kf2_pad = kf2s + [kf2s[0]] * (TP - T)
        fmat_pad = np.stack(fmats + [fmats[0]] * (TP - T)).astype(np.float32)
        ep_pad = np.array(eps + [eps[0]] * (TP - T), np.float32)
        free1 = w.kf_feat_valid[kf1] & (w.kf_obs_point[kf1] < 0)
        free2 = w.kf_feat_valid[kf2_pad] & (w.kf_obs_point[kf2_pad] < 0)
        free2[T:] = False  # padded rows match nothing

        if self.dev_world is not None and self.cfg.loc.fused_tri:
            with Timer("loc/tri_sync"):
                self.dev_world.sync()
            return self._triangulate_fused(
                kf1, kf2s, kf2_pad, fmat_pad, ep_pad, free1, free2,
                ratio_factor,
            )
        if self.dev_world is not None:
            with Timer("loc/tri_sync"):
                self.dev_world.sync()
        with Timer("loc/tri_search"):
            if self.dev_world is not None:
                dv = self.dev_world
                match = fetch(
                    matching.search_for_triangulation_gather(
                        jnp.int32(kf1),
                        jnp.array(kf2_pad, jnp.int32),
                        jnp.array(free1),
                        jnp.array(free2),
                        jnp.array(fmat_pad),
                        jnp.array(ep_pad),
                        jnp.array(sigma2, jnp.float32),
                        dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
                        dv.kf_feat_octave, dv.kf_feat_angle,
                    )
                )[:T]                                     # (T, F)
            else:
                match = fetch(
                    matching.search_for_triangulation_batch(
                        jnp.array(w.kf_feat_uv[kf1], jnp.float32),
                        jnp.array(w.kf_feat_ur[kf1], jnp.float32),
                        jnp.array(w.kf_feat_desc[kf1]),
                        jnp.array(w.kf_feat_octave[kf1]),
                        jnp.array(w.kf_feat_angle[kf1]),
                        jnp.array(free1),
                        jnp.array(w.kf_feat_uv[kf2_pad], jnp.float32),
                        jnp.array(w.kf_feat_ur[kf2_pad], jnp.float32),
                        jnp.array(w.kf_feat_desc[kf2_pad]),
                        jnp.array(w.kf_feat_octave[kf2_pad]),
                        jnp.array(w.kf_feat_angle[kf2_pad]),
                        jnp.array(free2),
                        jnp.array(fmat_pad),
                        jnp.array(ep_pad),
                        jnp.array(sigma2, jnp.float32),
                    )
                )[:T]                                     # (T, F)

        # flatten candidates across pairs, keeping covisibility order
        pair_t, idx1 = np.nonzero(match >= 0)
        if len(idx1) == 0:
            return 0
        idx2 = match[pair_t, idx1]
        kf2_of = np.array(kf2s)[pair_t]
        return self._triangulate_matches(
            kf1, kf2_of, idx1, idx2, ratio_factor, pair_order=pair_t
        )

    def _triangulate_fused(
        self, kf1, kf2s, kf2_pad, fmat_pad, ep_pad, free1, free2,
        ratio_factor,
    ) -> int:
        """Fused single-dispatch triangulation (mapping/tri_kernel.py):
        search + init + candidate solve + gates + first-wins selection in
        ONE device program; the host fetches packed per-match records and
        does only the map surgery for the winners."""
        w = self.world
        cfg = self.cfg
        dv = self.dev_world
        from .tri_kernel import triangulate_kernel

        T = len(kf2s)
        TP = len(kf2_pad)
        job_ok = np.zeros(TP, bool)
        job_ok[:T] = True
        with Timer("loc/tri_solve"):
            (win, idx1, idx2, pair_t, pts, hstr, str_comp, from_mono,
             n_m) = fetch(
                triangulate_kernel(
                    self.cam,
                    jnp.int32(kf1),
                    jnp.array(kf2_pad, jnp.int32),
                    jnp.array(job_ok),
                    jnp.array(free1),
                    jnp.array(free2),
                    jnp.array(fmat_pad),
                    jnp.array(ep_pad),
                    jnp.array(w.pyr["sigma2"], jnp.float32),
                    jnp.array(w.pyr["sigma2_inv"], jnp.float32),
                    jnp.array(w.pyr["scale_factors"], jnp.float32),
                    dv.kf_q, dv.kf_t,
                    dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
                    dv.kf_feat_octave, dv.kf_feat_angle, dv.kf_feat_depth,
                    dv.kf_comp_cand,
                    self.assoc.gmap.means, self.assoc.gmap.normal,
                    self.assoc.gmap.is_degenerated,
                    m_tri=cfg.caps.tri_match_budget,
                    tri_lambda2=cfg.loc.tri_lambda2,
                    tri_opt_iters=cfg.loc.tri_opt_iters,
                    tri_check_str_chi2=cfg.loc.tri_check_str_chi2,
                    tri_str_thresh=cfg.loc.tri_str_thresh,
                    ratio_factor=ratio_factor,
                )
            )
        self.tri_stats.append(int(n_m))
        if n_m > cfg.caps.tri_match_budget:
            # no silent truncation: the budget dropped candidate matches
            print(
                f"[tri] match budget bound at kf{kf1}: {n_m} matches > "
                f"budget {cfg.caps.tri_match_budget}",
                flush=True,
            )
        wi = np.where(win)[0]
        if len(wi) == 0:
            return 0
        kf2_of = np.array(kf2s)[pair_t[wi]]
        pids = np.array(
            [
                w.alloc_point(
                    pts[j], ref_kf=kf1, created_kf_idx=w.kf_frame_idx[kf1]
                )
                for j in wi
            ],
            np.int64,
        )
        mono = from_mono[wi]
        hs = hstr[wi]
        w.pt_type[pids] = np.where(
            mono,
            np.where(hs, ms.PT_FROM_TRI_MONO_GMM, ms.PT_FROM_TRI_MONO),
            np.where(hs, ms.PT_FROM_TRI_STEREO_GMM, ms.PT_FROM_TRI_STEREO),
        ).astype(w.pt_type.dtype)
        w.pt_assoc_comp[pids[hs]] = str_comp[wi][hs]
        w.add_observations_batch(pids, kf1, idx1[wi])
        for k2 in np.unique(kf2_of):
            g = kf2_of == k2
            w.add_observations_batch(pids[g], int(k2), idx2[wi][g])
        w.compute_distinctive_descriptor_batch(pids)
        w.update_normal_and_depth_batch(pids)
        self.candidate_points.extend(pids.tolist())
        return len(pids)

    def _triangulate_matches(
        self, kf1, kf2_of, idx1, idx2, ratio_factor, pair_order=None
    ) -> int:
        """Init (DLT / stereo unproject) + batched GMM-constrained solve +
        acceptance gates (localization_opt.cpp:283-445), vectorized over
        matches from ALL neighbor pairs at once (`kf2_of` is per-match).
        `pair_order` (covisibility rank of each match's pair) drives the
        first-wins selection replacing the reference's sequential
        feature-occupancy update between pairs."""
        w = self.world
        cfg = self.cfg
        cam = self.cam
        kf2_of = np.asarray(kf2_of)
        M = len(idx1)
        sigma2 = w.pyr["sigma2"]
        sigma2_inv = w.pyr["sigma2_inv"]
        sf = w.pyr["scale_factors"]

        q1, t1 = w.kf_q[kf1], w.kf_t[kf1]
        q2, t2 = w.kf_q[kf2_of], w.kf_t[kf2_of]          # (M,4), (M,3)
        R1 = ms._quat_to_mat(q1)
        R2 = ms._quat_to_mat_batch(q2)                    # (M,3,3)
        T1 = np.eye(4)
        T1[:3, :3], T1[:3, 3] = R1, t1
        T2 = np.tile(np.eye(4), (M, 1, 1))
        T2[:, :3, :3], T2[:, :3, 3] = R2, t2
        t1_wc = -R1.T @ t1
        t2_wc = -np.einsum("mji,mj->mi", R2, t2)          # (M,3)

        uv1 = w.kf_feat_uv[kf1][idx1]
        uv2 = w.kf_feat_uv[kf2_of, idx2]
        ur1 = w.kf_feat_ur[kf1][idx1]
        ur2 = w.kf_feat_ur[kf2_of, idx2]
        z1 = w.kf_feat_depth[kf1][idx1]
        z2 = w.kf_feat_depth[kf2_of, idx2]
        oct1 = w.kf_feat_octave[kf1][idx1]
        oct2 = w.kf_feat_octave[kf2_of, idx2]
        st1 = ur1 >= 0
        st2 = ur2 >= 0

        xn1 = np.stack(
            [(uv1[:, 0] - cam.cx) / cam.fx, (uv1[:, 1] - cam.cy) / cam.fy, np.ones(M)], -1
        )
        xn2 = np.stack(
            [(uv2[:, 0] - cam.cx) / cam.fx, (uv2[:, 1] - cam.cy) / cam.fy, np.ones(M)], -1
        )
        ray1 = xn1 @ R1  # (M,3) rows xn1 R1 -> components (R1^T xn1)^T
        ray2 = np.einsum("mi,mij->mj", xn2, R2)
        cos_rays = np.einsum("mi,mi->m", ray1, ray2) / (
            np.linalg.norm(ray1, axis=1) * np.linalg.norm(ray2, axis=1)
        )
        b = cam.bf / cam.fx
        cos_st1 = np.where(st1, np.cos(2 * np.arctan2(b / 2, np.maximum(z1, 1e-6))), cos_rays + 1)
        cos_st2 = np.where(st2, np.cos(2 * np.arctan2(b / 2, np.maximum(z2, 1e-6))), cos_rays + 1)
        cos_stereo = np.minimum(cos_st1, cos_st2)

        use_dlt = (cos_rays < cos_stereo) & (cos_rays > 0) & (
            st1 | st2 | (cos_rays < 0.9998)
        )
        use_s1 = ~use_dlt & st1 & (cos_st1 < cos_st2)
        use_s2 = ~use_dlt & st2 & (cos_st2 <= cos_st1) & ~use_s1
        usable = use_dlt | use_s1 | use_s2
        from_mono = use_dlt

        pts0 = np.zeros((M, 3))
        # DLT (SVD on 4x4, :320-341) — batched over all DLT rows at once
        di = np.where(use_dlt)[0]
        if len(di):
            A = np.stack(
                [
                    xn1[di, 0, None] * T1[2] - T1[0],
                    xn1[di, 1, None] * T1[2] - T1[1],
                    xn2[di, 0, None] * T2[di, 2] - T2[di, 0],
                    xn2[di, 1, None] * T2[di, 2] - T2[di, 1],
                ],
                axis=1,
            )                                           # (n, 4, 4)
            _, _, Vt = np.linalg.svd(A)
            v = Vt[:, 3]                                # (n, 4)
            bad = np.abs(v[:, 3]) < 1e-12
            usable[di[bad]] = False
            vs = np.where(bad[:, None], 1.0, v[:, 3:4])
            pts0[di] = v[:, :3] / vs
        s1i = np.where(use_s1)[0]
        if len(s1i):
            pts0[s1i] = (xn1[s1i] * z1[s1i, None] - t1) @ R1
        s2i_ = np.where(use_s2)[0]
        if len(s2i_):
            pts0[s2i_] = np.einsum(
                "mi,mij->mj", xn2[s2i_] * z2[s2i_, None] - t2[s2i_], R2[s2i_]
            )

        mi = np.where(usable)[0]
        if len(mi) == 0:
            return 0

        # candidate degenerate components: union of both features' candidates
        cand1 = w.kf_comp_cand[kf1][idx1]          # (M, K)
        cand2 = w.kf_comp_cand[kf2_of, idx2]
        cands = np.concatenate([cand1, cand2], axis=1)  # (M, 2K)
        deg = self.assoc._deg
        cands = np.where((cands >= 0) & deg[np.maximum(cands, 0)], cands, -1)

        obs1 = np.concatenate([uv1, ur1[:, None]], -1)
        obs2 = np.concatenate([uv2, ur2[:, None]], -1)
        s2i1 = sigma2_inv[oct1]
        # NOTE: reference uses sigma2_inv1 for both edges (:130-137)
        s2i2 = s2i1

        CK = cands.shape[1]
        flat_c = cands[mi].reshape(-1)
        n_flat = len(flat_c)
        from .association import bucket_size

        B = bucket_size(n_flat)

        def padb(a, fill=0.0):
            a = np.asarray(a)
            out = np.full((B,) + a.shape[1:], fill, a.dtype)
            out[:n_flat] = a
            return out

        safe_c = np.maximum(padb(flat_c, 0), 0)
        rep = lambda a: np.repeat(a[mi], CK, axis=0)
        with Timer("loc/tri_upload"):
            tri_args = (
                jnp.array(padb(rep(pts0)), jnp.float32),
                jnp.tile(jnp.array(q1, jnp.float32), (B, 1)),
                jnp.tile(jnp.array(t1, jnp.float32), (B, 1)),
                jnp.array(padb(rep(obs1)), jnp.float32),
                jnp.array(padb(rep(st1), False)),
                jnp.array(padb(rep(s2i1), 1.0), jnp.float32),
                jnp.array(padb(rep(q2)), jnp.float32),
                jnp.array(padb(rep(t2)), jnp.float32),
                jnp.array(padb(rep(obs2)), jnp.float32),
                jnp.array(padb(rep(st2), False)),
                jnp.array(padb(rep(s2i2), 1.0), jnp.float32),
                jnp.array(self.assoc._normal[safe_c], jnp.float32),
                jnp.array(self.assoc._means[safe_c], jnp.float32),
            )
        with Timer("loc/tri_solve"):
            x_opt, c1o, c2o, cso = fetch(
                point_solver.optimize_triangulation(
                    self.cam,
                    *tri_args,
                    tri_lambda2=cfg.loc.tri_lambda2,
                    iters=cfg.loc.tri_opt_iters,
                )
            )
        x_opt = x_opt[:n_flat].reshape(len(mi), CK, 3)
        c1o = c1o[:n_flat].reshape(len(mi), CK)
        c2o = c2o[:n_flat].reshape(len(mi), CK)
        cso = cso[:n_flat].reshape(len(mi), CK)

        th1 = np.where(st1[mi], 7.8, 5.991)[:, None]
        th2 = np.where(st2[mi], 7.8, 5.991)[:, None]
        ok = (flat_c.reshape(len(mi), CK) >= 0) & (c1o <= th1) & (c2o <= th2)
        if cfg.loc.tri_check_str_chi2:
            ok &= cso <= cfg.loc.tri_str_thresh * cfg.loc.tri_lambda2
        err_sum = np.where(ok, c1o + c2o, np.inf)
        best = np.argmin(err_sum, axis=1)
        has_str = np.isfinite(err_sum[np.arange(len(mi)), best])
        str_comp = np.where(
            has_str, cands[mi][np.arange(len(mi)), best], -1
        )
        pts = np.where(has_str[:, None], x_opt[np.arange(len(mi)), best], pts0[mi])

        # acceptance gates (:358-412): reprojection into both KFs + scale —
        # vectorized over all usable matches; only the map surgery for the
        # survivors stays a loop
        def reproj_ok(pc, uvk, urk, stk):
            z = pc[:, 2]
            zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
            u = cam.fx * pc[:, 0] / zs + cam.cx
            v = cam.fy * pc[:, 1] / zs + cam.cy
            err = (u - uvk[:, 0]) ** 2 + (v - uvk[:, 1]) ** 2
            errs = err + (u - cam.bf / zs - urk) ** 2
            e = np.where(stk, errs, err)
            th = np.where(stk, 7.8, 5.991)
            # NOTE: the reference scales both gates by sigma2[kp1.octave]
            # (:371,:382 use kp1's octave even for kp2 — mirrored here)
            return (z > 0) & (e <= th * sigma2[oct1[mi]])

        ok_pt = reproj_ok(pts @ R1.T + t1, uv1[mi], ur1[mi], st1[mi])
        pc2 = np.einsum("mij,mj->mi", R2[mi], pts) + t2[mi]
        ok_pt &= reproj_ok(pc2, uv2[mi], ur2[mi], st2[mi])
        d1 = np.linalg.norm(pts - t1_wc, axis=1)
        d2 = np.linalg.norm(pts - t2_wc[mi], axis=1)
        ok_pt &= (d1 >= 1e-9) & (d2 >= 1e-9)
        ratio_dist = d2 / np.maximum(d1, 1e-9)
        ratio_oct = sf[oct1[mi]] / sf[oct2[mi]]
        ok_pt &= (ratio_dist * ratio_factor >= ratio_oct) & (
            ratio_dist <= ratio_oct * ratio_factor
        )

        # first-wins per kf1 feature across pairs (covisibility order):
        # mirrors the reference's sequential feature-occupancy update —
        # a feature failing the gates in one pair stays available to later
        # pairs, exactly as its reference free1 recomputation behaves.
        win = np.where(ok_pt)[0]                     # mi-indices of survivors
        if len(win) == 0:
            return 0
        # `mi` (and thus win) is already sorted in pair-major order
        _, first = np.unique(idx1[mi[win]], return_index=True)
        win = win[np.sort(first)]

        # batched creation (alloc loop + vectorized binding/attrs)
        m_sel = mi[win]
        pids = np.array(
            [
                w.alloc_point(
                    pts[j], ref_kf=kf1, created_kf_idx=w.kf_frame_idx[kf1]
                )
                for j in win
            ],
            np.int64,
        )
        mono = from_mono[m_sel]
        hstr = has_str[win]
        w.pt_type[pids] = np.where(
            mono,
            np.where(hstr, ms.PT_FROM_TRI_MONO_GMM, ms.PT_FROM_TRI_MONO),
            np.where(hstr, ms.PT_FROM_TRI_STEREO_GMM, ms.PT_FROM_TRI_STEREO),
        ).astype(w.pt_type.dtype)
        w.pt_assoc_comp[pids[hstr]] = str_comp[win][hstr]
        w.add_observations_batch(pids, kf1, idx1[m_sel])
        for k2 in np.unique(kf2_of[m_sel]):
            g = kf2_of[m_sel] == k2
            w.add_observations_batch(pids[g], int(k2), idx2[m_sel][g])
        w.compute_distinctive_descriptor_batch(pids)
        w.update_normal_and_depth_batch(pids)
        self.candidate_points.extend(pids.tolist())
        return len(pids)

    # ------------------------------------------------------------------

    def search_in_neighbors(self) -> None:
        """Fuse duplicated landmarks with 1st+2nd ring covisible KFs
        (localization.cpp:154-223)."""
        w = self.world
        kf = self.curr_kf
        tgt = []
        seen = set()
        for kf1 in w.best_covisible(kf, 10):
            if kf1 in seen or not w.kf_valid[kf1]:
                continue
            seen.add(kf1)
            tgt.append(kf1)
            for kf2 in w.best_covisible(kf1, 5):
                if kf2 in seen or kf2 == kf or not w.kf_valid[kf2]:
                    continue
                seen.add(kf2)
                tgt.append(kf2)

        obs = w.kf_obs_point[kf]
        curr_pts = np.unique(obs[obs >= 0])

        # candidates for the reverse direction, de-duplicated by stamp
        all_tgt_pts = w.kf_obs_point[tgt].ravel() if tgt else np.zeros(0, np.int32)
        all_tgt_pts = np.unique(all_tgt_pts[all_tgt_pts >= 0])
        stamp = w.kf_frame_idx[kf]
        fc = all_tgt_pts[
            w.pt_valid[all_tgt_pts] & (w.pt_fuse_tgt_kf[all_tgt_pts] != stamp)
        ]
        w.pt_fuse_tgt_kf[fc] = stamp

        if self.dev_world is not None:
            # device path: forward jobs (current KF's landmarks against
            # each target) AND the reverse job (2nd-ring landmarks
            # against the current KF) in ONE dispatch — per-job query
            # rows, oversized sets chunked to the row bucket
            # (fuse_project_match_gather r5).
            jobs = [(int(k), curr_pts) for k in tgt]
            if len(fc):
                jobs.append((kf, fc))
            self._fuse_device_jobs(jobs)
        else:
            # ONE vmapped fuse-match dispatch for all (target, query) jobs
            jobs = [(int(k), curr_pts) for k in tgt]
            if len(fc):
                jobs.append((kf, fc))
            self._fuse_jobs(jobs)

        o = w.kf_obs_point[kf]
        upd = np.unique(o[o >= 0])
        w.compute_distinctive_descriptor_batch(upd)
        w.update_normal_and_depth_batch(upd)
        w.update_connections(kf)

    def _fuse_prepare(self, kf: int, pids: np.ndarray, th: float = 3.0):
        """Host-side gating for fuseObservations (localization.cpp:226-325):
        project, scale/view-cos gates, predicted level. Returns the query
        arrays for the device matcher or None."""
        w = self.world
        cam = self.cam
        pids = pids[w.pt_valid[pids]]
        if len(pids) == 0:
            return None
        # skip points already observed by kf (vectorized)
        pids = pids[~(w.pt_obs_kf[pids] == kf).any(axis=1)]
        if len(pids) == 0:
            return None

        R = ms._quat_to_mat(w.kf_q[kf])
        t = w.kf_t[kf]
        t_wc = -R.T @ t
        pos = w.pt_pos[pids]
        pc = pos @ R.T + t
        z = pc[:, 2]
        zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        ur = u - cam.bf / zs
        inside = (z > 0) & (u >= 0) & (v >= 0) & (u < cam.width) & (v < cam.height)

        vdir = pos - t_wc
        dist = np.linalg.norm(vdir, axis=-1)
        ok = inside & (dist >= 0.8 * w.pt_min_dist[pids]) & (
            dist <= 1.2 * w.pt_max_dist[pids]
        ) & (dist > 1e-9)
        vc = np.einsum("ni,ni->n", vdir, w.pt_normal[pids]) / np.clip(dist, 1e-9, None)
        ok &= vc >= 0.5
        lvl = np.ceil(
            np.log(np.clip(w.pt_max_dist[pids] / np.clip(dist, 1e-9, None), 1e-9, None))
            / w.pyr["log_scale_factor"]
        ).astype(np.int32)
        lvl = np.clip(lvl, 0, self.cfg.frame.num_levels - 1)

        pids, u, v, ur, lvl = pids[ok], u[ok], v[ok], ur[ok], lvl[ok]
        if len(pids) == 0:
            return None
        sf = w.pyr["scale_factors"]
        return (pids, np.stack([u, v], -1), ur, lvl, th * sf[lvl])

    def _fuse_jobs(self, jobs) -> int:
        """Batched fuseObservations over many (target KF, query set) jobs:
        one vmapped device dispatch + one fetch replaces the per-target
        loop's T round trips."""
        w = self.world
        from .association import bucket_size

        prepped = []
        for k, pids in jobs:
            pr = self._fuse_prepare(k, pids)
            if pr is not None:
                prepped.append((k,) + pr)
        if not prepped:
            return 0
        T = len(prepped)
        TP = 1 << max(0, (T - 1).bit_length())          # tier T to pow2
        B = bucket_size(max(len(p[1]) for p in prepped))

        def pad(a, fill, dtype):
            a = np.asarray(a)
            out = np.full((B,) + a.shape[1:], fill, dtype)
            out[: len(a)] = a
            return out

        kfs = [p[0] for p in prepped] + [prepped[0][0]] * (TP - T)
        q_uv = np.stack(
            [pad(p[2], 0.0, np.float32) for p in prepped]
            + [np.zeros((B, 2), np.float32)] * (TP - T)
        )
        q_ur = np.stack(
            [pad(p[3], -1.0, np.float32) for p in prepped]
            + [np.full(B, -1.0, np.float32)] * (TP - T)
        )
        q_desc = np.stack(
            [pad(w.pt_desc[p[1]], 0, np.uint8) for p in prepped]
            + [np.zeros((B, 32), np.uint8)] * (TP - T)
        )
        q_lvl = np.stack(
            [pad(p[4], 0, np.int32) for p in prepped]
            + [np.zeros(B, np.int32)] * (TP - T)
        )
        q_rad = np.stack(
            [pad(p[5], 1.0, np.float32) for p in prepped]
            + [np.ones(B, np.float32)] * (TP - T)
        )
        q_ok = np.stack(
            [pad(np.ones(len(p[1]), bool), False, bool) for p in prepped]
            + [np.zeros(B, bool)] * (TP - T)
        )

        with Timer("loc/fuse_upload"):
            dev_args = (
                jnp.array(q_uv), jnp.array(q_ur), jnp.array(q_desc),
                jnp.array(q_lvl), jnp.array(q_rad), jnp.array(q_ok),
                jnp.array(w.kf_feat_uv[kfs], jnp.float32),
                jnp.array(w.kf_feat_ur[kfs], jnp.float32),
                jnp.array(w.kf_feat_desc[kfs]),
                jnp.array(w.kf_feat_octave[kfs]),
                jnp.array(w.kf_feat_valid[kfs]),
                jnp.array(w.pyr["sigma2_inv"], jnp.float32),
            )
        with Timer("loc/fuse_dispatch"):
            res = matching.fuse_match_batch(*dev_args)
        with Timer("loc/fuse_fetch"):
            match = fetch(res)

        num_fused = 0
        for ti, (k, pids, *_rest) in enumerate(prepped):
            m = match[ti][: len(pids)]
            for j in np.where(m >= 0)[0]:
                p = pids[j]
                if not w.pt_valid[p]:
                    continue
                ft = int(m[j])
                existing = w.kf_obs_point[k, ft]
                if existing >= 0 and w.pt_valid[existing]:
                    if w.pt_n_obs[existing] > w.pt_n_obs[p]:
                        w.replace_point(p, existing)
                    else:
                        w.replace_point(existing, p)
                else:
                    w.add_observation(p, k, ft)
                num_fused += 1
        return num_fused

    def _fuse(self, kf: int, pids: np.ndarray, th: float = 3.0) -> int:
        """Single-target fuseObservations (kept for tests/callers)."""
        if self.dev_world is not None:
            return self._fuse_device([kf], pids, th=th)
        return self._fuse_jobs([(kf, pids)])

    def _fuse_device(self, kfs, pids: np.ndarray, th: float = 3.0) -> int:
        """fuseObservations against many targets sharing one query set
        (kept for tests/callers; delegates to the jobs form)."""
        return self._fuse_device_jobs([(int(k), pids) for k in kfs], th=th)

    def _fuse_device_jobs(self, jobs, th: float = 3.0) -> int:
        """fuseObservations over many (target KF, query set) jobs in ONE
        dispatch with the world resident on device: projection/gating/
        matching gather from the mirror; the host uploads only the query
        ids, target ids and the per-row already-observed mask. Oversized
        query sets are chunked into extra rows of the same bucket (one
        program instead of per-direction dispatches). Surgery semantics
        identical to _fuse_jobs."""
        w = self.world
        from .association import bucket_size

        CHUNK = 2048
        rows = []  # (kf, pids_chunk)
        for k, pids in jobs:
            pids = np.asarray(pids, np.int64)
            pids = pids[w.pt_valid[pids]]
            for i in range(0, len(pids), CHUNK):
                rows.append((int(k), pids[i : i + CHUNK]))
        if not rows:
            return 0
        dv = self.dev_world
        with Timer("loc/fuse_sync"):
            dv.sync()
        T = len(rows)
        TP = 1 << max(0, (T - 1).bit_length())
        B = bucket_size(max(len(p) for _, p in rows))
        with Timer("loc/fuse_prep"):
            kf_arr = np.array(
                [k for k, _ in rows] + [rows[0][0]] * (TP - T), np.int32
            )
            job_ok = np.zeros(TP, bool)
            job_ok[:T] = True
            pid_pad = np.zeros((TP, B), np.int32)
            q_ok = np.zeros((TP, B), bool)
            for ti, (_, p) in enumerate(rows):
                pid_pad[ti, : len(p)] = p
                q_ok[ti, : len(p)] = True
            # (TP,B): landmark already observed by the target (host registry)
            skip = (
                w.pt_obs_kf[pid_pad] == kf_arr[:, None, None]
            ).any(-1)

        with Timer("loc/fuse_dispatch"):
            res = matching.fuse_project_match_gather(
                self.cam,
                jnp.array(kf_arr), jnp.array(job_ok),
                jnp.array(pid_pad), jnp.array(q_ok), jnp.array(skip),
                dv.kf_q, dv.kf_t,
                dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
                dv.kf_feat_octave, dv.kf_feat_valid,
                dv.pt_pos, dv.pt_normal, dv.pt_min_dist, dv.pt_max_dist,
                dv.pt_desc, dv.pt_valid,
                jnp.array(w.pyr["sigma2_inv"], jnp.float32),
                jnp.array(w.pyr["scale_factors"], jnp.float32),
                jnp.float32(w.pyr["log_scale_factor"]),
                th=th,
            )
        with Timer("loc/fuse_fetch"):
            match = fetch(res)

        num_fused = 0
        for ti in range(T):
            k = int(kf_arr[ti])
            pids = rows[ti][1]
            m = match[ti][: len(pids)]
            js = np.where(m >= 0)[0]
            if len(js) == 0:
                continue
            # batch the non-interacting majority (free feature slot, no
            # duplicate feature claims): outcome identical to the
            # sequential loop, which cost ~50us/python-call x hundreds
            # of matches per target. Collisions (occupied slot -> the
            # add-or-replace merge; duplicate feature targets) keep the
            # sequential original-order semantics.
            p = pids[js]
            ft = np.asarray(m[js], np.int64)
            valid = w.pt_valid[p]
            existing = w.kf_obs_point[k, ft]
            uft, cnt = np.unique(ft, return_counts=True)
            is_dup = np.isin(ft, uft[cnt > 1])
            easy = valid & (existing < 0) & ~is_dup
            if easy.any():
                w.add_observations_batch(p[easy], k, ft[easy])
                num_fused += int(easy.sum())
            for j in js[~easy]:
                pj = pids[j]
                if not w.pt_valid[pj]:
                    continue
                fj = int(m[j])
                ex = w.kf_obs_point[k, fj]
                if ex >= 0 and w.pt_valid[ex]:
                    if w.pt_n_obs[ex] > w.pt_n_obs[pj]:
                        w.replace_point(pj, ex)
                    else:
                        w.replace_point(ex, pj)
                else:
                    w.add_observation(pj, k, fj)
                num_fused += 1
        return num_fused

    # ------------------------------------------------------------------

    def joint_optimization(self) -> None:
        """Gather the local window, run the staged Schur BA, write back
        (localization_opt.cpp:456-925)."""
        w = self.world
        cfg = self.cfg
        caps = cfg.caps
        kf0 = self.curr_kf

        local = [kf0] + [int(k) for k in w.best_covisible(kf0)]
        local_all = [k for k in local if w.kf_valid[k]]
        local = local_all[: caps.local_ba_kfs]
        local_set = set(local)

        pts = set()
        for k in local:
            o = w.kf_obs_point[k]
            pts.update(o[o >= 0].tolist())
        pts_all = [p for p in pts if w.pt_valid[p]]
        pts = pts_all[: caps.local_ba_points]
        # cap-bind accounting (VERDICT r3 weak #7): a bound cap silently
        # drops constraints — confess it in ba_stats + the run log
        dropped_local = len(local_all) - len(local)
        dropped_pts = len(pts_all) - len(pts)
        pt_slot = {p: i for i, p in enumerate(pts)}

        fixed = []
        fixed_set = set()
        for p in pts:
            kfs = w.pt_obs_kf[p]
            for k in kfs[kfs >= 0]:
                if k not in local_set and k not in fixed_set and w.kf_valid[k]:
                    fixed_set.add(int(k))
                    fixed.append(int(k))
        fixed = fixed[: caps.fixed_ba_kfs]
        fixed_set = set(fixed)

        # first map KF handling: prior if it's in the local set, else fixed.
        # The prior factor acts on camera SLOT 0, so the first KF must be
        # moved to the front of the local list when the prior is active.
        first_kf = w._kf_order[0] if w._kf_order else -1
        has_prior = cfg.loc.ba_first_as_prior and (first_kf in local_set)
        if has_prior:
            local.remove(first_kf)
            local.insert(0, first_kf)
        elif not cfg.loc.ba_first_as_prior and first_kf in local_set:
            local.remove(first_kf)
            fixed.insert(0, first_kf)
            fixed_set.add(first_kf)
            local_set.discard(first_kf)

        # GAUGE GUARD: a window with no fixed camera and no prior is
        # anchored only by the GMM plane factors, whose normals can be
        # near-parallel — the near-null gauge direction let whole windows
        # slide ~0.5m (observed r1). Hold the oldest local KF fixed then.
        if not fixed and not has_prior and len(local) > 1:
            oldest = min(local, key=lambda k: w.kf_frame_idx[k])
            local.remove(oldest)
            fixed.insert(0, oldest)
            fixed_set.add(oldest)
            local_set.discard(oldest)

        # tiered static shapes: small windows compile to small programs
        # (the padded worst-case BA costs ~4-8x more than early windows need)
        n_local = len(local)
        n_pts = len(pts)
        tiers = [(8, 16, 2048), (16, 32, 4096), (caps.local_ba_kfs, caps.fixed_ba_kfs, caps.local_ba_points)]
        for (tl, tf, tp) in tiers:
            if n_local <= tl and n_pts <= tp:
                L, F_CAP, P = tl, tf, tp
                break
        else:
            L, F_CAP, P = tiers[-1]
        C = L + F_CAP
        dropped_fixed = max(0, len(fixed) - F_CAP)
        fixed = fixed[:F_CAP]
        fixed_set = set(fixed)

        if cfg.loc.ba_device_assembly and self.dev_world is not None:
            return self._joint_opt_device(
                local, fixed, pts, has_prior, first_kf, L, F_CAP, P,
                (dropped_local, dropped_pts, dropped_fixed), kf0,
            )

        cam_q = np.tile(np.array([1.0, 0, 0, 0]), (C, 1))
        cam_t = np.zeros((C, 3))
        cam_valid = np.zeros(C, bool)
        slot_of = {}
        for i, k in enumerate(local):
            cam_q[i], cam_t[i] = w.kf_q[k], w.kf_t[k]
            cam_valid[i] = True
            slot_of[k] = i
        for i, k in enumerate(fixed):
            cam_q[L + i], cam_t[L + i] = w.kf_q[k], w.kf_t[k]
            cam_valid[L + i] = True
            slot_of[k] = L + i

        pts_np = np.array(pts, np.int64)
        n_act = len(pts)
        pts_arr = np.zeros((P, 3))
        pt_valid = np.zeros(P, bool)
        str_type = np.zeros(P, np.int32)
        str_normal = np.zeros((P, 3))
        str_normal[:, 2] = 1.0
        str_mean = np.zeros((P, 3))
        str_sqrt = np.tile(np.eye(3), (P, 1, 1))
        deg = self.assoc._deg
        pts_arr[:n_act] = w.pt_pos[pts_np]
        pt_valid[:n_act] = True
        comp = w.pt_assoc_comp[pts_np]
        has_c = comp >= 0
        cs = np.maximum(comp, 0)
        is_deg = has_c & deg[cs]
        is_nd = has_c & ~deg[cs]
        str_type[:n_act] = np.where(
            is_deg, local_ba.STR_DEG, np.where(is_nd, local_ba.STR_NONDEG, 0)
        )
        str_normal[:n_act][is_deg] = self.assoc._normal[cs[is_deg]]
        str_mean[:n_act][has_c] = self.assoc._means[cs[has_c]]
        str_sqrt[:n_act][is_nd] = self.assoc._sqrt_info[cs[is_nd]]

        # per-point observation tables (the solver is gather/one-hot based,
        # see solver/local_ba.py). The world already
        # keeps (MP, MO_world) observation tables, so assembly is pure
        # vectorized gathering: map KF ids -> window slots, compact the
        # surviving observations to the first MO columns per row.
        MO = caps.ba_obs_per_point
        obs_cam = np.full((P, MO), -1, np.int32)
        obs_uvr = np.zeros((P, MO, 3), np.float32)
        obs_st = np.zeros((P, MO), bool)
        obs_s2i = np.ones((P, MO), np.float32)
        obs_valid = np.zeros((P, MO), bool)
        obs_kfid = np.full((P, MO), -1, np.int32)  # for post-BA obs erasure
        sigma2_inv = w.pyr["sigma2_inv"]
        slot_lut = np.full(w.MK, -1, np.int32)
        for k, s in slot_of.items():
            slot_lut[k] = s
        okf = w.pt_obs_kf[pts_np]                       # (n_act, MO_world)
        oslot = np.where(okf >= 0, slot_lut[np.maximum(okf, 0)], -1)
        use = (okf >= 0) & (oslot >= 0)
        order = np.argsort(~use, axis=1, kind="stable")[:, :MO]
        use_c = np.take_along_axis(use, order, axis=1)
        okf_c = np.where(use_c, np.take_along_axis(okf, order, axis=1), 0)
        oft_c = np.where(
            use_c, np.take_along_axis(w.pt_obs_feat[pts_np], order, axis=1), 0
        )
        obs_cam[:n_act] = np.where(
            use_c, np.take_along_axis(oslot, order, axis=1), -1
        )
        uv = w.kf_feat_uv[okf_c, oft_c]                 # (n_act, MO, 2)
        urr = w.kf_feat_ur[okf_c, oft_c]
        obs_uvr[:n_act] = np.concatenate([uv, urr[..., None]], -1)
        obs_st[:n_act] = use_c & (urr >= 0)
        obs_s2i[:n_act] = np.where(
            use_c, sigma2_inv[w.kf_feat_octave[okf_c, oft_c]], 1.0
        )
        obs_valid[:n_act] = use_c
        obs_kfid[:n_act] = np.where(use_c, okf_c, -1)
        obs_per_cam = np.bincount(
            obs_cam[:n_act][use_c].astype(np.int64), minlength=C
        )
        n_obs_pt = use_c.sum(1)
        self.ba_stats.append({
            "L": L, "P": P, "MO": MO,
            "n_local": n_local, "n_fixed": len(fixed), "n_pts": n_act,
            "obs_mean": float(n_obs_pt.mean()) if n_act else 0.0,
            "obs_p95": float(np.percentile(n_obs_pt, 95)) if n_act else 0.0,
            "obs_max_hit": int((n_obs_pt >= MO).sum()),
            "n_obs": int(n_obs_pt.sum()),
            "dropped_local": dropped_local, "dropped_pts": dropped_pts,
            "dropped_fixed": dropped_fixed,
        })
        if dropped_local or dropped_pts or dropped_fixed:
            # no silent truncation (the reference has no caps,
            # localization_opt.cpp:460-527 — ours must at least confess)
            print(
                f"[ba] cap bound at kf{kf0}: dropped "
                f"local={dropped_local} pts={dropped_pts} "
                f"fixed={dropped_fixed} (caps {caps.local_ba_kfs}/"
                f"{caps.local_ba_points}/{caps.fixed_ba_kfs})",
                flush=True,
            )

        # A local KF with almost no surviving observations is effectively
        # unconstrained — optimizing it lets it wander (observed r1: culled
        # points left stale KFs that BA dragged ~0.5m, corrupting frames
        # anchored to them). Demote such KFs to fixed by zeroing their free
        # status via cam_valid masking in slot space.
        weak = (np.arange(C) < L) & cam_valid & (obs_per_cam < 10)
        if weak[0] and has_prior:
            weak[0] = False  # the prior-anchored first KF stays free
        cam_valid[weak] = False  # solver: invalid free slot == held fixed;
        # its observations still constrain points (obs_on_free masks only
        # the camera-side blocks).

        prob = local_ba.BAProblem(
            cam_q=jnp.array(cam_q, jnp.float32),
            cam_t=jnp.array(cam_t, jnp.float32),
            cam_valid=jnp.array(cam_valid),
            pts=jnp.array(pts_arr, jnp.float32),
            pt_valid=jnp.array(pt_valid),
            obs_cam=jnp.array(obs_cam),
            obs_uvr=jnp.array(obs_uvr),
            obs_stereo=jnp.array(obs_st),
            obs_sigma2_inv=jnp.array(obs_s2i),
            obs_valid=jnp.array(obs_valid),
            str_type=jnp.array(str_type),
            str_normal=jnp.array(str_normal, jnp.float32),
            str_mean=jnp.array(str_mean, jnp.float32),
            str_sqrt_info=jnp.array(str_sqrt, jnp.float32),
            prior_q=jnp.array(w.kf_q[first_kf] if first_kf >= 0 else cam_q[0], jnp.float32),
            prior_t=jnp.array(w.kf_t[first_kf] if first_kf >= 0 else cam_t[0], jnp.float32),
            has_prior=jnp.array(bool(has_prior)),
        )
        sig_rot = np.deg2rad(cfg.loc.prior_sigma_rot_deg)
        res = local_ba.solve_local_ba(
            self.cam,
            prob,
            n_free=L,
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

        # ONE overlapped readback of every BA output
        new_q, new_t, new_pts, drop_all, bad_all, n_iters = fetch(
            (res.cam_q, res.cam_t, res.pts, res.str_drop, res.obs_bad,
             res.n_iters)
        )
        self.last_ba_iters = int(n_iters)
        self._ba_writeback(
            local, pts_np, n_act, new_q, new_t, new_pts, drop_all,
            bad_all, obs_kfid,
        )

    def _joint_opt_device(
        self, local, fixed, pts, has_prior, first_kf, L, F_CAP, P,
        dropped, kf0,
    ) -> None:
        """Device-assembled local BA: the window's observation tables,
        camera blocks and structure factors are gathered from the
        DeviceWorld mirror inside ONE program that also runs the solve
        (mapping/ba_assemble.py); the host uploads only slot lists
        (~20 KB instead of 17 (P,MO)-shaped arrays)."""
        w = self.world
        cfg = self.cfg
        from . import ba_assemble

        dv = self.dev_world
        with Timer("loc/ba_sync"):
            dv.sync()
        n_act = len(pts)
        pts_np = np.array(pts, np.int64)
        local_arr = np.full(L, -1, np.int32)
        local_arr[: len(local)] = local
        fixed_arr = np.full(F_CAP, -1, np.int32)
        fixed_arr[: len(fixed)] = fixed
        pts_ids = np.full(P, -1, np.int32)
        pts_ids[:n_act] = pts
        slot_lut = np.full(w.MK, -1, np.int32)
        for i, k in enumerate(local):
            slot_lut[k] = i
        for i, k in enumerate(fixed):
            slot_lut[k] = L + i

        sig_rot = np.deg2rad(cfg.loc.prior_sigma_rot_deg)
        res, obs_kfid_d, n_obs_pt_d = ba_assemble.assemble_and_solve(
            self.cam,
            jnp.array(local_arr), jnp.array(fixed_arr), jnp.array(pts_ids),
            jnp.array(slot_lut),
            jnp.array(bool(has_prior)),
            jnp.int32(max(first_kf, 0)),
            dv.kf_q, dv.kf_t,
            dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_octave,
            dv.pt_pos, dv.pt_obs_kf, dv.pt_obs_feat, dv.pt_acomp,
            self.assoc.gmap.means, self.assoc.gmap.normal,
            self.assoc.gmap.sqrt_info, self.assoc.gmap.is_degenerated,
            jnp.array(w.pyr["sigma2_inv"], jnp.float32),
            n_free=L, n_cams=L + F_CAP, n_pts=P,
            mo=cfg.caps.ba_obs_per_point,
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
        (new_q, new_t, new_pts, drop_all, bad_all, n_iters, obs_kfid,
         n_obs_pt) = fetch(
            (res.cam_q, res.cam_t, res.pts, res.str_drop, res.obs_bad,
             res.n_iters, obs_kfid_d, n_obs_pt_d)
        )
        self.last_ba_iters = int(n_iters)
        no = n_obs_pt[:n_act]
        self.ba_stats.append({
            "L": L, "P": P, "MO": cfg.caps.ba_obs_per_point,
            "n_local": len(local), "n_fixed": len(fixed), "n_pts": n_act,
            "obs_mean": float(no.mean()) if n_act else 0.0,
            "obs_p95": float(np.percentile(no, 95)) if n_act else 0.0,
            "obs_max_hit": int((no >= cfg.caps.ba_obs_per_point).sum()),
            "n_obs": int(no.sum()),
            "dropped_local": dropped[0], "dropped_pts": dropped[1],
            "dropped_fixed": dropped[2],
        })
        if any(dropped):
            print(
                f"[ba] cap bound at kf{kf0}: dropped "
                f"local={dropped[0]} pts={dropped[1]} fixed={dropped[2]}",
                flush=True,
            )
        self._ba_writeback(
            local, pts_np, n_act, new_q, new_t, new_pts, drop_all,
            bad_all, obs_kfid,
        )

    def _ba_writeback(
        self, local, pts_np, n_act, new_q, new_t, new_pts, drop_all,
        bad_all, obs_kfid,
    ) -> None:
        w = self.world
        # write back poses/points, rejecting implausible jumps: a local-BA
        # step that moves a keyframe by decimetres is divergence (gauge
        # slide / edge-deactivation runaway), not refinement — keep the
        # tracked pose in that case (observed r1: 0.5m slides corrupted
        # the anchored frame exports permanently).
        new_q = new_q.astype(np.float64)
        new_t = new_t.astype(np.float64)
        for i, k in enumerate(local):
            n = new_q[i] / np.linalg.norm(new_q[i])
            if np.linalg.norm(new_t[i] - w.kf_t[k]) > 0.3:
                continue
            w.kf_q[k], w.kf_t[k] = n, new_t[i]
        w.pt_pos[pts_np] = new_pts[:n_act].astype(np.float64)
        w.map_version += 1  # BA moved poses/points in place (cache tokens)
        w.dirty_pt.update(pts_np.tolist())

        # association downgrade (:837-855)
        drop = drop_all[:n_act]
        dg_lut = np.arange(128, dtype=np.int16)
        for src, dst in ms.DOWNGRADE.items():
            dg_lut[src] = dst
        dgm = drop & np.isin(w.pt_type[pts_np], list(ms.DOWNGRADE.keys()))
        sel = pts_np[dgm]
        w.pt_type[sel] = dg_lut[w.pt_type[sel]].astype(w.pt_type.dtype)
        w.pt_assoc_comp[sel] = -1
        w.pt_assoc_vetted[sel] = False
        # associations that survived this BA pass are vetted for per-frame
        # pose anchoring (tracker._gather_anchors)
        keep = pts_np[w.pt_assoc_comp[pts_np] >= 0]
        w.pt_assoc_vetted[keep] = True

        # erase outlier observations (:857-894) — host surgery over the
        # (few) flagged entries only
        bad = bad_all[:n_act] & (obs_kfid[:n_act] >= 0)
        for i, oi in np.argwhere(bad):
            p = pts_np[i]
            if w.pt_valid[p]:
                if w.remove_observation(p, int(obs_kfid[i, oi])):
                    w.remove_point(p)
        w.update_normal_and_depth_batch(pts_np)

    # ------------------------------------------------------------------

    def remove_keyframes(self) -> None:
        """Cull redundant KFs (localization.cpp:334-397): >90% of near-depth
        points seen >=3 times elsewhere at same-or-finer scale."""
        w = self.world
        cfg = self.cfg
        th_depth = w.pyr["th_depth"]
        for kf in w.best_covisible(self.curr_kf):
            if w.kf_frame_idx[kf] == 0 or not w.kf_valid[kf]:
                continue
            obs = w.kf_obs_point[kf]
            d = w.kf_feat_depth[kf]
            near = (obs >= 0) & w.pt_valid[np.maximum(obs, 0)] & (d >= 0) & (
                d <= th_depth
            )
            pts = obs[near]
            num_mps = len(pts)
            if num_mps == 0:
                continue
            lvl = w.kf_feat_octave[kf, near]
            # count other-KF observations at same-or-one-coarser scale
            okf = w.pt_obs_kf[pts]                     # (n, MO_world)
            oft = np.maximum(w.pt_obs_feat[pts], 0)
            other = (okf >= 0) & (okf != kf)
            oct_other = w.kf_feat_octave[np.maximum(okf, 0), oft]
            n_obs = np.sum(other & (oct_other <= lvl[:, None] + 1), axis=1)
            redundant = (w.pt_n_obs[pts] > cfg.loc.cull_min_obs) & (
                n_obs >= cfg.loc.cull_min_obs
            )
            if redundant.sum() > cfg.loc.kf_cull_redundancy * num_mps:
                w.remove_keyframe(kf)
