"""Device-resident world mirror: KF feature tables + landmark attributes.

The reference runs in one CPU address space, so its per-KF stages read
the world for free (localization.cpp passes pointers). Re-uploading the
gathered neighbor-KF feature tables and query-point attributes on every
keyframe costs far more host-link traffic than the device compute it
feeds. So the world is mirrored in device memory and gathered ON
DEVICE:

  - keyframe feature tables (uv/ur/desc/octave/angle/valid) are immutable
    after creation (map_state.alloc_keyframe) -> row-scatter once per KF;
  - landmark attributes (pos/normal/dist bounds/descriptor) change in
    known batches (creation, BA write-back, descriptor refresh) ->
    row-scatter of the dirty ids per sync;
  - poses and validity masks are small -> re-uploaded wholesale.

MapState marks dirty rows at its mutation sites; sync() applies them as
ONE jitted multi-field scatter per table group (eager .at[].set would
compile a fresh executable per shape and pay per-op dispatch through the
link). Scatter index arrays are padded to pow2 buckets (pad index =
first id, writing identical data twice) so each group has a handful of
executables instead of one per length.
"""

from __future__ import annotations

import jax
import numpy as np

from .map_state import MapState


def _pad_pow2(ids: np.ndarray, lo: int = 64) -> np.ndarray:
    b = lo
    while b < len(ids):
        b <<= 1
    out = np.full(b, ids[0], ids.dtype)
    out[: len(ids)] = ids
    return out


@jax.jit
def _scatter_kf(uv, ur, desc, octv, ang, val, dep, cand, ids, r_uv, r_ur,
                r_desc, r_oct, r_ang, r_val, r_dep, r_cand):
    return (
        uv.at[ids].set(r_uv), ur.at[ids].set(r_ur),
        desc.at[ids].set(r_desc), octv.at[ids].set(r_oct),
        ang.at[ids].set(r_ang), val.at[ids].set(r_val),
        dep.at[ids].set(r_dep), cand.at[ids].set(r_cand),
    )


@jax.jit
def _scatter_pt(pos, nrm, dmin, dmax, desc, okf, oft, val, comp, acomp,
                ids, r_pos, r_nrm, r_dmin, r_dmax, r_desc, r_okf, r_oft,
                r_val, r_comp, r_acomp):
    return (
        pos.at[ids].set(r_pos), nrm.at[ids].set(r_nrm),
        dmin.at[ids].set(r_dmin), dmax.at[ids].set(r_dmax),
        desc.at[ids].set(r_desc), okf.at[ids].set(r_okf),
        oft.at[ids].set(r_oft), val.at[ids].set(r_val),
        comp.at[ids].set(r_comp), acomp.at[ids].set(r_acomp),
    )


class DeviceWorld:
    """HBM mirror of the MapState tables the mapping kernels gather from."""

    def __init__(self, world: MapState):
        import jax.numpy as jnp

        self.w = world
        MK, MP, F = world.MK, world.MP, world.F
        # zeros allocate on device without a host transfer
        self.kf_feat_uv = jnp.zeros((MK, F, 2), jnp.float32)
        self.kf_feat_ur = jnp.full((MK, F), -1.0, jnp.float32)
        self.kf_feat_desc = jnp.zeros((MK, F, 32), jnp.uint8)
        self.kf_feat_octave = jnp.zeros((MK, F), jnp.int32)
        self.kf_feat_angle = jnp.zeros((MK, F), jnp.float32)
        self.kf_feat_valid = jnp.zeros((MK, F), bool)
        self.kf_feat_depth = jnp.full((MK, F), -1.0, jnp.float32)
        knn = world.kf_comp_cand.shape[2]
        self.kf_comp_cand = jnp.full((MK, F, knn), -1, jnp.int32)
        self.pt_pos = jnp.zeros((MP, 3), jnp.float32)
        self.pt_normal = jnp.zeros((MP, 3), jnp.float32)
        self.pt_min_dist = jnp.zeros(MP, jnp.float32)
        self.pt_max_dist = jnp.zeros(MP, jnp.float32)
        self.pt_desc = jnp.zeros((MP, 32), jnp.uint8)
        # per-point observation tables (BA problem assembly gathers the
        # window's observations ON DEVICE — mapping/ba_assemble.py)
        MO = world.MO
        self.pt_obs_kf = jnp.full((MP, MO), -1, jnp.int32)
        self.pt_obs_feat = jnp.full((MP, MO), -1, jnp.int32)
        # per-row validity / association state (scattered with the pt
        # group: a wholesale re-upload of the (MP,) arrays would move
        # ~0.58 MB per sync)
        self.pt_valid = jnp.zeros(MP, bool)
        # vetted GMM component as f32 (-1 none) — chained track step input
        self.pt_comp = jnp.full(MP, -1.0, jnp.float32)
        # raw GMM association (un-vetted; BA structure factors use this)
        self.pt_acomp = jnp.full(MP, -1, jnp.int32)
        # small, re-uploaded every sync
        self.kf_q = jnp.zeros((MK, 4), jnp.float32)
        self.kf_t = jnp.zeros((MK, 3), jnp.float32)
        self.n_syncs = 0
        self._synced_version = -1

    # ------------------------------------------------------------------

    def prewarm_scatters(self, kf_buckets=(1, 2, 4, 8), pt_buckets=(256, 512, 1024,
                                                             2048, 4096)) -> None:
        """Compile the scatter executables for the common dirty-set
        buckets so none lands inside a measured window."""
        import jax.numpy as jnp

        for b in kf_buckets:
            ids = jnp.zeros(b, jnp.int32)
            _scatter_kf(
                self.kf_feat_uv, self.kf_feat_ur, self.kf_feat_desc,
                self.kf_feat_octave, self.kf_feat_angle, self.kf_feat_valid,
                self.kf_feat_depth, self.kf_comp_cand,
                ids,
                jnp.zeros((b,) + self.kf_feat_uv.shape[1:], jnp.float32),
                jnp.zeros((b,) + self.kf_feat_ur.shape[1:], jnp.float32),
                jnp.zeros((b,) + self.kf_feat_desc.shape[1:], jnp.uint8),
                jnp.zeros((b,) + self.kf_feat_octave.shape[1:], jnp.int32),
                jnp.zeros((b,) + self.kf_feat_angle.shape[1:], jnp.float32),
                jnp.zeros((b,) + self.kf_feat_valid.shape[1:], bool),
                jnp.zeros((b,) + self.kf_feat_depth.shape[1:], jnp.float32),
                jnp.zeros((b,) + self.kf_comp_cand.shape[1:], jnp.int32),
            )[0].block_until_ready()
        mo = self.pt_obs_kf.shape[1]
        for b in pt_buckets:
            ids = jnp.zeros(b, jnp.int32)
            _scatter_pt(
                self.pt_pos, self.pt_normal, self.pt_min_dist,
                self.pt_max_dist, self.pt_desc, self.pt_obs_kf,
                self.pt_obs_feat, self.pt_valid, self.pt_comp,
                self.pt_acomp, ids,
                jnp.zeros((b, 3), jnp.float32), jnp.zeros((b, 3), jnp.float32),
                jnp.zeros(b, jnp.float32), jnp.zeros(b, jnp.float32),
                jnp.zeros((b, 32), jnp.uint8),
                jnp.zeros((b, mo), jnp.int32), jnp.zeros((b, mo), jnp.int32),
                jnp.zeros(b, bool), jnp.zeros(b, jnp.float32),
                jnp.zeros(b, jnp.int32),
            )[0].block_until_ready()

    def sync(self) -> None:
        """Bring the mirror up to date with MapState's dirty rows."""
        import jax.numpy as jnp

        from ..utils.fetch import record_uploads

        w = self.w
        if (
            not w.dirty_kf and not w.dirty_pt
            and self._synced_version == w.map_version
        ):
            # nothing changed since the last sync: skip the wholesale
            # pose/validity/comp re-uploads too (every in-place pose or
            # association write bumps map_version — BA write-back, loop
            # closing; measured ~0.4 MB + a blocking barrier per no-op
            # sync across the 2-4 sync sites per keyframe)
            return
        self._synced_version = w.map_version
        n_up = 0
        did_kf = bool(w.dirty_kf)
        did_pt = bool(w.dirty_pt)
        if w.dirty_kf:
            # lo=1: the common case is ONE new keyframe; a 64-row bucket
            # would re-upload ~4.7 MB of padding per sync
            ids = _pad_pow2(
                np.fromiter(w.dirty_kf, np.int64, len(w.dirty_kf)), lo=1
            )
            (self.kf_feat_uv, self.kf_feat_ur, self.kf_feat_desc,
             self.kf_feat_octave, self.kf_feat_angle, self.kf_feat_valid,
             self.kf_feat_depth, self.kf_comp_cand) = _scatter_kf(
                self.kf_feat_uv, self.kf_feat_ur, self.kf_feat_desc,
                self.kf_feat_octave, self.kf_feat_angle, self.kf_feat_valid,
                self.kf_feat_depth, self.kf_comp_cand,
                jnp.array(ids),
                jnp.array(w.kf_feat_uv[ids], jnp.float32),
                jnp.array(w.kf_feat_ur[ids], jnp.float32),
                jnp.array(w.kf_feat_desc[ids]),
                jnp.array(w.kf_feat_octave[ids], jnp.int32),
                jnp.array(w.kf_feat_angle[ids], jnp.float32),
                jnp.array(w.kf_feat_valid[ids]),
                jnp.array(w.kf_feat_depth[ids], jnp.float32),
                jnp.array(w.kf_comp_cand[ids], jnp.int32),
            )
            w.dirty_kf.clear()
            n_up += 9
        if w.dirty_pt:
            ids = _pad_pow2(
                np.fromiter(w.dirty_pt, np.int64, len(w.dirty_pt)), lo=256
            )
            (self.pt_pos, self.pt_normal, self.pt_min_dist,
             self.pt_max_dist, self.pt_desc, self.pt_obs_kf,
             self.pt_obs_feat, self.pt_valid, self.pt_comp,
             self.pt_acomp) = _scatter_pt(
                self.pt_pos, self.pt_normal, self.pt_min_dist,
                self.pt_max_dist, self.pt_desc, self.pt_obs_kf,
                self.pt_obs_feat, self.pt_valid, self.pt_comp,
                self.pt_acomp,
                jnp.array(ids),
                jnp.array(w.pt_pos[ids], jnp.float32),
                jnp.array(w.pt_normal[ids], jnp.float32),
                jnp.array(w.pt_min_dist[ids], jnp.float32),
                jnp.array(w.pt_max_dist[ids], jnp.float32),
                jnp.array(w.pt_desc[ids]),
                jnp.array(w.pt_obs_kf[ids], jnp.int32),
                jnp.array(w.pt_obs_feat[ids], jnp.int32),
                jnp.array(w.pt_valid[ids]),
                jnp.array(
                    np.where(
                        w.pt_assoc_vetted[ids], w.pt_assoc_comp[ids], -1
                    ).astype(np.float32)
                ),
                jnp.array(w.pt_assoc_comp[ids], jnp.int32),
            )
            w.dirty_pt.clear()
            n_up += 11
        self.kf_q = jnp.array(w.kf_q, jnp.float32)
        self.kf_t = jnp.array(w.kf_t, jnp.float32)
        record_uploads(n_up + 2)
        # Materialize the scatter chains before anything dispatches on
        # them (LocConfig.sync_barrier): "always" after any scatter, "kf"
        # only after keyframe-row scatters. Whether the GPU needs these
        # barriers is not measured yet (ROADMAP C2).
        policy = getattr(self.w.cfg.loc, "sync_barrier", "always")
        if did_pt and (policy == "always" or did_kf):
            self.pt_desc.block_until_ready()
        if did_kf:
            self.kf_feat_desc.block_until_ready()
        self.n_syncs += 1
