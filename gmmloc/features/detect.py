"""Full ORB-style detection pipeline over the image pyramid.

Batched replacement for ORBextractor::detect
(ref: /root/reference/gmmloc/src/cv/orb_extractor.cpp:988-1054):
pyramid -> per-level FAST + per-cell distribution -> IC-angle ->
blur -> steered BRIEF; keypoints scaled back to level-0 coordinates.

The per-level quotas follow the reference's geometric split
(:418-434): n_l ∝ (1/1.2)^l, remainder to the coarsest level.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import fast, orb, pyramid


class Detections(NamedTuple):
    uv: jax.Array       # (N,2) level-0 pixel coords
    octave: jax.Array   # (N,) int32
    angle: jax.Array    # (N,) degrees
    response: jax.Array  # (N,)
    desc: jax.Array     # (N,32) uint8
    valid: jax.Array    # (N,) bool


def level_quotas(num_features: int, num_levels: int, scale: float):
    inv = 1.0 / scale
    factor = num_features * (1 - inv) / (1 - inv**num_levels)
    quotas = [int(round(factor * inv**l)) for l in range(num_levels - 1)]
    quotas.append(max(0, num_features - sum(quotas)))
    return quotas


class ORBDetector:
    """Builds one jitted detect() for a fixed image geometry."""

    def __init__(self, height: int, width: int, num_features: int = 1200,
                 num_levels: int = 8, scale: float = 1.2, cell: int = 24,
                 distribution: str = "quota"):
        self.shapes = tuple(pyramid.level_shapes(height, width, num_levels, scale))
        self.quotas = level_quotas(num_features, num_levels, scale)
        self.num_levels = num_levels
        self.scale_factors = scale ** np.arange(num_levels)
        self.cell = cell
        # keypoint spatial distribution: "quota" = per-cell winners +
        # top-quota (default); "octree" = coarse-to-fine multi-scale cell
        # emulation of DistributeOctTree (fast.select_keypoints_octree,
        # A/B for the reference's quadtree — orb_extractor.cpp:529-737)
        self.distribution = distribution
        self._detect = jax.jit(self._detect_impl)

    def _detect_impl(self, img):
        levels = pyramid.build_pyramid(img, self.shapes)
        return self.detect_from_levels(levels)

    def _atlas_geom(self):
        heights = [s[0] for s in self.shapes]
        widths = [s[1] for s in self.shapes]
        offs = [0]
        for h in heights[:-1]:
            offs.append(offs[-1] + h)
        H_tot = offs[-1] + heights[-1]
        return heights, widths, offs, H_tot

    def _build_atlases(self, levels):
        """Stack the raw and per-level-blurred pyramid into atlases.
        Blur is applied per level BEFORE stacking so it cannot bleed
        across level boundaries."""
        heights, widths, offs, H_tot = self._atlas_geom()
        W0 = widths[0]
        atlas_raw = jnp.zeros((H_tot, W0), levels[0].dtype)
        atlas_blur = jnp.zeros((H_tot, W0), levels[0].dtype)
        for l, im in enumerate(levels):
            atlas_raw = jax.lax.dynamic_update_slice(atlas_raw, im, (offs[l], 0))
            atlas_blur = jax.lax.dynamic_update_slice(
                atlas_blur, pyramid.gaussian_blur7(im), (offs[l], 0)
            )
        return atlas_raw, atlas_blur

    def _score_atlas(self, atlas_raw):
        """ONE FAST+NMS pass over the whole stacked pyramid (and, for
        the stereo pair, both images) instead of one per level.

        Bit-exactness at every SELECTABLE pixel: select_keypoints masks
        candidates to >= 16 px from each level's edges; a candidate's
        score and its 3x3-NMS neighbors' scores (>= 15 px from edges)
        read only ring pixels >= 12 px inside the level band — never
        across a band boundary (ring radius 3). Cross-band artifacts
        exist only within 3 px of band edges, outside the selectable
        region."""
        return fast.nms3x3(fast.fast_score(atlas_raw))

    def _select_levels(self, score_atlas, base_off):
        """Per-level keypoint selection from static atlas slices."""
        heights, widths, offs, _ = self._atlas_geom()
        uvs_lvl, octs, resps, valids = [], [], [], []
        for l in range(self.num_levels):
            y0 = base_off + offs[l]
            sl = jax.lax.slice(
                score_atlas, (y0, 0), (y0 + heights[l], widths[l])
            )
            if self.distribution == "octree":
                uv, resp, valid = fast.select_keypoints_octree(
                    sl, quota=self.quotas[l], edge=16
                )
            else:
                uv, resp, valid = fast.select_keypoints(
                    sl, cell=self.cell, quota=self.quotas[l], edge=16
                )
            uvs_lvl.append(uv)
            octs.append(jnp.full(uv.shape[0], l, jnp.int32))
            resps.append(resp)
            valids.append(valid)
        return (
            jnp.concatenate(uvs_lvl), jnp.concatenate(octs),
            jnp.concatenate(resps), jnp.concatenate(valids),
        )

    def _angle_desc(self, atlas_raw, atlas_blur, uv_all, octave, extra_off=0):
        """Orientation + descriptors as ONE atlas gather across all
        levels (orb.ic_angle_atlas / brief_descriptors_atlas) — the
        patch gathers were the dominant front-end cost before the atlas
        rewrite. Identical clip semantics to the per-level path."""
        heights, widths, offs, _ = self._atlas_geom()
        y_off = jnp.asarray(offs, jnp.int32)[octave] + extra_off
        h_v = jnp.asarray(heights, jnp.int32)[octave]
        w_v = jnp.asarray(widths, jnp.int32)[octave]
        ang = orb.ic_angle_atlas(atlas_raw, uv_all, y_off, h_v, w_v)
        desc = orb.brief_descriptors_atlas(
            atlas_blur, uv_all, ang, y_off, h_v, w_v
        )
        return ang, desc

    def detect_from_levels(self, levels):
        """Detection given a prebuilt pyramid (lets a caller share ONE
        pyramid between detection and stereo refinement inside a single
        fused jit — frontend.process_packed)."""
        atlas_raw, atlas_blur = self._build_atlases(levels)
        score = self._score_atlas(atlas_raw)
        uv_all, octave, resp, valid = self._select_levels(score, 0)
        ang, desc = self._angle_desc(atlas_raw, atlas_blur, uv_all, octave)
        sf = jnp.asarray(self.scale_factors, uv_all.dtype)[octave]
        return Detections(
            uv=uv_all * sf[:, None],
            octave=octave,
            angle=ang,
            response=resp,
            desc=desc,
            valid=valid,
        )

    def detect_pair_from_levels(self, levels_l, levels_r):
        """Detect on BOTH stereo images with ONE FAST+NMS dispatch and
        ONE orientation/descriptor gather pass: the two pyramid atlases
        stack vertically (each level band keeps its own border-exclusion
        region, so stacking adds no interaction — see _score_atlas)."""
        raw_l, blur_l = self._build_atlases(levels_l)
        raw_r, blur_r = self._build_atlases(levels_r)
        H_tot = raw_l.shape[0]
        raw = jnp.concatenate([raw_l, raw_r], axis=0)
        blur = jnp.concatenate([blur_l, blur_r], axis=0)
        score = self._score_atlas(raw)
        uv_l, oct_l, resp_l, val_l = self._select_levels(score, 0)
        uv_r, oct_r, resp_r, val_r = self._select_levels(score, H_tot)
        n_l = uv_l.shape[0]
        uv_all = jnp.concatenate([uv_l, uv_r])
        octave = jnp.concatenate([oct_l, oct_r])
        extra = jnp.concatenate([
            jnp.zeros(n_l, jnp.int32),
            jnp.full(uv_r.shape[0], H_tot, jnp.int32),
        ])
        heights, widths, offs, _ = self._atlas_geom()
        y_off = jnp.asarray(offs, jnp.int32)[octave] + extra
        h_v = jnp.asarray(heights, jnp.int32)[octave]
        w_v = jnp.asarray(widths, jnp.int32)[octave]
        ang = orb.ic_angle_atlas(raw, uv_all, y_off, h_v, w_v)
        desc = orb.brief_descriptors_atlas(blur, uv_all, ang, y_off, h_v, w_v)
        sf = jnp.asarray(self.scale_factors, uv_all.dtype)[octave]
        uv0 = uv_all * sf[:, None]

        def mk(sl):
            return Detections(
                uv=uv0[sl], octave=octave[sl], angle=ang[sl],
                response=jnp.concatenate([resp_l, resp_r])[sl],
                desc=desc[sl], valid=jnp.concatenate([val_l, val_r])[sl],
            )

        return mk(slice(0, n_l)), mk(slice(n_l, None))

    def __call__(self, img) -> Detections:
        """img: (H,W) float32 [0,255]."""
        return self._detect(img)
