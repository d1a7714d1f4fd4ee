"""Stereo correspondence: batched row-banded Hamming match + SAD refine.

JAX replacement for Frame::computeStereoMatches
(ref: /root/reference/gmmloc/src/types/frame.cpp:179-349). The per-left-
keypoint row-candidate scan becomes one dense masked (NL, NR) pass; the
11-step SAD subpixel refinement becomes a batched gather of 11x11 windows
at 11 shifts with a parabola fit; the median-based outlier cut
(:337-348) stays as a final masked filter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import matching

TH_HIGH = matching.TH_HIGH
TH_LOW = matching.TH_LOW


class StereoMatches(NamedTuple):
    u_right: jax.Array  # (NL,) refined right-u, -1 if unmatched
    depth: jax.Array    # (NL,) bf/disparity, -1 if unmatched


@functools.partial(jax.jit, static_argnames=("bf", "min_z"))
def match_stereo(
    uv_l, octave_l, desc_l, valid_l,
    uv_r, octave_r, desc_r, valid_r,
    scale_factors,            # (L,)
    bf: float,
    min_z: float,
):
    """Descriptor stage (frame.cpp:193-277): returns best right index per
    left keypoint (-1 if fails) + the descriptor distance."""
    max_d = bf / min_z

    # row band: |vL - vR| <= 2 * sf[octave_r] (:196-206)
    band = 2.0 * scale_factors[octave_r]
    row_ok = jnp.abs(uv_l[:, None, 1] - uv_r[None, :, 1]) <= band[None, :]
    lvl_ok = (octave_r[None, :] >= octave_l[:, None] - 1) & (
        octave_r[None, :] <= octave_l[:, None] + 1
    )
    du = uv_l[:, None, 0] - uv_r[None, :, 0]     # disparity = uL - uR
    disp_ok = (du >= 0.0) & (du <= max_d)
    cand = row_ok & lvl_ok & disp_ok & valid_l[:, None] & valid_r[None, :]

    dist = matching.hamming_matrix(desc_l, desc_r)
    dist = jnp.where(cand, dist, 1 << 20)
    best = jnp.argmin(dist, axis=1)
    d0 = jnp.take_along_axis(dist, best[:, None], axis=1)[:, 0]
    th = (TH_HIGH + TH_LOW) // 2
    ok = d0 < th
    return jnp.where(ok, best, -1), d0


def _window(img, cy, cx, r):
    dy = jnp.arange(-r, r + 1)
    dx = jnp.arange(-r, r + 1)
    yy = cy[:, None, None] + dy[None, :, None]
    xx = cx[:, None, None] + dx[None, None, :]
    h, w = img.shape
    yy = jnp.clip(yy, 0, h - 1)
    xx = jnp.clip(xx, 0, w - 1)
    return img[yy, xx]


@functools.partial(jax.jit, static_argnames=("bf", "min_z", "n_levels"))
def refine_subpixel(
    pyr_l,          # tuple of left level images
    pyr_r,          # tuple of right level images
    uv_l, octave_l,
    u_r0,           # (NL,) coarse right-u from descriptor stage
    matched,        # (NL,) bool
    scale_factors,  # (L,)
    bf: float,
    min_z: float,
    n_levels: int,
):
    """SAD subpixel refinement (frame.cpp:279-335): 11x11 windows, +-5
    shift, center-normalized L1, parabola interpolation."""
    W, L = 5, 5
    inv_sf = 1.0 / scale_factors
    su_l = uv_l[:, 0] * inv_sf[octave_l]
    sv_l = uv_l[:, 1] * inv_sf[octave_l]
    su_r = u_r0 * inv_sf[octave_l]

    NL = uv_l.shape[0]

    iy = jnp.round(sv_l).astype(jnp.int32)
    ixl = jnp.round(su_l).astype(jnp.int32)
    ixr = jnp.round(su_r).astype(jnp.int32)

    # Level ATLAS: stack the pyramid vertically into one image so each
    # keypoint gathers from its own level via a row offset — the
    # per-level unroll ran 8 levels x (1 + 11 shifts) = 96 window
    # gathers for ALL keypoints each (masked combine). Here: ONE left
    # 11x11 gather + ONE right 11x21 gather (the 11 shifted windows are
    # slices of the wide window), then pure elementwise SAD. Clip bounds
    # are per-level, matching the original per-level-image clipping.
    heights = [im.shape[0] for im in pyr_l]
    widths = [im.shape[1] for im in pyr_l]
    offs = [0]
    for h in heights[:-1]:
        offs.append(offs[-1] + h)
    H_tot, W0 = offs[-1] + heights[-1], widths[0]

    def atlas(pyr):
        a = jnp.zeros((H_tot, W0), pyr[0].dtype)
        for l, im in enumerate(pyr):
            a = jax.lax.dynamic_update_slice(a, im, (offs[l], 0))
        return a

    al, ar = atlas(pyr_l), atlas(pyr_r)
    off_v = jnp.asarray(offs, jnp.int32)[octave_l]
    h_v = jnp.asarray(heights, jnp.int32)[octave_l]
    w_v = jnp.asarray(widths, jnp.int32)[octave_l]
    y_lo = off_v[:, None, None]
    y_hi = (off_v + h_v - 1)[:, None, None]
    x_hi = (w_v - 1)[:, None, None]

    def win(img, cy, cx, rx_lo, rx_hi):
        dy = jnp.arange(-W, W + 1)
        dx = jnp.arange(rx_lo, rx_hi + 1)
        yy = jnp.clip(cy[:, None, None] + dy[None, :, None], y_lo, y_hi)
        xx = jnp.clip(cx[:, None, None] + dx[None, None, :], 0, x_hi)
        return img[yy, xx]

    wl = win(al, iy + off_v, ixl, -W, W)                  # (NL, 11, 11)
    wl = wl - wl[:, W : W + 1, W : W + 1]
    wr_wide = win(ar, iy + off_v, ixr, -W - L, W + L)     # (NL, 11, 11+2L)
    cols = []
    for k in range(2 * L + 1):
        wr = jax.lax.slice_in_dim(wr_wide, k, k + 2 * W + 1, axis=2)
        wr = wr - wr[:, W : W + 1, W : W + 1]  # center of the slice
        cols.append(jnp.sum(jnp.abs(wl - wr), axis=(1, 2)))
    dists = jnp.stack(cols, axis=1)                       # (NL, 2L+1)

    best_k = jnp.argmin(dists, axis=1)
    interior = (best_k > 0) & (best_k < 2 * L)
    km = jnp.clip(best_k - 1, 0, 2 * L)
    kp = jnp.clip(best_k + 1, 0, 2 * L)
    d1 = jnp.take_along_axis(dists, km[:, None], 1)[:, 0]
    d2 = jnp.take_along_axis(dists, best_k[:, None], 1)[:, 0]
    d3 = jnp.take_along_axis(dists, kp[:, None], 1)[:, 0]
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = jnp.where(jnp.abs(denom) > 1e-9, (d1 - d3) / denom, 2.0)
    good = matched & interior & (delta >= -1.0) & (delta <= 1.0)

    best_inc = best_k.astype(jnp.float32) - L
    u_right = scale_factors[octave_l] * (
        jnp.round(su_r) + best_inc + delta
    )
    disparity = uv_l[:, 0] - u_right
    max_d = bf / min_z
    in_range = (disparity >= 0.0) & (disparity < max_d)
    disparity = jnp.where(disparity <= 0.0, 0.01, disparity)
    u_right = jnp.where(disparity <= 0.01, uv_l[:, 0] - 0.01, u_right)
    good = good & in_range
    sad_final = d2

    return u_right, bf / disparity, good, sad_final


def compute_stereo_matches(
    pyr_l, pyr_r,
    uv_l, octave_l, desc_l, valid_l,
    uv_r, octave_r, desc_r, valid_r,
    scale_factors, bf: float, baseline: float, n_levels: int,
):
    """Full stereo pipeline incl. the median outlier cut (frame.cpp:337-348).
    Returns (u_right (NL,), depth (NL,)) with -1 where unmatched."""
    best, _ = match_stereo(
        uv_l, octave_l, desc_l, valid_l, uv_r, octave_r, desc_r, valid_r,
        jnp.asarray(scale_factors), bf=bf, min_z=baseline,
    )
    matched = best >= 0
    u_r0 = jnp.where(matched, uv_r[jnp.clip(best, 0), 0], 0.0)
    u_right, depth, good, sad = refine_subpixel(
        tuple(pyr_l), tuple(pyr_r), uv_l, octave_l, u_r0, matched,
        jnp.asarray(scale_factors), bf=bf, min_z=baseline, n_levels=n_levels,
    )

    # median SAD outlier cut: drop matches with sad >= 2.1 * median.
    # In-graph f32 nanmedian — identical to the fused packed front-end
    # (host np.nanmedian computes in f64 and flips borderline matches
    # by one ulp of the threshold)
    med = jnp.nanmedian(jnp.where(good, sad, jnp.nan))
    med = jnp.where(jnp.isfinite(med), med, 0.0)
    thr = 1.5 * 1.4 * med
    good = good & (sad <= thr)
    return (
        jnp.where(good, u_right, -1.0),
        jnp.where(good, depth, -1.0),
    )
