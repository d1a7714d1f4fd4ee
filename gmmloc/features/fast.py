"""FAST-16 corner scoring + per-cell distribution as dense XLA ops.

JAX replacement for the per-cell FAST + quad-tree keypoint
distribution of ORBextractor (ref:
/root/reference/gmmloc/src/cv/orb_extractor.cpp:739-988,
DistributeOctTree:529+). Design differences, intentional (SURVEY.md §7
build plan step 3):

  - the segment test runs as 16 shifted full-image masks + circular
    run-length AND/OR (VPU-shaped), not per-pixel scalar loops;
  - the octree distribution is replaced by per-cell winners (32px cells,
    3x3 NMS) + per-level top-quota selection with the 20 -> 7 threshold
    fallback expressed as a sort priority — behavior-equivalent spatial
    spreading with static shapes.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# FAST-16 ring offsets (row, col), radius 3 — standard Bresenham circle
RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ]
)

FAST_TH_HIGH = 20.0
FAST_TH_LOW = 7.0
ARC_LEN = 9


def _shift2d(img, dy, dx):
    """Shift with edge clamp so ring reads stay in bounds."""
    return jnp.roll(img, (-dy, -dx), axis=(0, 1))


@jax.jit
def fast_score(img):
    """Continuous FAST corner score per pixel.

    score = max over (bright, dark) of the best 9-contiguous-arc strength
    with threshold FAST_TH_LOW; 0 where the segment test fails. Border
    pixels (3px) are zeroed.
    """
    p = img
    ring = jnp.stack([_shift2d(img, int(dy), int(dx)) for dy, dx in RING])  # (16,H,W)
    d = ring - p[None]

    bright = d > FAST_TH_LOW
    dark = d < -FAST_TH_LOW

    def arc_strength(mask, mag):
        # min over each 9-long circular arc of mag, where the whole arc
        # passes `mask`; score = max over the 16 arcs
        best = jnp.zeros_like(p)
        for s in range(16):
            idx = [(s + k) % 16 for k in range(ARC_LEN)]
            ok = mask[idx[0]]
            mn = mag[idx[0]]
            for k in idx[1:]:
                ok = ok & mask[k]
                mn = jnp.minimum(mn, mag[k])
            best = jnp.maximum(best, jnp.where(ok, mn, 0.0))
        return best

    score = jnp.maximum(arc_strength(bright, d), arc_strength(dark, -d))

    h, w = img.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    border = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(border, score, 0.0)


@jax.jit
def nms3x3(score):
    """3x3 non-max suppression (keep strict maxima)."""
    neigh = jnp.stack(
        [
            _shift2d(score, dy, dx)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ]
    )
    return jnp.where(score >= neigh.max(axis=0) + 1e-6, score, 0.0)


@functools.partial(jax.jit, static_argnames=("cells", "quota", "edge"))
def select_keypoints_octree(
    score, cells=(96, 48, 24), quota: int = 256, edge: int = 16
):
    """Coarse-to-fine multi-scale cell selection — a static-shape
    emulation of DistributeOctTree (ref: orb_extractor.cpp:529-737).

    The reference's quadtree splits dense regions deeper and keeps the
    best keypoint per leaf, which guarantees every COARSE region
    contributes at least one keypoint before any dense region receives
    its second. Emulated here: per-cell winners at a pyramid of cell
    sizes; a winner's priority is (coarsest scale at which it wins,
    response). The top-quota cut then fills coarse winners first —
    the same spatial-spread-first guarantee with static shapes.
    Duplicate pixels (winning several scales) keep their coarsest rank.
    """
    h, w = score.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    ok = (ys >= edge) & (ys < h - edge) & (xs >= edge) & (xs < w - edge)
    s = jnp.where(ok, score, 0.0)

    n_scales = len(cells)
    cand_xy, cand_val, cand_rank = [], [], []
    for rank, cell in enumerate(cells):
        hc = -(-h // cell)
        wc = -(-w // cell)
        sp = jnp.pad(s, ((0, hc * cell - h), (0, wc * cell - w)))
        cgrid = sp.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3)
        cgrid = cgrid.reshape(hc * wc, cell * cell)
        win_val = cgrid.max(axis=1)
        win_arg = cgrid.argmax(axis=1)
        cy = win_arg // cell + (jnp.arange(hc * wc) // wc) * cell
        cx = win_arg % cell + (jnp.arange(hc * wc) % wc) * cell
        cand_xy.append(jnp.stack([cx, cy], -1))
        cand_val.append(win_val)
        cand_rank.append(jnp.full(hc * wc, rank, jnp.int32))
    xy = jnp.concatenate(cand_xy)
    val = jnp.concatenate(cand_val)
    rank = jnp.concatenate(cand_rank)

    # dedupe: a pixel winning at several scales keeps its coarsest entry
    # (first occurrence in rank order == concatenation order)
    key = xy[:, 1] * w + xy[:, 0]
    order = jnp.arange(key.shape[0])
    first = jnp.full((h * w,), key.shape[0], jnp.int32).at[key].min(
        jnp.where(val > 0, order, key.shape[0])
    )
    is_first = (first[key] == order) & (val > 0)

    # priority: scale rank dominates (coarse first), then the 20->7
    # threshold fallback, then the response
    RANKW = 1e8
    prio = (n_scales - 1 - rank).astype(jnp.float32) * RANKW
    prio = prio + jnp.where(val >= FAST_TH_HIGH, 1e6, 0.0) + val
    prio = jnp.where(is_first, prio, -1.0)
    k = min(quota, prio.shape[0])
    top_p, top_i = jax.lax.top_k(prio, k)
    uv = xy[top_i].astype(jnp.float32)
    resp = val[top_i]
    valid = top_p > 0.0
    if k < quota:
        uv = jnp.pad(uv, ((0, quota - k), (0, 0)))
        resp = jnp.pad(resp, (0, quota - k))
        valid = jnp.pad(valid, (0, quota - k))
    return uv, resp, valid


@functools.partial(jax.jit, static_argnames=("cell", "quota", "edge"))
def select_keypoints(score, cell: int = 32, quota: int = 256, edge: int = 16):
    """Per-cell winners + top-quota selection.

    Returns (uv (quota,2) float32, resp (quota,), valid (quota,)).
    Cells whose winner clears FAST_TH_HIGH outrank low-threshold winners
    (the reference's 20 -> 7 fallback, orb_extractor.cpp:780-788).
    `edge` mirrors the EDGE_THRESHOLD=19-ish border exclusion for
    orientation/descriptor patches.
    """
    h, w = score.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    ok = (ys >= edge) & (ys < h - edge) & (xs >= edge) & (xs < w - edge)
    s = jnp.where(ok, score, 0.0)

    hc = -(-h // cell)
    wc = -(-w // cell)
    pad_h, pad_w = hc * cell - h, wc * cell - w
    sp = jnp.pad(s, ((0, pad_h), (0, pad_w)))
    cells = sp.reshape(hc, cell, wc, cell).transpose(0, 2, 1, 3).reshape(hc * wc, cell * cell)
    win_val = cells.max(axis=1)
    win_arg = cells.argmax(axis=1)
    cy = win_arg // cell + (jnp.arange(hc * wc) // wc) * cell
    cx = win_arg % cell + (jnp.arange(hc * wc) % wc) * cell

    # priority: high-threshold winners first, then by score
    prio = jnp.where(win_val >= FAST_TH_HIGH, win_val + 1e6, win_val)
    prio = jnp.where(win_val > 0.0, prio, -1.0)
    top_p, top_i = jax.lax.top_k(prio, min(quota, hc * wc))
    uv = jnp.stack([cx[top_i].astype(jnp.float32), cy[top_i].astype(jnp.float32)], -1)
    resp = win_val[top_i]
    valid = top_p > 0.0
    n = uv.shape[0]
    if n < quota:
        uv = jnp.pad(uv, ((0, quota - n), (0, 0)))
        resp = jnp.pad(resp, (0, quota - n))
        valid = jnp.pad(valid, (0, quota - n))
    return uv, resp, valid
