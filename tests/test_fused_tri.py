"""Fused-triangulation kernel tests.

1. The adjugate power-iteration DLT init must match the f64 SVD null
   vector on realistic two-view systems (mapping/tri_kernel._dlt_null).
2. End-to-end: a run with the fused path produces the same-quality map
   and trajectory as the multi-dispatch host path.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.gmm import mixture
from gmmloc.mapping.map_state import _inverse
from gmmloc.mapping.tri_kernel import _dlt_null
from gmmloc.pipeline.system import GMMLocSystem
from tests import assets

HAVE_ASSETS = assets.HAVE_ASSETS


def _make_dlt_systems(rng, n, noise_px=0.5):
    """Realistic two-view DLT systems A (n,4,4) + ground-truth points."""
    fx = fy = 435.2
    cx, cy = 367.5, 252.2
    X = np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(2, 9, n)],
        -1,
    )
    A = np.zeros((n, 4, 4))
    for k, (Rt, tt) in enumerate(
        [(np.eye(3), np.zeros(3)), (None, None)]
    ):
        if Rt is None:
            th = 0.08
            Rt = np.array(
                [
                    [np.cos(th), 0, np.sin(th)],
                    [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)],
                ]
            )
            tt = np.array([-0.4, 0.02, 0.05])
        T = np.concatenate([Rt, tt[:, None]], 1)        # (3,4)
        pc = X @ Rt.T + tt
        u = fx * pc[:, 0] / pc[:, 2] + cx + rng.normal(0, noise_px, n)
        v = fy * pc[:, 1] / pc[:, 2] + cy + rng.normal(0, noise_px, n)
        xn = np.stack([(u - cx) / fx, (v - cy) / fy], -1)
        A[:, 2 * k] = xn[:, 0, None] * T[2] - T[0]
        A[:, 2 * k + 1] = xn[:, 1, None] * T[2] - T[1]
    return A, X


def test_dlt_null_matches_svd(rng):
    A, X = _make_dlt_systems(rng, 256)
    v = np.asarray(_dlt_null(jnp.array(A, jnp.float32)))
    pts = v[:, :3] / v[:, 3:4]
    # f64 SVD oracle
    _, _, Vt = np.linalg.svd(A)
    vs = Vt[:, 3]
    pts_svd = vs[:, :3] / vs[:, 3:4]
    err = np.linalg.norm(pts - pts_svd, axis=1)
    # f32 storage of A bounds the achievable null-vector precision at
    # ~1e-2 in point space (the f64 version of this algorithm matches
    # SVD to 4e-4); that is ~10x below the triangulation noise itself
    assert np.median(err) < 2e-2, np.median(err)
    assert (err < 8e-2).mean() > 0.95, np.percentile(err, 95)
    # the decisive criterion: adjugate-DLT points are as close to the
    # TRUE points as the f64 SVD's (within 20%)
    e_adj = np.median(np.linalg.norm(pts - X, axis=1))
    e_svd = np.median(np.linalg.norm(pts_svd - X, axis=1))
    assert e_adj < 1.2 * e_svd + 5e-3, (e_adj, e_svd)


def test_dlt_null_noise_free_exact(rng):
    A, X = _make_dlt_systems(rng, 64, noise_px=0.0)
    v = np.asarray(_dlt_null(jnp.array(A, jnp.float32)))
    pts = v[:, :3] / v[:, 3:4]
    assert np.median(np.linalg.norm(pts - X, axis=1)) < 1e-3


@pytest.mark.skipif(not HAVE_ASSETS, reason="reference assets absent")
def test_fused_tri_e2e_parity():
    """Same sequence with fused_tri on/off: both must track with small
    error and build comparably sized maps (DLT init differences make
    bit-equality impossible; the acceptance gates bound the effect)."""
    res = {}
    for fused in (True, False):
        cfg = euroc_v1_config()
        cfg = cfg.replace(
            loc=dataclasses.replace(cfg.loc, fused_tri=fused),
            tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9),
        )
        fe, ts, q_wc, t_wc = synthetic.make_sequence(
            cfg, **assets.EUROC_V1_01, n_frames=220, stride=1, n_landmarks=12000,
            disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
        )
        START, N = 150, 45
        gmap = mixture.load(
            assets.V1_GMM, pad_to=cfg.caps.gmm_components_pad,
            neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
            neighbor_cap=cfg.gmm.neighbor_cap,
        )
        s = GMMLocSystem(cfg, gmap)
        errs = []
        frames = []
        for i in range(N):
            fi = START + i
            f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
            st = s.step(f, q_wc[fi], t_wc[fi])
            assert st is None or st.res, f"tracking failed at {i} fused={fused}"
            frames.append((f, fi))
        s.flush()
        errs = [
            np.linalg.norm(_inverse(f.q_cw, f.t_cw)[1] - t_wc[fi])
            for f, fi in frames
        ]
        n_tri = int(
            np.isin(
                s.world.pt_type[s.world.pt_valid], [2, 3, 4, 5]
            ).sum()
        )
        res[fused] = (float(np.mean(errs)), s.world.n_points(), n_tri)
    for fused, (err, n_pts, n_tri) in res.items():
        assert err < 0.02, (fused, err)
        assert n_tri > 20, (fused, n_tri)  # triangulation actually ran
    # comparable map sizes
    assert abs(res[True][1] - res[False][1]) < 0.35 * max(
        res[True][1], res[False][1]
    ), res
