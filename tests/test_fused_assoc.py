"""Parity test: the fused single-dispatch KF-association kernel vs the
multi-dispatch host-orchestrated chain (render + searchCorrespondence +
checkMapAssociation + queryPoint fallback).

The fused kernel (association.associate_and_check_kernel) must produce
the same candidate table (bit-exact — identical sub-kernels) and the
same association decisions/point refinements up to f32-vs-f64 gate
rounding in the host path's neighbor-refinement chi2.
"""

import dataclasses
import os

import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.gmm import mixture
from gmmloc.pipeline.system import GMMLocSystem
from tests import assets

HAVE_ASSETS = assets.HAVE_ASSETS


@pytest.mark.skipif(not HAVE_ASSETS, reason="reference assets absent")
def test_fused_assoc_matches_host_chain():
    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, **assets.EUROC_V1_01, n_frames=220, stride=1, n_landmarks=12000,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
    )
    START, N = 150, 30
    gmap = mixture.load(
        assets.V1_GMM, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
    )
    s = GMMLocSystem(cfg, gmap)
    for i in range(N):
        fi = START + i
        f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
        st = s.step(f, q_wc[fi], t_wc[fi])
        assert st is None or st.res
    s.flush()
    w, assoc = s.world, s.assoc
    kf = s.curr_keyframe
    assert kf >= 0 and w.kf_valid[kf]

    # --- path A: host-orchestrated chain ---------------------------------
    assoc.associate_keyframe(w, kf)
    cand_a = w.kf_comp_cand[kf].copy()
    depth = w.kf_feat_depth[kf]
    feat_ok = w.kf_feat_valid[kf] & (depth > 0)
    has_cand = (cand_a >= 0).any(axis=1)
    sel = np.where(feat_ok & has_cand)[0]
    assert len(sel) > 50, "degenerate fixture: too few checkable features"
    # unproject (same math as create_map_points_from_stereo)
    from gmmloc.mapping import map_state as ms

    q_wc_kf, t_wc_kf = ms._inverse(w.kf_q[kf], w.kf_t[kf])
    R_wc = ms._quat_to_mat(q_wc_kf)
    uv = w.kf_feat_uv[kf][sel]
    zs = depth[sel]
    cam = s.cam
    pc = np.stack(
        [(uv[:, 0] - cam.cx) / cam.fx * zs,
         (uv[:, 1] - cam.cy) / cam.fy * zs, zs], -1,
    )
    pw = pc @ R_wc.T + t_wc_kf
    a_host, p_host = assoc.check_map_association_batch(w, kf, sel, pw)

    # --- path B: fused kernel --------------------------------------------
    assoc.associate_and_check_keyframe(w, kf)
    a_dev, p_dev = assoc._consume_fused_check(w, kf)
    cand_b = w.kf_comp_cand[kf].copy()

    # candidate tables are the same kernels — bit-exact
    np.testing.assert_array_equal(cand_a, cand_b)

    # association decisions: agreement up to borderline chi2-gate flips
    # (host neighbor-refinement runs f64, kernel f32)
    agree = a_host == a_dev[sel]
    assert agree.mean() > 0.97, (
        f"assoc agreement {agree.mean():.3f}",
        np.stack([a_host[~agree], a_dev[sel][~agree]]),
    )
    # refined points where both paths accepted the same component
    both = agree & (a_host >= 0)
    if both.any():
        np.testing.assert_allclose(
            p_host[both], p_dev[sel][both], atol=1e-3
        )
