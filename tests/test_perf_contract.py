"""Per-frame transfer-budget contract for the packed fused track path.

The packed-IO design (tracking/tracker._dispatch_packed) promises THREE
small host->device uploads per steady-state frame (pose/scalars, the
last-frame dynamic table, the current frame's packed feature table) and
ONE device->host readback (the packed result vector) — everything else
(GMM geometry, pyramid scales, and in kf-refresh mode the local-map
table) is device-resident. This is the contract the throughput story
rests on (utils/fetch.py; the reference pays zero transfers because it
is single-address-space CPU, tracking.cpp).

Accounting: utils/fetch counts uploads at the jnp.array sites on the hot
path and readbacks per fetch() call.
"""

import dataclasses
import os

import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.gmm import mixture
from gmmloc.pipeline.system import GMMLocSystem
from gmmloc.utils import fetch
from tests import assets

HAVE_ASSETS = assets.HAVE_ASSETS


@pytest.mark.skipif(not HAVE_ASSETS, reason="reference assets absent")
def test_packed_frame_transfer_budget():
    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(
            cfg.tracking,
            velocity_damping=0.9,
            use_fused_track=True,
            fused_packed_io=True,
            pipelined_track=True,
            fused_map_refresh="kf",
        )
    )
    gmap = mixture.load(
        assets.V1_GMM, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
    )
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, **assets.EUROC_V1_01, n_frames=220, stride=1, n_landmarks=20000,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
    )
    s = GMMLocSystem(cfg, gmap)

    # warmup: bootstrap + first dispatches + initial KF churn
    WARM, MEAS = 20, 30
    for i in range(WARM):
        fi = 150 + i
        f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
        s.step(f, q_wc[fi], t_wc[fi])

    # Per-step transfer deltas. A step that drains a frame whose mapping
    # side created a keyframe legitimately fetches more (association/
    # triangulation/fusion/BA readbacks); every OTHER step must hit the
    # exact packed budget: 1 readback (the packed result vector) and
    # <=3 uploads (pose scalars, dynamic table, current packed frame).
    plain_steps = 0
    for i in range(WARM, WARM + MEAS):
        fi = 150 + i
        f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
        kf0 = s.world.n_keyframes()
        fetch.reset_stats()
        st = s.step(f, q_wc[fi], t_wc[fi])
        stats = fetch.stats()
        assert st is None or st.res
        if s.world.n_keyframes() != kf0:
            continue  # KF-processing step: mapping-side transfers allowed
        plain_steps += 1
        assert stats["fetches"] <= 1, (i, stats)
        assert stats["uploads"] <= 3, (i, stats)
    # the window must actually exercise the steady-state path
    assert plain_steps >= MEAS // 2, plain_steps
