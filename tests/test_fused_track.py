"""Fused track-step megakernel test: recovers pose in one dispatch."""

import jax.numpy as jnp
import numpy as np

from gmmloc.config import CameraConfig, euroc_v1_config
from gmmloc.geometry import camera as cam_mod, se3
from gmmloc.tracking import fused
from tests import assets

CAM = cam_mod.CameraParams.from_config(CameraConfig())


def test_fused_track_step_recovers_pose(rng):
    cfg = euroc_v1_config()
    F, P = 512, 1024
    # world points visible from identity
    uv = rng.uniform([40, 40], [CAM.width - 40, CAM.height - 40], (P, 2))
    z = rng.uniform(2.0, 10.0, P)
    pts = np.stack(
        [(uv[:, 0] - CAM.cx) / CAM.fx * z, (uv[:, 1] - CAM.cy) / CAM.fy * z, z], -1
    )
    desc = rng.integers(0, 256, (P, 32), dtype=np.uint8)

    # GT pose: small offset from identity
    q_gt, t_gt = se3.exp(jnp.array([0.004, -0.003, 0.002, 0.02, 0.01, -0.015]))
    pc = se3.apply(q_gt, t_gt, jnp.array(pts))
    uvr, vis = cam_mod.project_stereo(CAM, pc)
    vis = np.asarray(vis)
    sel = np.where(vis)[0][:F]

    feat_uv = np.asarray(uvr)[sel, :2] + rng.standard_normal((len(sel), 2)) * 0.2
    feat_ur = np.asarray(uvr)[sel, 2]
    feat_desc = desc[sel]
    n = len(sel)

    def pad(a, fill, shape1=()):
        out = np.full((F,) + shape1, fill, np.asarray(a).dtype)
        out[:n] = a
        return out

    sf = cfg.frame.scale_factors().astype(np.float32)
    # last-frame = the same landmarks seen from identity (queries)
    last_uvr, _ = cam_mod.project_stereo(CAM, jnp.array(pts))
    last_pts = pts[sel]
    res = fused.fused_track_step(
        CAM,
        se3.quat_identity(), jnp.zeros(3),
        jnp.array(pad(last_pts, 0.0, (3,)), jnp.float32),
        jnp.array(pad(feat_desc, 0, (32,))),
        jnp.zeros(F, jnp.int32),
        jnp.zeros(F, jnp.float32),
        jnp.array(pad(np.asarray(last_uvr)[sel, 2], -1.0), jnp.float32),
        jnp.array(pad(np.ones(n, bool), False)),
        jnp.array(pad(feat_uv, 0.0, (2,)), jnp.float32),
        jnp.array(pad(feat_ur, -1.0), jnp.float32),
        jnp.array(pad(feat_desc, 0, (32,))),
        jnp.zeros(F, jnp.int32),
        jnp.zeros(F, jnp.float32),
        jnp.array(pad(np.ones(n, bool), False)),
        jnp.ones(F, jnp.float32),
        # local map = all landmarks
        jnp.array(pts, jnp.float32),
        jnp.array(desc),
        jnp.array(-pts / np.linalg.norm(pts, axis=1, keepdims=True), jnp.float32),
        jnp.array(z * 0.3, jnp.float32),
        jnp.array(z * 3.0, jnp.float32),
        jnp.ones(P, bool),
        jnp.array(sf),
        float(np.log(1.2)),
        8,
    )
    err = se3.log(*se3.compose(*se3.inverse(q_gt, t_gt), res.q, res.t))
    assert float(jnp.linalg.norm(err)) < 2e-3, np.asarray(err)
    assert int(res.num_inliers) > 0.8 * n


def test_fused_track_system_equivalence():
    """System-level equivalence: the fused single-dispatch path tracks the
    same synthetic slice as the classic multi-kernel path with matching
    accuracy (not bit-identical — match staging differs; ATE parity is the
    acceptance gate for defaulting use_fused_track on)."""
    import dataclasses
    import os
    import pytest
    from gmmloc.eval import ate, synthetic
    from gmmloc.gmm import mixture
    from gmmloc.pipeline.system import GMMLocSystem

    if not assets.HAVE_ASSETS:
        pytest.skip("reference assets absent")

    base = euroc_v1_config()
    base = base.replace(
        tracking=dataclasses.replace(base.tracking, velocity_damping=0.9)
    )
    gmap = mixture.load(
        assets.V1_GMM, pad_to=base.caps.gmm_components_pad,
        neighbor_dist_thresh=base.gmm.neighbor_dist_thresh,
        neighbor_cap=base.gmm.neighbor_cap,
    )
    START, N = 150, 50
    results = {}
    for use_fused in (False, True):
        cfg = base.replace(
            tracking=dataclasses.replace(base.tracking, use_fused_track=use_fused)
        )
        fe, ts, q_wc, t_wc = synthetic.make_sequence(
            cfg, **assets.EUROC_V1_01, n_frames=300, stride=1, n_landmarks=20000,
            disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
        )
        s = GMMLocSystem(cfg, gmap)
        for i in range(N):
            fi = START + i
            f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
            # pipelined default: step returns the PREVIOUS frame's stat
            # (None while the first frame is in flight)
            st = s.step(f, q_wc[fi], t_wc[fi])
            assert st is None or st.res, f"tracking failed at {i} (fused={use_fused})"
        st = s.flush()
        assert st is None or st.res
        ts_est, _, t_est = s.export_trajectory()
        m = ate.ate_rmse(ts_est, t_est, ts[START:START + N], t_wc[START:START + N])
        results[use_fused] = m["rmse"]
    assert results[True] < 0.03, f"fused ATE {results[True]*100:.2f}cm"
    assert results[False] < 0.03, f"classic ATE {results[False]*100:.2f}cm"
    # parity within 1 cm on this slice
    assert abs(results[True] - results[False]) < 0.01, results


def test_packed_matches_unpacked():
    """Bit-exact equivalence of the packed-IO fused path: identical
    trajectory, map state, and per-frame matches vs the unpacked path
    (same _track_core inside; packing is pure bit transport)."""
    import dataclasses
    import os
    import pytest
    from gmmloc.eval import synthetic
    from gmmloc.gmm import mixture
    from gmmloc.pipeline.system import GMMLocSystem

    if not assets.HAVE_ASSETS:
        pytest.skip("reference assets absent")

    base = euroc_v1_config()
    base = base.replace(
        tracking=dataclasses.replace(
            base.tracking, velocity_damping=0.9, use_fused_track=True
        )
    )
    gmap = mixture.load(
        assets.V1_GMM, pad_to=base.caps.gmm_components_pad,
        neighbor_dist_thresh=base.gmm.neighbor_dist_thresh,
        neighbor_cap=base.gmm.neighbor_cap,
    )

    def run(packed):
        cfg = base.replace(
            tracking=dataclasses.replace(base.tracking, fused_packed_io=packed)
        )
        fe, ts, q_wc, t_wc = synthetic.make_sequence(
            cfg, **assets.EUROC_V1_01, n_frames=220, stride=1, n_landmarks=20000,
            disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
        )
        s = GMMLocSystem(cfg, gmap)
        for i in range(50):
            fi = 150 + i
            f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
            st = s.step(f, q_wc[fi], t_wc[fi])
            assert st is None or st.res
        st = s.flush()
        assert st is None or st.res
        ts_e, q_e, t_e = s.export_trajectory()
        return q_e, t_e, s.world.n_keyframes(), s.world.n_points()

    a = run(False)
    b = run(True)
    np.testing.assert_allclose(a[0], b[0], atol=1e-6)
    np.testing.assert_allclose(a[1], b[1], atol=1e-6)
    assert a[2] == b[2] and a[3] == b[3]


def test_kf_refresh_ate_parity():
    """fused_map_refresh='kf' (local-map table uploaded only when the map
    changes; in-kernel carried-point exclusion) tracks with ATE parity vs
    per-frame refresh on a synthetic slice."""
    import dataclasses
    import os
    import pytest
    from gmmloc.eval import ate, synthetic
    from gmmloc.gmm import mixture
    from gmmloc.pipeline.system import GMMLocSystem

    if not assets.HAVE_ASSETS:
        pytest.skip("reference assets absent")

    base = euroc_v1_config()
    base = base.replace(
        tracking=dataclasses.replace(
            base.tracking, velocity_damping=0.9, use_fused_track=True
        )
    )
    gmap = mixture.load(
        assets.V1_GMM, pad_to=base.caps.gmm_components_pad,
        neighbor_dist_thresh=base.gmm.neighbor_dist_thresh,
        neighbor_cap=base.gmm.neighbor_cap,
    )
    START, N = 150, 50
    out = {}
    for mode in ("frame", "kf"):
        cfg = base.replace(
            tracking=dataclasses.replace(base.tracking, fused_map_refresh=mode)
        )
        fe, ts, q_wc, t_wc = synthetic.make_sequence(
            cfg, **assets.EUROC_V1_01, n_frames=220, stride=1, n_landmarks=20000,
            disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
        )
        s = GMMLocSystem(cfg, gmap)
        for i in range(N):
            fi = START + i
            f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
            st = s.step(f, q_wc[fi], t_wc[fi])
            assert st is None or st.res, f"tracking failed at {i} (mode={mode})"
        st = s.flush()
        assert st is None or st.res
        ts_e, _, t_e = s.export_trajectory()
        out[mode] = ate.ate_rmse(
            ts_e, t_e, ts[START:START + N], t_wc[START:START + N]
        )["rmse"]
    assert out["kf"] < 0.03, out
    assert abs(out["kf"] - out["frame"]) < 0.01, out
