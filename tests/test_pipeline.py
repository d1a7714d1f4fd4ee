"""Pipeline-level tests: short end-to-end synthetic run, ATE scoring,
sharded kernels on the virtual device mesh, rectification."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.eval import ate, synthetic
from gmmloc.geometry import se3
from gmmloc.gmm import mixture
from gmmloc.mapping.map_state import _inverse
from gmmloc.pipeline.system import GMMLocSystem
from tests import assets

HAVE_ASSETS = assets.HAVE_ASSETS


# ---------------------------------------------------------------------------
# ATE metric
# ---------------------------------------------------------------------------


def test_umeyama_recovers_similarity(rng):
    x = rng.standard_normal((3, 50))
    R_gt, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(R_gt) < 0:
        R_gt[:, 0] *= -1
    t_gt = rng.standard_normal(3)
    c_gt = 1.7
    y = c_gt * R_gt @ x + t_gt[:, None]
    r, t, c = ate.umeyama_alignment(x, y)
    np.testing.assert_allclose(r, R_gt, atol=1e-8)
    np.testing.assert_allclose(c, c_gt, atol=1e-8)
    np.testing.assert_allclose(t, t_gt, atol=1e-8)


def test_ate_zero_for_identical(rng):
    ts = np.arange(30) * 0.05
    p = rng.standard_normal((30, 3))
    m = ate.ate_rmse(ts, p, ts, p)
    assert m["rmse"] < 1e-9 and m["n"] == 30


# ---------------------------------------------------------------------------
# end-to-end synthetic slice (the demo milestone, SURVEY.md §7 step 6)
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not HAVE_ASSETS, reason="reference assets absent")
def test_end_to_end_tracking_accuracy():
    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, **assets.EUROC_V1_01, n_frames=400, stride=1, n_landmarks=20000,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
    )
    START, N = 150, 60
    gmap = mixture.load(
        assets.V1_GMM, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
    )
    s = GMMLocSystem(cfg, gmap)
    frames = []
    for i in range(N):
        fi = START + i
        f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
        st = s.step(f, q_wc[fi], t_wc[fi])
        assert st is None or st.res, f"tracking failed at {i}"
        frames.append((f, fi))
    s.flush()  # pipelined mode: final poses land at drain
    errs = np.array([
        np.linalg.norm(_inverse(f.q_cw, f.t_cw)[1] - t_wc[fi])
        for f, fi in frames
    ])
    assert errs.max() < 0.05, f"max frame error {errs.max()*100:.1f}cm"
    # trajectory export exists and scores
    ts_est, q_est, t_est = s.export_trajectory()
    m = ate.ate_rmse(ts_est, t_est, ts[START : START + N], t_wc[START : START + N])
    assert m["rmse"] < 0.03, m


# ---------------------------------------------------------------------------
# sharded kernels on the 8-device virtual mesh
# ---------------------------------------------------------------------------


def test_sharded_association_matches_single_device(rng):
    from gmmloc.geometry import camera as cam_mod
    from gmmloc.config import CameraConfig
    from gmmloc.gmm import render
    from gmmloc.parallel import sharding

    cam = cam_mod.CameraParams.from_config(CameraConfig())
    K = 128
    means = np.stack(
        [rng.uniform(-3, 3, K), rng.uniform(-2, 2, K), rng.uniform(5, 7, K)], -1
    )
    covs = np.tile(np.diag([0.04, 0.04, 1e-6]), (K, 1, 1))
    gmap = mixture.from_arrays(means, covs, pad_to=K)
    q, t = se3.quat_identity(), jnp.zeros(3)
    r_single = render.render_view(gmap, cam, q, t)

    mesh = sharding.make_mesh(8)
    gmap_sh = sharding.shard_gmm_map(gmap, mesh)
    r_sh = sharding.render_view_sharded(gmap_sh, cam, q, t, mesh)
    np.testing.assert_array_equal(
        np.asarray(r_single.visible), np.asarray(r_sh.visible)
    )

    uv = jnp.array(rng.uniform([0, 0], [752, 480], (32, 2)), jnp.float32)
    c1 = render.search_correspondence(r_single, uv, jnp.ones(32, bool))
    c2 = sharding.search_correspondence_sharded(r_sh, uv, jnp.ones(32, bool), mesh)
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


def test_dryrun_multichip_entrypoint():
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as g

    fn, args = g.entry()
    out = np.asarray(fn(*args))
    assert int(out[7]) > 0  # packed layout: [q(4) t(3) n_inl ...]
    g.dryrun_multichip(8)


# ---------------------------------------------------------------------------
# rectification
# ---------------------------------------------------------------------------


def test_rectifier_loads_reference_yaml():
    if not assets.EUROC_DIR:
        pytest.skip("EuRoC rectification yaml absent (GMMLOC_EUROC_DATA)")
    path = os.path.join(assets.EUROC_DIR, "..", "cfg", "euroc_rect.yaml")
    from gmmloc.pipeline.rectify import Rectifier

    r = Rectifier(path)
    img = np.random.default_rng(0).uniform(0, 255, (480, 752)).astype(np.float32)
    out = np.asarray(r.rectify_left(img))
    assert out.shape == (480, 752)
    assert np.isfinite(out).all()


def test_equalize_hist_spreads_range():
    from gmmloc.pipeline.rectify import equalize_hist

    img = np.full((64, 64), 100.0, np.float32)
    img[:32] = 110.0
    out = np.asarray(equalize_hist(jnp.array(img)))
    assert out.min() < 50 and out.max() > 200


def test_end_to_end_determinism():
    """Two identical runs produce bit-identical trajectories and map state
    (SURVEY.md §4: determinism is a required test pillar — the reference's
    only nod to nondeterminism is its 5-runs protocol)."""
    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )
    room = synthetic.seeded_room(40, seed=1, n_components=400)
    gmap = mixture.for_config(room.means, room.covs, cfg)

    def run():
        # rebuild the synthetic front-end per run: its observation-noise
        # stream is stateful (advances per make_frame call), and the test
        # isolates SYSTEM determinism, not harness state
        fe, ts, q_wc, t_wc = synthetic.make_sequence(
            cfg, gmm=(room.means, room.covs), trajectory=room.trajectory,
            n_landmarks=12000, disp_noise=0.1, pixel_noise=0.25,
            drop_frac=0.1,
        )
        s = GMMLocSystem(cfg, gmap)
        for i in range(40):
            f = fe.make_frame(i, ts[i], q_wc[i], t_wc[i])
            st = s.step(f, q_wc[i], t_wc[i])
            assert st is None or st.res
        ts_e, q_e, t_e = s.export_trajectory()
        return ts_e, q_e, t_e, s.world.n_keyframes(), s.world.n_points()

    a = run()
    b = run()
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    assert a[3] == b[3] and a[4] == b[4]
