"""GMM map engine tests: proto parsing against the real v1.gmm asset,
gaussian math against numpy/scipy oracles, render/associate invariants."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from gmmloc.config import CameraConfig
from gmmloc.geometry import camera as cam_mod
from gmmloc.geometry import se3
from gmmloc.gmm import gaussian, mixture, render
from gmmloc.utils import proto
from tests import assets

CAM = cam_mod.CameraParams.from_config(CameraConfig())


def make_random_components(rng, k=64):
    means = rng.uniform(-5, 5, size=(k, 3))
    A = rng.standard_normal((k, 3, 3)) * 0.3
    covs = A @ A.transpose(0, 2, 1) + np.eye(3) * 1e-3
    # make a third of them degenerate (planar)
    for i in range(0, k, 3):
        w, V = np.linalg.eigh(covs[i])
        w[0] = 1e-6
        covs[i] = (V * w) @ V.T
    return means, covs


# ---------------------------------------------------------------------------
# proto IO
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not assets.HAVE_ASSETS, reason="EuRoC map absent (GMMLOC_EUROC_DATA)")
def test_load_real_v1_map():
    means, covs, deg, sal = proto.load_gmm_file(assets.V1_GMM)
    assert means.shape == (3299, 3)  # SURVEY.md: v1 = 3299 components
    assert covs.shape == (3299, 3, 3)
    # covariances must be symmetric PSD
    np.testing.assert_allclose(covs, covs.transpose(0, 2, 1), atol=1e-12)
    evals = np.linalg.eigvalsh(covs)
    assert (evals[:, 0] > -1e-10).all()
    # means inside a plausible room-scale bounding box
    assert np.abs(means).max() < 50.0


def test_proto_roundtrip(rng, tmp_path):
    means, covs = make_random_components(rng, 17)
    path = str(tmp_path / "test.gmm")
    proto.save_gmm_file(path, means, covs, deg=np.ones(17, bool))
    m2, c2, d2, _ = proto.load_gmm_file(path)
    np.testing.assert_allclose(m2, means, rtol=1e-15)
    np.testing.assert_allclose(c2, covs, rtol=1e-15)
    assert d2.all()


# ---------------------------------------------------------------------------
# gaussian math
# ---------------------------------------------------------------------------


def test_decompose_flags(rng):
    means, covs = make_random_components(rng, 30)
    gmap = mixture.from_arrays(means, covs)
    deg = np.asarray(gmap.is_degenerated)
    evals = np.linalg.eigvalsh(covs)
    np.testing.assert_array_equal(deg[:30], evals[:, 0] < 1e-4)
    # normal is the smallest-eigenvalue direction
    _, V = np.linalg.eigh(covs[0])
    n = np.asarray(gmap.normal[0])
    assert abs(abs(n @ V[:, 0]) - 1.0) < 1e-4


def test_chi2_matches_numpy(rng):
    means, covs = make_random_components(rng, 8)
    x = rng.standard_normal((8, 3))
    ci = np.linalg.inv(covs)
    ref = np.einsum("ni,nij,nj->n", x - means, ci, x - means)
    ours = gaussian.chi2(jnp.array(means), jnp.array(ci), jnp.array(x))
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=1e-4)


def test_bhattacharyya_3d_symmetry_and_zero(rng):
    means, covs = make_random_components(rng, 6)
    det = np.linalg.det(covs)
    m, c, d = jnp.array(means), jnp.array(covs), jnp.array(det)
    bh_ab = gaussian.bhattacharyya_3d(m[:3], c[:3], d[:3], m[3:], c[3:], d[3:])
    bh_ba = gaussian.bhattacharyya_3d(m[3:], c[3:], d[3:], m[:3], c[:3], d[:3])
    np.testing.assert_allclose(np.asarray(bh_ab), np.asarray(bh_ba), rtol=1e-4)
    bh_aa = gaussian.bhattacharyya_3d(m, c, d, m, c, d)
    # f32 log-det noise on near-singular (degenerate) covariances
    np.testing.assert_allclose(np.asarray(bh_aa), 0.0, atol=5e-3)


def test_eig2x2_matches_numpy(rng):
    A = rng.standard_normal((32, 2, 2))
    covs = A @ A.transpose(0, 2, 1) + np.eye(2) * 1e-3
    evals, theta = gaussian.eig2x2(jnp.array(covs))
    ref = np.linalg.eigvalsh(covs)
    np.testing.assert_allclose(np.asarray(evals), ref, rtol=1e-4, atol=1e-5)


def test_neighbor_graph_matches_bruteforce(rng):
    means, covs = make_random_components(rng, 40)
    det = np.linalg.det(covs)
    nb = mixture.build_neighbor_graph(
        means, covs, det, np.ones(40, bool), thresh=2.5, cap=16
    )
    # brute-force numpy BH
    for i in range(5):
        ref = []
        for j in range(40):
            if j == i:
                continue
            cov = 0.5 * (covs[i] + covs[j])
            delta = means[j] - means[i]
            d0 = delta @ np.linalg.solve(cov, delta) / 8.0
            d1 = 0.5 * np.log(np.linalg.det(cov) / np.sqrt(det[i] * det[j]))
            if d0 + d1 < 2.5:
                ref.append(j)
        got = set(nb[i][nb[i] >= 0].tolist())
        assert got == set(ref), f"component {i}"


# ---------------------------------------------------------------------------
# render + associate
# ---------------------------------------------------------------------------


def make_map_in_front(rng, k=64, pad_to=None):
    """Components spread on a wall ~6m in front of the identity camera."""
    means = np.stack(
        [
            rng.uniform(-3, 3, size=k),
            rng.uniform(-2, 2, size=k),
            np.full(k, 6.0) + rng.uniform(-0.5, 0.5, size=k),
        ],
        axis=-1,
    )
    covs = np.zeros((k, 3, 3))
    covs[:] = np.diag([0.04, 0.04, 1e-6])  # planar patches facing the camera
    return mixture.from_arrays(means, covs, pad_to=pad_to)


def test_render_view_visibility(rng):
    gmap = make_map_in_front(rng, 64, pad_to=80)
    q = se3.quat_identity()
    t = jnp.zeros(3)
    r = render.render_view(gmap, CAM, q, t)
    vis = np.asarray(r.visible)
    # overlapping patches are deduped (keep-nearest), so not all 64 survive
    assert vis[:64].sum() > 20
    assert not vis[64:].any()   # padding never visible
    # depths are ~6m for visible ones
    d = np.asarray(r.depth)[vis]
    assert (np.abs(d - 6.0) < 1.0).all()


def test_render_view_behind_camera(rng):
    gmap = make_map_in_front(rng, 32)
    # rotate camera 180° about y: wall is now behind
    q = jnp.array([0.0, 0.0, 1.0, 0.0])
    r = render.render_view(gmap, CAM, q, jnp.zeros(3))
    assert not np.asarray(r.visible).any()


def test_render_view_cos_gate():
    # one degenerate component whose plane normal is perpendicular to the
    # viewing ray -> must be culled by the 78° view-cos gate
    means = np.array([[0.0, 0.0, 6.0]])
    covs = np.zeros((1, 3, 3))
    covs[0] = np.diag([1e-6, 0.09, 0.09])  # normal along x, ray along z
    gmap = mixture.from_arrays(means, covs)
    r = render.render_view(gmap, CAM, se3.quat_identity(), jnp.zeros(3))
    assert not np.asarray(r.visible).any()


def test_render_occlusion_keeps_nearest():
    # two identical overlapping patches at different depths
    means = np.array([[0.0, 0.0, 4.0], [0.05, 0.0, 8.0]])
    covs = np.zeros((2, 3, 3))
    covs[:] = np.diag([0.2, 0.2, 1e-6])
    gmap = mixture.from_arrays(means, covs)
    r = render.render_view(gmap, CAM, se3.quat_identity(), jnp.zeros(3))
    vis = np.asarray(r.visible)
    assert vis[0] and not vis[1]


def test_search_correspondence(rng):
    gmap = make_map_in_front(rng, 64, pad_to=80)
    r = render.render_view(gmap, CAM, se3.quat_identity(), jnp.zeros(3))
    mean2d = np.asarray(r.mean2d)
    vis = np.asarray(r.visible)
    vi = np.where(vis)[0]
    # query exactly at some projected means -> nearest candidate is that comp
    feat_uv = jnp.array(mean2d[vi[:10]])
    cand = render.search_correspondence(r, feat_uv, jnp.ones(10, bool))
    cand = np.asarray(cand)
    assert (cand[:, 0] == vi[:10]).all()
    # far-away query -> all gated out by mahalanobis
    far = jnp.array([[5000.0, 5000.0]])
    c2 = render.search_correspondence(r, far, jnp.ones(1, bool))
    assert (np.asarray(c2) == -1).all()


def test_query_point_3d(rng):
    gmap = make_map_in_front(rng, 64, pad_to=80)
    pts = gmap.means[:5] + 0.01
    res = render.query_point_3d(gmap, pts, jnp.ones(5, bool))
    np.testing.assert_array_equal(np.asarray(res), np.arange(5))
