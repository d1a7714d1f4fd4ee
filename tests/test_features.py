"""Image front-end tests: FAST/ORB/stereo on rasterized synthetic scenes."""

import jax.numpy as jnp
import numpy as np
import pytest

from gmmloc.config import CameraConfig
from gmmloc.features import detect, fast, matching, orb, pyramid, stereo
from gmmloc.geometry import camera as cam_mod

CAM = cam_mod.CameraParams.from_config(CameraConfig())
H, W = 480, 752


def render_sprites(uv, intensity, size, h=H, w=W, bg=40.0):
    """Rasterize gaussian blobs; ~checkerboard corners via square sprites."""
    img = np.full((h, w), bg, np.float32)
    for (u, v), a, s in zip(uv, intensity, size):
        iu, iv = int(round(u)), int(round(v))
        r = int(3 * s)
        y0, y1 = max(0, iv - r), min(h, iv + r + 1)
        x0, x1 = max(0, iu - r), min(w, iu + r + 1)
        if y1 <= y0 or x1 <= x0:
            continue
        ys = np.arange(y0, y1)[:, None] - v
        xs = np.arange(x0, x1)[None, :] - u
        blob = a * np.exp(-(ys**2 + xs**2) / (2 * s * s))
        img[y0:y1, x0:x1] += blob
    return np.clip(img, 0, 255)


def scene(rng, n=250, seed_offset=0.0):
    uv = rng.uniform([30, 30], [W - 30, H - 30], size=(n, 2)) + seed_offset
    inten = rng.uniform(60, 180, n) * np.sign(rng.standard_normal(n))
    size = rng.uniform(1.2, 2.5, n)
    return uv, inten, size


def test_fast_detects_blobs(rng):
    uv, inten, size = scene(rng, 150)
    img = render_sprites(uv, inten, size)
    score = fast.nms3x3(fast.fast_score(jnp.array(img)))
    kp_uv, resp, valid = fast.select_keypoints(score, quota=512)
    kp = np.asarray(kp_uv)[np.asarray(valid)]
    assert len(kp) > 100
    # most detections are near a sprite center
    d = np.linalg.norm(kp[:, None, :] - uv[None, :, :], axis=-1).min(1)
    assert np.median(d) < 4.0


def test_orb_detector_end_to_end(rng):
    uv, inten, size = scene(rng, 300)
    img = render_sprites(uv, inten, size)
    det = detect.ORBDetector(H, W, num_features=600)
    out = det(jnp.array(img))
    valid = np.asarray(out.valid)
    assert valid.sum() > 200
    assert np.asarray(out.desc).shape[1] == 32
    # angles well-defined
    ang = np.asarray(out.angle)[valid]
    assert ((ang >= 0) & (ang < 360)).all()


def test_descriptor_repeatability(rng):
    """Same scene shifted by 5px -> matched descriptors, small Hamming."""
    uv, inten, size = scene(rng, 250)
    img1 = render_sprites(uv, inten, size)
    img2 = render_sprites(uv + np.array([5.0, 3.0]), inten, size)
    det = detect.ORBDetector(H, W, num_features=600)
    o1, o2 = det(jnp.array(img1)), det(jnp.array(img2))
    m, d = matching.mutual_best_match(
        o1.desc, o1.valid, o2.desc, o2.valid, max_dist=matching.TH_LOW
    )
    m = np.asarray(m)
    matched = m >= 0
    assert matched.sum() > 80
    # matched pairs displaced by ~(5,3)
    uv1 = np.asarray(o1.uv)[matched]
    uv2 = np.asarray(o2.uv)[m[matched]]
    delta = uv2 - uv1
    med = np.median(delta, axis=0)
    np.testing.assert_allclose(med, [5.0, 3.0], atol=1.5)


def test_stereo_depth_recovery(rng):
    """Render left/right views of a fronto-parallel wall; recover depth."""
    z_true = 6.0
    n = 220
    uv_l = rng.uniform([60, 30], [W - 30, H - 30], size=(n, 2))
    disparity = CAM.bf / z_true
    uv_r = uv_l - np.array([disparity, 0.0])
    inten = rng.uniform(80, 170, n) * np.sign(rng.standard_normal(n))
    size = rng.uniform(1.2, 2.2, n)
    img_l = render_sprites(uv_l, inten, size)
    img_r = render_sprites(uv_r, inten, size)

    det = detect.ORBDetector(H, W, num_features=600)
    ol = det(jnp.array(img_l))
    orr = det(jnp.array(img_r))
    shapes = det.shapes
    pyr_l = pyramid.build_pyramid(jnp.array(img_l), shapes)
    pyr_r = pyramid.build_pyramid(jnp.array(img_r), shapes)
    sf = 1.2 ** np.arange(8)
    ur, depth = stereo.compute_stereo_matches(
        pyr_l, pyr_r,
        ol.uv, ol.octave, ol.desc, ol.valid,
        orr.uv, orr.octave, orr.desc, orr.valid,
        sf.astype(np.float32), bf=CAM.bf, baseline=CAM.bf / CAM.fx, n_levels=8,
    )
    depth = np.asarray(depth)
    got = depth[depth > 0]
    assert len(got) > 60
    med = np.median(got)
    assert abs(med - z_true) < 0.3, med


@pytest.mark.parametrize("n,m", [(77, 133), (1, 5), (1280, 301)])
def test_hamming_matrix_matches_numpy_popcount(rng, n, m):
    """The XLA Hamming matrix (xor + popcount + sum, fused by XLA) is
    exact against a numpy bit count at odd shapes."""
    from gmmloc.features import matching

    a = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    ref = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)
    out = np.asarray(matching.hamming_matrix(jnp.array(a), jnp.array(b)))
    np.testing.assert_array_equal(out, ref)


def test_octree_selection_covers_coarse_cells(rng):
    """select_keypoints_octree must give every occupied coarse (96px)
    cell a keypoint before dense regions get seconds — the
    DistributeOctTree spatial-spread guarantee (orb_extractor.cpp:529)."""
    import jax.numpy as jnp

    from gmmloc.features import fast

    score = np.zeros((480, 752), np.float32)
    # a dense cluster + isolated singles in far coarse cells
    for _ in range(400):
        y, x = rng.integers(30, 110), rng.integers(30, 110)
        score[y, x] = rng.uniform(8, 60)
    singles = [(250, 400), (460 - 20, 730 - 20), (100, 600), (400, 100)]
    for (y, x) in singles:
        score[y, x] = 9.0
    uv, resp, valid = fast.select_keypoints_octree(
        jnp.array(score), quota=40
    )
    uv = np.asarray(uv)[np.asarray(valid)]
    # every isolated single must be selected (its coarse cell is
    # otherwise empty), despite the dense cluster's higher responses
    for (y, x) in singles:
        assert ((uv[:, 0] == x) & (uv[:, 1] == y)).any(), (y, x)
    # no duplicate pixels
    keys = uv[:, 1] * 752 + uv[:, 0]
    assert len(np.unique(keys)) == len(keys)
