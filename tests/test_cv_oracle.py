"""OpenCV-oracle fidelity gates for the ORB front-end (SURVEY §7 step 3).

The BRIEF pattern and keypoint distribution are documented deviations
(README "deliberate deviations"), so the gates are BEHAVIORAL, not
bitwise: detector repeatability against cv2 FAST, and end-to-end
match precision/recall against a cv2-ORB + BFMatcher oracle on the same
image pair with geometric ground truth.

Ref counterpart: orb_extractor.cpp:988-1050 (detection),
orb_matcher.cpp (matching); the reference links stock OpenCV for both.
"""

import dataclasses

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.eval.image_synthetic import SpriteRenderer
from gmmloc.features import detect, matching
from gmmloc.mapping.map_state import _quat_to_mat

import jax.numpy as jnp


@pytest.fixture(scope="module")
def stereo_world():
    cfg = euroc_v1_config()
    cfg = cfg.replace(
        camera=dataclasses.replace(cfg.camera, do_rectify=False,
                                   do_equalization=False)
    )
    rng = np.random.default_rng(7)
    n = 4000
    pts = np.stack([
        rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(2.5, 9, n)
    ], -1)
    world = synthetic.SyntheticWorld(
        landmarks=pts,
        desc=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        base_angle=rng.uniform(0, 360, n).astype(np.float32),
        ref_dist=np.linalg.norm(pts, axis=1).astype(np.float32),
        comp_id=np.full(n, -1, np.int32),
        response=rng.uniform(20, 80, n).astype(np.float32),
    )
    renderer = SpriteRenderer(world, cfg, seed=1)
    q_id = np.array([1.0, 0, 0, 0])
    t0 = np.zeros(3)
    img0 = np.asarray(renderer.render(q_id, t0))
    # second view: small rotation + translation (known geometry)
    ang = np.deg2rad(2.0)
    q1 = np.array([np.cos(ang / 2), 0, np.sin(ang / 2), 0])
    t1 = np.array([0.06, 0.01, 0.02])
    img1 = np.asarray(renderer.render(q1, t1))
    return cfg, renderer, img0, img1, (q_id, t0), (q1, t1), world


def _project(cfg, q_wc, t_wc, pts):
    cam = cfg.camera
    R_cw = _quat_to_mat(q_wc).T
    pc = pts @ R_cw.T + (-R_cw @ t_wc)
    z = pc[:, 2]
    u = cam.fx * pc[:, 0] / z + cam.cx
    v = cam.fy * pc[:, 1] / z + cam.cy
    return np.stack([u, v], -1), z


def test_fast_detector_repeatability_vs_opencv(stereo_world):
    """Most of our FAST+NMS keypoints sit within 2px of a cv2 FAST
    keypoint on the same image (level 0)."""
    cfg, _, img0, *_ = stereo_world
    det = detect.ORBDetector(img0.shape[0], img0.shape[1],
                             num_features=800, num_levels=1)
    d = det(jnp.asarray(img0, jnp.float32))
    ours = np.asarray(d.uv)[np.asarray(d.valid)]

    fastd = cv2.FastFeatureDetector_create(threshold=18)
    kps = fastd.detect(img0.astype(np.uint8), None)
    theirs = np.array([k.pt for k in kps], np.float32)
    assert len(theirs) > 100, "oracle found too few corners (bad fixture)"

    dist = np.linalg.norm(ours[:, None, :] - theirs[None, :, :], axis=-1)
    near = (dist.min(axis=1) <= 2.0).mean()
    assert near > 0.7, f"only {near:.0%} of our keypoints near a cv2 corner"


def _match_precision(uv0, uv1, m01, gt_uv0, gt_uv1, world_pts, cfg, pose0, pose1):
    """Fraction of proposed matches whose implied displacement agrees with
    the ground-truth scene flow within 3px."""
    # map each detected point to its nearest rendered landmark in view 0
    p0, z0 = _project(cfg, *pose0, world_pts)
    p1, z1 = _project(cfg, *pose1, world_pts)
    ok = 0
    total = 0
    for i, j in m01:
        d0 = np.linalg.norm(p0 - uv0[i], axis=1)
        k = np.argmin(d0)
        if d0[k] > 3.0:
            continue  # unattributable detection; skip
        total += 1
        if np.linalg.norm(p1[k] - uv1[j]) <= 3.0:
            ok += 1
    return (ok / total if total else 0.0), total


def test_match_rate_vs_opencv_orb(stereo_world):
    """End-to-end detector+descriptor+matcher: precision within 10% of a
    cv2 ORB + crossCheck-BFMatcher oracle, and at least half its
    geometrically-verified match count."""
    cfg, _, img0, img1, pose0, pose1, world = stereo_world

    det = detect.ORBDetector(img0.shape[0], img0.shape[1],
                             num_features=800, num_levels=4)
    d0 = det(jnp.asarray(img0, jnp.float32))
    d1 = det(jnp.asarray(img1, jnp.float32))
    m, _ = matching.mutual_best_match(
        d0.desc, d0.valid, d1.desc, d1.valid, max_dist=matching.TH_LOW
    )
    m = np.asarray(m)
    uv0 = np.asarray(d0.uv)
    uv1 = np.asarray(d1.uv)
    ours = [(i, m[i]) for i in np.where(m >= 0)[0]]
    prec_ours, n_ours = _match_precision(
        uv0, uv1, ours, None, None, world.landmarks, cfg, pose0, pose1
    )

    orb = cv2.ORB_create(nfeatures=800)
    k0, dd0 = orb.detectAndCompute(img0.astype(np.uint8), None)
    k1, dd1 = orb.detectAndCompute(img1.astype(np.uint8), None)
    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    raw = bf.match(dd0, dd1)
    raw = [r for r in raw if r.distance <= matching.TH_LOW]
    cu0 = np.array([k.pt for k in k0], np.float32)
    cu1 = np.array([k.pt for k in k1], np.float32)
    theirs = [(r.queryIdx, r.trainIdx) for r in raw]
    prec_cv, n_cv = _match_precision(
        cu0, cu1, theirs, None, None, world.landmarks, cfg, pose0, pose1
    )

    assert n_cv > 50, "oracle produced too few matches (bad fixture)"
    assert n_ours >= 0.5 * n_cv, f"match count {n_ours} vs oracle {n_cv}"
    # tightened from -0.10 (VERDICT r2 #8): the G-II BRIEF pattern
    # measured 96.1% on this fixture vs the oracle's 93.9%
    assert prec_ours >= prec_cv - 0.05, (
        f"precision {prec_ours:.2f} vs oracle {prec_cv:.2f}"
    )


def test_descriptor_distance_separation(stereo_world):
    """Matched-pair Hamming distances must separate cleanly from the
    random-pair background (VERDICT r2 #8: distribution check). A weak
    pattern (correlated tests) collapses the background toward the
    matched mode and the matcher loses discrimination."""
    cfg, _, img0, img1, pose0, pose1, world = stereo_world
    det = detect.ORBDetector(img0.shape[0], img0.shape[1],
                             num_features=800, num_levels=4)
    d0 = det(jnp.asarray(img0, jnp.float32))
    d1 = det(jnp.asarray(img1, jnp.float32))
    m, md = matching.mutual_best_match(
        d0.desc, d0.valid, d1.desc, d1.valid, max_dist=matching.TH_LOW
    )
    m = np.asarray(m)
    qi = np.where(m >= 0)[0]
    assert len(qi) > 80
    matched = np.asarray(md)[qi]

    # random-pair background over valid descriptors
    a = np.asarray(d0.desc)[np.asarray(d0.valid)]
    b = np.asarray(d1.desc)[np.asarray(d1.valid)]
    rng = np.random.default_rng(0)
    ia = rng.integers(0, len(a), 4000)
    ib = rng.integers(0, len(b), 4000)
    pop = np.unpackbits(a[ia] ^ b[ib], axis=1).sum(1)

    # background mode near 128 (uncorrelated bits), matched mode far below
    assert np.median(pop) > 100, f"background median {np.median(pop)}"
    assert np.median(matched) < matching.TH_LOW, np.median(matched)
    # separation: background p5 above the matcher acceptance threshold
    assert np.percentile(pop, 5) > matching.TH_LOW, (
        np.percentile(pop, 5),
    )
