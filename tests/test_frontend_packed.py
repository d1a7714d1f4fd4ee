"""Fused packed image front-end == per-stage front-end on uint8 input.

The production path (ImageFrontend.dispatch/complete) fuses rectify +
equalize + dual pyramid/detect + stereo match/refine/median-cut into ONE
device program with one packed output table. On identical uint8 inputs
it must reproduce the per-stage path bit-for-bit (same kernels, same
order; the only transport difference is the uint8 upload + f32-lane
descriptor bitcast, both exact)."""

import dataclasses

import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.pipeline.frontend import ImageFrontend


@pytest.fixture(scope="module")
def stereo_pair(rng_module=None):
    rng = np.random.default_rng(7)
    cfg = euroc_v1_config()
    cfg = cfg.replace(camera=dataclasses.replace(
        cfg.camera, do_rectify=False, do_equalization=True))
    n = 3000
    pts = np.stack([
        rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(2.0, 10.0, n),
    ], -1)
    from gmmloc.eval.image_synthetic import SpriteRenderer

    world = synthetic.SyntheticWorld(
        landmarks=pts,
        desc=rng.integers(0, 256, (n, 32), dtype=np.uint8),
        base_angle=rng.uniform(0, 360, n).astype(np.float32),
        ref_dist=np.linalg.norm(pts, axis=1).astype(np.float32),
        comp_id=np.full(n, -1, np.int32),
        response=rng.uniform(20, 80, n).astype(np.float32),
    )
    renderer = SpriteRenderer(world, cfg, seed=1)
    left, right = renderer.render_stereo(
        np.array([1.0, 0, 0, 0]), np.zeros(3)
    )
    to8 = lambda im: np.clip(np.round(np.asarray(im)), 0, 255).astype(np.uint8)
    return cfg, to8(left), to8(right)


def test_packed_matches_per_stage(stereo_pair):
    cfg, left, right = stereo_pair
    fe = ImageFrontend(cfg)
    f1 = fe.process(0, 0.0, left, right)
    f2 = fe.process_packed(1, 0.0, left, right)
    n = cfg.frame.num_features
    assert np.array_equal(f1.valid[:n], f2.valid[:n])
    assert np.allclose(f1.uv[:n], f2.uv[:n], atol=1e-4)
    assert np.array_equal(f1.desc[:n], f2.desc[:n])
    assert np.allclose(f1.angle[:n], f2.angle[:n], atol=1e-3)
    m1, m2 = f1.ur[:n] >= 0, f2.ur[:n] >= 0
    assert m1.sum() > 100  # the pair actually produces stereo matches
    # the packed path is ONE fused program: XLA fusion may shift the
    # last ulp of the equalize/pyramid float chain, flipping matches
    # that sit exactly on the median-SAD threshold — allow a couple
    assert int((m1 != m2).sum()) <= 3, int((m1 != m2).sum())
    c = m1 & m2
    assert np.allclose(f1.ur[:n][c], f2.ur[:n][c], atol=1e-3)
    assert np.allclose(f1.depth[:n][c], f2.depth[:n][c], atol=1e-3)


def test_dispatch_complete_double_buffer(stereo_pair):
    """Two in-flight front-end dispatches complete in order with
    consistent results (the double-buffered production driver)."""
    cfg, left, right = stereo_pair
    fe = ImageFrontend(cfg)
    p0 = fe.dispatch(0, 0.0, left, right)
    p1 = fe.dispatch(1, 0.1, left, right)  # same pair: results must agree
    f0 = fe.complete(p0)
    f1 = fe.complete(p1)
    n = cfg.frame.num_features
    assert np.array_equal(f0.desc[:n], f1.desc[:n])
    assert np.allclose(f0.uv[:n], f1.uv[:n])
    assert f0.idx == 0 and f1.idx == 1
