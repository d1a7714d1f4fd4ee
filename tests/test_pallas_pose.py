"""Pallas staged pose solver vs the XLA oracle (pose_solver.*).

Runs the kernel in interpret mode on the CPU; chip_smoke.py runs the
same comparison compiled for the card at F=1280. The Pallas kernel runs
the identical 4x10 schedule (per-round restart, Huber rounds 0-2, chi2
reclassification, step_tol early-freeze) so the two implementations must
agree to float tolerance: same converged pose, same inlier
classification away from the chi2 threshold boundary.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

from gmmloc.geometry import camera as cam_mod  # noqa: E402
from gmmloc.geometry import se3  # noqa: E402
from gmmloc.config import euroc_v1_config  # noqa: E402
from gmmloc.solver import pallas_pose, pose_solver  # noqa: E402

F = 256


@pytest.fixture
def cam():
    return cam_mod.CameraParams.from_config(euroc_v1_config().camera)


# 200 features exercise the padding lanes of the power-of-two block
@pytest.mark.parametrize("n_feat", [F, 200])
def test_pallas_pose_matches_xla(cam, n_feat):
    args, _ = chip_smoke.pose_problem(cam, n_feat)
    ref = pose_solver.optimize_pose(cam, *args)
    out = pallas_pose.optimize_pose(cam, *args, interpret=True)
    assert chip_smoke._rot_deg(ref.q, out.q) < 0.01
    assert float(jnp.linalg.norm(ref.t - out.t)) < 1e-3
    # inlier sets may differ only at the chi2 threshold boundary
    diff = int(jnp.sum(ref.is_outlier != out.is_outlier))
    assert diff <= 2
    assert abs(int(ref.num_inliers) - int(out.num_inliers)) <= 2


def test_pallas_pose_anchored_matches_xla(cam):
    args, aargs = chip_smoke.pose_problem(cam, F, seed=3, anchored=True)
    ref = pose_solver.optimize_pose_anchored(cam, *args, *aargs)
    out = pallas_pose.optimize_pose_anchored(cam, *args, *aargs,
                                             interpret=True)
    assert chip_smoke._rot_deg(ref.q, out.q) < 0.02
    assert float(jnp.linalg.norm(ref.t - out.t)) < 2e-3
    diff = int(jnp.sum(ref.is_outlier != out.is_outlier))
    assert diff <= 3
    adiff = int(jnp.sum(ref.anc_outlier != out.anc_outlier))
    assert adiff <= 3


def test_pallas_pose_converges_to_truth(cam):
    """Independent of the oracle: noise-free problem recovers identity."""
    rng = np.random.default_rng(7)
    uv = rng.uniform([40, 40], [cam.width - 40, cam.height - 40], (F, 2))
    z = rng.uniform(1.0, 10.0, F)
    x_w = np.stack(
        [(uv[:, 0] - cam.cx) / cam.fx * z,
         (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
    obs = np.concatenate([uv, (uv[:, 0] - cam.bf / z)[:, None]], -1)
    q0 = np.array([1.0, 0.01, -0.01, 0.005])
    q0 = q0 / np.linalg.norm(q0)
    out = pallas_pose.optimize_pose(
        cam, jnp.array(q0, jnp.float32),
        jnp.array([0.03, -0.02, 0.01], jnp.float32),
        jnp.array(x_w, jnp.float32), jnp.array(obs, jnp.float32),
        jnp.ones(F, bool), jnp.ones(F, jnp.float32), jnp.ones(F, bool),
        interpret=True)
    assert chip_smoke._rot_deg(out.q, se3.quat_identity()) < 0.01
    assert float(jnp.linalg.norm(out.t)) < 1e-3
    assert int(out.num_inliers) == F


def test_pose_impl_route():
    """TrackingConfig.pose_impl: "auto" is the XLA chain on the CPU, the
    two explicit routes are honoured, anything else is refused."""
    from gmmloc.tracking import fused

    assert fused.use_pose_kernel("auto") is False
    assert fused.use_pose_kernel("xla") is False
    assert fused.use_pose_kernel("pallas") is True
    with pytest.raises(ValueError):
        fused.use_pose_kernel("Pallas")
