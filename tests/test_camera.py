"""Camera model unit tests: analytic Jacobian vs jax.jacfwd oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from gmmloc.config import CameraConfig
from gmmloc.geometry import camera as cam_mod

CAM = cam_mod.CameraParams.from_config(CameraConfig())


def test_project_unproject_roundtrip(rng):
    uv = rng.uniform([0, 0], [CAM.width, CAM.height], size=(64, 2))
    depth = rng.uniform(0.5, 30.0, size=(64,))
    pc = cam_mod.unproject(CAM, jnp.array(uv), jnp.array(depth))
    uv2, vis = cam_mod.project(CAM, pc)
    assert bool(jnp.all(vis))
    np.testing.assert_allclose(np.asarray(uv2), uv, atol=1e-3)


def test_project_visibility():
    pc = jnp.array(
        [
            [0.0, 0.0, 1.0],     # center: visible
            [0.0, 0.0, -1.0],    # behind: not
            [100.0, 0.0, 1.0],   # off-image: not
        ]
    )
    _, vis = cam_mod.project(CAM, pc)
    assert list(np.asarray(vis)) == [True, False, False]


def test_project_jacobian_matches_autodiff(rng):
    pc = jnp.array(rng.uniform([-2, -2, 0.5], [2, 2, 20], size=(32, 3)))
    J = cam_mod.project_jacobian(CAM, pc)
    J_ad = jax.vmap(jax.jacfwd(lambda p: cam_mod.project(CAM, p)[0]))(pc)
    np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), rtol=1e-4, atol=1e-4)


def test_stereo_projection_consistency(rng):
    pc = jnp.array(rng.uniform([-2, -2, 0.5], [2, 2, 20], size=(16, 3)))
    uvr, _ = cam_mod.project_stereo(CAM, pc)
    # disparity = u - u_right = bf / z
    disp = uvr[..., 0] - uvr[..., 2]
    np.testing.assert_allclose(np.asarray(disp), CAM.bf / np.asarray(pc[..., 2]), rtol=1e-5)
    depth = cam_mod.disparity_to_depth(CAM, disp)
    np.testing.assert_allclose(np.asarray(depth), np.asarray(pc[..., 2]), rtol=1e-5)
