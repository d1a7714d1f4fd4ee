"""Batched pinhole/stereo camera model with Jacobians.

JAX replacement for the aslam-derived PinholeCamera
(ref: /root/reference/gmmloc/src/cv/pinhole_camera.cpp,
include/gmmloc/cv/pinhole_camera.h:105-232) and the stereo projection
used by Frame::project3 (ref: frame.cpp:81-119).

All functions are shape-polymorphic over leading batch dims; visibility is
returned as a boolean mask instead of the reference's ProjectionResult
state machine (pinhole_camera.h:16-87).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CameraParams(NamedTuple):
    """Static pinhole intrinsics; bf = baseline*fx for the stereo model."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    bf: float = 0.0

    @classmethod
    def from_config(cls, cam) -> "CameraParams":
        return cls(cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height, cam.bf)


def project(cam: CameraParams, pc):
    """Camera-frame points (...,3) -> pixel uv (...,2) + visibility mask.

    Mirrors project3 + isKeypointVisible (pinhole_camera.cpp:45-66): valid iff
    z > 0 and the pixel lands inside the image.
    """
    z = pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / z_safe + cam.cx
    v = cam.fy * pc[..., 1] / z_safe + cam.cy
    uv = jnp.stack([u, v], axis=-1)
    visible = (
        (z > 0.0)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u < cam.width)
        & (v < cam.height)
    )
    return uv, visible


def project_jacobian(cam: CameraParams, pc):
    """d(uv)/d(pc): (...,2,3) point Jacobian (pinhole_camera.cpp project3)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zr = jnp.zeros_like(x)
    row0 = jnp.stack([cam.fx * iz, zr, -cam.fx * x * iz2], axis=-1)
    row1 = jnp.stack([zr, cam.fy * iz, -cam.fy * y * iz2], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def project_stereo(cam: CameraParams, pc):
    """Camera-frame points -> (u, v, u_right) (...,3) + visibility.

    u_right = u - bf/z (ref: frame.cpp:98-119, factors.cpp cam_project).
    """
    uv, visible = project(cam, pc)
    z = pc[..., 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    ur = uv[..., 0] - cam.bf / z_safe
    return jnp.concatenate([uv, ur[..., None]], axis=-1), visible


def unproject(cam: CameraParams, uv, depth):
    """Pixels (...,2) + depth (...,) -> camera-frame points (...,3).

    Ref: pinhole_camera.cpp unproject3:20-43.
    """
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def disparity_to_depth(cam: CameraParams, disparity):
    d = jnp.where(disparity <= 0.0, jnp.inf, disparity)
    return cam.bf / d


def depth_to_uright(cam: CameraParams, u, depth):
    z = jnp.where(depth <= 0.0, jnp.inf, depth)
    return u - cam.bf / z
