"""Stereo rectification: precomputed remap grids + device bilinear gather.

JAX replacement for cv_utils::Rectify
(ref: /root/reference/gmmloc/src/utils/cv_utils.cpp:9-54, config
gmmloc_ros/cfg/euroc_rect.yaml). OpenCV's initUndistortRectifyMap /
remap become: a host-side numpy map computation (radtan model, done once
at startup) and a jitted bilinear gather applied per frame on device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import yaml


def compute_rectify_map(K, D, R, P, width: int, height: int):
    """Per-pixel source coordinates for undistort+rectify.

    For each destination pixel: x_n = P^-1 [u v 1] (normalized, rectified),
    rotate back by R^-1, apply radtan distortion, project through K.
    Mirrors cv::initUndistortRectifyMap math.
    Returns map_x, map_y float32 (H, W).
    """
    K = np.asarray(K, np.float64).reshape(3, 3)
    D = np.asarray(D, np.float64).ravel()
    R = np.asarray(R, np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64).reshape(3, -1)[:, :3]

    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    x = (us - P[0, 2]) / P[0, 0]
    y = (vs - P[1, 2]) / P[1, 1]
    ones = np.ones_like(x)
    pts = np.stack([x, y, ones], axis=-1) @ np.linalg.inv(R).T
    xp = pts[..., 0] / pts[..., 2]
    yp = pts[..., 1] / pts[..., 2]

    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    r2 = xp * xp + yp * yp
    radial = 1.0 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = xp * radial + 2 * p1 * xp * yp + p2 * (r2 + 2 * xp * xp)
    yd = yp * radial + p1 * (r2 + 2 * yp * yp) + 2 * p2 * xp * yp

    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


@jax.jit
def remap_bilinear(img, map_x, map_y):
    """Bilinear remap (cv::remap equivalent), border = clamp."""
    h, w = img.shape
    x0 = jnp.floor(map_x)
    y0 = jnp.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


@jax.jit
def equalize_hist(img):
    """Histogram equalization (cv::equalizeHist equivalent) for [0,255]."""
    i8 = jnp.clip(img, 0, 255).astype(jnp.int32)
    hist = jnp.zeros(256, jnp.float32).at[i8.reshape(-1)].add(1.0)
    cdf = jnp.cumsum(hist)
    n = img.size
    cdf_min = cdf[jnp.argmax(hist > 0)]  # first non-empty bin's cdf
    lut = jnp.clip(
        jnp.round((cdf - cdf_min) / jnp.maximum(n - cdf_min, 1.0) * 255.0), 0, 255
    )
    return lut[i8]


class Rectifier:
    """Loads the reference's euroc_rect.yaml schema and rectifies frames."""

    def __init__(self, yaml_path: str):
        with open(yaml_path) as f:
            txt = f.read()
        # OpenCV FileStorage yaml is not valid YAML ("%YAML:1.0" directive,
        # "!!opencv-matrix" tags, "data:[..." without a space) — normalize.
        txt = txt.replace("%YAML:1.0", "").replace("!!opencv-matrix", "")
        txt = txt.replace("data:[", "data: [")
        cfg = yaml.safe_load(txt)

        def mat(side, name):
            node = cfg[f"{side}.{name}"]
            return np.array(node["data"], np.float64).reshape(
                node["rows"], node["cols"]
            )

        w, h = int(cfg["LEFT.width"]), int(cfg["LEFT.height"])
        self.width, self.height = w, h
        self.maps = {}
        for side in ("LEFT", "RIGHT"):
            mx, my = compute_rectify_map(
                mat(side, "K"), mat(side, "D"), mat(side, "R"), mat(side, "P"), w, h
            )
            self.maps[side] = (jnp.asarray(mx), jnp.asarray(my))

    def rectify_left(self, img):
        mx, my = self.maps["LEFT"]
        return remap_bilinear(jnp.asarray(img, jnp.float32), mx, my)

    def rectify_right(self, img):
        mx, my = self.maps["RIGHT"]
        return remap_bilinear(jnp.asarray(img, jnp.float32), mx, my)
