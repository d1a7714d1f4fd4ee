"""Image pyramid + Gaussian blur as XLA convolution/resize ops.

JAX replacement for ORBextractor::ComputePyramid
(ref: /root/reference/gmmloc/src/cv/orb_extractor.cpp:1056-1080): 8
levels, scale factor 1.2, bilinear resize; descriptors are computed on a
7x7 sigma=2 Gaussian-blurred copy (:1028-1034).

Images are float32 [H, W] in [0, 255]. Levels have static shapes
H_l = round(H / 1.2^l).
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def level_shapes(h: int, w: int, num_levels: int, scale: float):
    return [
        (int(round(h / scale**l)), int(round(w / scale**l)))
        for l in range(num_levels)
    ]


@functools.partial(jax.jit, static_argnames=("shapes",))
def build_pyramid(img, shapes: Tuple[Tuple[int, int], ...]):
    """Bilinear-resized pyramid. img (H,W) float32."""
    levels = [img]
    for (h, w) in shapes[1:]:
        levels.append(
            jax.image.resize(levels[-1], (h, w), method="linear")
        )
    return tuple(levels)


def _gauss_kernel(ksize: int = 7, sigma: float = 2.0):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


@jax.jit
def gaussian_blur7(img):
    """Separable 7x7 sigma=2 blur (BORDER_REFLECT_101-like via edge pad).

    Shift-and-add formulation: 14 statically-shifted multiply-adds that
    XLA fuses into two elementwise passes over the image, in place of a
    1-channel conv_general_dilated (which the first platform padded and
    transposed per call; its GPU cost is not measured yet, ROADMAP A3)."""
    k = _gauss_kernel()
    pad = 3
    xp = jnp.pad(img, ((pad, pad), (0, 0)), mode="reflect")
    x = sum(
        float(k[i]) * jax.lax.slice_in_dim(xp, i, i + img.shape[0], axis=0)
        for i in range(7)
    )
    xp = jnp.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    return sum(
        float(k[i]) * jax.lax.slice_in_dim(xp, i, i + img.shape[1], axis=1)
        for i in range(7)
    )
