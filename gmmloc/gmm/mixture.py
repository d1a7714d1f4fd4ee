"""The prior GMM map as a struct-of-arrays pytree on device.

JAX replacement for GMM / GaussianComponents (ref:
/root/reference/gmmloc/src/gmm/gaussian_mixture.cpp,
include/gmmloc/gmm/gaussian_mixture.h:98-170). The pointer graph of
GaussianComponent objects becomes a fixed-shape bundle of arrays padded to
a static capacity; the nanoflann KD-trees disappear in favor of dense
masked top-k passes (see render.py); the O(K^2) Bhattacharyya neighbor
graph (gaussian_mixture.cpp:61-78) becomes a blocked pairwise kernel +
top-k, stored as a (K, NB) index table.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import proto
from . import gaussian


# Host-side copies of map arrays, keyed by id(gmap.means). Populated at
# construction so consumers (association bookkeeping) never pull device
# buffers back through the slow/fragile host link. See host_view().
_HOST_CACHE: dict = {}


class GMMMap(NamedTuple):
    """Padded component arrays; `valid` masks real components."""

    means: jax.Array        # (K, 3)
    covs: jax.Array         # (K, 3, 3)
    cov_inv: jax.Array      # (K, 3, 3)
    det: jax.Array          # (K,)
    scale: jax.Array        # (K, 3) ascending eigenvalues
    axis: jax.Array         # (K, 3, 3) eigenvectors as columns
    normal: jax.Array       # (K, 3) smallest-eigenvalue direction
    sqrt_info: jax.Array    # (K, 3, 3) lower chol of cov_inv
    is_degenerated: jax.Array  # (K,) bool
    is_salient: jax.Array   # (K,) bool
    valid: jax.Array        # (K,) bool
    neighbors: jax.Array    # (K, NB) int32, -1 padded

    @property
    def capacity(self) -> int:
        return self.means.shape[0]


def _det3(m):
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def _inv3(m, det):
    """Adjugate-based 3x3 inverse (cheap, batched, no LAPACK)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = jnp.stack(
        [
            jnp.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        axis=-2,
    )
    det_safe = jnp.where(jnp.abs(det) < 1e-30, 1e-30, det)
    return adj / det_safe[..., None, None]


@functools.partial(jax.jit, static_argnames=("block",))
def _bh_block(means, covs, dets, row_means, row_covs, row_dets, block=None):
    """BH distances between `block` row components and all K components."""
    cov = 0.5 * (row_covs[:, None] + covs[None, :])       # (B, K, 3, 3)
    det_c = _det3(cov)
    inv_c = _inv3(cov, det_c)
    delta = means[None, :] - row_means[:, None]           # (B, K, 3)
    d0 = jnp.einsum("bki,bkij,bkj->bk", delta, inv_c, delta) / 8.0
    d1 = 0.5 * jnp.log(
        jnp.clip(det_c, 1e-300)
        / jnp.sqrt(jnp.clip(row_dets[:, None] * dets[None, :], 1e-300))
    )
    return d0 + d1


def build_neighbor_graph(
    means, covs, dets, valid, thresh: float, cap: int, block: int = 256
):
    """(K, cap) neighbor index table: BH distance < thresh (excluding self).

    Ref: GMM ctor neighbor loop gaussian_mixture.cpp:61-78 (unbounded list);
    here capped at `cap` nearest-by-BH, padded with -1.

    Load-time-only O(K^2) pass with a spatial PREFILTER: BH >= |d|^2 /
    (8 lambda_max(S_mean)) and the log-det term is >= 0 (Minkowski), so
    BH < thresh requires |d|^2 < 4 thresh (tr_a + tr_b) (trace bounds
    lambda_max). The full BH closed form then runs only on the sparse
    candidate pairs — at the 33k-component stress scale the dense
    float64 blocked pass allocated ~2 GB per block and took minutes;
    the prefiltered pass touches ~0.1-1% of the pairs.
    """
    K = means.shape[0]
    neighbors = np.full((K, cap), -1, dtype=np.int32)
    means = np.asarray(means, np.float64)
    covs = np.asarray(covs, np.float64)
    dets = np.asarray(dets, np.float64)
    valid_np = np.asarray(valid)
    tr = covs[:, 0, 0] + covs[:, 1, 1] + covs[:, 2, 2]
    # symmetric cov components (K,)
    C = {
        "a": covs[:, 0, 0], "b": covs[:, 0, 1], "c": covs[:, 0, 2],
        "e": covs[:, 1, 1], "f": covs[:, 1, 2], "i": covs[:, 2, 2],
    }
    for start in range(0, K, block):
        stop = min(start + block, K)
        d = means[None, :] - means[start:stop, None]          # (B,K,3)
        dist2 = np.einsum("bki,bki->bk", d, d)
        gate = dist2 < 4.0 * thresh * (tr[start:stop, None] + tr[None, :])
        gate &= valid_np[None, :] & valid_np[start:stop, None]
        ridx = np.arange(start, stop)
        gate[np.arange(stop - start), ridx] = False           # exclude self
        rr, cc = np.nonzero(gate)                             # candidates
        if len(rr) == 0:
            continue
        gi = rr + start
        a = 0.5 * (C["a"][gi] + C["a"][cc])
        b = 0.5 * (C["b"][gi] + C["b"][cc])
        c3 = 0.5 * (C["c"][gi] + C["c"][cc])
        e = 0.5 * (C["e"][gi] + C["e"][cc])
        f = 0.5 * (C["f"][gi] + C["f"][cc])
        i3 = 0.5 * (C["i"][gi] + C["i"][cc])
        det_c = a * (e * i3 - f * f) - b * (b * i3 - f * c3) + c3 * (
            b * f - e * c3
        )
        dx, dy, dz = (means[cc] - means[gi]).T
        A00 = e * i3 - f * f
        A01 = c3 * f - b * i3
        A02 = b * f - c3 * e
        A11 = a * i3 - c3 * c3
        A12 = b * c3 - a * f
        A22 = a * e - b * b
        quad = (
            dx * dx * A00 + dy * dy * A11 + dz * dz * A22
            + 2.0 * (dx * dy * A01 + dx * dz * A02 + dy * dz * A12)
        ) / np.clip(det_c, 1e-300, None)
        bh = quad / 8.0 + 0.5 * np.log(
            np.clip(det_c, 1e-300, None)
            / np.sqrt(np.clip(dets[gi] * dets[cc], 1e-300, None))
        )
        ok = bh < thresh
        rr, cc, bh = rr[ok], cc[ok], bh[ok]
        for r in np.unique(rr):
            sel = rr == r
            idx = cc[sel]
            if len(idx) > cap:
                idx = idx[np.argsort(bh[sel])[:cap]]
            neighbors[start + r, : len(idx)] = idx
    return neighbors


def from_arrays(
    means,
    covs,
    pad_to: int | None = None,
    neighbor_dist_thresh: float = 2.5,
    neighbor_cap: int = 16,
    degenerate_eig_thresh: float = 1e-4,
    salient_eig_thresh: float = 0.2,
    dtype=jnp.float32,
    build_neighbors: bool = True,
) -> GMMMap:
    """Build a GMMMap from raw (K,3)/(K,3,3) arrays.

    Mirrors GaussianComponent ctor + decompose (gaussian.cpp:36-63) and the
    GMM ctor (gaussian_mixture.cpp:43-90), all batched.
    """
    means = np.asarray(means, dtype=np.float64)
    covs = np.asarray(covs, dtype=np.float64)
    K = means.shape[0]
    cap = pad_to or K

    # eigendecomposition in float64 on host for accuracy (load-time only)
    evals, evecs = np.linalg.eigh(covs)
    cov_inv = np.linalg.inv(covs)
    det = np.linalg.det(covs)
    is_deg = evals[:, 0] < degenerate_eig_thresh
    is_sal = (evals[:, 1] > salient_eig_thresh) & (evals[:, 2] > salient_eig_thresh)
    sqrt_info = np.linalg.cholesky(cov_inv)

    valid = np.zeros(cap, dtype=bool)
    valid[:K] = True

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, dtype=a.dtype)
        out[:K] = a
        return out

    neighbors = np.full((cap, neighbor_cap), -1, dtype=np.int32)
    if build_neighbors:
        neighbors[:K] = build_neighbor_graph(
            means, covs, det, np.ones(K, dtype=bool),
            neighbor_dist_thresh, neighbor_cap,
        )

    # pad covariances with identity so batched 3x3 math stays finite
    covs_p = pad(covs)
    covs_p[K:] = np.eye(3)
    cov_inv_p = pad(cov_inv)
    cov_inv_p[K:] = np.eye(3)
    sqrt_p = pad(sqrt_info)
    sqrt_p[K:] = np.eye(3)
    axis_p = pad(evecs)
    axis_p[K:] = np.eye(3)

    host = {
        "means": pad(means).astype(np.float64),
        "cov_inv": cov_inv_p.astype(np.float64),
        "normal": axis_p[:, :, 0].astype(np.float64),
        "sqrt_info": sqrt_p.astype(np.float64),
        "is_degenerated": pad(is_deg, False),
        "neighbors": neighbors,
        "valid": valid,
    }
    gmap = GMMMap(
        means=jnp.asarray(pad(means), dtype=dtype),
        covs=jnp.asarray(covs_p, dtype=dtype),
        cov_inv=jnp.asarray(cov_inv_p, dtype=dtype),
        det=jnp.asarray(pad(det, 1.0), dtype=dtype),
        scale=jnp.asarray(pad(evals), dtype=dtype),
        axis=jnp.asarray(axis_p, dtype=dtype),
        normal=jnp.asarray(axis_p[:, :, 0], dtype=dtype),
        sqrt_info=jnp.asarray(sqrt_p, dtype=dtype),
        is_degenerated=jnp.asarray(pad(is_deg, False)),
        is_salient=jnp.asarray(pad(is_sal, False)),
        valid=jnp.asarray(valid),
        neighbors=jnp.asarray(neighbors),
    )
    _HOST_CACHE[id(gmap.means)] = host
    return gmap


def for_config(means, covs, cfg) -> GMMMap:
    """from_arrays with the padding, neighbor gate and eigen thresholds
    of a SystemConfig."""
    return from_arrays(
        means, covs,
        pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
        degenerate_eig_thresh=cfg.gmm.degenerate_eig_thresh,
        salient_eig_thresh=cfg.gmm.salient_eig_thresh,
    )


def host_view(gmap: GMMMap) -> dict:
    """Host numpy copies of the map arrays (no device->host transfer
    when the map was built by from_arrays in this process)."""
    cached = _HOST_CACHE.get(id(gmap.means))
    if cached is not None:
        return cached
    return {
        "means": np.asarray(gmap.means, np.float64),
        "cov_inv": np.asarray(gmap.cov_inv, np.float64),
        "normal": np.asarray(gmap.normal, np.float64),
        "sqrt_info": np.asarray(gmap.sqrt_info, np.float64),
        "is_degenerated": np.asarray(gmap.is_degenerated),
        "neighbors": np.asarray(gmap.neighbors),
        "valid": np.asarray(gmap.valid),
    }


def load(path: str, pad_to: int | None = None, **kw) -> GMMMap:
    """Load a .gmm protobuf stream into a GMMMap.

    Ref: GMMUtility::loadGMMModel (gmm_utils.cpp:9-67). Uses the native
    C++ parser when available (utils/native.py), else pure Python.
    """
    from ..utils import native

    parsed = native.load_gmm_file(path) if native.available() else None
    if parsed is None:
        means, covs, _, _ = proto.load_gmm_file(path)
    else:
        means, covs, _, _ = parsed
    return from_arrays(means, covs, pad_to=pad_to, **kw)
