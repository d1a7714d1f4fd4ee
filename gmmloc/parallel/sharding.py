"""Device-mesh sharding for the heavy kernels (multi-chip scale-out).

The reference has no distributed computing at all (SURVEY.md §2.3); the
scaling dimensions of THIS workload are (§5.7):

  - GMM component count K: renderView / association sharded over a
    "comp" mesh axis — each device projects + gates its component shard,
    association reduces over the shard axis (all-gather of candidates).
  - local-BA observations/points: sharded over the same devices; the
    Schur-reduced (6L x 6L) camera system is psum-reduced across shards
    (the distributed Hessian-block reduction).
  - sequence/run sweeps: embarrassingly parallel over a "dp"-style axis
    (driver-level, see eval harness).

Implementation style: GSPMD — inputs carry NamedShardings, the solver
code stays single-program, and XLA inserts the psum/all-gather
collectives. The mesh is flat and 1-D: the cards of one host reach each
other all to all (NVLink), so the layout follows the algorithm alone.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import camera as cam_mod
from ..gmm import mixture, render
from ..solver import local_ba


def make_mesh(n_devices: Optional[int] = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


# ---------------------------------------------------------------------------
# sharded GMM association
# ---------------------------------------------------------------------------


def shard_gmm_map(gmap: mixture.GMMMap, mesh: Mesh, axis: str = "shard") -> mixture.GMMMap:
    """Put component arrays with the K axis sharded over the mesh."""
    def put(x):
        if x.ndim == 0:
            return x
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return mixture.GMMMap(*[put(x) for x in gmap])


def render_view_sharded(gmap, cam, q_cw, t_cw, mesh, **kw) -> render.Render2D:
    """renderView with components sharded: per-component gates are local;
    the pairwise occlusion pass induces an all-gather of the (small)
    projected 2D means."""
    with jax.set_mesh(mesh):
        return render.render_view(gmap, cam, q_cw, t_cw, **kw)


def search_correspondence_sharded(r2d, feat_uv, feat_valid, mesh, **kw):
    """Association: the (N_feat, K) distance matrix is sharded over K; the
    top-k contracts over K (all-gather/psum of per-shard top-k)."""
    with jax.set_mesh(mesh):
        return render.search_correspondence(r2d, feat_uv, feat_valid, **kw)


# ---------------------------------------------------------------------------
# sharded local BA — the distributed "training step"
# ---------------------------------------------------------------------------


def shard_ba_problem(prob: local_ba.BAProblem, mesh: Mesh, axis: str = "shard") -> local_ba.BAProblem:
    """Observations + points sharded, camera blocks replicated.

    The per-iteration reduced camera system S (6L x 6L) is assembled from
    per-shard partial sums — XLA emits the psum over the mesh axis,
    mirroring the psum-of-Schur-blocks design (SURVEY.md §2.3).
    """
    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    rep = P()
    sh = P(axis)
    return local_ba.BAProblem(
        cam_q=put(prob.cam_q, rep),
        cam_t=put(prob.cam_t, rep),
        cam_valid=put(prob.cam_valid, rep),
        pts=put(prob.pts, P(axis, None)),
        pt_valid=put(prob.pt_valid, sh),
        obs_cam=put(prob.obs_cam, P(axis, None)),
        obs_uvr=put(prob.obs_uvr, P(axis, None, None)),
        obs_stereo=put(prob.obs_stereo, P(axis, None)),
        obs_sigma2_inv=put(prob.obs_sigma2_inv, P(axis, None)),
        obs_valid=put(prob.obs_valid, P(axis, None)),
        str_type=put(prob.str_type, sh),
        str_normal=put(prob.str_normal, P(axis, None)),
        str_mean=put(prob.str_mean, P(axis, None)),
        str_sqrt_info=put(prob.str_sqrt_info, P(axis, None, None)),
        prior_q=put(prob.prior_q, rep),
        prior_t=put(prob.prior_t, rep),
        has_prior=put(prob.has_prior, rep),
    )


def solve_local_ba_sharded(cam, prob, mesh, n_free: int, **kw) -> local_ba.BAResult:
    with jax.set_mesh(mesh):
        return local_ba.solve_local_ba(cam, prob, n_free=n_free, **kw)
