"""Pose-graph optimization (loop-closure backend).

Capability extension named by BASELINE.json ("pose-graph backend for loop
closure") — the reference has no loop closing at all. Standard SE3 PGO:
vertices = keyframe poses T_cw, edges = relative constraints
T_ij = T_i_w * T_w_j with residual r = log(T_ij_meas^-1 * T_i * T_j^-1).

Shape: all edge residuals/Jacobians in one batched pass
(autodiff Jacobians w.r.t. the two endpoint tangents), scatter-added into
a dense (6N x 6N) system solved directly — at keyframe counts (<=512)
a dense solve is simpler than sparse bookkeeping.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3


class PoseGraph(NamedTuple):
    q: jax.Array          # (N,4) T_cw
    t: jax.Array          # (N,3)
    valid: jax.Array      # (N,) bool
    fixed: jax.Array      # (N,) bool — gauge anchors
    edge_i: jax.Array     # (E,) int32
    edge_j: jax.Array     # (E,) int32
    edge_q: jax.Array     # (E,4) measured T_ij = T_i_w * T_w_j
    edge_t: jax.Array     # (E,3)
    edge_info: jax.Array  # (E,6) diagonal information
    edge_valid: jax.Array  # (E,) bool


def edge_residual(qi, ti, qj, tj, q_meas, t_meas):
    """r = log(T_meas^-1 * T_i * T_j^-1) (...,6)."""
    qm_i, tm_i = se3.inverse(q_meas, t_meas)
    qj_i, tj_i = se3.inverse(qj, tj)
    qa, ta = se3.compose(qi, ti, qj_i, tj_i)
    qr, tr = se3.compose(qm_i, tm_i, qa, ta)
    return se3.log(qr, tr)


def _edge_terms(g: PoseGraph):
    """Residuals + Jacobians w.r.t. both endpoint tangents (autodiff)."""
    qi, ti = g.q[g.edge_i], g.t[g.edge_i]
    qj, tj = g.q[g.edge_j], g.t[g.edge_j]

    def res(xi_i, xi_j, qi, ti, qj, tj, qm, tm):
        qii, tii = se3.boxplus(qi, ti, xi_i)
        qjj, tjj = se3.boxplus(qj, tj, xi_j)
        return edge_residual(qii, tii, qjj, tjj, qm, tm)

    zeros = jnp.zeros_like(g.edge_t[:, :3])
    z6 = jnp.zeros(g.edge_t.shape[:-1] + (6,), g.edge_t.dtype)
    r = jax.vmap(res)(z6, z6, qi, ti, qj, tj, g.edge_q, g.edge_t)
    Ji = jax.vmap(jax.jacfwd(res, argnums=0))(
        z6, z6, qi, ti, qj, tj, g.edge_q, g.edge_t
    )
    Jj = jax.vmap(jax.jacfwd(res, argnums=1))(
        z6, z6, qi, ti, qj, tj, g.edge_q, g.edge_t
    )
    return r, Ji, Jj


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(g: PoseGraph, iters: int = 20, lam0: float = 1e-6):
    """Batched LM over the whole graph. Returns (q, t, final_cost)."""
    N = g.q.shape[0]
    dtype = g.t.dtype

    free = g.valid & ~g.fixed

    def cost_fn(q, t):
        gg = g._replace(q=q, t=t)
        r, _, _ = _edge_terms(gg)
        return jnp.sum(
            jnp.where(g.edge_valid, jnp.sum(r * r * g.edge_info, -1), 0.0)
        )

    def iteration(carry, _):
        q, t, lam, cost = carry
        gg = g._replace(q=q, t=t)
        r, Ji, Jj = _edge_terms(gg)
        w = g.edge_valid.astype(dtype)[:, None] * g.edge_info

        H = jnp.zeros((N, N, 6, 6), dtype)
        b = jnp.zeros((N, 6), dtype)
        Hi = jnp.einsum("eai,ea,eaj->eij", Ji, w, Ji)
        Hj = jnp.einsum("eai,ea,eaj->eij", Jj, w, Jj)
        Hij = jnp.einsum("eai,ea,eaj->eij", Ji, w, Jj)
        bi = jnp.einsum("eai,ea,ea->ei", Ji, w, r)
        bj = jnp.einsum("eai,ea,ea->ei", Jj, w, r)
        H = H.at[g.edge_i, g.edge_i].add(Hi)
        H = H.at[g.edge_j, g.edge_j].add(Hj)
        H = H.at[g.edge_i, g.edge_j].add(Hij)
        H = H.at[g.edge_j, g.edge_i].add(Hij.transpose(0, 2, 1))
        b = b.at[g.edge_i].add(bi)
        b = b.at[g.edge_j].add(bj)

        Hf = H.transpose(0, 2, 1, 3).reshape(6 * N, 6 * N)
        diag_boost = jnp.repeat(~free, 6)
        Hf = Hf + jnp.diag(jnp.where(diag_boost, 1e6, lam) + 1e-9)
        bf = jnp.where(jnp.repeat(free, 6), b.reshape(-1), 0.0)
        dx = -jnp.linalg.solve(Hf, bf).reshape(N, 6)
        dx = jnp.where(free[:, None], dx, 0.0)

        q_new, t_new = se3.boxplus(q, t, dx)
        new_cost = cost_fn(q_new, t_new)
        accept = new_cost < cost
        q = jnp.where(accept, q_new, q)
        t = jnp.where(accept, t_new, t)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9), lam * 4.0)
        cost = jnp.minimum(new_cost, cost)
        return (q, t, lam, cost), None

    cost0 = cost_fn(g.q, g.t)
    (q, t, _, cost), _ = jax.lax.scan(
        iteration, (g.q, g.t, jnp.array(lam0, dtype), cost0), None, length=iters
    )
    return q, t, cost
