"""Pose-graph optimization tests: drift correction via a loop edge."""

import jax.numpy as jnp
import numpy as np

from gmmloc.geometry import se3
from gmmloc.solver import pose_graph as pg


def ring_graph(rng, n=12, drift=0.02):
    """A loop of poses with odometry drift; GT = regular polygon."""
    # GT poses around a circle
    qs, ts = [], []
    for i in range(n):
        ang = 2 * np.pi * i / n
        q = se3.so3_exp(jnp.array([0.0, 0.0, ang]))
        t = jnp.array([np.cos(ang), np.sin(ang), 0.0])
        qs.append(q)
        ts.append(t)
    q_gt = jnp.stack(qs)
    t_gt = jnp.stack(ts)

    # odometry edges with drift in the estimates
    edge_i, edge_j, eq, et = [], [], [], []
    for i in range(n):
        j = (i + 1) % n
        dq, dt = se3.compose(q_gt[i], t_gt[i], *se3.inverse(q_gt[j], t_gt[j]))
        edge_i.append(i)
        edge_j.append(j)
        eq.append(dq)
        et.append(dt)

    # drifted initial estimate: accumulate noisy odometry from pose 0
    q_est = [q_gt[0]]
    t_est = [t_gt[0]]
    for i in range(1, n):
        # T_i = T_meas(i-1,i)^-1 * T_{i-1}  since T_meas = T_{i-1} T_i^-1
        noise = jnp.array(rng.standard_normal(6) * drift)
        dq, dt = se3.compose(*se3.exp(noise), *se3.inverse(eq[i - 1], et[i - 1]))
        q_i, t_i = se3.compose(dq, dt, q_est[-1], t_est[-1])
        q_est.append(q_i)
        t_est.append(t_i)

    g = pg.PoseGraph(
        q=jnp.stack(q_est),
        t=jnp.stack(t_est),
        valid=jnp.ones(n, bool),
        fixed=jnp.zeros(n, bool).at[0].set(True),
        edge_i=jnp.array(edge_i, jnp.int32),
        edge_j=jnp.array(edge_j, jnp.int32),
        edge_q=jnp.stack(eq),
        edge_t=jnp.stack(et),
        edge_info=jnp.ones((n, 6)),
        edge_valid=jnp.ones(n, bool),
    )
    return g, q_gt, t_gt


def test_edge_residual_zero_at_truth(rng):
    g, q_gt, t_gt = ring_graph(rng, drift=0.0)
    gg = g._replace(q=q_gt, t=t_gt)
    r, _, _ = pg._edge_terms(gg)
    np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-5)


def test_pose_graph_corrects_drift(rng):
    g, q_gt, t_gt = ring_graph(rng, n=12, drift=0.03)
    # initial drift is visible
    init_err = np.linalg.norm(np.asarray(g.t) - np.asarray(t_gt), axis=1)
    assert init_err.max() > 0.05
    q, t, cost = pg.optimize_pose_graph(g, iters=25)
    # residual cost ~ 0 (graph is consistent with GT up to gauge)
    assert float(cost) < 1e-6
    # with pose 0 fixed at GT and consistent edges, solution matches GT
    err = np.linalg.norm(np.asarray(t) - np.asarray(t_gt), axis=1)
    assert err.max() < 1e-3, err.max()
