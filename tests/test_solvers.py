"""Solver engine tests: Jacobian oracles (autodiff), pose/point/BA recovery
on synthetic geometry with known ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmmloc.config import CameraConfig
from gmmloc.geometry import camera as cam_mod
from gmmloc.geometry import se3
from gmmloc.solver import factors, local_ba, point_solver, pose_solver

CAM = cam_mod.CameraParams.from_config(CameraConfig())


def make_scene(rng, n=200, depth_range=(3.0, 12.0)):
    """Random world points in the frustum of a camera at a known pose."""
    q_gt = se3.so3_exp(jnp.array(rng.standard_normal(3) * 0.1))
    t_gt = jnp.array(rng.standard_normal(3) * 0.5)
    # sample pixels + depths, unproject through the GT pose
    uv = rng.uniform([40, 40], [CAM.width - 40, CAM.height - 40], size=(n, 2))
    z = rng.uniform(*depth_range, size=(n,))
    pc = cam_mod.unproject(CAM, jnp.array(uv), jnp.array(z))
    q_wc, t_wc = se3.inverse(q_gt, t_gt)
    x_w = se3.apply(q_wc, t_wc, pc)
    uvr, vis = cam_mod.project_stereo(CAM, pc)
    assert bool(jnp.all(vis))
    return q_gt, t_gt, x_w, uvr


# ---------------------------------------------------------------------------
# Jacobian oracles
# ---------------------------------------------------------------------------


def test_pose_jacobian_matches_autodiff(rng):
    q_gt, t_gt, x_w, uvr = make_scene(rng, 8)
    stereo = jnp.array([True] * 4 + [False] * 4)

    def res(xi):
        q, t = se3.boxplus(q_gt, t_gt, xi)
        r, _, _ = factors.reproj_residual(CAM, q, t, x_w, uvr, stereo)
        return r

    J_ad = jax.jacfwd(res)(jnp.zeros(6))
    _, pc, _ = factors.reproj_residual(CAM, q_gt, t_gt, x_w, uvr, stereo)
    J = factors.stereo_proj_jac_pose(CAM, pc, stereo)
    np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), rtol=1e-3, atol=1e-3)


def test_point_jacobian_matches_autodiff(rng):
    q_gt, t_gt, x_w, uvr = make_scene(rng, 8)
    stereo = jnp.array([True] * 8)

    def res(x):
        r, _, _ = factors.reproj_residual(CAM, q_gt, t_gt, x, uvr, stereo)
        return r

    J_ad = jax.vmap(jax.jacfwd(lambda x, u: factors.reproj_residual(
        CAM, q_gt, t_gt, x[None], u[None], stereo[:1])[0][0]))(x_w, uvr)
    _, pc, _ = factors.reproj_residual(CAM, q_gt, t_gt, x_w, uvr, stereo)
    J = factors.stereo_proj_jac_point(CAM, q_gt, pc, stereo)
    np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), rtol=1e-3, atol=1e-3)


def test_prior_jacobian_small_residual(rng):
    q, t = se3.exp(jnp.array(rng.standard_normal(6) * 0.3))
    r = factors.se3_prior_residual(q, t, q, t)
    np.testing.assert_allclose(np.asarray(r), 0.0, atol=1e-6)
    J = factors.se3_prior_jacobian(q, t, q, t)
    # at zero residual the jacobian is Ad(T^{-1})-ish; just check finite/shape
    assert J.shape == (6, 6) and bool(jnp.all(jnp.isfinite(J)))


# ---------------------------------------------------------------------------
# pose-only solver (tracking_opt equivalent)
# ---------------------------------------------------------------------------


def test_pose_recovery_clean(rng):
    q_gt, t_gt, x_w, uvr = make_scene(rng, 300)
    stereo = jnp.ones(300, bool)
    sigma2_inv = jnp.ones(300)
    valid = jnp.ones(300, bool)
    # perturb the initial guess
    q0, t0 = se3.boxplus(q_gt, t_gt, jnp.array([0.02, -0.01, 0.015, 0.05, -0.04, 0.06]))
    res = pose_solver.optimize_pose(CAM, q0, t0, x_w, uvr, stereo, sigma2_inv, valid)
    err = se3.log(*se3.compose(*se3.inverse(q_gt, t_gt), res.q, res.t))
    assert float(jnp.linalg.norm(err)) < 1e-4
    assert int(res.num_inliers) == 300


def test_pose_recovery_with_outliers(rng):
    n = 400
    q_gt, t_gt, x_w, uvr = make_scene(rng, n)
    uvr = np.asarray(uvr).copy()
    # pixel noise sigma=0.4 + 15% gross outliers
    uvr += rng.standard_normal(uvr.shape) * 0.4
    out_idx = rng.choice(n, size=n * 15 // 100, replace=False)
    uvr[out_idx, :2] += rng.uniform(20, 80, size=(len(out_idx), 2))
    res = pose_solver.optimize_pose(
        CAM, q_gt, t_gt, jnp.array(x_w), jnp.array(uvr),
        jnp.ones(n, bool), jnp.ones(n), jnp.ones(n, bool),
    )
    err = se3.log(*se3.compose(*se3.inverse(q_gt, t_gt), res.q, res.t))
    assert float(jnp.linalg.norm(err[:3])) < 2e-3   # rotation
    assert float(jnp.linalg.norm(err[3:])) < 2e-2   # translation
    flagged = set(np.where(np.asarray(res.is_outlier))[0].tolist())
    assert len(flagged & set(out_idx.tolist())) > 0.9 * len(out_idx)


def test_pose_solver_mono_only(rng):
    q_gt, t_gt, x_w, uvr = make_scene(rng, 300)
    stereo = jnp.zeros(300, bool)
    q0, t0 = se3.boxplus(q_gt, t_gt, jnp.array([0.01, 0.0, -0.01, 0.03, 0.02, -0.02]))
    res = pose_solver.optimize_pose(
        CAM, q0, t0, x_w, uvr, stereo, jnp.ones(300), jnp.ones(300, bool)
    )
    err = se3.log(*se3.compose(*se3.inverse(q_gt, t_gt), res.q, res.t))
    assert float(jnp.linalg.norm(err)) < 1e-3


# ---------------------------------------------------------------------------
# point solvers
# ---------------------------------------------------------------------------


def test_point_opt_pulls_to_plane(rng):
    """Stereo obs of a point near a plane: solution balances both factors."""
    n = 32
    q_cw, t_cw = se3.identity()
    # GT points on the z=6 plane
    uv = rng.uniform([100, 100], [600, 380], size=(n, 2))
    x_gt = cam_mod.unproject(CAM, jnp.array(uv), jnp.full((n,), 6.0))
    uvr, _ = cam_mod.project_stereo(CAM, x_gt)
    normal = jnp.tile(jnp.array([0.0, 0.0, 1.0]), (n, 1))
    mean = jnp.tile(jnp.array([0.0, 0.0, 6.0]), (n, 1))
    x0 = x_gt + jnp.array(rng.standard_normal((n, 3)) * 0.3)
    res = point_solver.optimize_point_stereo(
        CAM, x0,
        jnp.tile(q_cw, (n, 1)), jnp.tile(t_cw, (n, 1)),
        uvr, jnp.ones(n),
        normal, mean, jnp.full((n,), 400.0 * 36.0),
        str_chi2_thresh=0.0064 * 400.0,
    )
    assert bool(jnp.all(res.ok))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(x_gt), atol=5e-3)


def test_point_opt_rejects_wrong_plane(rng):
    """A laterally-offset plane must fail the reprojection chi2 gate.

    (A plane offset purely along the viewing ray is ambiguous for this
    mini-solve — the reference rejects that case later via the 3D
    component Mahalanobis gate in checkMapAssociation, gmmloc_opt.cpp:230.)
    """
    q_cw, t_cw = se3.identity()
    x_gt = jnp.array([[0.5, 0.2, 6.0]])
    uvr, _ = cam_mod.project_stereo(CAM, x_gt)
    normal = jnp.array([[1.0, 0.0, 0.0]])
    mean = jnp.array([[1.5, 0.2, 6.0]])  # wrong plane, 1m lateral offset
    res = point_solver.optimize_point_stereo(
        CAM, x_gt, q_cw[None], t_cw[None], uvr, jnp.ones(1),
        normal, mean, jnp.array([400.0 * 36.0]),
        str_chi2_thresh=0.0064 * 400.0,
    )
    assert not bool(res.ok[0])


def test_triangulation_two_views(rng):
    """Mono obs from two keyframes + correct plane -> recover point."""
    x_gt = jnp.array([0.3, -0.2, 6.0])
    q1, t1 = se3.identity()
    q2, t2 = se3.exp(jnp.array([0.0, 0.05, 0.0, -0.4, 0.0, 0.0]))
    pc1 = se3.apply(q1, t1, x_gt)
    pc2 = se3.apply(q2, t2, x_gt)
    o1, _ = cam_mod.project_stereo(CAM, pc1)
    o2, _ = cam_mod.project_stereo(CAM, pc2)
    x0 = x_gt + jnp.array([0.1, -0.08, 0.25])
    x, c1, c2, cs = point_solver.optimize_triangulation(
        CAM, x0[None],
        q1[None], t1[None], o1[None], jnp.zeros(1, bool), jnp.ones(1),
        q2[None], t2[None], o2[None], jnp.zeros(1, bool), jnp.ones(1),
        jnp.array([[0.0, 0.0, 1.0]]), jnp.array([[0.0, 0.0, 6.0]]),
        tri_lambda2=400.0,
    )
    np.testing.assert_allclose(np.asarray(x[0]), np.asarray(x_gt), atol=2e-3)
    assert float(c1[0]) < 5.991 and float(c2[0]) < 5.991
    assert float(cs[0]) < 0.0064 * 400.0


# ---------------------------------------------------------------------------
# local BA
# ---------------------------------------------------------------------------


def build_ba_problem(rng, n_cams=4, n_fixed=1, n_pts=120, outlier_obs=0):
    """Cameras on a small arc looking at a z=6 wall of points."""
    C = n_cams + n_fixed
    P = n_pts
    # GT cameras: small lateral offsets
    cam_q_gt, cam_t_gt = [], []
    for i in range(C):
        xi = jnp.array([0.0, 0.0, 0.0, -0.3 * i, 0.02 * i, 0.0])
        q, t = se3.exp(xi)
        cam_q_gt.append(q)
        cam_t_gt.append(t)
    cam_q_gt = jnp.stack(cam_q_gt)
    cam_t_gt = jnp.stack(cam_t_gt)

    pts_gt = np.stack(
        [rng.uniform(-2, 3.5, P), rng.uniform(-1.5, 1.5, P), np.full(P, 6.0)], -1
    )
    pts_gt = jnp.array(pts_gt)

    MO = 8
    obs_cam = np.full((P, MO), -1, np.int32)
    obs_uvr = np.zeros((P, MO, 3))
    obs_st = np.zeros((P, MO), bool)
    obs_valid = np.zeros((P, MO), bool)
    slot = np.zeros(P, np.int32)
    coords = []
    for c in range(C):
        pc = se3.apply(cam_q_gt[c], cam_t_gt[c], pts_gt)
        uvr, vis = cam_mod.project_stereo(CAM, pc)
        uvr = np.asarray(uvr)
        for p in np.where(np.asarray(vis))[0]:
            s = slot[p]
            if s >= MO:
                continue
            obs_cam[p, s] = c
            obs_uvr[p, s] = uvr[p]
            obs_st[p, s] = p % 2 == 0
            obs_valid[p, s] = True
            coords.append((p, s))
            slot[p] += 1
    O = len(coords)
    noise = rng.standard_normal((P, MO, 2)) * 0.3
    obs_uvr[:, :, :2] += noise * obs_valid[:, :, None]
    if outlier_obs:
        bad_sel = rng.choice(O, size=outlier_obs, replace=False)
        bad = []
        for bi in bad_sel:
            p, s = coords[bi]
            obs_uvr[p, s, :2] += 50.0
            bad.append((p, s))
    else:
        bad = []

    prob = local_ba.BAProblem(
        cam_q=cam_q_gt,
        cam_t=cam_t_gt,
        cam_valid=jnp.ones(C, bool),
        pts=pts_gt,
        pt_valid=jnp.ones(P, bool),
        obs_cam=jnp.array(obs_cam),
        obs_uvr=jnp.array(obs_uvr, jnp.float32),
        obs_stereo=jnp.array(obs_st),
        obs_sigma2_inv=jnp.ones((P, MO)),
        obs_valid=jnp.array(obs_valid),
        str_type=jnp.full(P, local_ba.STR_DEG, jnp.int32),
        str_normal=jnp.tile(jnp.array([0.0, 0.0, 1.0]), (P, 1)),
        str_mean=jnp.tile(jnp.array([0.0, 0.0, 6.0]), (P, 1)),
        str_sqrt_info=jnp.tile(jnp.eye(3), (P, 1, 1)),
        prior_q=cam_q_gt[0],
        prior_t=cam_t_gt[0],
        has_prior=jnp.array(True),
    )
    return prob, cam_q_gt, cam_t_gt, pts_gt, bad, O


def test_local_ba_recovers_perturbation(rng):
    prob, q_gt, t_gt, pts_gt, _, O = build_ba_problem(rng)
    n_free = 4
    # perturb free cams (except slot 0, held by prior) and points
    dq = []
    dt = []
    pert = [np.zeros(6)] + [rng.standard_normal(6) * 0.01 for _ in range(3)] + [np.zeros(6)]
    for c in range(5):
        q, t = se3.boxplus(prob.cam_q[c], prob.cam_t[c], jnp.array(pert[c]))
        dq.append(q)
        dt.append(t)
    prob = prob._replace(
        cam_q=jnp.stack(dq),
        cam_t=jnp.stack(dt),
        pts=prob.pts + jnp.array(rng.standard_normal(prob.pts.shape) * 0.05),
    )
    res = local_ba.solve_local_ba(CAM, prob, n_free=n_free, iters3=20)
    # convergence to the ML optimum: limited by the 0.3px observation noise
    # (the solve routinely finds lower cost than the GT configuration)
    for c in range(4):
        err = se3.log(*se3.compose(*se3.inverse(q_gt[c], t_gt[c]), res.cam_q[c], res.cam_t[c]))
        assert float(jnp.linalg.norm(err)) < 1.5e-2, f"cam {c}: {err}"
    pt_err = np.linalg.norm(np.asarray(res.pts) - np.asarray(pts_gt), axis=-1)
    assert np.median(pt_err) < 0.02


def test_local_ba_flags_outlier_obs(rng):
    prob, q_gt, t_gt, pts_gt, bad, O = build_ba_problem(rng, outlier_obs=10)
    res = local_ba.solve_local_ba(CAM, prob, n_free=4, iters3=10)
    flagged = np.asarray(res.obs_bad)
    for (p, s) in bad:
        assert flagged[p, s], (p, s)
    # healthy observations largely kept
    assert flagged.sum() < 0.1 * O


def test_local_ba_drops_wrong_plane_assoc(rng):
    prob, *_ = build_ba_problem(rng)
    # corrupt one association: plane 1m off
    sm = np.asarray(prob.str_mean).copy()
    sm[5] = [0.0, 0.0, 7.5]
    prob = prob._replace(str_mean=jnp.array(sm))
    res = local_ba.solve_local_ba(CAM, prob, n_free=4, iters3=10)
    drop = np.asarray(res.str_drop)
    assert drop[5]
    assert drop.sum() <= 3


# ---------------------------------------------------------------------------
# per-frame GMM pose anchors (pose_solver.optimize_pose_anchored)
# ---------------------------------------------------------------------------


def test_anchor_jacobian_matches_autodiff(rng):
    q = se3.so3_exp(jnp.array(rng.standard_normal(3) * 0.2))
    t = jnp.array(rng.standard_normal(3) * 0.4)
    x_c = jnp.array(rng.uniform(-1, 1, (6, 3)) + np.array([0, 0, 4.0]))

    def xw(xi):
        qq, tt = se3.boxplus(q, t, xi)
        out, _ = factors.anchor_point_world(qq, tt, x_c)
        return out

    J_ad = jax.jacfwd(xw)(jnp.zeros(6))
    _, R_wc = factors.anchor_point_world(q, t, x_c)
    J = factors.anchor_jac_pose(jnp.broadcast_to(R_wc, (6, 3, 3)), x_c)
    np.testing.assert_allclose(np.asarray(J), np.asarray(J_ad), rtol=1e-4, atol=1e-5)


def _anchored_args(rng, n=120, n_anchor=60):
    """Scene + anchors consistent with the GT pose."""
    q_gt, t_gt, x_w, uvr = make_scene(rng, n)
    stereo = jnp.ones(n, bool)
    # anchors: stereo-measured camera points = GT camera coords of the
    # first n_anchor landmarks; components centered at the landmarks
    pc = se3.apply(q_gt, t_gt, x_w[:n_anchor])
    anc_xc = jnp.zeros((n, 3)).at[:n_anchor].set(pc)
    anc_mean = jnp.zeros((n, 3)).at[:n_anchor].set(x_w[:n_anchor])
    normal = jnp.tile(jnp.array([0.0, 0, 1.0]), (n, 1))
    sqrt_info = jnp.tile(jnp.eye(3) * 20.0, (n, 1, 1))
    half = n_anchor // 2
    anc_type = jnp.zeros(n, jnp.int32)
    anc_type = anc_type.at[:half].set(pose_solver.ANCHOR_DEG)
    anc_type = anc_type.at[half:n_anchor].set(pose_solver.ANCHOR_NONDEG)
    weight = jnp.where(anc_type == pose_solver.ANCHOR_DEG, 400.0, 1.0)
    return q_gt, t_gt, x_w, uvr, stereo, (
        anc_xc, anc_mean, normal, sqrt_info, anc_type, weight
    )


def test_anchored_pose_matches_plain_without_anchors(rng):
    q_gt, t_gt, x_w, uvr, stereo, anc = _anchored_args(rng)
    n = x_w.shape[0]
    xi = jnp.array(rng.standard_normal(6) * 0.01)
    q0, t0 = se3.boxplus(q_gt, t_gt, xi)
    s2i = jnp.ones(n)
    valid = jnp.ones(n, bool)
    r1 = pose_solver.optimize_pose(CAM, q0, t0, x_w, uvr, stereo, s2i, valid)
    none_type = jnp.zeros(n, jnp.int32)
    r2 = pose_solver.optimize_pose_anchored(
        CAM, q0, t0, x_w, uvr, stereo, s2i, valid,
        anc[0], anc[1], anc[2], anc[3], none_type, anc[5], jnp.float32(2.56),
    )
    np.testing.assert_allclose(np.asarray(r1.q), np.asarray(r2.q), atol=1e-6)
    np.testing.assert_allclose(np.asarray(r1.t), np.asarray(r2.t), atol=1e-6)
    assert int(r2.num_anchors) == 0


def test_anchored_pose_recovers_weak_direction(rng):
    """A lateral-translation + compensating-rotation offset that the
    reprojection edges barely see must be pulled back by the anchors."""
    q_gt, t_gt, x_w, uvr, stereo, anc = _anchored_args(rng, n=160, n_anchor=120)
    n = x_w.shape[0]
    # weak-direction perturbation: translate +x by 5cm, rotate about y by
    # -dx/z_avg so projections nearly cancel
    z_avg = float(jnp.mean(se3.apply(q_gt, t_gt, x_w)[:, 2]))
    dx = 0.05
    xi = jnp.array([0.0, -dx / z_avg, 0.0, dx, 0.0, 0.0])
    q0, t0 = se3.boxplus(q_gt, t_gt, xi)
    s2i = jnp.ones(n)
    valid = jnp.ones(n, bool)

    res = pose_solver.optimize_pose_anchored(
        CAM, q0, t0, x_w, uvr, stereo, s2i, valid, *anc, jnp.float32(2.56),
    )
    e0 = float(jnp.linalg.norm(t0 - t_gt))
    e1 = float(jnp.linalg.norm(res.t - t_gt))
    assert int(res.num_anchors) > 50
    assert e1 < 0.25 * e0, (e0, e1)


def test_local_ba_bf16_matches_f32(rng):
    """bf16-staged Hessian assembly must converge to the same optimum as
    the f32 path (approximate preconditioner, exact cost/accept)."""
    prob, q_gt, t_gt, pts_gt, _, O = build_ba_problem(rng)
    pert = jnp.array(rng.standard_normal(prob.pts.shape) * 0.03)
    prob = prob._replace(pts=prob.pts + pert)
    r32 = local_ba.solve_local_ba(CAM, prob, n_free=4, iters3=20, use_bf16=False)
    r16 = local_ba.solve_local_ba(CAM, prob, n_free=4, iters3=20, use_bf16=True)
    for c in range(4):
        err = se3.log(*se3.compose(
            *se3.inverse(r32.cam_q[c], r32.cam_t[c]), r16.cam_q[c], r16.cam_t[c]
        ))
        assert float(jnp.linalg.norm(err)) < 2e-3, f"cam {c}: {err}"
    d = np.linalg.norm(np.asarray(r16.pts) - np.asarray(r32.pts), axis=-1)
    assert np.median(d) < 5e-3, np.median(d)


@pytest.mark.parametrize("impl", ["blockdiag", "flatpm"])
def test_local_ba_impl_matches_flat(rng, impl):
    """Every Schur-assembly implementation computes the same
    contractions (H_cc off-diagonal blocks are structurally zero;
    flatpm is the lane-major production default) — all must land on the
    same optimum with the same edge classification."""
    prob, q_gt, t_gt, pts_gt, _, O = build_ba_problem(rng)
    pert = jnp.array(rng.standard_normal(prob.pts.shape) * 0.03)
    prob = prob._replace(pts=prob.pts + pert)
    rf = local_ba.solve_local_ba(
        CAM, prob, n_free=4, iters3=20, schur_impl="flat")
    rb = local_ba.solve_local_ba(
        CAM, prob, n_free=4, iters3=20, schur_impl=impl)
    for c in range(4):
        err = se3.log(*se3.compose(
            *se3.inverse(rf.cam_q[c], rf.cam_t[c]), rb.cam_q[c], rb.cam_t[c]
        ))
        assert float(jnp.linalg.norm(err)) < 2e-3, f"cam {c}: {err}"
    d = np.linalg.norm(np.asarray(rb.pts) - np.asarray(rf.pts), axis=-1)
    assert np.median(d) < 5e-3, np.median(d)
    # same edge classification
    assert np.array_equal(np.asarray(rb.str_drop), np.asarray(rf.str_drop))


def test_local_ba_batch_matches_solo(rng):
    """vmapped multi-window solve == per-window solves (lock-step LM with
    per-window accept masking preserves each window's own schedule)."""
    import jax

    probs = []
    for seed in (1, 2, 3):
        r = np.random.default_rng(seed)
        prob, *_ = build_ba_problem(r)
        pert = jnp.array(r.standard_normal(prob.pts.shape) * 0.03)
        probs.append(prob._replace(pts=prob.pts + pert))
    batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *probs)
    rb = local_ba.solve_local_ba_batch(CAM, batch, n_free=4, iters3=20)
    for i, p in enumerate(probs):
        rs = local_ba.solve_local_ba(
            CAM, p, n_free=4, iters3=20, schur_impl="blockdiag")
        for c in range(4):
            err = se3.log(*se3.compose(
                *se3.inverse(rs.cam_q[c], rs.cam_t[c]),
                rb.cam_q[i, c], rb.cam_t[i, c]
            ))
            assert float(jnp.linalg.norm(err)) < 2e-3, f"w{i} cam{c}: {err}"
        d = np.linalg.norm(np.asarray(rb.pts[i]) - np.asarray(rs.pts), axis=-1)
        assert np.median(d) < 5e-3, (i, np.median(d))
