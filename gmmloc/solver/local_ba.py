"""Local bundle adjustment with GMM structure factors — Schur-complement LM.

JAX replacement for Localization::jointOptimization
(ref: /root/reference/gmmloc/src/modules/localization_opt.cpp:456-925).
The g2o sparse graph (SE3 vertices + marginalized point vertices + mono/
stereo reprojection edges + EdgePt2Gaussian{,Deg} structure edges + the
first-KF SE3 prior) becomes fixed-capacity arrays and one jitted staged
LM schedule:

  stage 1 (5 it) -> deactivate bad degenerate-GMM edges
                    (chi2 > tri_str_thresh * ba_lambda2, :773-789)
  stage 2 (5 it) -> deactivate bad reprojection edges (chi2 gates /
                    negative depth), drop Huber (:797-825)
  stage 3 (40 it)

Data layout: observations live in a PER-POINT table (P, MO) — gathers +
dense einsum reductions only, no scatter-adds (the earlier COO
formulation spent most of each iteration in them); with per-point
tables every reduction is a gather + one-hot einsum. Landmark
blocks are eliminated per point (dense 3x3), the reduced (6L x 6L)
camera system is assembled with einsums and solved directly.

LM loop structure: the residual/Jacobian products at the CURRENT
accepted state are carried in the loop state, so each LM iteration runs
exactly ONE (P, MO) residual+Jacobian pass — at the PROPOSED state,
where its chi2 doubles as the accept-test cost. A rejected step redoes
only the (cheap) damped assembly+solve from the carried products with a
larger lambda; the earlier formulation paid a full residual pass for the
cost AND recomputed Jacobians at the unchanged state after a reject.
Products are mask-independent (active/huber masks apply at assembly
time), so they stay valid across the stage-gate transitions.

Variants: "flatpm" (the production default), "flat" and "blockdiag".
flatpm's (k, P*MO) lane-major layout keeps 3/6-wide dims out of the
minor position, which the first platform's 128-wide tiles padded. The
GPU ranking of the variants is not measured yet (ROADMAP C4).

Memory note: carrying r/Jc/Jp ((P,MO,3,6)+(P,MO,3,3)+(P,MO,3) in bf16)
in the while_loop keeps two copies live (accepted + proposed) during the
accept select — a few MB extra peak HBM at current tiers, traded for
skipping a full recompute pass on reject. Revisit with input/output
aliasing if P/MO tiers grow ~10x.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import camera as cam_mod
from ..geometry import se3
from . import factors

CHI2_MONO = 5.991
CHI2_STEREO = 7.815

# GMM association types (mirrors MapPoint provenance semantics)
STR_NONE = 0
STR_DEG = 1      # degenerate component -> 1D point-to-plane edge
STR_NONDEG = 2   # full component -> 3D sqrt-info whitened edge


class BAProblem(NamedTuple):
    """Fixed-capacity local-BA problem. C camera slots (first n_free are
    optimizable), P point slots, MO observation slots per point."""

    cam_q: jax.Array          # (C,4) T_cw rotations
    cam_t: jax.Array          # (C,3)
    cam_valid: jax.Array      # (C,) bool
    pts: jax.Array            # (P,3) world points
    pt_valid: jax.Array       # (P,) bool
    obs_cam: jax.Array        # (P,MO) int32, -1 = empty slot
    obs_uvr: jax.Array        # (P,MO,3)
    obs_stereo: jax.Array     # (P,MO) bool
    obs_sigma2_inv: jax.Array  # (P,MO)
    obs_valid: jax.Array      # (P,MO) bool
    str_type: jax.Array       # (P,) int32 STR_*
    str_normal: jax.Array     # (P,3) dominant normal (deg)
    str_mean: jax.Array       # (P,3) component mean
    str_sqrt_info: jax.Array  # (P,3,3) lower chol of cov_inv (nondeg)
    prior_q: jax.Array        # (4,) prior for camera slot 0
    prior_t: jax.Array        # (3,)
    has_prior: jax.Array      # () bool


class BAResult(NamedTuple):
    cam_q: jax.Array
    cam_t: jax.Array
    pts: jax.Array
    obs_bad: jax.Array        # (P,MO) bool — erase these observations
    str_drop: jax.Array       # (P,) bool — downgrade GMM association
    obs_chi2: jax.Array       # (P,MO)
    cost: jax.Array           # () final total cost
    n_iters: jax.Array        # () int32 LM iterations used across stages


def _inv3(m):
    """Closed-form 3x3 inverse (adjugate): elementwise math that fuses,
    in place of batched LAPACK inv/det calls."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    det = a * A + d * B + g * C
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], -1),
            jnp.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            jnp.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        axis=-2,
    )
    det_safe = jnp.where(jnp.abs(det) < 1e-20, 1.0, det)
    inv = adj / det_safe[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=m.dtype), m.shape)
    inv = jnp.where(jnp.abs(det)[..., None, None] < 1e-20, eye, inv)
    return inv, det


def _obs_residuals(cam, prob: BAProblem, cam_q, cam_t, pts):
    """Residual-only pass (no Jacobians) for cost evaluation."""
    ci = jnp.clip(prob.obs_cam, 0)
    q = cam_q[ci]
    t = cam_t[ci]
    x = pts[:, None, :]
    r, pc, depth_ok = factors.reproj_residual(
        cam, q, t, jnp.broadcast_to(x, prob.obs_uvr.shape), prob.obs_uvr,
        prob.obs_stereo,
    )
    chi2 = jnp.sum(r * r, axis=-1) * prob.obs_sigma2_inv
    return chi2, depth_ok


def _obs_terms(cam, prob: BAProblem, cam_q, cam_t, pts):
    """Residual/Jacobian pass over the (P, MO) observation table."""
    ci = jnp.clip(prob.obs_cam, 0)
    q = cam_q[ci]                        # (P,MO,4)
    t = cam_t[ci]
    x = pts[:, None, :]                  # (P,1,3) broadcast over MO
    r, pc, depth_ok = factors.reproj_residual(
        cam, q, t, jnp.broadcast_to(x, prob.obs_uvr.shape), prob.obs_uvr,
        prob.obs_stereo,
    )
    Jc = factors.stereo_proj_jac_pose(cam, pc, prob.obs_stereo)    # (P,MO,3,6)
    Jp = factors.stereo_proj_jac_point(cam, q, pc, prob.obs_stereo)  # (P,MO,3,3)
    chi2 = jnp.sum(r * r, axis=-1) * prob.obs_sigma2_inv
    return r, Jc, Jp, chi2, depth_ok


def _gmm_terms(prob: BAProblem, pts, ba_lambda2, active_str):
    """Structure-factor contributions to the point blocks (see reference
    edge defs, localization_opt.cpp:650-683)."""
    is_deg = (prob.str_type == STR_DEG) & active_str
    is_nd = (prob.str_type == STR_NONDEG) & active_str

    rs = factors.pt2plane_residual(pts, prob.str_mean, prob.str_normal)  # (P,)
    n = prob.str_normal
    H_deg = ba_lambda2 * n[:, :, None] * n[:, None, :]
    b_deg = (ba_lambda2 * rs)[:, None] * n

    L = prob.str_sqrt_info
    d = pts - prob.str_mean
    r_nd = jnp.einsum("pji,pj->pi", L, d)
    H_nd = jnp.einsum("pij,pkj->pik", L, L)
    b_nd = jnp.einsum("pij,pj->pi", L, r_nd)

    H = jnp.where(is_deg[:, None, None], H_deg, 0.0) + jnp.where(
        is_nd[:, None, None], H_nd, 0.0
    )
    b = jnp.where(is_deg[:, None], b_deg, 0.0) + jnp.where(is_nd[:, None], b_nd, 0.0)
    cost = jnp.where(is_deg, ba_lambda2 * rs * rs, 0.0) + jnp.where(
        is_nd, jnp.sum(r_nd * r_nd, axis=-1), 0.0
    )
    return H, b, cost


def _prior_terms(prob: BAProblem, cam_q, cam_t, rot_info, trans_info):
    """First-KF SE3 prior (localization_opt.cpp:558-582)."""
    r = factors.se3_prior_residual(cam_q[0], cam_t[0], prob.prior_q, prob.prior_t)
    J = factors.se3_prior_jacobian(cam_q[0], cam_t[0], prob.prior_q, prob.prior_t)
    info = jnp.concatenate(
        [jnp.full(3, rot_info, r.dtype), jnp.full(3, trans_info, r.dtype)]
    )
    w = prob.has_prior.astype(r.dtype)
    H = w * jnp.einsum("ij,i,ik->jk", J, info, J)
    b = w * jnp.einsum("ij,i,i->j", J, info, r)
    cost = w * jnp.sum(info * r * r)
    return H, b, cost


def _pcg_solve(S, b, iters: int):
    """Jacobi-preconditioned CG for the reduced camera system. LM accepts
    inexact steps (the accept test uses the exact cost), and a fixed-count
    CG of matvecs is an alternative to the LU that jnp.linalg.solve
    lowers to."""
    d = jnp.diagonal(S)
    Minv = 1.0 / jnp.where(jnp.abs(d) < 1e-12, 1.0, d)
    x = jnp.zeros_like(b)
    r = b
    z = Minv * r
    p = z
    rz = jnp.dot(r, z)

    def body(_, carry):
        x, r, p, rz = carry
        Sp = S @ p
        denom = jnp.dot(p, Sp)
        alpha = jnp.where(jnp.abs(denom) < 1e-30, 0.0, rz / denom)
        x = x + alpha * p
        r = r - alpha * Sp
        z = Minv * r
        rz_new = jnp.dot(r, z)
        beta = jnp.where(jnp.abs(rz) < 1e-30, 0.0, rz_new / rz)
        p = z + beta * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rz))
    return x


@functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "n_free", "ba_lambda2", "tri_str_thresh",
        "prior_rot_info", "prior_trans_info",
        "iters1", "iters2", "iters3", "term_gain", "use_bf16",
        "schur_impl", "linear_solver", "cg_iters",
    ),
)
def solve_local_ba(
    cam: cam_mod.CameraParams,
    prob: BAProblem,
    n_free: int,
    ba_lambda2: float = 400.0,
    tri_str_thresh: float = 0.0064,
    prior_rot_info: float = 1.0 / (2.0 * jnp.pi / 180.0) ** 2,
    prior_trans_info: float = 1.0 / 0.01**2,
    iters1: int = 5,
    iters2: int = 5,
    iters3: int = 40,
    term_gain: float = 1e-5,
    use_bf16: bool = True,
    schur_impl: str = "flat",
    linear_solver: str = "lu",
    cg_iters: int = 48,
) -> BAResult:
    if schur_impl == "flatpm":
        return _solve_flat_pm(
            cam, prob, n_free, ba_lambda2, tri_str_thresh,
            prior_rot_info, prior_trans_info,
            iters1, iters2, iters3, term_gain, use_bf16, linear_solver,
        )
    L = n_free
    P, MO = prob.obs_cam.shape
    dtype = prob.pts.dtype
    huber_delta = jnp.where(
        prob.obs_stereo, jnp.sqrt(CHI2_STEREO), jnp.sqrt(CHI2_MONO)
    ).astype(dtype)
    chi2_th = jnp.where(prob.obs_stereo, CHI2_STEREO, CHI2_MONO).astype(dtype)

    free_mask = (jnp.arange(prob.cam_q.shape[0]) < L) & prob.cam_valid
    obs_exists = (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    obs_on_free = obs_exists & (prob.obs_cam < L) & free_mask[
        jnp.clip(prob.obs_cam, 0, L - 1)
    ]
    # one-hot over free camera slots: (P, MO, L) — gathered reductions only
    onehot = (
        (prob.obs_cam[..., None] == jnp.arange(L)[None, None, :])
        & obs_on_free[..., None]
    ).astype(dtype)

    # bf16 staging for the heavy (P,MO,·) einsums — inputs in bfloat16,
    # accumulation in f32. The Hessian blocks become mildly
    # approximate (a preconditioner-quality change; the LM accept test
    # uses the exact f32 cost), halving the dominant HBM traffic. chi2 is
    # always computed in f32 inside the pass, so the accept cost is exact.
    stage_dt = jnp.bfloat16 if use_bf16 else dtype
    ohb = onehot.astype(stage_dt)

    def products_at(cam_q, cam_t, pts):
        """The single (P, MO) residual+Jacobian pass. Everything heavy the
        LM loop needs at a state is computed here once."""
        r, Jc, Jp, chi2, depth_ok = _obs_terms(cam, prob, cam_q, cam_t, pts)
        return (
            r.astype(stage_dt), Jc.astype(stage_dt), Jp.astype(stage_dt),
            chi2, depth_ok,
        )

    def cost_from(products, cam_q, cam_t, pts, active_obs, active_str, use_huber):
        """Exact total cost from carried products — no (P,MO,·) pass."""
        s = products[3]
        d = huber_delta
        rho = jnp.where(
            use_huber & (s > d * d), 2.0 * d * jnp.sqrt(jnp.clip(s, 1e-24)) - d * d, s
        )
        c_obs = jnp.sum(jnp.where(active_obs, rho, 0.0))
        _, _, c_str = _gmm_terms(prob, pts, ba_lambda2, active_str)
        _, _, c_pri = _prior_terms(
            prob, cam_q, cam_t, prior_rot_info, prior_trans_info
        )
        return c_obs + jnp.sum(jnp.where(prob.pt_valid, c_str, 0.0)) + c_pri

    def lm_step(products, cam_q, cam_t, pts, lam, active_obs, active_str, use_huber):
        rb, Jcb, Jpb, chi2, _ = products
        hw = jnp.where(use_huber, factors.huber_weight(chi2, huber_delta), 1.0)
        w = prob.obs_sigma2_inv * hw * active_obs.astype(dtype)   # (P,MO)
        wb = w.astype(stage_dt)
        ein = functools.partial(jnp.einsum, preferred_element_type=jnp.float32)

        # point blocks (dense per-point reductions over MO)
        H_pp = ein("pmai,pm,pmaj->pij", Jpb, wb, Jpb)
        b_p = ein("pmai,pm,pma->pi", Jpb, wb, rb)
        H_str, b_str, _ = _gmm_terms(prob, pts, ba_lambda2, active_str)
        H_pp = H_pp + jnp.where(prob.pt_valid[:, None, None], H_str, 0.0)
        b_p = b_p + jnp.where(prob.pt_valid[:, None], b_str, 0.0)

        H_pri, b_pri, _ = _prior_terms(
            prob, cam_q, cam_t, prior_rot_info, prior_trans_info
        )

        # LM damping on points (multiplicative block-diagonal)
        eyep = jnp.eye(3, dtype=dtype)
        H_pp_d = H_pp + lam * (
            jnp.einsum("pii->p", H_pp)[:, None, None] / 3.0 + 1e-9
        ) * eyep
        H_pp_d = jnp.where(
            prob.pt_valid[:, None, None], H_pp_d, jnp.eye(3, dtype=dtype)
        )
        Hpp_inv, _ = _inv3(H_pp_d)
        eyec = jnp.eye(6, dtype=dtype)

        if schur_impl == "flat":
            # Flattened-GEMM assembly: the camera-side reductions become
            # large clean matmuls — Z[p, n, l*6+i] = onehot[p,m,l] *
            # Jc[p,m,a,i] with n = m*3+a, so H_cc = Z^T W Z ((96, P·N) @
            # (P·N, 96)), U = batched (P,96,N)@(P,N,3), and the Schur term
            # is one (96, P·3)@(P·3, 96) GEMM. Bit-equal to the one-hot
            # einsum path (same contractions, reshaped into GEMMs).
            N = MO * 3
            Z = (ohb[:, :, None, :, None] * Jcb[:, :, :, None, :]).reshape(
                P, N, L * 6
            )
            Wn = jnp.repeat(wb, 3, axis=-1).reshape(P, N)
            Jpf = Jpb.reshape(P, N, 3)
            rf = rb.reshape(P, N)
            ZW = Z * Wn[..., None]
            H_cc_full = ein("pnc,pnd->cd", ZW, Z)            # (6L,6L)
            b_c_full = ein("pnc,pn->c", ZW, rf)              # (6L,)
            Uf = ein("pnc,pnj->pcj", ZW, Jpf)                # (P,6L,3)

            H_cc_full = H_cc_full.at[:6, :6].add(H_pri)
            b_c_full = b_c_full.at[:6].add(b_pri)

            Tf = ein("pcj,pjk->pck", Uf, Hpp_inv.astype(jnp.float32))
            S_flat = H_cc_full - ein("pcj,pdj->cd", Tf, Uf)
            # camera LM damping: per-6x6-block trace/6 on the diagonal
            tr = jnp.einsum("cc->c", H_cc_full).reshape(L, 6).sum(-1)
            S_flat = S_flat + jnp.diag(
                jnp.repeat(lam * (tr / 6.0 + 1e-9), 6)
            )
            b_red = (b_c_full - ein("pcj,pj->c", Tf, b_p)).reshape(L, 6)
        elif schur_impl == "blockdiag":
            # Staged pairwise contractions exploiting that H_cc is
            # BLOCK-DIAGONAL (camera-camera coupling enters only via the
            # point Schur term): per-observation 6x6 / 6x3 products first,
            # then one (L, P*M)@(P*M, ...) GEMM against the one-hot — no
            # (P, M*3, 6L) Z materialization (the "flat" path moves ~110MB
            # of Z/ZW per iteration; this moves ~25MB). Numerically the
            # same contractions as the one-hot einsum path.
            JcW = Jcb * wb[..., None, None]                       # (P,M,3,6)
            JWJc = ein("pmai,pmaj->pmij", JcW, Jcb)               # (P,M,6,6)
            JWJp = ein("pmai,pmaj->pmij", JcW, Jpb)               # (P,M,6,3)
            JWr = ein("pmai,pma->pmi", JcW, rb)                   # (P,M,6)
            H_cc = ein(
                "pml,pmx->lx", ohb, JWJc.reshape(P, MO, 36).astype(stage_dt)
            ).reshape(L, 6, 6)
            b_c = ein("pml,pmi->li", ohb, JWr.astype(stage_dt))
            U = ein("pml,pmx->plx", ohb, JWJp.reshape(P, MO, 18)
                    .astype(stage_dt)).reshape(P, L, 6, 3)
            H_cc = H_cc.at[0].add(H_pri)
            b_c = b_c.at[0].add(b_pri)

            H_cc_d = H_cc + lam * (
                jnp.einsum("lii->l", H_cc)[:, None, None] / 6.0 + 1e-9
            ) * eyec

            T = jnp.einsum("plij,pjk->plik", U, Hpp_inv)          # (P,L,6,3)
            S_red = -jnp.einsum("plij,pmkj->lmik", T, U)
            S_red = S_red.at[jnp.arange(L), jnp.arange(L)].add(H_cc_d)
            b_red = b_c - jnp.einsum("plij,pj->li", T, b_p)       # (L,6)
            S_flat = S_red.transpose(0, 2, 1, 3).reshape(L * 6, L * 6)
            Uf = U.reshape(P, L * 6, 3)
        else:
            # camera blocks via one-hot einsum (no scatters)
            H_cc = ein("pmai,pm,pmaj,pml->lij", Jcb, wb, Jcb, ohb)
            b_c = ein("pmai,pm,pma,pml->li", Jcb, wb, rb, ohb)
            H_cc = H_cc.at[0].add(H_pri)
            b_c = b_c.at[0].add(b_pri)

            # camera-point coupling U[p,l] = sum_m Jc^T W Jp
            U = ein("pmai,pm,pmaj,pml->plij", Jcb, wb, Jpb, ohb)  # (P,L,6,3)

            H_cc_d = H_cc + lam * (
                jnp.einsum("lii->l", H_cc)[:, None, None] / 6.0 + 1e-9
            ) * eyec

            # Schur reduction (einsums over P)
            T = jnp.einsum("plij,pjk->plik", U, Hpp_inv)          # (P,L,6,3)
            S_red = -jnp.einsum("plij,pmkj->lmik", T, U)
            S_red = S_red.at[jnp.arange(L), jnp.arange(L)].add(H_cc_d)
            b_red = b_c - jnp.einsum("plij,pj->li", T, b_p)       # (L,6)
            S_flat = S_red.transpose(0, 2, 1, 3).reshape(L * 6, L * 6)
            Uf = U.reshape(P, L * 6, 3)

        fm = free_mask[:L]
        diag_fix = jnp.repeat(~fm, 6)
        S_flat = jnp.where(
            diag_fix[:, None] | diag_fix[None, :],
            jnp.eye(L * 6, dtype=dtype),
            S_flat,
        )
        b_flat = jnp.where(jnp.repeat(fm, 6), b_red.reshape(-1), 0.0)

        if linear_solver == "cg":
            dc = -_pcg_solve(S_flat, b_flat, cg_iters).reshape(L, 6)
        else:
            dc = -jnp.linalg.solve(S_flat, b_flat).reshape(L, 6)
        dc = jnp.where(fm[:, None], dc, 0.0)

        # back-substitute points (gathers only)
        rhs_p = b_p + jnp.einsum("pcj,c->pj", Uf, dc.reshape(-1))
        dp = -jnp.einsum("pij,pj->pi", Hpp_inv, rhs_p)
        dp = jnp.where(prob.pt_valid[:, None], dp, 0.0)

        new_q_free, new_t_free = se3.boxplus(cam_q[:L], cam_t[:L], dc)
        new_q = jnp.concatenate([new_q_free, cam_q[L:]], axis=0)
        new_t = jnp.concatenate([new_t_free, cam_t[L:]], axis=0)
        return new_q, new_t, pts + dp

    def run_stage(state, active_obs, active_str, use_huber, iters):
        # while_loop with convergence termination — g2o's optimize(n) also
        # stops early when the chi2 gain becomes negligible, and most of
        # the 40-iteration budget is never used.
        def cond(carry):
            _, _, _, _, lam, cost, it, done = carry
            return (it < iters) & ~done

        def body(carry):
            cam_q, cam_t, pts, products, lam, cost, it, done = carry
            nq, nt, npts = lm_step(
                products, cam_q, cam_t, pts, lam, active_obs, active_str, use_huber
            )
            nproducts = products_at(nq, nt, npts)
            new_cost = cost_from(
                nproducts, nq, nt, npts, active_obs, active_str, use_huber
            )
            accept = new_cost < cost
            gain = (cost - new_cost) / jnp.maximum(cost, 1e-12)
            done = (accept & (gain < term_gain)) | (lam > 1e4)
            cam_q = jnp.where(accept, nq, cam_q)
            cam_t = jnp.where(accept, nt, cam_t)
            pts = jnp.where(accept, npts, pts)
            products = jax.tree_util.tree_map(
                lambda new, old: jnp.where(accept, new, old), nproducts, products
            )
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9), lam * 4.0)
            cost = jnp.minimum(new_cost, cost)
            return cam_q, cam_t, pts, products, lam, cost, it + 1, done

        cam_q, cam_t, pts, products, lam0, it_tot = state
        cost0 = cost_from(
            products, cam_q, cam_t, pts, active_obs, active_str, use_huber
        )
        out = jax.lax.while_loop(
            cond, body,
            (cam_q, cam_t, pts, products, lam0, cost0, jnp.array(0),
             jnp.array(False)),
        )
        return out[:5] + (it_tot + out[6],)

    use_huber = jnp.array(True)
    active_obs = prob.obs_valid & obs_exists
    active_str = prob.pt_valid & (prob.str_type != STR_NONE)

    state = (
        prob.cam_q, prob.cam_t, prob.pts,
        products_at(prob.cam_q, prob.cam_t, prob.pts),
        jnp.array(1e-4, dtype), jnp.array(0),
    )
    state = run_stage(state, active_obs, active_str, use_huber, iters1)

    # stage-1 -> stage-2 gate: drop bad degenerate structure edges (:773-789)
    pts_s1 = state[2]
    rs = factors.pt2plane_residual(pts_s1, prob.str_mean, prob.str_normal)
    chi2_deg = ba_lambda2 * rs * rs
    bad_deg = (prob.str_type == STR_DEG) & (chi2_deg > tri_str_thresh * ba_lambda2)
    active_str = active_str & ~bad_deg

    state = run_stage(state, active_obs, active_str, use_huber, iters2)

    # stage-2 -> stage-3 gate: drop bad reprojection edges, drop Huber
    # (:797-825) — chi2/depth at the stage-2 state come from the carried
    # products, no extra residual pass.
    chi2_o, depth_ok = state[3][3], state[3][4]
    bad_obs = (chi2_o > chi2_th) | ~depth_ok
    active_obs = active_obs & ~bad_obs
    use_huber = jnp.array(False)

    state = run_stage(state, active_obs, active_str, use_huber, iters3)
    cam_q_f, cam_t_f, pts_f = state[0], state[1], state[2]

    # final classification (:837-894) from the final carried products
    chi2_f, depth_ok_f = state[3][3], state[3][4]
    obs_bad = prob.obs_valid & obs_exists & ((chi2_f > chi2_th) | ~depth_ok_f)
    rs_f = factors.pt2plane_residual(pts_f, prob.str_mean, prob.str_normal)
    chi2_deg_f = ba_lambda2 * rs_f * rs_f
    str_drop = (
        prob.pt_valid
        & (prob.str_type == STR_DEG)
        & (chi2_deg_f > tri_str_thresh * ba_lambda2)
    )
    cost_f = cost_from(
        state[3], cam_q_f, cam_t_f, pts_f, active_obs, active_str, use_huber
    )
    return BAResult(
        cam_q_f, cam_t_f, pts_f, obs_bad, str_drop, chi2_f, cost_f,
        state[5].astype(jnp.int32),
    )


def _solve_flat_pm(
    cam, prob: BAProblem, n_free,
    ba_lambda2, tri_str_thresh, prior_rot_info, prior_trans_info,
    iters1, iters2, iters3, term_gain, use_bf16, linear_solver,
) -> BAResult:
    """Lane-major staged-LM solve: every per-observation quantity lives
    as a (k, P*MO) vector with the OBSERVATION axis minormost.

    Why: the (P, MO, 3, 6) layouts of the flat/onehot paths put 3- and
    6-wide dims in the minor position, which wide vector tiles pad.
    Here jacobians are 18/9/3 separate (PM,) vectors (perfect lanes), H_cc is computed in its true
    BLOCK-DIAGONAL form via three (6L, PM)@(PM, 6) GEMMs, U lives as
    (6L, 3, P), and the Schur term is one (6L, 3P)@(3P, 6L) GEMM.

    Same staged 5/5/40 schedule, gates, carried-products LM and result
    classification as the flat path (ref localization_opt.cpp:769-894);
    same bf16 staging semantics (products bf16, chi2/cost exact f32).
    """
    L = n_free
    P, MO = prob.obs_cam.shape
    PM = P * MO
    dtype = prob.pts.dtype
    stage_dt = jnp.bfloat16 if use_bf16 else dtype
    C = prob.cam_q.shape[0]

    # ---- flat (PM,) observation-major constants -----------------------
    ci = prob.obs_cam.reshape(PM)
    cic = jnp.clip(ci, 0, C - 1)
    stereo_f = prob.obs_stereo.reshape(PM)
    s2i_f = prob.obs_sigma2_inv.reshape(PM).astype(dtype)
    uvr_f = [prob.obs_uvr.reshape(PM, 3)[:, a] for a in range(3)]
    huber_delta_f = jnp.where(
        stereo_f, jnp.sqrt(CHI2_STEREO), jnp.sqrt(CHI2_MONO)
    ).astype(dtype)
    chi2_th_f = jnp.where(stereo_f, CHI2_STEREO, CHI2_MONO).astype(dtype)

    free_mask = (jnp.arange(C) < L) & prob.cam_valid
    obs_exists_f = (ci >= 0) & jnp.repeat(prob.pt_valid, MO)
    on_free_f = obs_exists_f & (ci < L) & free_mask[jnp.clip(ci, 0, L - 1)]
    # one-hot over free cameras, lane-major: (L, PM)
    oh = (
        (jnp.arange(L)[:, None] == ci[None, :]) & on_free_f[None, :]
    ).astype(stage_dt)

    def pts_flat(pts):
        """(P,3) -> x per obs as three (PM,) vectors (pure layout)."""
        xT = pts.T  # (3,P)
        return [
            jnp.broadcast_to(xT[a, :, None], (P, MO)).reshape(PM)
            for a in range(3)
        ]

    def products_at(cam_q, cam_t, pts):
        """Flat residual + jacobian pass. Returns
        (r[3](PM,), Jc[18](PM,), Jp[9](PM,), chi2 (PM,), depth_ok (PM,))
        with r/Jc/Jp staged to bf16, chi2 exact f32."""
        R = se3.quat_to_matrix(cam_q)                     # (C,3,3)
        Rf = [[R[:, i, j][cic] for j in range(3)] for i in range(3)]
        tf = [cam_t[:, i][cic] for i in range(3)]
        x = pts_flat(pts)
        pc = [
            Rf[i][0] * x[0] + Rf[i][1] * x[1] + Rf[i][2] * x[2] + tf[i]
            for i in range(3)
        ]
        xx, yy, z = pc
        z_safe = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        iz = 1.0 / z_safe
        iz2 = iz * iz
        st = stereo_f.astype(dtype)
        pred_u = cam.fx * xx * iz + cam.cx
        pred_v = cam.fy * yy * iz + cam.cy
        pred_ur = pred_u - cam.bf * iz
        r = [
            pred_u - uvr_f[0],
            pred_v - uvr_f[1],
            (pred_ur - uvr_f[2]) * st,
        ]
        chi2 = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * s2i_f
        depth_ok = z > 0.0

        zr = jnp.zeros_like(xx)
        # dpc rows (d pred_a / d pc): u, v, ur
        d_u = (cam.fx * iz, zr, -cam.fx * xx * iz2)
        d_v = (zr, cam.fy * iz, -cam.fy * yy * iz2)
        d_ur = (d_u[0] * st, zr, (d_u[2] + cam.bf * iz2) * st)
        Jc = []
        Jp = []
        for d in (d_u, d_v, d_ur):
            d0, d1, d2 = d
            # omega block: -d @ skew(pc); upsilon block: d
            Jc.extend([
                d2 * yy - d1 * z, d0 * z - d2 * xx, d1 * xx - d0 * yy,
                d0, d1, d2,
            ])
            # point block: d @ R_cw
            for j in range(3):
                Jp.append(d0 * Rf[0][j] + d1 * Rf[1][j] + d2 * Rf[2][j])
        cast = lambda vs: [v.astype(stage_dt) for v in vs]
        return cast(r), cast(Jc), cast(Jp), chi2, depth_ok

    def cost_from(products, cam_q, cam_t, pts, active_f, active_str, use_huber):
        chi2 = products[3]
        d = huber_delta_f
        rho = jnp.where(
            use_huber & (chi2 > d * d),
            2.0 * d * jnp.sqrt(jnp.clip(chi2, 1e-24)) - d * d, chi2,
        )
        c_obs = jnp.sum(jnp.where(active_f, rho, 0.0))
        _, _, c_str = _gmm_terms(prob, pts, ba_lambda2, active_str)
        _, _, c_pri = _prior_terms(
            prob, cam_q, cam_t, prior_rot_info, prior_trans_info
        )
        return c_obs + jnp.sum(jnp.where(prob.pt_valid, c_str, 0.0)) + c_pri

    eyec = jnp.eye(6, dtype=dtype)
    eyep = jnp.eye(3, dtype=dtype)

    def lm_step(products, cam_q, cam_t, pts, lam, active_f, active_str,
                use_huber):
        r, Jc, Jp, chi2, _ = products
        hw = jnp.where(
            use_huber, factors.huber_weight(chi2, huber_delta_f), 1.0
        )
        w = s2i_f * hw * active_f.astype(dtype)
        sqw = jnp.sqrt(w).astype(stage_dt)                    # (PM,)
        rw = [v * sqw for v in r]
        Jcw = [v * sqw for v in Jc]
        Jpw = [v * sqw for v in Jp]

        f32 = lambda v: v.astype(jnp.float32)
        # point blocks H_pp (P,3,3), b_p (3,P): minor-M reductions
        red = lambda v: f32(v).reshape(P, MO).sum(-1)
        H_pp = jnp.stack([
            jnp.stack([
                red(sum(Jpw[a * 3 + i] * Jpw[a * 3 + j] for a in range(3)))
                for j in range(3)
            ], -1)
            for i in range(3)
        ], -2)                                                # (P,3,3)
        b_p3 = [
            red(sum(Jpw[a * 3 + i] * rw[a] for a in range(3)))
            for i in range(3)
        ]
        b_p = jnp.stack(b_p3, -1)                             # (P,3)

        H_str, b_str, _ = _gmm_terms(prob, pts, ba_lambda2, active_str)
        H_pp = H_pp + jnp.where(prob.pt_valid[:, None, None], H_str, 0.0)
        b_p = b_p + jnp.where(prob.pt_valid[:, None], b_str, 0.0)
        H_pri, b_pri, _ = _prior_terms(
            prob, cam_q, cam_t, prior_rot_info, prior_trans_info
        )
        H_pp_d = H_pp + lam * (
            jnp.einsum("pii->p", H_pp)[:, None, None] / 3.0 + 1e-9
        ) * eyep
        H_pp_d = jnp.where(prob.pt_valid[:, None, None], H_pp_d, eyep)
        Hpp_inv, _ = _inv3(H_pp_d)                            # (P,3,3) f32

        # camera blocks, block-diagonal: three (6L, PM)@(PM, 6) GEMMs
        Hcc_blocks = jnp.zeros((L, 6, 6), jnp.float32)
        b_c = jnp.zeros((L, 6), jnp.float32)
        ein = functools.partial(jnp.einsum, preferred_element_type=jnp.float32)
        for a in range(3):
            Jca = jnp.stack(Jcw[a * 6:(a + 1) * 6], 0)        # (6, PM)
            A = (oh[:, None, :] * Jca[None, :, :]).reshape(L * 6, PM)
            Hcc_blocks = Hcc_blocks + ein(
                "cm,im->ci", A, Jca
            ).reshape(L, 6, 6)
            b_c = b_c + ein("cm,m->c", A, rw[a]).reshape(L, 6)
        Hcc_blocks = Hcc_blocks.at[0].add(H_pri)
        b_c = b_c.at[0].add(b_pri)

        # U (6L, 3, P): JcWJp[i,j] = sum_a Jcw[a6+i] * Jpw[a3+j], then the
        # per-(l) m-reduction (oh_l * JcWJp).sum(minor M)
        JcWJp = jnp.stack([
            sum(Jcw[a * 6 + i] * Jpw[a * 3 + j] for a in range(3))
            for i in range(6) for j in range(3)
        ], 0)                                                 # (18, PM)
        Uparts = []
        for l in range(L):
            m = (oh[l][None, :] * JcWJp).astype(jnp.float32)
            Uparts.append(m.reshape(18, P, MO).sum(-1))       # (18,P)
        U = jnp.stack(Uparts, 0).reshape(L * 6, 3, P)         # (6L,3,P)

        # Tf = U @ Hpp_inv (per point): (6L,3,P)
        G = Hpp_inv.transpose(1, 2, 0).astype(jnp.float32)    # (3,3,P)
        Tf = jnp.stack([
            sum(U[:, k, :] * G[k, j, :][None, :] for k in range(3))
            for j in range(3)
        ], 1)                                                 # (6L,3,P)

        S = ein("cjp,djp->cd", Tf, U)                         # (6L,6L)
        # assemble damped block-diagonal H_cc into S
        tr = jnp.einsum("lii->l", Hcc_blocks)
        Hcc_d = Hcc_blocks + (
            lam * (tr[:, None, None] / 6.0 + 1e-9)
        ) * eyec
        bd = jnp.zeros((L, 6, L, 6), jnp.float32)
        bd = bd.at[jnp.arange(L), :, jnp.arange(L), :].set(Hcc_d)
        S_flat = bd.reshape(L * 6, L * 6) - S
        b_red = b_c.reshape(-1) - ein("cjp,pj->c", Tf, b_p)

        fm = free_mask[:L]
        diag_fix = jnp.repeat(~fm, 6)
        S_flat = jnp.where(
            diag_fix[:, None] | diag_fix[None, :],
            jnp.eye(L * 6, dtype=jnp.float32), S_flat,
        )
        b_flat = jnp.where(jnp.repeat(fm, 6), b_red, 0.0)
        dc = -jnp.linalg.solve(S_flat, b_flat).reshape(L, 6)
        dc = jnp.where(fm[:, None], dc, 0.0)

        # back-substitute points: rhs_p = b_p + U^T dc
        rhs_p = b_p + ein("cjp,c->pj", U, dc.reshape(-1))
        dp = -jnp.einsum("pij,pj->pi", Hpp_inv, rhs_p)
        dp = jnp.where(prob.pt_valid[:, None], dp, 0.0)

        new_q_free, new_t_free = se3.boxplus(cam_q[:L], cam_t[:L], dc)
        new_q = jnp.concatenate([new_q_free, cam_q[L:]], axis=0)
        new_t = jnp.concatenate([new_t_free, cam_t[L:]], axis=0)
        return new_q, new_t, pts + dp

    def run_stage(state, active_f, active_str, use_huber, iters):
        def cond(carry):
            _, _, _, _, lam, cost, it, done = carry
            return (it < iters) & ~done

        def body(carry):
            cam_q, cam_t, pts, products, lam, cost, it, done = carry
            nq, nt, npts = lm_step(
                products, cam_q, cam_t, pts, lam, active_f, active_str,
                use_huber,
            )
            nproducts = products_at(nq, nt, npts)
            new_cost = cost_from(
                nproducts, nq, nt, npts, active_f, active_str, use_huber
            )
            accept = new_cost < cost
            gain = (cost - new_cost) / jnp.maximum(cost, 1e-12)
            done = (accept & (gain < term_gain)) | (lam > 1e4)
            cam_q = jnp.where(accept, nq, cam_q)
            cam_t = jnp.where(accept, nt, cam_t)
            pts = jnp.where(accept, npts, pts)
            products = jax.tree_util.tree_map(
                lambda new, old: jnp.where(accept, new, old),
                nproducts, products,
            )
            lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-9), lam * 4.0)
            cost = jnp.minimum(new_cost, cost)
            return cam_q, cam_t, pts, products, lam, cost, it + 1, done

        cam_q, cam_t, pts, products, lam0, it_tot = state
        cost0 = cost_from(
            products, cam_q, cam_t, pts, active_f, active_str, use_huber
        )
        out = jax.lax.while_loop(
            cond, body,
            (cam_q, cam_t, pts, products, lam0, cost0, jnp.array(0),
             jnp.array(False)),
        )
        return out[:5] + (it_tot + out[6],)

    use_huber = jnp.array(True)
    active_f = prob.obs_valid.reshape(PM) & obs_exists_f
    active_str = prob.pt_valid & (prob.str_type != STR_NONE)

    state = (
        prob.cam_q, prob.cam_t, prob.pts,
        products_at(prob.cam_q, prob.cam_t, prob.pts),
        jnp.array(1e-4, dtype), jnp.array(0),
    )
    state = run_stage(state, active_f, active_str, use_huber, iters1)

    pts_s1 = state[2]
    rs = factors.pt2plane_residual(pts_s1, prob.str_mean, prob.str_normal)
    chi2_deg = ba_lambda2 * rs * rs
    bad_deg = (prob.str_type == STR_DEG) & (
        chi2_deg > tri_str_thresh * ba_lambda2
    )
    active_str = active_str & ~bad_deg

    state = run_stage(state, active_f, active_str, use_huber, iters2)

    chi2_o, depth_ok = state[3][3], state[3][4]
    bad_obs = (chi2_o > chi2_th_f) | ~depth_ok
    active_f = active_f & ~bad_obs
    use_huber = jnp.array(False)

    state = run_stage(state, active_f, active_str, use_huber, iters3)
    cam_q_f, cam_t_f, pts_f = state[0], state[1], state[2]

    chi2_ff, depth_ok_f = state[3][3], state[3][4]
    obs_bad = (
        prob.obs_valid.reshape(PM) & obs_exists_f
        & ((chi2_ff > chi2_th_f) | ~depth_ok_f)
    ).reshape(P, MO)
    rs_f = factors.pt2plane_residual(pts_f, prob.str_mean, prob.str_normal)
    chi2_deg_f = ba_lambda2 * rs_f * rs_f
    str_drop = (
        prob.pt_valid
        & (prob.str_type == STR_DEG)
        & (chi2_deg_f > tri_str_thresh * ba_lambda2)
    )
    cost_f = cost_from(
        state[3], cam_q_f, cam_t_f, pts_f, active_f, active_str, use_huber
    )
    return BAResult(
        cam_q_f, cam_t_f, pts_f, obs_bad, str_drop,
        state[3][3].reshape(P, MO), cost_f, state[5].astype(jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "cam", "n_free", "ba_lambda2", "tri_str_thresh",
        "iters1", "iters2", "iters3", "use_bf16",
        "schur_impl", "linear_solver",
    ),
)
def solve_local_ba_batch(
    cam: cam_mod.CameraParams,
    probs: BAProblem,          # leading batch axis on every leaf
    n_free: int,
    ba_lambda2: float = 400.0,
    tri_str_thresh: float = 0.0064,
    iters1: int = 5,
    iters2: int = 5,
    iters3: int = 40,
    use_bf16: bool = True,
    schur_impl: str = "flat",
    linear_solver: str = "lu",
) -> BAResult:
    """Solve B INDEPENDENT local-BA windows in one dispatch (vmap).

    On the first platform vmap batching did not amortize the LM chain
    (the iteration cost was not launch-bound there); on the GPU it is
    not measured yet. This API remains for data-parallel sequence sweeps where one
    dispatch over B independent maps is operationally convenient;
    windows that share keyframes must stay sequential anyway (the
    reference's per-KF ordering, localization.cpp:65-122).
    """
    return jax.vmap(
        lambda p: solve_local_ba(
            cam, p, n_free, ba_lambda2=ba_lambda2,
            tri_str_thresh=tri_str_thresh,
            iters1=iters1, iters2=iters2, iters3=iters3,
            use_bf16=use_bf16, schur_impl=schur_impl,
            linear_solver=linear_solver,
        )
    )(probs)
