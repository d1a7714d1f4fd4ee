"""Single-program Pallas kernel (Triton route) for the staged pose solve.

XLA runs pose_solver.optimize_pose as a while_loop of small fusions: on
the GPU every Gauss-Newton iteration costs several kernel launches plus a
device-to-host read of the loop condition, so the 4-round x 10-iteration
schedule (tracking_opt.cpp:21-227) is bound by launch and sync overhead,
not by arithmetic. This kernel runs the whole schedule -- residuals,
Jacobians, Huber weights, 6x6 normal equations, Cholesky, quaternion
boxplus, per-round outlier reclassification and the GMM anchor terms --
in ONE program (grid (1,)). The per-feature state is one power-of-two
block (B >= F lanes, padding lanes invalid) loaded once; each iteration's
21 + 6 normal-equation sums are block reductions, and the pose and
Cholesky math is scalar code.

Numerically equivalent (not bit-identical: reduction order differs) to
the XLA path; tests/test_pallas_pose.py gates it against pose_solver in
interpret mode, chip_smoke.py on the card.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..geometry import camera as cam_mod
from . import pose_solver

# warps per program, measured on the H100 at F=1280 (PERF.md, PR 1):
# 16 beat 4, 8 and 32
NUM_WARPS = 16

# channel indices of the packed per-feature tensor (16, B)
_CH_XW = 0          # 0..2 landmark world position
_CH_OBS = 3         # 3..5 (u, v, u_right)
_CH_STEREO = 6
_CH_S2I = 7
_CH_VALID = 8
_CH_CHI2TH = 9
_CH_DELTA = 10
N_CH = 16           # padded to a power of two

# anchor channels (separate (32, B) tensor, present when use_anchors)
_AC_XC = 0          # 0..2 camera-frame measured point
_AC_MEAN = 3        # 3..5 component mean (world)
_AC_NORM = 6        # 6..8 dominant normal
_AC_SQI = 9         # 9..17 sqrt_info rows (row-major L)
_AC_W = 18
_AC_EXISTS = 19
_AC_DEG = 20
N_AC = 32

# packed pose output: q(4) t(3) n_inliers n_anchors, padded
POSE_W = 16


def _quat_to_R(q):
    """Unit quaternion (4 scalars) -> 9 rotation-matrix scalars."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


def _boxplus(q, t, dx):
    """Scalar SE3 left-multiplicative update exp(xi)*(q,t), xi=[omega,ups].

    Mirrors se3.boxplus/so3_exp/_v_matrix exactly (incl. small-angle
    branches via where) on 0-d scalars so the kernel needs no
    small-array ops."""
    w0, w1, w2, u0, u1, u2 = dx
    theta2 = w0 * w0 + w1 * w1 + w2 * w2
    theta = jnp.sqrt(jnp.maximum(theta2, 1e-24))
    small = theta2 < 1e-12
    half = 0.5 * theta
    qw = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    s = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / theta)
    dq = (qw, w0 * s, w1 * s, w2 * s)
    dn = jax.lax.rsqrt(
        jnp.maximum(dq[0] ** 2 + dq[1] ** 2 + dq[2] ** 2 + dq[3] ** 2, 1e-24)
    )
    dq = tuple(c * dn for c in dq)

    # V(omega) = I + a*Om + b*Om2 with Om2 = w w^T - theta2 * I
    a = jnp.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, 1e-24),
    )
    b = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, 1e-24),
    )
    om = ((0.0, -w2, w1), (w2, 0.0, -w0), (-w1, w0, 0.0))
    w = (w0, w1, w2)
    V = [[0.0] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            V[i][j] = a * om[i][j] + b * w[i] * w[j]
        V[i][i] = V[i][i] + (1.0 - b * theta2)
    ups = (u0, u1, u2)
    dt = tuple(sum(V[i][j] * ups[j] for j in range(3)) for i in range(3))

    # compose: q' = dq (x) q ; t' = R(dq) t + dt ; renormalize q'
    aw, ax, ay, az = dq
    bw, bx, by, bz = q
    qn = (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )
    Rd = _quat_to_R(dq)
    tn = tuple(
        Rd[i][0] * t[0] + Rd[i][1] * t[1] + Rd[i][2] * t[2] + dt[i]
        for i in range(3)
    )
    nn = jax.lax.rsqrt(
        jnp.maximum(qn[0] ** 2 + qn[1] ** 2 + qn[2] ** 2 + qn[3] ** 2, 1e-24)
    )
    qn = tuple(c * nn for c in qn)
    return qn, tn


def _chol_solve6(H, b):
    """Scalar 6x6 Cholesky solve on nested lists (pose_solver._chol_solve6
    semantics). Returns a list of 6 scalars."""
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        s = H[i][i]
        for k in range(i):
            s = s - L[i][k] * L[i][k]
        L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-20))
        for j in range(i + 1, 6):
            s2 = H[j][i]
            for k in range(i):
                s2 = s2 - L[j][k] * L[i][k]
            L[j][i] = s2 / L[i][i]
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _make_kernel(cam: cam_mod.CameraParams, rounds: int, iters: int,
                 step_tol: float, use_anchors: bool):
    fx, fy, cx, cy, bf = (
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
        float(cam.bf),
    )

    def kernel(scal_ref, ch_ref, *rest):
        if use_anchors:
            anc_ref, pose_out, chi2_out, flags_out = rest
        else:
            anc_ref, (pose_out, chi2_out, flags_out) = None, rest

        def ch(i):
            return ch_ref[i, :]

        xwx, xwy, xwz = ch(_CH_XW), ch(_CH_XW + 1), ch(_CH_XW + 2)
        ou, ov, orr = ch(_CH_OBS), ch(_CH_OBS + 1), ch(_CH_OBS + 2)
        stereo = ch(_CH_STEREO)
        s2i = ch(_CH_S2I)
        valid = ch(_CH_VALID)
        chi2_th = ch(_CH_CHI2TH)
        delta = ch(_CH_DELTA)

        q0 = tuple(scal_ref[k] for k in range(4))
        t0 = tuple(scal_ref[4 + k] for k in range(3))
        anc_chi2_th = scal_ref[7]
        anc_delta = jnp.sqrt(jnp.maximum(anc_chi2_th, 1e-24))

        if use_anchors:
            def ac(i):
                return anc_ref[i, :]

            acx = ac(_AC_XC)
            acy = ac(_AC_XC + 1)
            acz = ac(_AC_XC + 2)
            amx = ac(_AC_MEAN)
            amy = ac(_AC_MEAN + 1)
            amz = ac(_AC_MEAN + 2)
            anx = ac(_AC_NORM)
            any_ = ac(_AC_NORM + 1)
            anz = ac(_AC_NORM + 2)
            sqi = [
                [ac(_AC_SQI + 3 * i + j) for j in range(3)]
                for i in range(3)
            ]
            aw = ac(_AC_W)
            aex = ac(_AC_EXISTS)
            adeg = ac(_AC_DEG)

        def reproj_rows(q, t):
            """Residual rows + J rows + chi2, given scalar pose."""
            R = _quat_to_R(q)
            pcx = R[0][0] * xwx + R[0][1] * xwy + R[0][2] * xwz + t[0]
            pcy = R[1][0] * xwx + R[1][1] * xwy + R[1][2] * xwz + t[1]
            pcz = R[2][0] * xwx + R[2][1] * xwy + R[2][2] * xwz + t[2]
            zs = jnp.where(jnp.abs(pcz) < 1e-9, 1e-9, pcz)
            iz = 1.0 / zs
            iz2 = iz * iz
            u = fx * pcx * iz + cx
            v = fy * pcy * iz + cy
            ur = u - bf * iz
            ru = u - ou
            rv = v - ov
            rr = (ur - orr) * stereo
            chi2 = (ru * ru + rv * rv + rr * rr) * s2i
            # J rows via dpc = [-skew(pc) | I] (factors.stereo_proj_jac_pose)
            a0 = fx * iz
            a2 = -fx * pcx * iz2
            b1 = fy * iz
            b2 = -fy * pcy * iz2
            c = bf * iz2
            Ju = (a2 * pcy, a0 * pcz - a2 * pcx, -a0 * pcy, a0,
                  jnp.zeros_like(a0), a2)
            Jv = (-b1 * pcz + b2 * pcy, -b2 * pcx, b1 * pcx,
                  jnp.zeros_like(b1), b1, b2)
            Jr = tuple(
                (Ju[k] + (c * pcy, -c * pcx, 0.0, 0.0, 0.0, c)[k]) * stereo
                for k in range(6)
            )
            return (ru, rv, rr), (Ju, Jv, Jr), chi2

        def anchor_rows(q, t):
            """Anchor residual rows (3) + J rows + chi2 (vector)."""
            R = _quat_to_R(q)  # R_cw; R_wc = R^T
            dxc = (acx - t[0], acy - t[1], acz - t[2])
            # x_w = R^T (xc - t)
            xa = tuple(
                R[0][i] * dxc[0] + R[1][i] * dxc[1] + R[2][i] * dxc[2]
                for i in range(3)
            )
            d = (xa[0] - amx, xa[1] - amy, xa[2] - amz)
            # M = [skew(xc) | -I]; Jx[i][j] = sum_k R[k][i] * M[k][j]
            sk = ((jnp.zeros_like(acx), -acz, acy),
                  (acz, jnp.zeros_like(acx), -acx),
                  (-acy, acx, jnp.zeros_like(acx)))
            Jx = [[None] * 6 for _ in range(3)]
            for i in range(3):
                for j in range(3):
                    Jx[i][j] = (R[0][i] * sk[0][j] + R[1][i] * sk[1][j]
                                + R[2][i] * sk[2][j])
                for j in range(3):
                    Jx[i][3 + j] = -R[j][i] * jnp.ones_like(acx)
            n = (anx, any_, anz)
            r_deg = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
            J_deg = tuple(
                n[0] * Jx[0][j] + n[1] * Jx[1][j] + n[2] * Jx[2][j]
                for j in range(6)
            )
            # nondeg: r_i = sum_j sqi[j][i] d[j]; J_i = sum_k sqi[k][i] Jx[k]
            r_nd = tuple(
                sqi[0][i] * d[0] + sqi[1][i] * d[1] + sqi[2][i] * d[2]
                for i in range(3)
            )
            J_nd = [
                tuple(
                    sqi[0][i] * Jx[0][j] + sqi[1][i] * Jx[1][j]
                    + sqi[2][i] * Jx[2][j]
                    for j in range(6)
                )
                for i in range(3)
            ]
            zero = jnp.zeros_like(r_deg)
            r3 = (
                jnp.where(adeg > 0.5, r_deg, r_nd[0]),
                jnp.where(adeg > 0.5, zero, r_nd[1]),
                jnp.where(adeg > 0.5, zero, r_nd[2]),
            )
            J3 = [
                tuple(
                    jnp.where(adeg > 0.5, J_deg[j] if i == 0 else zero,
                              J_nd[i][j])
                    for j in range(6)
                )
                for i in range(3)
            ]
            chi2_a = (r3[0] ** 2 + r3[1] ** 2 + r3[2] ** 2) * aw
            return r3, J3, chi2_a

        def accumulate(H, b, rows, Js, w):
            """H += sum_n w * J^T J ; b += sum_n w * J^T r (21+6 reductions)."""
            for a in range(6):
                for c2 in range(a, 6):
                    prod = Js[0][a] * Js[0][c2]
                    for i in range(1, len(Js)):
                        prod = prod + Js[i][a] * Js[i][c2]
                    # padding lanes may hold inf Jacobians: mask, don't
                    # multiply, so 0 * inf cannot poison the sums
                    v = jnp.sum(jnp.where(w > 0, w * prod, 0.0))
                    H[a][c2] = H[a][c2] + v
                    if c2 != a:
                        H[c2][a] = H[c2][a] + v
                pr = Js[0][a] * rows[0]
                for i in range(1, len(Js)):
                    pr = pr + Js[i][a] * rows[i]
                b[a] = b[a] + jnp.sum(jnp.where(w > 0, w * pr, 0.0))
            return H, b

        outlier = jnp.zeros_like(valid)       # 1.0 = outlier
        anc_out = jnp.zeros_like(valid)
        qf, tf = q0, t0

        for rd in range(rounds):
            active = valid * (1.0 - outlier)
            use_huber = rd < 3
            if use_anchors:
                if use_huber:
                    active_anc = aex
                else:
                    active_anc = aex * (1.0 - anc_out)

            def gn_body(_, carry):
                (qw_, qx_, qy_, qz_, t0_, t1_, t2_, done) = carry
                q = (qw_, qx_, qy_, qz_)
                t = (t0_, t1_, t2_)
                rows, Js, chi2 = reproj_rows(q, t)
                if use_huber:
                    sr = jnp.sqrt(jnp.maximum(chi2, 1e-24))
                    hw = jnp.where(sr <= delta, 1.0, delta / sr)
                else:
                    hw = 1.0
                w = s2i * hw * active
                H = [[jnp.float32(0.0)] * 6 for _ in range(6)]
                bvec = [jnp.float32(0.0)] * 6
                H, bvec = accumulate(H, bvec, rows, Js, w)
                if use_anchors:
                    r3, J3, chi2_a = anchor_rows(q, t)
                    if use_huber:
                        sa = jnp.sqrt(jnp.maximum(chi2_a, 1e-24))
                        hwa = jnp.where(sa <= anc_delta, 1.0, anc_delta / sa)
                    else:
                        hwa = 1.0
                    wa = aw * hwa * active_anc
                    H, bvec = accumulate(H, bvec, r3, J3, wa)
                for i in range(6):
                    H[i][i] = H[i][i] + 1e-6
                dx = [-v for v in _chol_solve6(H, bvec)]
                q_n, t_n = _boxplus(q, t, dx)
                fin = jnp.float32(0.0)
                for v in q_n + t_n:
                    fin = fin + v
                ok = jnp.isfinite(fin)
                upd = ok & ~done
                q = tuple(jnp.where(upd, n, o) for n, o in zip(q_n, q))
                t = tuple(jnp.where(upd, n, o) for n, o in zip(t_n, t))
                maxdx = jnp.abs(dx[0])
                for v in dx[1:]:
                    maxdx = jnp.maximum(maxdx, jnp.abs(v))
                done = done | ~ok | (maxdx < step_tol)
                return q + t + (done,)

            init = q0 + t0 + (jnp.array(False),)
            out = jax.lax.fori_loop(0, iters, gn_body, init)
            qf, tf = out[:4], out[4:7]

            _, _, chi2 = reproj_rows(qf, tf)
            inl = (chi2 <= chi2_th).astype(jnp.float32)
            outlier = valid * (1.0 - inl)
            if use_anchors:
                _, _, chi2_a = anchor_rows(qf, tf)
                anc_inl = (chi2_a <= anc_chi2_th).astype(jnp.float32)
                anc_out = aex * (1.0 - anc_inl)

        _, _, chi2 = reproj_rows(qf, tf)
        n_inl = jnp.sum(valid * (1.0 - outlier))
        if use_anchors:
            n_anc = jnp.sum(aex * (1.0 - anc_out))
        else:
            n_anc = jnp.float32(0.0)

        lane = jax.lax.broadcasted_iota(jnp.int32, (POSE_W,), 0)
        vals = (qf[0], qf[1], qf[2], qf[3], tf[0], tf[1], tf[2], n_inl, n_anc)
        acc = jnp.zeros((POSE_W,), jnp.float32)
        for k, v in enumerate(vals):
            acc = jnp.where(lane == k, v, acc)
        pose_out[...] = acc
        chi2_out[...] = chi2
        flags_out[0, :] = outlier
        flags_out[1, :] = anc_out

    return kernel


def lanes(F: int) -> int:
    """Block width for F features: the next power of two (Triton blocks
    are powers of two; padding lanes carry valid=0)."""
    return max(16, 1 << (F - 1).bit_length())


def _pack(rows, B):
    """List of (F,) channels -> (C, B) f32, C a power of two >= len."""
    C = 1 << (len(rows) - 1).bit_length()
    x = jnp.stack([jnp.asarray(r, jnp.float32) for r in rows])
    return jnp.pad(x, ((0, C - x.shape[0]), (0, B - x.shape[1])))


def _feature_channels(x_w, obs_uvr, is_stereo, sigma2_inv, valid, B):
    chi2_th = jnp.where(
        is_stereo, pose_solver.CHI2_STEREO, pose_solver.CHI2_MONO
    )
    ch = _pack([
        x_w[:, 0], x_w[:, 1], x_w[:, 2],
        obs_uvr[:, 0], obs_uvr[:, 1], obs_uvr[:, 2],
        is_stereo, sigma2_inv, valid, chi2_th, jnp.sqrt(chi2_th),
    ], B)
    assert ch.shape[0] == N_CH
    return ch


def _scalars(q0, t0, anc_chi2_th=0.0):
    return jnp.concatenate([
        q0.astype(jnp.float32), t0.astype(jnp.float32),
        jnp.asarray(anc_chi2_th, jnp.float32)[None],
        jnp.zeros(POSE_W - 8, jnp.float32),
    ])


def _solve(kern, B, inputs, interpret):
    return pl.pallas_call(
        kern,
        out_shape=(
            jax.ShapeDtypeStruct((POSE_W,), jnp.float32),
            jax.ShapeDtypeStruct((B,), jnp.float32),
            jax.ShapeDtypeStruct((2, B), jnp.float32),
        ),
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="pose_solve",
    )(*inputs)


@functools.partial(
    jax.jit,
    static_argnames=("cam", "rounds", "iters", "step_tol", "interpret"),
)
def optimize_pose(
    cam: cam_mod.CameraParams,
    q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv, valid,
    rounds: int = 4, iters: int = 10, step_tol: float = 1e-8,
    interpret: bool = False,
) -> pose_solver.PoseOptResult:
    """Single-program drop-in for pose_solver.optimize_pose."""
    F = x_w.shape[0]
    B = lanes(F)
    ch = _feature_channels(x_w, obs_uvr, is_stereo, sigma2_inv, valid, B)
    kern = _make_kernel(cam, rounds, iters, step_tol, use_anchors=False)
    pose, chi2, flags = _solve(
        kern, B, (_scalars(q0, t0), ch), interpret
    )
    return pose_solver.PoseOptResult(
        q=pose[:4], t=pose[4:7],
        is_outlier=flags[0, :F] > 0.5,
        num_inliers=pose[7].astype(jnp.int32),
        chi2=chi2[:F],
    )


@functools.partial(
    jax.jit,
    static_argnames=("cam", "rounds", "iters", "step_tol", "interpret"),
)
def optimize_pose_anchored(
    cam: cam_mod.CameraParams,
    q0, t0, x_w, obs_uvr, is_stereo, sigma2_inv, valid,
    anc_xc, anc_mean, anc_normal, anc_sqrt_info, anc_type, anc_weight,
    anc_chi2_th,
    rounds: int = 4, iters: int = 10, step_tol: float = 1e-8,
    interpret: bool = False,
) -> pose_solver.PoseAnchorResult:
    """Single-program drop-in for pose_solver.optimize_pose_anchored."""
    F = x_w.shape[0]
    B = lanes(F)
    ch = _feature_channels(x_w, obs_uvr, is_stereo, sigma2_inv, valid, B)
    sqi = anc_sqrt_info.astype(jnp.float32)
    anc = _pack(
        [anc_xc[:, 0], anc_xc[:, 1], anc_xc[:, 2],
         anc_mean[:, 0], anc_mean[:, 1], anc_mean[:, 2],
         anc_normal[:, 0], anc_normal[:, 1], anc_normal[:, 2]]
        + [sqi[:, i, j] for i in range(3) for j in range(3)]
        + [anc_weight, anc_type != pose_solver.ANCHOR_NONE,
           anc_type == pose_solver.ANCHOR_DEG],
        B,
    )
    assert anc.shape[0] == N_AC
    kern = _make_kernel(cam, rounds, iters, step_tol, use_anchors=True)
    pose, chi2, flags = _solve(
        kern, B, (_scalars(q0, t0, anc_chi2_th), ch, anc), interpret
    )
    return pose_solver.PoseAnchorResult(
        q=pose[:4], t=pose[4:7],
        is_outlier=flags[0, :F] > 0.5,
        num_inliers=pose[7].astype(jnp.int32),
        chi2=chi2[:F],
        anc_outlier=flags[1, :F] > 0.5,
        num_anchors=pose[8].astype(jnp.int32),
    )
