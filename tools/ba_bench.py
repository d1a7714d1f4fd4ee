"""Local-BA variant micro-benchmark on the default device.

Times solve_local_ba across tier shapes and {f32, bf16} staging, each
call run to completion (float(cost)). Prints a small table; used to track
the BA-iteration cost.

Usage: python tools/ba_bench.py [--iters3 40]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

jaxenv.setup_compile_cache()

import numpy as np


def build(rng, cam, L, C, P, MO, noise_px=0.5):
    import jax.numpy as jnp

    from gmmloc.solver import local_ba

    cam_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (C, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.arange(C) * 0.05
    pts = np.stack(
        [rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(3, 9, P)], -1
    ).astype(np.float32)
    obs_cam = rng.integers(0, C, (P, MO)).astype(np.int32)
    # realistic occupancy: ~3 obs/point (measured mean 2.3-2.9, p95 ~5)
    occ = rng.random((P, MO)) < (3.0 / MO)
    occ[:, 0] = True
    obs_cam = np.where(occ, obs_cam, -1)
    pc = pts[:, None, :] + cam_t[np.maximum(obs_cam, 0)]
    uvr = np.stack(
        [
            cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
            cam.fy * pc[..., 1] / pc[..., 2] + cam.cy,
            cam.fx * pc[..., 0] / pc[..., 2] + cam.cx - cam.bf / pc[..., 2],
        ],
        -1,
    ).astype(np.float32)
    # observation noise + a perturbed initial state: a noise-free problem
    # converges in 1-2 LM iterations and under-reports the solve cost
    uvr += rng.normal(0, noise_px, uvr.shape).astype(np.float32)
    pts = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
    cam_t = cam_t + rng.normal(0, 0.005, cam_t.shape).astype(np.float32)
    return local_ba.BAProblem(
        cam_q=jnp.array(cam_q), cam_t=jnp.array(cam_t),
        cam_valid=jnp.ones(C, bool),
        pts=jnp.array(pts), pt_valid=jnp.ones(P, bool),
        obs_cam=jnp.array(obs_cam),
        obs_uvr=jnp.array(uvr), obs_stereo=jnp.ones((P, MO), bool),
        obs_sigma2_inv=jnp.ones((P, MO), jnp.float32),
        obs_valid=jnp.array(occ),
        str_type=jnp.full(P, local_ba.STR_DEG, jnp.int32),
        str_normal=jnp.tile(jnp.array([0.0, 0, 1], jnp.float32), (P, 1)),
        str_mean=jnp.array(pts),
        str_sqrt_info=jnp.tile(jnp.eye(3, dtype=jnp.float32), (P, 1, 1)),
        prior_q=jnp.array(cam_q[0]), prior_t=jnp.array(cam_t[0]),
        has_prior=jnp.array(True),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters3", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--impls", default="flat,blockdiag")
    ap.add_argument("--batch", type=int, default=4,
                    help="also time a vmapped batch of this many windows "
                         "at the production tier (0 = skip)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from gmmloc.config import euroc_v1_config
    from gmmloc.geometry import camera as cam_mod
    from gmmloc.solver import local_ba

    cfg = euroc_v1_config()
    cam = cam_mod.CameraParams.from_config(cfg.camera)
    rng = np.random.default_rng(0)
    MO = cfg.caps.ba_obs_per_point

    tiers = [(8, 24, 2048), (16, 48, 4096), (16, 48, 8192)]
    print(f"MO={MO} iters3={args.iters3}")
    for (L, C, P) in tiers:
        prob = build(rng, cam, L, C, P, MO)
        for impl in args.impls.split(","):
            for bf16 in (False, True):
                def run():
                    r = local_ba.solve_local_ba(
                        cam, prob, n_free=L, iters3=args.iters3,
                        use_bf16=bf16, schur_impl=impl,
                    )
                    return float(r.cost)  # forces completion

                run()  # compile + warm
                ts = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    run()
                    ts.append(time.perf_counter() - t0)
                print(f"L={L:3d} C={C:3d} P={P:5d} {impl:9s} bf16={int(bf16)}: "
                      f"{min(ts)*1e3:7.1f} ms (best of {args.reps})",
                      flush=True)

    if args.batch:
        B = args.batch
        L, C, P = tiers[-1]
        probs = [build(np.random.default_rng(s), cam, L, C, P, MO)
                 for s in range(B)]
        batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *probs)
        for impl in args.impls.split(","):
            def runb():
                r = local_ba.solve_local_ba_batch(
                    cam, batch, n_free=L, iters3=args.iters3,
                    schur_impl=impl,
                )
                return float(jnp.sum(r.cost))

            runb()
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                runb()
                ts.append(time.perf_counter() - t0)
            per = min(ts) * 1e3 / B
            print(f"batch B={B} L={L} C={C} P={P} {impl:9s} bf16=1: "
                  f"{min(ts)*1e3:7.1f} ms = {per:6.1f} ms/solve", flush=True)


if __name__ == "__main__":
    main()
