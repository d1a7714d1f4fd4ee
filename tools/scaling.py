"""Scaling-efficiency harness: sharded association + distributed BA.

BASELINE target: >=0.7 scaling efficiency at N>=2 hosts for the
distributed Schur-complement BA. On a real multi-chip mesh this measures
wall-time vs device count at FIXED global problem size (strong scaling)
for the two sharded stages; on a virtual CPU mesh the numbers only
validate the collective structure — all "devices" share the host's
cores, so efficiency is not meaningful there (flagged in the output).

Usage:
  python tools/scaling.py                # devices = all available
  python tools/scaling.py --cpu 8        # 8-device virtual CPU mesh
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

import numpy as np


def main():
    # --cpu N: an N-device virtual CPU mesh
    if "--cpu" in sys.argv:
        import jax as _jax

        n = int(sys.argv[sys.argv.index("--cpu") + 1])
        _jax.config.update("jax_platforms", "cpu")
        _jax.config.update("jax_num_cpu_devices", n)
    jaxenv.setup_compile_cache()

    import jax
    import jax.numpy as jnp

    from gmmloc.config import CameraConfig
    from gmmloc.geometry import camera as cam_mod
    from gmmloc.gmm import mixture
    from gmmloc.parallel import sharding
    from gmmloc.solver import local_ba

    def timeit(fn, warmup=1, iters=6):
        """Median wall time (s) of fn() to completion, after warm-up."""
        for _ in range(warmup):
            jax.block_until_ready(fn())
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    n_dev = len(jax.devices())
    virtual = jax.default_backend() == "cpu"
    cam = cam_mod.CameraParams.from_config(CameraConfig())
    rng = np.random.default_rng(0)

    # fixed global sizes (stress scale)
    K = 8192
    means = np.stack(
        [rng.uniform(-4, 4, K), rng.uniform(-3, 3, K), rng.uniform(3, 9, K)], -1
    )
    covs = np.tile(np.diag([0.04, 0.04, 1e-6]), (K, 1, 1))
    gmap = mixture.from_arrays(means, covs, pad_to=K, build_neighbors=False)
    q = jnp.array([1.0, 0, 0, 0], jnp.float32)
    t = jnp.zeros(3, jnp.float32)

    L, C, P, MO = 16, 48, 8192, 12
    cam_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (C, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.arange(C) * 0.05
    pts = np.stack(
        [rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(3, 9, P)], -1
    ).astype(np.float32)
    obs_cam = rng.integers(0, C, (P, MO)).astype(np.int32)
    pc = pts[:, None, :] + cam_t[obs_cam]
    uvr = np.stack(
        [
            cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
            cam.fy * pc[..., 1] / pc[..., 2] + cam.cy,
            cam.fx * pc[..., 0] / pc[..., 2] + cam.cx - cam.bf / pc[..., 2],
        ],
        -1,
    ).astype(np.float32)
    prob = local_ba.BAProblem(
        cam_q=jnp.array(cam_q), cam_t=jnp.array(cam_t),
        cam_valid=jnp.ones(C, bool),
        pts=jnp.array(pts), pt_valid=jnp.ones(P, bool),
        obs_cam=jnp.array(obs_cam), obs_uvr=jnp.array(uvr),
        obs_stereo=jnp.ones((P, MO), bool),
        obs_sigma2_inv=jnp.ones((P, MO), jnp.float32),
        obs_valid=jnp.ones((P, MO), bool),
        str_type=jnp.full(P, local_ba.STR_DEG, jnp.int32),
        str_normal=jnp.tile(jnp.array([0.0, 0, 1], jnp.float32), (P, 1)),
        str_mean=jnp.array(pts),
        str_sqrt_info=jnp.tile(jnp.eye(3, dtype=jnp.float32), (P, 1, 1)),
        prior_q=jnp.array(cam_q[0]), prior_t=jnp.array(cam_t[0]),
        has_prior=jnp.array(True),
    )

    counts = [n for n in (1, 2, 4, 8, 16) if n <= n_dev]
    base_assoc = base_ba = None
    print(f"devices={n_dev} backend={jax.default_backend()} virtual={virtual}")
    for n in counts:
        mesh = sharding.make_mesh(n)
        gm = sharding.shard_gmm_map(gmap, mesh)
        t_assoc = timeit(
            lambda: sharding.render_view_sharded(gm, cam, q, t, mesh),
            warmup=1, iters=6,
        )
        pr = sharding.shard_ba_problem(prob, mesh)
        t_ba = timeit(
            lambda: sharding.solve_local_ba_sharded(
                cam, pr, mesh, n_free=L, iters1=1, iters2=1, iters3=3
            ),
            warmup=1, iters=4,
        )
        if base_assoc is None:
            base_assoc, base_ba = t_assoc * 1, t_ba * 1
        eff_a = base_assoc / (t_assoc * n)
        eff_b = base_ba / (t_ba * n)
        print(
            f"N={n}: assoc {t_assoc*1e3:8.2f} ms (eff {eff_a:.2f})   "
            f"BA {t_ba*1e3:8.2f} ms (eff {eff_b:.2f})"
        )
    if virtual:
        print("NOTE: virtual CPU mesh — structure validation only, "
              "efficiency numbers are not meaningful.")


if __name__ == "__main__":
    main()
