"""Compare solve_local_ba variants {schur_impl}x{linear_solver} on the
default device.

Times the full staged solve (5/5/iters3 LM) per combo, each call run to
completion (float(cost)); the winner becomes the config default.

Usage: python tools/ba_variants.py [--iters3 40]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

jaxenv.setup_compile_cache()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters3", type=int, default=40)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--tier", type=int, default=-1,
                    help="run only tier index (default: all)")
    ap.add_argument("--combos", default="all",
                    help="comma list like onehot-lu,flat-cg")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    print("devices:", jax.devices(), flush=True)

    from ba_bench import build

    from gmmloc.config import euroc_v1_config
    from gmmloc.geometry import camera as cam_mod
    from gmmloc.solver import local_ba

    cfg = euroc_v1_config()
    cam = cam_mod.CameraParams.from_config(cfg.camera)
    rng = np.random.default_rng(0)
    MO = cfg.caps.ba_obs_per_point

    tiers = [(8, 24, 2048), (16, 48, 8192)]
    if args.tier >= 0:
        tiers = [tiers[args.tier]]
    combos = [
        ("onehot", "lu"),
        ("flat", "lu"),
        ("onehot", "cg"),
        ("flat", "cg"),
    ]
    if args.combos != "all":
        combos = [tuple(c.split("-")) for c in args.combos.split(",")]
    for (L, C, P) in tiers:
        prob = build(rng, cam, L, C, P, MO)
        base_cost = None
        for (si, ls) in combos:
            def run():
                r = local_ba.solve_local_ba(
                    cam, prob, n_free=L, iters3=args.iters3,
                    use_bf16=True, schur_impl=si, linear_solver=ls,
                )
                return float(r.cost)

            try:
                c = run()  # compile + warm
            except Exception as e:  # noqa: BLE001
                print(f"L={L} P={P} {si}/{ls}: FAILED {e}", flush=True)
                continue
            if base_cost is None:
                base_cost = c
            ts = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                run()
                ts.append(time.perf_counter() - t0)
            rel = c / base_cost if base_cost else float("nan")
            print(
                f"L={L:3d} C={C:3d} P={P:5d} {si:6s}/{ls:2s}: "
                f"{min(ts)*1e3:7.1f} ms  cost_ratio={rel:.6f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
