"""Per-stage wall-clock attribution of GMMLocSystem.step (VERDICT r2 #1).

Answers "where does the per-frame time go" with a committed JSON
artifact: drives >=200 steady-state frames through the production
configuration with ALL frames pre-generated BEFORE the timed window
(the synthetic frontend is harness, not system — it must not be on the
clock), then reports

  - end-to-end fps over the measured window (+ per-frame percentiles)
  - the named-scope timing registry totals per stage (fused dispatch /
    readback wait / host bookkeeping / KF association / triangulation /
    fusion / BA / culling), measured-window only
  - transfer counts from utils/fetch (uploads, fetches per frame)
  - the unattributed remainder (pose init, KF policy, loop overhead)

Usage:
  python tools/step_profile.py --map room|DIR [--frames 260] [--warm 40]
                               [--out step_profile.json]
(JAX_PLATFORMS=cpu for the CPU backend.)
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", required=True,
                    help="'room' or the EuRoC data directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=260)
    ap.add_argument("--warm", type=int, default=40)
    ap.add_argument("--start", type=int, default=150)
    ap.add_argument("--seq", default="V1_01_easy")
    ap.add_argument("--out", default="step_profile.json")
    ap.add_argument("--pipelined", type=int, default=None)
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--online", action="store_true")
    args = ap.parse_args()

    jaxenv.setup_compile_cache()
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")

    from gmmloc.config import euroc_v1_config
    from gmmloc.eval import synthetic
    from gmmloc.gmm import mixture
    from gmmloc.pipeline import prewarm as prewarm_mod
    from gmmloc.pipeline.system import GMMLocSystem
    from gmmloc.utils import fetch as fetch_mod
    from gmmloc.utils import timing as timing_mod

    cfg = euroc_v1_config()
    tk = dict(velocity_damping=0.9)
    if args.pipelined is not None:
        tk["pipelined_track"] = bool(args.pipelined)
    if args.depth is not None:
        tk["pipeline_depth"] = args.depth
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, **tk))
    if args.online:
        cfg = cfg.replace(online=True)

    means, covs, trajectory = synthetic.load_map_and_trajectory(
        args.map, args.seq, args.start + args.warm + args.frames,
        seed=args.seed)
    gmap = mixture.for_config(means, covs, cfg)
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gmm=(means, covs), trajectory=trajectory,
        n_landmarks=30000, seed=0,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
    )
    N = args.warm + args.frames

    # -- harness OFF the clock: pre-generate every frame ----------------
    t0 = time.perf_counter()
    frames = []
    for i in range(N):
        fi = args.start + i
        frames.append(
            (fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi]), q_wc[fi], t_wc[fi])
        )
    gen_s = time.perf_counter() - t0
    print(f"frame gen: {gen_s/N*1e3:.2f} ms/frame (OFF the clock)", flush=True)

    sys_ = GMMLocSystem(cfg, gmap)
    prewarm_mod.prewarm(cfg, sys_.cam)

    for i in range(args.warm):
        f, gq, gt = frames[i]
        sys_.step(f, gq, gt)
        if sys_.track_failed:
            raise SystemExit("tracking failed during warmup")
    kf_before = sys_.world.n_keyframes()
    timing_mod.reset()
    fetch_mod.reset_stats()

    per_frame = []
    t_meas0 = time.perf_counter()
    for i in range(args.warm, N):
        f, gq, gt = frames[i]
        t1 = time.perf_counter()
        sys_.step(f, gq, gt)
        per_frame.append(time.perf_counter() - t1)
        if sys_.track_failed:
            break
    sys_.flush()
    wall = time.perf_counter() - t_meas0
    sys_.stop()
    n_done = len(per_frame)
    kfs = sys_.world.n_keyframes() - kf_before

    stages = {}
    with timing_mod.REGISTRY.lock:
        for tag, a in sorted(timing_mod.REGISTRY.accs.items()):
            stages[tag] = {
                "count": a.count,
                "total_s": round(a.total, 4),
                "mean_ms": round(a.mean() * 1e3, 3),
                "min_ms": round(a.min * 1e3, 3),
                "max_ms": round(a.max * 1e3, 3),
                "ms_per_frame": round(a.total / n_done * 1e3, 3),
            }
    # leaf stages only (no double counting): drop aggregates that contain
    # other tags ("loc" contains loc/*; "track" contains classic fallbacks)
    leaf = {
        t: v for t, v in stages.items()
        if t not in ("loc", "loc/miscs", "track", "kf/process")
    }
    attributed = sum(v["total_s"] for v in leaf.values())
    fstats = fetch_mod.stats()
    out = {
        "config": {
            "pipelined": cfg.tracking.pipelined_track,
            "packed_io": cfg.tracking.fused_packed_io,
            "map_refresh": sys_.cfg.tracking.fused_map_refresh,
            "pipeline_depth": sys_._depth,
            "online": cfg.online,
            "seq": args.seq,
        },
        "chain_health": {
            "primes": sys_.n_primes,
            "rewinds": sys_.n_rewinds,
            "rewound_frames": sys_.n_rewound_frames,
        },
        "device": str(jax.devices()[0]),
        "frames_measured": n_done,
        "keyframes_in_window": kfs,
        "fps": round(n_done / wall, 2),
        "ms_per_frame": round(wall / n_done * 1e3, 2),
        "frame_ms_p50": round(float(np.percentile(per_frame, 50)) * 1e3, 2),
        "frame_ms_p95": round(float(np.percentile(per_frame, 95)) * 1e3, 2),
        "frame_ms_max": round(float(np.max(per_frame)) * 1e3, 2),
        "frame_gen_ms_off_clock": round(gen_s / N * 1e3, 2),
        "stages": stages,
        "attribution": {
            "attributed_ms_per_frame": round(attributed / n_done * 1e3, 2),
            "unattributed_ms_per_frame": round(
                (wall - attributed) / n_done * 1e3, 2
            ),
            "note": "leaf stages only; 'loc'/'loc/miscs'/'track' are "
                    "aggregates of other tags",
        },
        "transfers": {
            "uploads_per_frame": round(fstats["uploads"] / n_done, 2),
            "fetches_per_frame": round(fstats["fetches"] / n_done, 2),
            "fetch_leaves_per_frame": round(fstats["leaves"] / n_done, 2),
        },
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
