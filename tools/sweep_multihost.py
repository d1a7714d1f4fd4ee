"""Multi-host sequence-sharded protocol sweep (SURVEY §5.8 / BASELINE
multi-host target).

One process per host, (sequence, run) jobs round-robin sharded; process 0
merges per-host results into summary.json and reports the scaling
numbers. Single-box testing: `--spawn N` forks N local worker processes
wired through the same jax.distributed contract (CPU backend).

  python tools/sweep_multihost.py --map DIR --spawn 2 \
      --seqs V1_01_easy,V1_02_medium --runs 1 --frames 200 --out mh_out

Real deployment: run the same script once per host with
GMMLOC_COORDINATOR / GMMLOC_NUM_PROCESSES / GMMLOC_PROCESS_ID set.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

jaxenv.setup_compile_cache()

ALL_SEQS = [
    "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]


def worker(args) -> None:
    from gmmloc.parallel import distributed as dist

    pid, nproc = dist.init_distributed()
    import numpy as np

    from gmmloc.config import euroc_v1_config
    from gmmloc.eval import synthetic
    from gmmloc.gmm import mixture
    from tools.evaluate import run_once

    seqs = args.seqs.split(",") if args.seqs != "all" else ALL_SEQS
    jobs = [(s, r) for s in seqs for r in range(args.runs)]
    mine = dist.shard_jobs(jobs, pid, nproc)
    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )

    sources = {}
    results = []
    t0 = time.time()
    for seq, r in mine:
        if seq not in sources:
            src = synthetic.load_map_and_trajectory(
                args.map, seq, args.start + args.frames)
            sources[seq] = (src, mixture.for_config(src[0], src[1], cfg))
        src, gmap = sources[seq]
        out_path = os.path.join(args.out, f"{seq}{r}.txt")
        m = run_once(cfg, seq, r, args.frames, args.start, gmap, src, out_path)
        m["seq"], m["run"] = seq, r
        results.append(m)
        print(f"[host {pid}] {seq} run{r}: rmse={m['rmse']*100:.2f}cm "
              f"frames={m['frames']}/{m['target']}", flush=True)
    wall = time.time() - t0

    merged = dist.barrier_and_gather_json(
        args.out, "sweep", {"pid": pid, "wall_s": wall, "runs": results},
        pid, nproc,
    )
    if merged is None:
        return
    all_runs = [r for h in merged if h for r in h["runs"]]
    walls = [h["wall_s"] for h in merged if h]
    per_seq = {}
    for r in all_runs:
        per_seq.setdefault(r["seq"], []).append(r["rmse"])
    summary = {
        "n_hosts": nproc,
        "host_wall_s": walls,
        "total_frames": sum(r["frames"] for r in all_runs),
        "agg_fps": sum(r["frames"] for r in all_runs) / max(walls),
        # efficiency vs a single host doing all jobs serially: estimated
        # from the sum of per-run walls (exact when jobs dominate)
        "scaling_efficiency": (
            sum(r["frames"] / max(r["fps"], 1e-9) for r in all_runs)
            / (nproc * max(walls))
        ),
        "ate": {
            s: {"rmse_mean": float(np.mean(v)), "rmse_std": float(np.std(v))}
            for s, v in per_seq.items()
        },
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"summary": summary, "runs": all_runs}, f, indent=2,
                  default=float)
    print(json.dumps(summary, indent=2, default=float), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spawn", type=int, default=0,
                    help="fork N local worker processes (single-box test)")
    ap.add_argument("--seqs", default="all")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=100000)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--map", required=True,
                    help="the EuRoC data directory (or 'room')")
    ap.add_argument("--out", default="sweep_out")
    ap.add_argument("--port", type=int, default=9911)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    if args.spawn > 0:
        procs = []
        for i in range(args.spawn):
            env = dict(os.environ)
            env.update(
                GMMLOC_COORDINATOR=f"127.0.0.1:{args.port}",
                GMMLOC_NUM_PROCESSES=str(args.spawn),
                GMMLOC_PROCESS_ID=str(i),
                JAX_PLATFORMS="cpu",
            )
            cmd = [sys.executable, "-u", __file__, "--spawn", "0",
                   "--seqs", args.seqs, "--runs", str(args.runs),
                   "--frames", str(args.frames), "--start", str(args.start),
                   "--out", args.out, "--map", args.map]
            procs.append(subprocess.Popen(cmd, env=env))
        rc = 0
        for p in procs:
            rc |= p.wait()
        sys.exit(rc)

    worker(args)


if __name__ == "__main__":
    main()
