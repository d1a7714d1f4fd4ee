"""Reference-protocol sweep driver.

Runs tools/evaluate.py once per sequence (5 runs in-process so jit
compiles amortize), full-length from frame 0, one child after another
(one process on the device at a time), and reports which sequences
completed. Ref protocol: gmmloc_ros/scripts/evaluate_euroc.sh (5 runs x
sequence, offline single-thread, TUM export + evo APE).

Usage:
  python tools/protocol_sweep.py --map DIR --out sweep_out [--runs 5]
                                 [--seqs all] [--extra "--depth 4"]
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALL_SEQS = [
    "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]


def run_sequence(seq, args):
    out_dir = os.path.join(args.out, seq)
    os.makedirs(out_dir, exist_ok=True)
    cmd = [
        sys.executable, "tools/evaluate.py", "--map", args.map,
        "--runs", str(args.runs), "--frames", str(args.frames),
        "--start", str(args.start), "--seqs", seq, "--out", out_dir,
    ] + (args.extra.split() if args.extra else [])
    with open(os.path.join(out_dir, "sweep_log.txt"), "w") as log:
        return subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                              cwd=ROOT).returncode == 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", required=True,
                    help="the EuRoC data directory (map/, gt_sync/)")
    ap.add_argument("--out", default="sweep_out")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=99999)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--seqs", default="all")
    ap.add_argument("--extra", default="--fused 1 --pipelined 1")
    args = ap.parse_args()
    seqs = ALL_SEQS if args.seqs == "all" else args.seqs.split(",")
    os.makedirs(args.out, exist_ok=True)
    status = {}
    for seq in seqs:
        t0 = time.time()
        status[seq] = run_sequence(seq, args)
        print(f"[sweep] {seq}: {'ok' if status[seq] else 'FAILED'} "
              f"({time.time() - t0:.0f}s)", flush=True)
    print("[sweep] done:", status, flush=True)
    sys.exit(0 if all(status.values()) else 1)


if __name__ == "__main__":
    main()
