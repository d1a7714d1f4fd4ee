"""End-to-end synthetic run: the full system along a trajectory.

Usage:
  python tools/run_synthetic.py --map room [--seed 0] [--frames 100]
  python tools/run_synthetic.py --map DIR [--seq V1_01_easy] [--start 150]
                                [--stride 1] [--frames 100]
--map room runs the seeded V1-size room; --map DIR the EuRoC map and
ground truth under DIR (start=150 skips the stationary, depth-degenerate
opening of the V1/V2 sequences — see README deliberate deviations).
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

jaxenv.setup_compile_cache()

from gmmloc.config import euroc_v1_config
from gmmloc.eval import ate, synthetic
from gmmloc.gmm import mixture
from gmmloc.pipeline.system import GMMLocSystem


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", required=True, help=synthetic.MAP_HELP)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seq", default="V1_01_easy")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--start", type=int, default=None,
                    help="first frame (default 150 for EuRoC, 0 for the room)")
    args = ap.parse_args()
    start = args.start if args.start is not None else (
        0 if args.map == "room" else 150)
    n_frames, stride = args.frames, args.stride

    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )
    means, covs, trajectory = synthetic.load_map_and_trajectory(
        args.map, args.seq, (start + n_frames) * stride, seed=args.seed)
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gmm=(means, covs), trajectory=trajectory,
        n_frames=start + n_frames,
        stride=stride,
        n_landmarks=30000,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
    )
    ts, q_wc, t_wc = ts[start:], q_wc[start:], t_wc[start:]
    sys_ = GMMLocSystem(cfg, mixture.for_config(means, covs, cfg))

    t0 = time.time()
    frames = []
    stats = []

    from gmmloc.utils.control import control as ctl, install_signal_handlers

    install_signal_handlers()  # SIGUSR1 pause / SIGUSR2 step / SIGTERM stop
    for i in range(len(ts)):
        while not ctl.should_run() and not ctl.stop:
            time.sleep(0.001)
        ctl.consume_step()
        if ctl.stop:
            print(f"stop requested at frame {i}")
            break
        frame = fe.make_frame(i, ts[i], q_wc[i], t_wc[i])
        stat = sys_.step(frame, q_wc[i], t_wc[i])
        if stat is not None:  # pipelined mode: stat belongs to prev frame
            stats.append(stat)
        if sys_.track_failed:
            print(f"TRACKING FAILED at frame {i}")
            break
        if i % 20 == 0:
            print(
                f"frame {i:4d} inliers={stat.num_match_inliers:4d} "
                f"ratio={stat.ratio_map:.2f} kfs={sys_.world.n_keyframes()} "
                f"pts={sys_.world.n_points()} t={time.time()-t0:.1f}s"
            )
    st = sys_.flush()  # final in-flight frame (pipelined mode)
    if st is not None:
        stats.append(st)
    wall = time.time() - t0
    n_done = len(stats)
    print(f"\n{n_done} frames in {wall:.1f}s = {n_done/wall:.2f} fps")

    ts_est, q_est, t_est = sys_.export_trajectory()
    m = ate.ate_rmse(ts_est, t_est, ts[:n_done], t_wc[:n_done])
    print(f"ATE: rmse={m['rmse']*100:.2f}cm mean={m['mean']*100:.2f}cm n={m['n']}")


if __name__ == "__main__":
    main()
