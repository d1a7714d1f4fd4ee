"""Per-frame diagnostic run: tracks pose error vs GT frame by frame.

Logs, for every frame: translation error (cm), rotation error (deg),
inlier count, map ratio, KF events, LOST/reloc events. Written as CSV to
--out for offline analysis of where a difficult sequence (V1_03, V2_02)
diverges.

Usage:
  python tools/diagnose_seq.py --map DIR --seq V1_03_difficult \
      --frames 400 --start 150 --out diag.csv [--reloc 1]
  python tools/diagnose_seq.py --map room --start 0 --out diag.csv
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

jaxenv.setup_compile_cache()

import numpy as np

from gmmloc.config import euroc_v1_config
from gmmloc.eval import ate, synthetic
from gmmloc.gmm import mixture
from gmmloc.mapping import map_state as ms
from gmmloc.pipeline.system import GMMLocSystem


def quat_angle_deg(q1, q2):
    d = abs(float(np.dot(q1, q2)))
    return float(np.degrees(2 * np.arccos(min(1.0, d))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", required=True, help=synthetic.MAP_HELP)
    ap.add_argument("--seq", default="V1_03_difficult")
    ap.add_argument("--frames", type=int, default=400)
    ap.add_argument("--start", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reloc", type=int, default=1)
    ap.add_argument("--out", default="diag.csv")
    ap.add_argument("--damping", type=float, default=0.9)
    ap.add_argument("--ema", type=float, default=None)
    ap.add_argument("--anchor", type=int, default=None)
    ap.add_argument("--gate", type=int, default=None)
    args = ap.parse_args()

    cfg = euroc_v1_config()
    tk = dict(velocity_damping=args.damping)
    if args.ema is not None:
        tk["velocity_ema"] = args.ema
    if args.anchor is not None:
        tk["use_gmm_pose_anchor"] = bool(args.anchor)
    if args.gate is not None and not args.gate:
        tk["max_jump_trans"] = 1e9
        tk["max_jump_rot_deg"] = 1e9
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, **tk),
        enable_relocalization=bool(args.reloc),
    )
    means, covs, trajectory = synthetic.load_map_and_trajectory(
        args.map, args.seq, args.start + args.frames, seed=args.seed)
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gmm=(means, covs), trajectory=trajectory,
        n_frames=args.start + args.frames,
        n_landmarks=30000,
        seed=args.seed,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
    )
    ts, q_wc, t_wc = ts[args.start:], q_wc[args.start:], t_wc[args.start:]

    gmap = mixture.for_config(means, covs, cfg)
    vocab = None
    if args.reloc:
        # on-domain vocabulary, as in tools/evaluate.py
        from gmmloc.vocab.bow import Vocabulary

        sub = fe.world.desc[:: max(1, len(fe.world.desc) // 20000)]
        vocab = Vocabulary.train(sub, k=10, depth=4, seed=0)
    sys_ = GMMLocSystem(cfg, gmap, vocabulary=vocab)

    rows = []
    t0 = time.time()
    for i in range(len(ts)):
        frame = fe.make_frame(i, ts[i], q_wc[i], t_wc[i])
        stat = sys_.step(frame, q_wc[i], t_wc[i])
        # GT camera pose -> T_cw
        q_gt_cw = q_wc[i] * np.array([1.0, -1, -1, -1])
        t_gt_cw = -ms._quat_to_mat(q_gt_cw) @ t_wc[i]
        if stat.res:
            q_wc_est, t_wc_est = ms._inverse(frame.q_cw, frame.t_cw)
            terr = float(np.linalg.norm(t_wc_est - t_wc[i])) * 100
            rerr = quat_angle_deg(frame.q_cw, q_gt_cw)
            # error vector in the GT camera frame (x right, y down, z fwd)
            ecam = ms._quat_to_mat(q_gt_cw) @ (t_wc_est - t_wc[i]) * 100
        else:
            terr, rerr = -1.0, -1.0
            ecam = np.full(3, -1.0)
        dbg = sys_.tracker.dbg
        if "t_pred" in dbg and stat.res:
            tp_err = float(
                np.linalg.norm(ms._inverse(dbg["q_pred"], dbg["t_pred"])[1] - t_wc[i])
            ) * 100
            rp_err = quat_angle_deg(dbg["q_pred"], q_gt_cw)
        else:
            tp_err, rp_err = -1.0, -1.0
        rows.append(
            (i, int(stat.res), int(sys_.lost), terr, rerr,
             stat.num_match_inliers, stat.ratio_map,
             sys_.world.n_keyframes(), int(frame.is_keyframe),
             frame.ref_kf,
             dbg.get("n_motion_match", -1),
             int(dbg.get("used_wide_retry", False)),
             int(dbg.get("used_kf_fallback", False)),
             dbg.get("n_gmm_inliers", -1),
             tp_err, rp_err,
             dbg.get("n_tmp_edges", -1), dbg.get("n_per_edges", -1),
             ecam[0], ecam[1], ecam[2], int(dbg.get("coasted", False)))
        )
        if sys_.track_failed:
            print(f"FATAL tracking failure at frame {i}")
            break
        if i % 50 == 0:
            print(f"frame {i:4d} terr={terr:7.2f}cm rerr={rerr:6.2f}deg "
                  f"inl={stat.num_match_inliers:4d} lost={sys_.lost} "
                  f"kfs={sys_.world.n_keyframes()}", flush=True)

    wall = time.time() - t0
    with open(args.out, "w") as f:
        f.write("frame,res,lost,terr_cm,rerr_deg,inliers,ratio_map,kfs,is_kf,"
                "ref_kf,n_motion,wide_retry,kf_fallback,n_gmm_inl,"
                "tpred_cm,rpred_deg,n_tmp,n_per,ex_cm,ey_cm,ez_cm,coasted\n")
        for r in rows:
            f.write(",".join(str(x) for x in r) + "\n")

    ts_est, q_est, t_est = sys_.export_trajectory()
    m = ate.ate_rmse(ts_est, t_est, ts, t_wc)
    done = [r for r in rows if r[1]]
    print(f"\n{len(rows)} frames ({len(done)} tracked) in {wall:.1f}s")
    print(f"ATE rmse={m['rmse']*100:.2f}cm mean={m['mean']*100:.2f}cm n={m['n']}")
    print(f"n_lost={sys_.n_lost}  csv={args.out}")
    bs = sys_.localizer.ba_stats
    if bs:
        import collections
        tiers = collections.Counter((b["L"], b["P"]) for b in bs)
        om = np.array([b["obs_mean"] for b in bs])
        op = np.array([b["obs_p95"] for b in bs])
        print(f"BA solves={len(bs)} tiers={dict(tiers)} "
              f"obs/pt mean={om.mean():.2f} p95={op.mean():.2f} "
              f"MO-hit={sum(b['obs_max_hit'] for b in bs)}")


if __name__ == "__main__":
    main()
