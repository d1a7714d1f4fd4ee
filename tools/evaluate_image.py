"""Image-level evaluation: sprite-rendered stereo -> FULL ORB front-end
-> tracking/mapping -> ATE (VERDICT r1 missing #4).

The feature-level harness (tools/evaluate.py) bypasses the detector/
descriptor/stereo stack; this one renders stereo images of a GMM-sampled
sprite world along a trajectory (--map: the seeded room, or the EuRoC
ground truth and map under a data directory) and drives the whole
pipeline through them — detector noise, descriptor churn, stereo-matching
errors and all. Ref counterpart: the reference benchmark is image-driven
(orb_extractor.cpp:988-1050, frame.cpp:179-349).

Usage:
  python tools/evaluate_image.py --map room|DIR [--seqs V1_01_easy]
                                 [--runs 1] [--frames 600] [--start 0]
                                 [--out img_out]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

jaxenv.setup_compile_cache()

import numpy as np

from gmmloc.config import euroc_v1_config
from gmmloc.eval import ate, synthetic
from gmmloc.eval.image_synthetic import SpriteRenderer
from gmmloc.gmm import mixture
from gmmloc.pipeline.frontend import ImageFrontend
from gmmloc.pipeline.system import GMMLocSystem


def run_once(cfg, seq, run_idx, n_frames, start, gmap, source,
             out_path=None, packed=True, reloc=False, n_landmarks=9000):
    means, covs, (ts, q_wc, t_wc) = source
    world = synthetic.sample_world_from_gmm(
        means, covs, n_landmarks=n_landmarks, seed=run_idx
    )
    renderer = SpriteRenderer(world, cfg, seed=run_idx)
    frontend = ImageFrontend(cfg)
    voc = None
    if reloc:
        from gmmloc.vocab.bow import Vocabulary

        voc = Vocabulary.train(
            world.desc[:: max(1, len(world.desc) // 20000)],
            k=10, depth=4, seed=0,
        )
    sys_ = GMMLocSystem(cfg, gmap, vocabulary=voc)
    N = min(n_frames, len(ts) - start)
    # harness off the clock: render the sprite imagery before the timed
    # window (uint8 to bound memory); the system under measurement starts
    # at the image front-end
    imgs = []
    for i in range(N):
        fi = start + i
        left, right = renderer.render_stereo(q_wc[fi], t_wc[fi])
        imgs.append(
            (np.clip(np.round(left), 0, 255).astype(np.uint8),
             np.clip(np.round(right), 0, 255).astype(np.uint8))
        )
    t0 = time.time()
    done = 0
    use_packed = packed
    pend = None
    i_prev = -1
    for i in range(N + 1):
        # double-buffered front-end: frame i's fused detect/stereo
        # program runs on device while the tracker steps frame i-1
        # (the reference overlaps its two extractor threads with the
        # main loop the same way, gmmloc.cpp:241-249)
        if i < N and use_packed:
            fi = start + i
            left, right = imgs[i]
            pend_new = frontend.dispatch(i, ts[fi], left, right)
        else:
            pend_new = None
        if use_packed:
            if pend is None:
                pend, i_prev = pend_new, i
                continue
            frame = frontend.complete(pend)
            step_i = i_prev
            pend, i_prev = pend_new, i
        else:
            if i >= N:
                break
            fi = start + i
            left, right = imgs[i]
            frame = frontend.process(i, ts[fi], left, right)
            step_i = i
        fi = start + step_i
        sys_.step(frame, q_wc[fi], t_wc[fi])
        if sys_.track_failed:
            break
        done += 1
        if done % 100 == 0:
            print(f"  [{seq} r{run_idx}] {done}/{N} frames "
                  f"({done/(time.time()-t0):.1f} fps)", flush=True)
    sys_.flush()
    wall = time.time() - t0
    sys_.stop()
    ts_est, q_est, t_est = sys_.export_trajectory()
    if out_path:
        sys_.world.save_trajectory_tum(out_path)
    m = ate.ate_rmse(
        ts_est, t_est, ts[start:start + done], t_wc[start:start + done]
    )
    m.update(
        frames=done, target=N, fps=done / wall if wall > 0 else 0.0,
        kfs=sys_.world.n_keyframes(), pts=sys_.world.n_points(),
        completed=done == N, lost=sys_.n_lost,
        recoveries=len(sys_.recovery_frames),
    )
    # split-at-recovery scoring (VERDICT r4 #3): a BoW rescue re-anchors
    # the run after a divergence window; each inter-recovery segment is
    # scored with its OWN alignment so pre-loss divergence does not
    # pollute the post-recovery accuracy claim. post_recovery_rmse pools
    # the segments that start at a recovery.
    if sys_.recovery_frames and len(ts_est):
        rec_ts = [ts[start + ri] for ri in sys_.recovery_frames
                  if start + ri < len(ts)]
        bounds = [ts_est[0] - 1.0] + rec_ts + [ts_est[-1] + 1.0]
        segs = []
        for si, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
            sel = (ts_est >= a) & (ts_est < b)
            if sel.sum() < 30:
                continue
            sm = ate.ate_rmse(
                ts_est[sel], t_est[sel],
                ts[start:start + done], t_wc[start:start + done],
            )
            segs.append({
                "segment": si, "n": int(sel.sum()),
                "rmse": float(sm["rmse"]),
                "post_recovery": si > 0,
            })
        post = [s for s in segs if s["post_recovery"]]
        if post:
            n_tot = sum(s["n"] for s in post)
            m["post_recovery_rmse"] = float(
                np.sqrt(sum(s["n"] * s["rmse"] ** 2 for s in post) / n_tot)
            )
        m["segments"] = segs
    return m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", required=True, help=synthetic.MAP_HELP)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--seqs", default="V1_01_easy")
    ap.add_argument("--out", default="img_out")
    ap.add_argument("--damping", type=float, default=0.9)
    ap.add_argument("--refexact", action="store_true",
                    help="reference-exact tracking contract (ablation, "
                         "VERDICT r2 missing #5): raw constant-velocity "
                         "model (damping=1.0, ema=1.0), GMM pose anchors "
                         "off, plausibility gate off, no relocalization "
                         "(the reference's behavior is tracking.cpp:35-116 "
                         "alone)")
    ap.add_argument("--reloc", type=int, default=0,
                    help="1: arm the BoW relocalization rescue (capability "
                         "extension; default 0 = reference contract, "
                         "terminate on loss)")
    ap.add_argument("--packed", type=int, default=1,
                    help="1: fused single-dispatch front-end, double-"
                         "buffered against the tracker (production); "
                         "0: per-stage path")
    ap.add_argument("--depth", type=int, default=None,
                    help="override tracking.pipeline_depth")
    ap.add_argument("--distribution", default=None,
                    help="keypoint distribution A/B: quota (default) | "
                         "octree (DistributeOctTree emulation)")
    ap.add_argument("--landmarks", type=int, default=9000,
                    help="sprite-world landmark count (fidelity knob)")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    cfg = euroc_v1_config()
    tk = dict(
        velocity_damping=args.damping,
        use_fused_track=True, pipelined_track=True,
    )
    if args.refexact:
        tk.update(
            velocity_damping=1.0, velocity_ema=1.0,
            use_gmm_pose_anchor=False, max_jump_trans=1e9,
        )
    if args.depth is not None:
        tk["pipeline_depth"] = args.depth
    fr = {}
    if args.distribution:
        fr["detect_distribution"] = args.distribution
    cfg = cfg.replace(
        camera=dataclasses.replace(
            cfg.camera, do_rectify=False, do_equalization=False
        ),
        tracking=dataclasses.replace(cfg.tracking, **tk),
        frame=dataclasses.replace(cfg.frame, **fr),
    )
    results = {}
    seqs = ["room"] if args.map == "room" else args.seqs.split(",")
    for seq in seqs:
        source = synthetic.load_map_and_trajectory(
            args.map, seq, args.start + args.frames, seed=args.seed)
        gmap = mixture.for_config(source[0], source[1], cfg)
        runs = []
        for r in range(args.runs):
            m = run_once(cfg, seq, r, args.frames, args.start, gmap, source,
                         os.path.join(args.out, f"{seq}{r}.txt"),
                         packed=bool(args.packed), reloc=bool(args.reloc),
                         n_landmarks=args.landmarks)
            runs.append(m)
            post = (
                f" post_rec={m['post_recovery_rmse']*100:.2f}cm"
                if "post_recovery_rmse" in m else ""
            )
            print(
                f"{seq} run{r}: rmse={m['rmse']*100:.2f}cm "
                f"frames={m['frames']}/{m['target']} fps={m['fps']:.2f} "
                f"kfs={m['kfs']} rec={m.get('recoveries', 0)}{post}",
                flush=True,
            )
        results[seq] = {
            "rmse_mean": float(np.mean([m["rmse"] for m in runs])),
            "completion": float(np.mean([m["completed"] for m in runs])),
            "runs": runs,
        }
    print("\n=== image-level summary ===")
    for seq, r in results.items():
        print(f"{seq}: ATE rmse {r['rmse_mean']*100:.2f} cm "
              f"(completion {r['completion']*100:.0f}%)")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=2, default=float)


if __name__ == "__main__":
    main()
