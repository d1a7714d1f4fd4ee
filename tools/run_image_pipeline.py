"""Image-path smoke: sprite-rendered stereo -> ORB front-end -> system.

Exercises the FULL pipeline including the image front-end (the
feature-level harness bypasses it). Usage:
  python tools/run_image_pipeline.py --map room [--seed 0] [--frames 30]
  python tools/run_image_pipeline.py --map DIR [--frames 30] [--start 150]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

jaxenv.setup_compile_cache()

import argparse
import dataclasses

import numpy as np

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.eval.image_synthetic import SpriteRenderer
from gmmloc.gmm import mixture
from gmmloc.mapping.map_state import _inverse
from gmmloc.pipeline.frontend import ImageFrontend
from gmmloc.pipeline.system import GMMLocSystem


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", required=True, help=synthetic.MAP_HELP)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--start", type=int, default=None,
                    help="first frame (default 150 for EuRoC, 0 for the room)")
    args = ap.parse_args()
    n_frames = args.frames
    start = args.start if args.start is not None else (
        0 if args.map == "room" else 150)

    cfg = euroc_v1_config()
    cfg = cfg.replace(
        camera=dataclasses.replace(cfg.camera, do_rectify=False, do_equalization=False),
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9),
    )
    means, covs, (ts, q_wc, t_wc) = synthetic.load_map_and_trajectory(
        args.map, "V1_01_easy", start + n_frames, seed=args.seed)
    world = synthetic.sample_world_from_gmm(means, covs, n_landmarks=9000)
    renderer = SpriteRenderer(world, cfg)
    frontend = ImageFrontend(cfg)
    sys_ = GMMLocSystem(cfg, mixture.for_config(means, covs, cfg))

    t0 = time.time()
    frames = []
    for i in range(n_frames):
        fi = start + i
        left, right = renderer.render_stereo(q_wc[fi], t_wc[fi])
        left = np.clip(np.round(left), 0, 255).astype(np.uint8)
        right = np.clip(np.round(right), 0, 255).astype(np.uint8)
        frame = frontend.process_packed(i, ts[fi], left, right)
        n_depth = int((frame.depth > 0).sum())
        # pipelined default: stat belongs to the PREVIOUS frame (None
        # while the first is in flight); final poses land at drain time
        st = sys_.step(frame, q_wc[fi], t_wc[fi])
        frames.append((fi, frame))
        print(
            f"f{i}: feats={frame.num_features()} stereo={n_depth} "
            f"inl={st.num_match_inliers if st is not None else '-'} "
            f"kfs={sys_.world.n_keyframes()} pts={sys_.world.n_points()}",
            flush=True,
        )
        if sys_.track_failed or (st is not None and not st.res):
            print("TRACKING FAILED")
            break
    sys_.flush()
    errs = []
    for fi, frame in frames:
        _, ti = _inverse(frame.q_cw, frame.t_cw)
        errs.append(np.linalg.norm(ti - t_wc[fi]))
    wall = time.time() - t0
    print(f"\n{len(errs)} frames in {wall:.0f}s; max err {max(errs)*1000:.1f}mm")


if __name__ == "__main__":
    main()
