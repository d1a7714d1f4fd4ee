"""Export the interactive HTML map viewer from a checkpoint.

Usage:
  python tools/view_map.py <checkpoint.npz> [--gmm room|/path.gmm]
                           [--out map.html]

Viewer parity for the reference's live visualizer (visualizer.cpp) over
the checkpoint format instead of a ROS topic — open the HTML in any
browser, no server or network needed.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # pure host tool

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.mapping.map_state import MapState
from gmmloc.pipeline import checkpoint, html_viewer
from gmmloc.utils import proto


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--gmm", default=None,
                    help="path to a .gmm proto stream, or 'room' for the "
                         "seeded room's map")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    cfg = euroc_v1_config()
    world = MapState(cfg)
    checkpoint.load_checkpoint(args.ckpt, world)

    gmm = None
    if args.gmm:
        if args.gmm == "room":
            means, covs = synthetic.room_gmm()
        else:
            means, covs, _, _ = proto.load_gmm_file(args.gmm)
        gmm = {"means": means, "covs": covs}

    out = args.out or os.path.splitext(args.ckpt)[0] + ".html"
    html_viewer.export_html(world, out, gmm=gmm)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
