"""Where the tests find the EuRoC prior maps and ground truth.

The files are not part of the repository. Tests that need them skip
unless GMMLOC_EUROC_DATA names a directory holding map/v1.gmm and
gt_sync/*.txt; everything else runs on the seeded room
(eval/synthetic.py)."""

import os

EUROC_DIR = os.environ.get("GMMLOC_EUROC_DATA", "")
V1_GMM = os.path.join(EUROC_DIR, "map", "v1.gmm") if EUROC_DIR else ""
GT_DIR = os.path.join(EUROC_DIR, "gt_sync") if EUROC_DIR else ""
HAVE_ASSETS = bool(EUROC_DIR) and os.path.exists(V1_GMM)
V1_01_GT = os.path.join(GT_DIR, "V1_01_easy.txt") if EUROC_DIR else ""
EUROC_V1_01 = dict(gt_path=V1_01_GT, gmm_path=V1_GMM)

# data sources for the V1-size integration tests: the seeded room always
# runs; the EuRoC case skips without the files
SOURCES = ["room", "euroc"]


def v1_run(cfg, kind: str, n_frames: int, n_landmarks: int = 20000):
    """(gmap, frontend, ts, q_wc, t_wc, start) for a V1-size run of
    n_frames from `start`: kind "room" is the seeded room from frame 0,
    kind "euroc" is V1_01 on v1.gmm from frame 150 (skipped without the
    files)."""
    import pytest

    from gmmloc.eval import synthetic
    from gmmloc.gmm import mixture

    noise = dict(disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
    if kind == "room":
        gmap, fe, ts, q_wc, t_wc = synthetic.room_run(
            cfg, n_frames, n_landmarks=n_landmarks, **noise)
        return gmap, fe, ts, q_wc, t_wc, 0
    if not HAVE_ASSETS:
        pytest.skip("EuRoC files absent (GMMLOC_EUROC_DATA)")
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, **EUROC_V1_01, n_frames=150 + n_frames,
        n_landmarks=n_landmarks, **noise)
    gmap = mixture.load(
        V1_GMM, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
    )
    return gmap, fe, ts, q_wc, t_wc, 150
