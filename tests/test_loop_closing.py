"""Loop-closing test: drifted revisit is detected, verified, corrected."""

import numpy as np
import pytest

from gmmloc.mapping import loop_closing, map_state as ms
from gmmloc.vocab.bow import KeyFrameDatabase, Vocabulary
from tests.test_world_model import make_test_frame, small_cfg


def test_loop_close_corrects_drift(rng):
    cfg = small_cfg()
    w = ms.MapState(cfg)

    # shared landmark descriptors for the revisited place
    n_feat = 48
    place_desc = rng.integers(0, 256, (n_feat, 32), dtype=np.uint8)
    voc = Vocabulary.train(
        rng.integers(0, 256, (1500, 32), dtype=np.uint8), k=8, depth=3
    )
    db = KeyFrameDatabase(voc)

    # KF0 at origin observing landmarks on the z=5 wall
    lm_pos = np.stack(
        [rng.uniform(-2, 2, n_feat), rng.uniform(-1.5, 1.5, n_feat),
         np.full(n_feat, 5.0)], -1,
    )

    def add_kf(frame_idx, t_cw_offset, desc, drift=np.zeros(3)):
        f = make_test_frame(frame_idx, n=64)
        f.desc[:n_feat] = desc
        f.set_pose(np.array([1.0, 0, 0, 0]), np.asarray(t_cw_offset))
        kf = w.alloc_keyframe(f)
        for i in range(n_feat):
            p = w.alloc_point(lm_pos[i] + drift, kf, frame_idx)
            w.add_observation(p, kf, i)
        db.add(kf, w.kf_feat_desc[kf], w.kf_feat_valid[kf])
        return kf

    kf0 = add_kf(0, [0.0, 0, 0], place_desc)

    # intermediate keyframes elsewhere (different descriptors)
    mids = []
    for i in range(1, 4):
        kf = add_kf(
            i * 40, [i * 0.5, 0, 0],
            rng.integers(0, 256, (n_feat, 32), dtype=np.uint8),
        )
        mids.append(kf)

    # revisit the place with 0.3m of accumulated drift: same landmarks,
    # duplicated as drifted map points
    drift = np.array([0.3, 0.1, 0.0])
    kf_re = add_kf(200, drift, place_desc, drift=drift)

    lc = loop_closing.LoopCloser(cfg, w, db, min_score=0.01, min_inliers=15)
    cand = lc.detect(kf_re)
    assert cand is not None and cand[0] == kf0

    ver = lc.verify(kf_re, kf0)
    assert ver is not None
    q_ab, t_ab, n_in = ver
    assert n_in >= 15

    t_before = w.kf_t[kf_re].copy()
    ok = lc.close(kf_re)
    assert ok
    # the revisit KF pose moved toward consistency with kf0's frame:
    # its world position correction should be ~the drift magnitude
    assert np.linalg.norm(w.kf_t[kf_re] - t_before) > 0.1
