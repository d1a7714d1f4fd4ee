"""LOST-state relocalization: the system survives a tracking blackout.

Capability extension over the reference, which terminates the run on
tracking failure (ref: gmmloc.cpp:157-159; SURVEY.md §5.3). Here the
observation stream is blacked out for several frames (total detection
dropout) and the system must enter the LOST state, keep consuming
frames, relocalize via the BoW keyframe database once observations
resume, and finish the sequence with a sane trajectory.
"""

import dataclasses
import os

import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.eval import ate, synthetic
from gmmloc.gmm import mixture
from gmmloc.pipeline.system import GMMLocSystem
from gmmloc.vocab.bow import Vocabulary
from tests import assets

HAVE_ASSETS = assets.HAVE_ASSETS


@pytest.mark.skipif(not HAVE_ASSETS, reason="reference assets absent")
def test_lost_state_relocalization_recovers():
    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, **assets.EUROC_V1_01, n_frames=400, stride=1, n_landmarks=20000,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
    )
    gmap = mixture.load(
        assets.V1_GMM, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
    )
    voc = Vocabulary.train(fe.world.desc[::4], k=10, depth=3, seed=0)
    s = GMMLocSystem(cfg, gmap, vocabulary=voc)
    assert s.relocalizer is not None

    START, N = 150, 70
    BLACKOUT = range(40, 46)  # frames with zero true detections
    frames = []
    for i in range(N):
        fi = START + i
        if i in BLACKOUT:
            fe.drop_frac, saved = 1.0, fe.drop_frac
        f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
        if i in BLACKOUT:
            fe.drop_frac = saved
        s.step(f, q_wc[fi], t_wc[fi])  # pipelined: stat is prev frame's
        assert not s.track_failed, f"fatal failure at {i}"
        frames.append((i, fi, f))
    s.flush()

    assert s.n_lost > 0, "blackout never triggered the LOST state"
    assert not s.lost, "system did not relocalize after the blackout"
    # per-frame post-recovery error from each frame's FINAL pose (solved
    # at drain time in pipelined mode); untracked frames keep their guess
    # pose but also have no frame_info — gate on recorded timestamps
    recorded = {info.timestamp for info in s.world.frame_infos}
    errs = [
        np.linalg.norm(-_rot(f.q_cw).T @ f.t_cw - t_wc[fi])
        for i, fi, f in frames
        if i > max(BLACKOUT) and ts[fi] in recorded
    ]
    assert len(errs) >= 10, "too few tracked frames after recovery"
    assert np.max(errs) < 0.10, f"post-recovery error {np.max(errs):.3f} m"

    # exported trajectory skips the lost frames but still scores
    ts_est, _, t_est = s.export_trajectory()
    m = ate.ate_rmse(ts_est, t_est, ts[START : START + N], t_wc[START : START + N])
    assert m["rmse"] < 0.05, m


def _rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


@pytest.mark.skipif(not HAVE_ASSETS, reason="reference assets absent")
def test_kidnapped_robot_relocalizes_into_old_map():
    """Kidnapped-robot scenario (VERDICT r1 #8): after mapping a stretch,
    the camera is teleported (with a sensor blackout masking the jump)
    back into previously-mapped territory. The tracker must go LOST and
    BoW place recognition must re-anchor it against the old keyframes,
    with small post-recovery absolute error."""
    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, **assets.EUROC_V1_01, n_frames=500, stride=1, n_landmarks=20000,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
    )
    gmap = mixture.load(
        assets.V1_GMM, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
    )
    voc = Vocabulary.train(fe.world.desc[::4], k=10, depth=3, seed=0)
    s = GMMLocSystem(cfg, gmap, vocabulary=voc)

    START, MAPPED, BLACK = 150, 90, 5
    RETURN = 10   # teleport target: frame START+RETURN (old territory)
    errs_after = []
    step = 0
    # phase 1: map a stretch
    for i in range(MAPPED):
        fi = START + i
        f = fe.make_frame(step, ts[fi], q_wc[fi], t_wc[fi])
        s.step(f, q_wc[fi], t_wc[fi])
        step += 1
        assert not s.track_failed
    kfs_before = s.world.n_keyframes()
    # phase 2: blackout frames during the "teleport"
    saved = fe.drop_frac
    fe.drop_frac = 1.0
    for _ in range(BLACK):
        fi = START + RETURN
        f = fe.make_frame(step, ts[fi], q_wc[fi], t_wc[fi])
        s.step(f, q_wc[fi], t_wc[fi])
        step += 1
    fe.drop_frac = saved
    assert s.lost or s.n_lost > 0, "teleport blackout did not trigger LOST"
    # phase 3: wake up in old territory
    for j in range(40):
        fi = START + RETURN + j
        f = fe.make_frame(step, ts[fi], q_wc[fi], t_wc[fi])
        st = s.step(f, q_wc[fi], t_wc[fi])
        step += 1
        assert not s.track_failed
        if st is not None and st.res and not s.lost:
            errs_after.append(
                np.linalg.norm(-_rot(f.q_cw).T @ f.t_cw - t_wc[fi])
            )
    assert not s.lost, "never relocalized after the kidnap"
    assert len(errs_after) >= 15, "too few tracked frames after recovery"
    assert np.median(errs_after) < 0.10, (
        f"post-recovery error {np.median(errs_after):.3f} m"
    )
