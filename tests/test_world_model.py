"""World-model (MapState) bookkeeping tests: observation surgery,
covisibility, replacement, culling, trajectory re-anchoring."""

import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.mapping import map_state as ms
from gmmloc.tracking.frame import make_frame


def small_cfg():
    cfg = euroc_v1_config()
    import dataclasses

    caps = dataclasses.replace(
        cfg.caps, max_keyframes=16, max_points=256, max_obs_per_point=8
    )
    frame = dataclasses.replace(cfg.frame, feat_cap=64)
    return cfg.replace(caps=caps, frame=frame)


def make_test_frame(idx, n=32, stereo=True, seed=0):
    rng = np.random.default_rng(seed + idx)
    uv = rng.uniform([0, 0], [752, 480], (n, 2))
    ur = uv[:, 0] - 8.0 if stereo else np.full(n, -1.0)
    depth = np.full(n, 6.0) if stereo else np.full(n, -1.0)
    return make_frame(
        idx, idx * 0.05, uv, ur, depth,
        rng.integers(0, 8, n), rng.uniform(0, 360, n),
        rng.integers(0, 256, (n, 32), dtype=np.uint8), 64,
    )


def test_alloc_and_observe():
    w = ms.MapState(small_cfg())
    f = make_test_frame(0)
    kf = w.alloc_keyframe(f)
    p = w.alloc_point([1.0, 2.0, 3.0], ref_kf=kf, created_kf_idx=0)
    w.add_observation(p, kf, 5)
    assert w.kf_obs_point[kf, 5] == p
    assert w.pt_n_obs[p] == 2  # stereo counts double (mappoint.cpp:72)
    w.check_invariants()
    # removing drops below the bad threshold
    bad = w.remove_observation(p, kf)
    assert bad  # 0 obs <= 2
    w.remove_point(p)
    assert not w.pt_valid[p]
    w.check_invariants()


def test_replace_point_moves_observations():
    w = ms.MapState(small_cfg())
    kf1 = w.alloc_keyframe(make_test_frame(0))
    kf2 = w.alloc_keyframe(make_test_frame(1))
    a = w.alloc_point([0, 0, 5.0], kf1, 0)
    b = w.alloc_point([0, 0, 5.01], kf2, 1)
    w.add_observation(a, kf1, 3)
    w.add_observation(b, kf2, 7)
    w.replace_point(a, b)
    assert not w.pt_valid[a]
    assert w.pt_replaced_by[a] == b
    assert w.kf_obs_point[kf1, 3] == b
    assert w.resolve_replaced(a) == b
    w.check_invariants()


def test_covisibility_links():
    w = ms.MapState(small_cfg())
    kf1 = w.alloc_keyframe(make_test_frame(0))
    kf2 = w.alloc_keyframe(make_test_frame(1))
    # 20 shared points (>= threshold 15)
    for i in range(20):
        p = w.alloc_point([i, 0, 5.0], kf1, 0)
        w.add_observation(p, kf1, i)
        w.add_observation(p, kf2, i)
    best = w.update_connections(kf1)
    assert best == kf2
    assert w.covis[kf1, kf2] == 20
    assert list(w.best_covisible(kf1)) == [kf2]


def test_covisibility_below_threshold_keeps_best():
    w = ms.MapState(small_cfg())
    kf1 = w.alloc_keyframe(make_test_frame(0))
    kf2 = w.alloc_keyframe(make_test_frame(1))
    for i in range(5):  # below th=15 -> still linked as single best
        p = w.alloc_point([i, 0, 5.0], kf1, 0)
        w.add_observation(p, kf1, i)
        w.add_observation(p, kf2, i)
    w.update_connections(kf1)
    assert list(w.best_covisible(kf1)) == [kf2]


def test_remove_keyframe_reanchors_frames():
    w = ms.MapState(small_cfg())
    f0 = make_test_frame(0)
    f1 = make_test_frame(1)
    f1.set_pose(np.array([1.0, 0, 0, 0]), np.array([1.0, 0, 0]))
    kf0 = w.alloc_keyframe(f0)
    kf1 = w.alloc_keyframe(f1)
    for i in range(20):
        p = w.alloc_point([i, 0, 5.0], kf0, 0)
        w.add_observation(p, kf0, i)
        w.add_observation(p, kf1, i)
    w.update_connections(kf0)
    w.update_connections(kf1)

    frame = make_test_frame(2)
    frame.ref_kf = kf1
    frame.set_pose(np.array([1.0, 0, 0, 0]), np.array([1.0, 0.5, 0]))
    w.update_frame_info(frame)
    ts, q, t = w.export_trajectory()
    t_before = t[0].copy()

    w.remove_keyframe(kf1)
    assert not w.kf_valid[kf1]
    assert w.frame_infos[0].ref_kf == kf0
    ts, q, t = w.export_trajectory()
    np.testing.assert_allclose(t[0], t_before, atol=1e-9)
    w.check_invariants()


def test_distinctive_descriptor_median():
    w = ms.MapState(small_cfg())
    kfs = [w.alloc_keyframe(make_test_frame(i)) for i in range(3)]
    p = w.alloc_point([0, 0, 5.0], kfs[0], 0)
    # make kf0/kf1 descriptors identical, kf2 different: median picks 0 or 1
    w.kf_feat_desc[kfs[1], 1] = w.kf_feat_desc[kfs[0], 0]
    for kf, ft in zip(kfs, [0, 1, 2]):
        w.add_observation(p, kf, ft)
    w.compute_distinctive_descriptor(p)
    assert (
        (w.pt_desc[p] == w.kf_feat_desc[kfs[0], 0]).all()
        or (w.pt_desc[p] == w.kf_feat_desc[kfs[1], 1]).all()
    )


def test_tum_export_format(tmp_path):
    w = ms.MapState(small_cfg())
    f = make_test_frame(0)
    kf = w.alloc_keyframe(f)
    frame = make_test_frame(1)
    frame.ref_kf = kf
    w.update_frame_info(frame)
    path = str(tmp_path / "traj.txt")
    w.save_trajectory_tum(path)
    data = np.loadtxt(path)
    assert data.shape == (8,)
    # quaternion normalized, stored xyzw after position
    np.testing.assert_allclose(np.linalg.norm(data[4:8]), 1.0, atol=1e-6)
