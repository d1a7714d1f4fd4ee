"""Device-resident world mirror: equivalence with the upload paths.

The mirror (mapping/device_world.py) + on-device gather kernels replace
per-KF re-uploads of the world tables (ref reads them from shared memory,
localization.cpp:154-325). These tests pin:
  - mirror sync correctness (dirty-row scatter == host tables)
  - search_for_triangulation_gather == search_for_triangulation_batch
    (bit-identical: same f32 inputs either way)
  - _fuse_device == _fuse_jobs on a gate-unambiguous world (the device
    path projects in f32 where the host path used f64; the fixture keeps
    every gate decision far from its threshold so both agree exactly)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.features import matching
from gmmloc.geometry import camera as cam_mod
from gmmloc.mapping import map_state as ms
from gmmloc.mapping.device_world import DeviceWorld
from gmmloc.tracking.frame import make_frame


def _mk_world(cfg, rng, n_kfs=4, pts_per_kf=120):
    """World with n_kfs keyframes on a slow lateral track, all observing
    one shared field of landmarks at 4-8 m depth."""
    cam = cam_mod.CameraParams.from_config(cfg.camera)
    w = ms.MapState(cfg)
    N = n_kfs * pts_per_kf
    uv = rng.uniform([80, 80], [cam.width - 80, cam.height - 80], (N, 2))
    z = rng.uniform(4.0, 8.0, N)
    pw = np.stack(
        [(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z],
        -1,
    )
    desc = rng.integers(0, 256, (N, 32), dtype=np.uint8)
    kf_ids = []
    for k in range(n_kfs):
        t_cw = np.array([-(0.03 * k), 0.0, 0.0])
        pc = pw + t_cw
        u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
        v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
        ur = u - cam.bf / pc[:, 2]
        f = make_frame(
            k, float(k), np.stack([u, v], -1), ur.astype(np.float32),
            pc[:, 2].astype(np.float32), np.full(N, 2), np.zeros(N), desc,
            cfg.frame.feat_cap,
        )
        f.set_pose(np.array([1.0, 0, 0, 0]), t_cw)
        kf = w.alloc_keyframe(f)
        kf_ids.append(kf)
    # landmarks owned by kf0, observed there
    pids = []
    sf = w.pyr["scale_factors"]
    for i in range(N):
        p = w.alloc_point(pw[i], ref_kf=kf_ids[0], created_kf_idx=0)
        w.pt_desc[p] = desc[i]
        d = np.linalg.norm(pw[i])
        w.pt_normal[p] = pw[i] / d  # camera-to-point (update_normal_and_depth)
        w.pt_max_dist[p] = d * sf[2]
        w.pt_min_dist[p] = w.pt_max_dist[p] / sf[-1]
        w.add_observation(p, kf_ids[0], i)
        pids.append(p)
    return cam, w, kf_ids, np.array(pids), pw


def test_mirror_sync_matches_host(rng):
    cfg = euroc_v1_config()
    cam, w, kfs, pids, pw = _mk_world(cfg, rng)
    dv = DeviceWorld(w)
    dv.sync()
    np.testing.assert_array_equal(
        np.asarray(dv.kf_feat_desc)[kfs], w.kf_feat_desc[kfs]
    )
    np.testing.assert_allclose(
        np.asarray(dv.kf_feat_uv)[kfs], w.kf_feat_uv[kfs], rtol=0, atol=0
    )
    np.testing.assert_array_equal(np.asarray(dv.pt_valid), w.pt_valid)
    # mutate: BA-style position change + KF feature invalidation
    w.pt_pos[pids[:7]] += 0.01
    w.dirty_pt.update(pids[:7].tolist())
    w.kf_feat_valid[kfs[-1]] = False  # as remove_keyframe does
    w.dirty_kf.add(kfs[-1])
    dv.sync()
    np.testing.assert_allclose(
        np.asarray(dv.pt_pos)[pids[:7]],
        w.pt_pos[pids[:7]].astype(np.float32),
    )
    assert not np.asarray(dv.kf_feat_valid)[kfs[-1]].any()
    assert not w.dirty_pt and not w.dirty_kf


def test_tri_gather_equals_upload(rng):
    cfg = euroc_v1_config()
    cam, w, kfs, pids, pw = _mk_world(cfg, rng)
    dv = DeviceWorld(w)
    dv.sync()
    kf1 = kfs[0]
    kf2 = [kfs[1], kfs[2]]
    sigma2 = w.pyr["sigma2"]
    free1 = w.kf_feat_valid[kf1] & (w.kf_obs_point[kf1] < 0)
    free2 = w.kf_feat_valid[kf2]
    # fundamental matrices via the host helper in localization
    from gmmloc.mapping.localization import Localization
    from gmmloc.mapping.association import GMMAssociator

    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    fm, ep = [], []
    for k2 in kf2:
        q12, t12 = ms._compose(
            w.kf_q[kf1], w.kf_t[kf1], *ms._inverse(w.kf_q[k2], w.kf_t[k2])
        )
        R12 = ms._quat_to_mat(q12)
        tx = np.array(
            [[0, -t12[2], t12[1]], [t12[2], 0, -t12[0]], [-t12[1], t12[0], 0]]
        )
        fm.append(np.linalg.inv(K).T @ (tx @ R12) @ np.linalg.inv(K))
        ep.append([cam.cx, cam.cy])
    a = np.asarray(
        matching.search_for_triangulation_batch(
            jnp.array(w.kf_feat_uv[kf1], jnp.float32),
            jnp.array(w.kf_feat_ur[kf1], jnp.float32),
            jnp.array(w.kf_feat_desc[kf1]),
            jnp.array(w.kf_feat_octave[kf1]),
            jnp.array(w.kf_feat_angle[kf1]),
            jnp.array(free1),
            jnp.array(w.kf_feat_uv[kf2], jnp.float32),
            jnp.array(w.kf_feat_ur[kf2], jnp.float32),
            jnp.array(w.kf_feat_desc[kf2]),
            jnp.array(w.kf_feat_octave[kf2]),
            jnp.array(w.kf_feat_angle[kf2]),
            jnp.array(free2),
            jnp.array(np.stack(fm), jnp.float32),
            jnp.array(ep, jnp.float32),
            jnp.array(sigma2, jnp.float32),
        )
    )
    b = np.asarray(
        matching.search_for_triangulation_gather(
            jnp.int32(kf1), jnp.array(kf2, jnp.int32),
            jnp.array(free1), jnp.array(free2),
            jnp.array(np.stack(fm), jnp.float32),
            jnp.array(ep, jnp.float32),
            jnp.array(sigma2, jnp.float32),
            dv.kf_feat_uv, dv.kf_feat_ur, dv.kf_feat_desc,
            dv.kf_feat_octave, dv.kf_feat_angle,
        )
    )
    np.testing.assert_array_equal(a, b)


def test_fuse_device_equals_jobs(rng):
    base = euroc_v1_config()
    results = []
    for use_dev in (False, True):
        cfg = base.replace(
            loc=dataclasses.replace(base.loc, use_device_world=use_dev)
        )
        r = np.random.default_rng(7)  # same world both times
        cam, w, kfs, pids, pw = _mk_world(cfg, r)
        from gmmloc.gmm import mixture
        from gmmloc.mapping.association import GMMAssociator
        from gmmloc.mapping.localization import Localization

        gmap = mixture.from_arrays(
            np.array([[0.0, 0, 6.0]]), np.tile(np.eye(3) * 0.04, (1, 1, 1)),
            pad_to=8,
        )
        assoc = GMMAssociator(cfg, cam, gmap)
        loc = Localization(cfg, cam, w, assoc)
        # fuse kf1..3 against kf0's landmarks (points not yet observed
        # by those KFs -> pure add_observation path)
        n = loc._fuse(kfs[1], pids) if use_dev else loc._fuse_jobs(
            [(kfs[1], pids)]
        )
        obs = w.kf_obs_point[kfs[1]].copy()
        results.append((n, obs))
    n0, o0 = results[0]
    n1, o1 = results[1]
    assert n0 > 50  # the fixture actually fuses
    assert n1 == n0
    np.testing.assert_array_equal(o0, o1)
