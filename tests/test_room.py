"""The seeded room (eval/synthetic.py): a V1-sized prior map and a 20 Hz
trajectory made from a seed, in place of the EuRoC files."""

import numpy as np

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.gmm import mixture


def test_room_is_deterministic_per_seed():
    a = synthetic.seeded_room(50, seed=3)
    b = synthetic.seeded_room(50, seed=3)
    c = synthetic.seeded_room(50, seed=4)
    for x, y in ((a.means, b.means), (a.covs, b.covs), (a.q_wc, b.q_wc),
                 (a.t_wc, b.t_wc)):
        np.testing.assert_array_equal(x, y)
    assert not np.allclose(a.means, c.means)
    assert not np.allclose(a.t_wc, c.t_wc)


def test_room_map_size_and_planar_share():
    cfg = euroc_v1_config()
    room = synthetic.seeded_room(10, seed=0)
    K = synthetic.ROOM_COMPONENTS
    assert room.means.shape == (K, 3) and room.covs.shape == (K, 3, 3)
    gmap = mixture.for_config(room.means, room.covs, cfg)
    assert gmap.means.shape[0] == cfg.caps.gmm_components_pad
    deg = np.asarray(gmap.is_degenerated)[:K]
    assert 0.8 <= deg.mean() <= 0.95, deg.mean()
    # components lie inside the room box (floor at 0, centred in x/y)
    sx, sy, sz = synthetic.ROOM_SIZE
    lo = np.array([-sx / 2, -sy / 2, 0.0]) - 1e-6
    hi = np.array([sx / 2, sy / 2, sz]) + 1e-6
    assert ((room.means >= lo) & (room.means <= hi)).all()
    # the neighbour graph is built (most components have a neighbour)
    nb = np.asarray(gmap.neighbors)[:K]
    assert (nb[:, 0] >= 0).mean() > 0.5


def test_room_trajectory_is_smooth_and_inside():
    ts, q, t = synthetic.room_trajectory(400, seed=0)
    assert np.allclose(np.diff(ts), 0.05)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-12)
    step = np.linalg.norm(np.diff(t, axis=0), axis=1)
    assert 0.005 < step.mean() < 0.05 and step.max() < 0.08
    dots = np.abs(np.sum(q[1:] * q[:-1], axis=1))
    dang = np.degrees(2 * np.arccos(np.clip(dots, 0, 1)))
    assert 0.5 < dang.mean() < 3.0 and dang.max() < 6.0
    sx, sy, sz = synthetic.ROOM_SIZE
    assert (np.abs(t[:, 0]) < sx / 2 - 1).all()
    assert (np.abs(t[:, 1]) < sy / 2 - 1).all()
    assert ((t[:, 2] > 0.5) & (t[:, 2] < sz - 0.5)).all()


def test_make_sequence_needs_a_map_and_a_trajectory():
    import pytest

    cfg = euroc_v1_config()
    room = synthetic.seeded_room(5, seed=0, n_components=50)
    with pytest.raises(ValueError):
        synthetic.make_sequence(cfg, trajectory=room.trajectory)
    with pytest.raises(ValueError):
        synthetic.make_sequence(cfg, gmm=(room.means, room.covs))
    with pytest.raises(FileNotFoundError):
        synthetic.make_sequence(cfg, gmm_path="missing.gmm",
                                trajectory=room.trajectory)
