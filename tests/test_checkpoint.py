"""Checkpoint/resume round-trip tests."""

import numpy as np

from gmmloc.pipeline import checkpoint
from tests.test_world_model import make_test_frame, small_cfg

from gmmloc.mapping import map_state as ms


def test_checkpoint_roundtrip(tmp_path):
    cfg = small_cfg()
    w = ms.MapState(cfg)
    kf0 = w.alloc_keyframe(make_test_frame(0))
    kf1 = w.alloc_keyframe(make_test_frame(1))
    for i in range(20):
        p = w.alloc_point([i, 0.0, 5.0], kf0, 0)
        w.add_observation(p, kf0, i)
        w.add_observation(p, kf1, i)
    w.update_connections(kf0)
    fr = make_test_frame(2)
    fr.ref_kf = kf0
    w.update_frame_info(fr)

    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(path, w, frame_cursor=3, extra={"seq": "V1"})

    w2 = ms.MapState(cfg)
    cursor, extra = checkpoint.load_checkpoint(path, w2)
    assert cursor == 3 and extra["seq"] == "V1"
    np.testing.assert_array_equal(w.kf_obs_point, w2.kf_obs_point)
    np.testing.assert_array_equal(w.pt_pos, w2.pt_pos)
    np.testing.assert_array_equal(w.covis, w2.covis)
    assert w._kf_order == w2._kf_order
    assert len(w2.frame_infos) == 1
    w2.check_invariants()
    # trajectories identical
    t1 = w.export_trajectory()
    t2 = w2.export_trajectory()
    np.testing.assert_allclose(t1[2], t2[2])


def test_html_viewer_export(tmp_path):
    """The offline viewer renders a populated world + GMM layer into one
    self-contained HTML file (viewer parity, visualizer.cpp:150-221)."""
    import dataclasses

    import numpy as np

    from gmmloc.config import euroc_v1_config
    from gmmloc.eval import synthetic
    from gmmloc.gmm import mixture
    from gmmloc.pipeline import html_viewer
    from gmmloc.pipeline.system import GMMLocSystem

    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )
    room = synthetic.seeded_room(25, seed=0, n_components=400)
    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gmm=(room.means, room.covs), trajectory=room.trajectory,
        n_landmarks=12000, disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1,
    )
    s = GMMLocSystem(cfg, mixture.for_config(room.means, room.covs, cfg))
    for i in range(25):
        f = fe.make_frame(i, ts[i], q_wc[i], t_wc[i])
        s.step(f, q_wc[i], t_wc[i])
    means, covs = room.means, room.covs
    out = str(tmp_path / "map.html")
    html_viewer.export_html(s.world, out, gmm={"means": means, "covs": covs})
    text = open(out).read()
    assert "frusta" in text and "<canvas" in text
    # data payload is present and non-trivial
    import json
    import re

    m = re.search(r"const D = (\{.*?\});\n", text, re.S)
    data = json.loads(m.group(1))
    assert len(data["frusta"]) >= 8       # >= one keyframe (8 segments)
    assert len(data["points"]) > 100
    assert len(data["ellipsoids"]) > 100
    assert len(data["traj"]) >= 20
