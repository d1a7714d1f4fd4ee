"""Live viewer: throttled atomic HTML re-export from a running world."""

import time

import numpy as np

from gmmloc.config import euroc_v1_config
from gmmloc.mapping.map_state import MapState
from gmmloc.pipeline.live_viewer import LiveViewer
from gmmloc.tracking.frame import make_frame


def _world_with_kf():
    cfg = euroc_v1_config()
    w = MapState(cfg)
    n = 50
    rng = np.random.default_rng(0)
    f = make_frame(
        0, 0.0, rng.uniform(50, 400, (n, 2)), np.full(n, -1.0),
        np.full(n, -1.0), np.zeros(n, np.int32), np.zeros(n),
        rng.integers(0, 256, (n, 32), dtype=np.uint8), cfg.frame.feat_cap,
    )
    f.valid[:n] = True
    f.set_pose(np.array([1.0, 0, 0, 0]), np.zeros(3))
    kf = w.alloc_keyframe(f)
    for i in range(20):
        p = w.alloc_point(rng.uniform(-2, 2, 3), ref_kf=kf, created_kf_idx=0)
        w.add_observation(p, kf, i)
    f.ref_kf = kf
    w.update_frame_info(f)
    return w


def test_live_viewer_writes_and_throttles(tmp_path):
    w = _world_with_kf()
    path = str(tmp_path / "live.html")
    v = LiveViewer(path, interval=10.0)
    assert v.maybe_update(w)            # first write goes through
    html = open(path).read()
    assert "http-equiv=\"refresh\"" in html
    assert len(html) > 1000
    assert not v.maybe_update(w)        # throttled inside the interval
    assert v.maybe_update(w, force=True)
    assert v.n_writes == 2
    assert not (tmp_path / "live.html.tmp").exists()  # atomic rename


def test_live_viewer_interval_elapses(tmp_path):
    w = _world_with_kf()
    v = LiveViewer(str(tmp_path / "x.html"), interval=0.05)
    assert v.maybe_update(w)
    time.sleep(0.06)
    assert v.maybe_update(w)
