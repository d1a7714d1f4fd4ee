"""Online (threaded mapping) mode smoke test."""

import dataclasses

import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.mapping.map_state import _inverse
from gmmloc.pipeline.system import GMMLocSystem
from tests import assets


@pytest.mark.parametrize("kind", assets.SOURCES)
def test_online_mode_tracks_and_maps(kind):
    cfg = euroc_v1_config().replace(online=True)
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )
    N = 50
    gmap, fe, ts, q_wc, t_wc, START = assets.v1_run(cfg, kind, N)
    s = GMMLocSystem(cfg, gmap)
    assert s.online is not None
    errs = []
    for i in range(N):
        fi = START + i
        f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
        st = s.step(f, q_wc[fi], t_wc[fi])
        assert st is None or st.res, f"failed at {i}"
        qi, ti = _inverse(f.q_cw, f.t_cw)
        errs.append(np.linalg.norm(ti - t_wc[fi]))
    s.stop()  # drain the mapping thread
    assert s.localizer.is_finished
    assert max(errs) < 0.08, max(errs)
    # mapping thread processed the queue
    assert s.localizer.count_queue() == 0
    assert s.world.n_keyframes() >= 1
