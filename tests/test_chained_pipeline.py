"""Deep device-chained pipeline (tracking.pipeline_depth > 1).

The chained mode computes frame N+1's dispatch inputs on device from
frame N's un-fetched output (fused.fused_track_step_chained) and drains
results pipeline_depth frames late — the host-side readback RTT hides
behind the dispatch front. Semantics are bounded-staleness (the
reference's online tracking/mapping contract, gmmloc.cpp:56-59), NOT
bit-identical to the synchronous path: KF decisions land at drain time
and temporal points are synthesized from the device pose chain.
"""

import dataclasses

import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.mapping.map_state import _inverse
from gmmloc.pipeline.system import GMMLocSystem
from tests import assets


def _run(depth, kind, n=60):
    cfg = euroc_v1_config()
    cfg = cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, velocity_damping=0.9, pipeline_depth=depth))
    gmap, fe, ts, q_wc, t_wc, START = assets.v1_run(cfg, kind, n)
    s = GMMLocSystem(cfg, gmap)
    frames = []
    for i in range(n):
        fi = START + i
        f = fe.make_frame(i, ts[fi], q_wc[fi], t_wc[fi])
        frames.append((f, q_wc[fi], t_wc[fi]))
    done = 0
    for f, gq, gt in frames:
        st = s.step(f, gq, gt)
        assert not s.track_failed
        if st is not None and st.res:
            done += 1
    st = s.flush()
    if st is not None and st.res:
        done += 1
    errs = []
    for f, gq, gt in frames:
        _, c = _inverse(f.q_cw, f.t_cw)
        errs.append(np.linalg.norm(c - gt))
    return s, done, errs


@pytest.mark.parametrize("kind", assets.SOURCES)
def test_chained_pipeline_tracks(kind):
    s, done, errs = _run(depth=4, kind=kind)
    # chained mode forces kf-cadence map refresh + requires device world
    assert s._depth == 4
    assert s.cfg.tracking.fused_map_refresh == "kf"
    # stats arrive with the pipeline-fill lag and flush surfaces one
    # final stat: n - depth - 1 .. n of them; poses stay near GT
    assert done >= 60 - 5, done
    assert max(errs) < 0.08, max(errs)
    assert s.world.n_keyframes() >= 2
    # the pipeline actually ran chained (chain primed, depth respected)
    assert s.tracker._chain is not None or s._pendq == type(s._pendq)()


@pytest.mark.parametrize("kind", assets.SOURCES)
def test_chained_matches_depth1_accuracy(kind):
    """Drained trajectories of depth-4 vs depth-1 agree to sub-cm on a
    clean slice (bounded staleness, not bit-equality)."""
    _, done1, errs1 = _run(depth=1, kind=kind)
    _, done4, errs4 = _run(depth=4, kind=kind)
    # depth-4 surfaces up to depth more stats through flush as a single
    # return — compare the tracked POSES, not the stat count
    assert done4 >= done1 - 4
    assert max(errs4) < max(errs1) + 0.02, (max(errs1), max(errs4))
