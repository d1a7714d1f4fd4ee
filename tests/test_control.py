"""Run-control wiring: pause / step / stop gate the main loop.

Ref: global::pause/step/stop atomics (global.cpp:8-10) consumed by the
spin loop at gmmloc.cpp:128-131; here utils/control.py consumed by
GMMLocSystem.run (and the CLI tools' frame loops via
install_signal_handlers)."""

import os

import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.utils.control import _Control, control
from tests import assets

HAVE_ASSETS = assets.HAVE_ASSETS


def test_control_flag_semantics():
    c = _Control()
    assert c.should_run()                 # free-running by default
    c.toggle_pause()
    assert not c.should_run()             # paused blocks
    c.request_step()
    assert c.should_run()                 # single-step releases once
    assert c.consume_step()               # ...and is consumed
    assert not c.consume_step()
    assert not c.should_run()             # still paused after the step
    c.toggle_pause()
    assert c.should_run()
    c.request_stop()
    assert c.stop


@pytest.mark.skipif(not HAVE_ASSETS, reason="reference assets absent")
def test_stop_breaks_main_loop():
    """With stop requested, run() exits before tracking any frame
    (ref: gmmloc.cpp:130 `if (global::stop) break;`)."""
    from gmmloc.gmm import mixture
    from gmmloc.pipeline.system import GMMLocSystem

    cfg = euroc_v1_config()
    gmap = mixture.load(
        assets.V1_GMM, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
    )
    s = GMMLocSystem(cfg, gmap)

    consumed = []

    def frames():
        for i in range(5):
            consumed.append(i)
            yield None  # would crash in step() — must never get there

    control.stop = True
    try:
        s.run(frames())
    finally:
        control.stop = False
    assert len(consumed) == 1  # generator pulled once, then stop broke
    assert s.world.n_keyframes() == 0
