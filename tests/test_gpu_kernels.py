"""The Pallas pose kernel compiled for the card against its XLA reference
at production widths. Marked `gpu`: they skip on the CPU and run on the
card with `python -m pytest -m gpu tests/`."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.gpu


def test_pose_kernels_match_xla_at_feat_cap(gpu):
    import chip_smoke

    r = chip_smoke.phase_kernels(reps=3)
    assert r["pose"]["kernel_ms"] > 0 and r["pose_anchored"]["kernel_ms"] > 0
