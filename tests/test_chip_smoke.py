"""chip_smoke.py's phases at a tiny size on the CPU (the card runs them at
full size), its device check, and the compile-cache helper."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from gmmloc.utils import jaxenv  # noqa: E402


def test_device_check_refuses_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.check_device()


def test_cache_dir_honours_env_else_fixed_path():
    assert jaxenv.cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) == "/x/cache"
    assert jaxenv.cache_dir({}) == jaxenv.DEFAULT_CACHE_DIR
    assert jaxenv.DEFAULT_CACHE_DIR == os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")


def test_setup_compile_cache_leaves_env_dir_to_jax(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert jaxenv.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir is None  # JAX reads env
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert jaxenv.setup_compile_cache() == jaxenv.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == jaxenv.DEFAULT_CACHE_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_phase_kernels_tiny():
    r = chip_smoke.phase_kernels(F=128, P=256, n_hamming=(64, 100),
                                 interpret=True, reps=1)
    assert set(r) == {"pose", "pose_anchored", "hamming_xla",
                      "fused_track_step"}
    assert r["fused_track_step"]["inliers"][0] > 0


@pytest.mark.parametrize("online", [False, True])
def test_phase_main_path_tiny(online):
    r = chip_smoke.phase_main_path(
        online=online, n_frames=40, n_components=400, n_landmarks=12000,
        min_kfs=3, prewarm=False)
    assert r["frames"] == 40 and r["keyframes"] >= 3


def test_phase_image_path_tiny():
    import dataclasses

    from gmmloc.config import CameraConfig

    c = CameraConfig()
    half = dataclasses.replace(
        c, fx=c.fx / 2, fy=c.fy / 2, cx=c.cx / 2, cy=c.cy / 2, bf=c.bf / 2,
        width=c.width // 2, height=c.height // 2)
    r = chip_smoke.phase_image_path(n_frames=6, n_components=400,
                                    n_landmarks=3000, camera=half)
    assert r["frames"] == 6
