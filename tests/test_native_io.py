"""Native IO layer: libpng decode + prefetch ring vs the PIL oracle.

(ref role: /root/reference/gmmloc/src/utils/dataloader.cpp:53-116 image
loading; gmmloc.cpp:241-249 decode threads.)
"""

import os

import numpy as np
import pytest
from PIL import Image

from gmmloc.utils import native


@pytest.fixture(autouse=True)
def _io_library():
    """Skip unless the native IO library builds (it needs libpng)."""
    if not native.io_available():
        pytest.skip("native io library not built (libpng missing?)")


def _write_pngs(tmp_path, n=6, w=64, h=48, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(img, mode="L").save(p)
        paths.append((p, img))
    return paths


def test_decode_matches_pil(tmp_path):
    for p, img in _write_pngs(tmp_path, n=3):
        dec = native.decode_png_gray(p)
        assert dec is not None
        np.testing.assert_array_equal(dec, img)


def test_decode_rgb_converts_to_gray(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    p = str(tmp_path / "rgb.png")
    Image.fromarray(img, mode="RGB").save(p)
    dec = native.decode_png_gray(p)
    assert dec is not None and dec.shape == (16, 16)
    # BT.709 luma within rounding of the float conversion
    luma = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    assert np.abs(dec.astype(np.float64) - luma).max() <= 2.0


def test_prefetcher_in_order_and_complete(tmp_path):
    pairs = _write_pngs(tmp_path, n=10)
    paths = [p for p, _ in pairs]
    imgs = [im for _, im in pairs]
    pf = native.NativePrefetcher(paths, list(reversed(paths)),
                                 capacity=3, n_threads=2)
    try:
        for i in range(10):
            got = pf.take()
            assert got is not None
            np.testing.assert_array_equal(got[0], imgs[i])
            np.testing.assert_array_equal(got[1], imgs[9 - i])
        assert pf.take() is None
    finally:
        pf.close()


def test_prefetcher_slot_contention_stress(tmp_path):
    # capacity 2 with 4 workers maximizes same-slot contention; the ring
    # must serve frames in strict order with uncorrupted buffers.
    pairs = _write_pngs(tmp_path, n=64, w=32, h=24, seed=3)
    paths = [p for p, _ in pairs]
    imgs = [im for _, im in pairs]
    pf = native.NativePrefetcher(paths, paths, capacity=2, n_threads=4)
    try:
        for i in range(64):
            got = pf.take()
            np.testing.assert_array_equal(got[0], imgs[i])
            np.testing.assert_array_equal(got[1], imgs[i])
        assert pf.take() is None
    finally:
        pf.close()


def test_missing_file_raises(tmp_path):
    pairs = _write_pngs(tmp_path, n=2)
    paths = [p for p, _ in pairs]
    bad = [paths[0], str(tmp_path / "nope.png")]
    pf = native.NativePrefetcher(bad, bad, capacity=2, n_threads=1)
    try:
        pf.take()  # first pair decodes fine
        with pytest.raises(IOError):
            pf.take()
    finally:
        pf.close()


def test_dataloader_uses_native_decode(tmp_path):
    # EuRoC ASL layout smoke: cam0/cam1 with a 3-frame index
    from gmmloc.pipeline.dataloader import EuRoCDataloader

    for cam in ("cam0", "cam1"):
        os.makedirs(tmp_path / "mav0" / cam / "data", exist_ok=True)
    rng = np.random.default_rng(2)
    rows = []
    frames = []
    for i in range(3):
        img = rng.integers(0, 256, (20, 24), dtype=np.uint8)
        name = f"{1000+i}.png"
        for cam in ("cam0", "cam1"):
            Image.fromarray(img, mode="L").save(
                str(tmp_path / "mav0" / cam / "data" / name))
        rows.append(f"{(1000+i)*1000000},{name}")
        frames.append(img)
    with open(tmp_path / "mav0" / "cam0" / "data.csv", "w") as f:
        f.write("#ts,fname\n" + "\n".join(rows) + "\n")

    dl = EuRoCDataloader(str(tmp_path))
    out = list(dl)
    assert len(out) == 3
    for i, fr in enumerate(out):
        np.testing.assert_array_equal(fr.left.astype(np.uint8), frames[i])
        np.testing.assert_array_equal(fr.right.astype(np.uint8), frames[i])
