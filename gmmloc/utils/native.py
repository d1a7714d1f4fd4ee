"""ctypes bindings for the native runtime library (graceful fallback).

The native library covers the reference's host-native roles (SURVEY.md §2
"native where the reference's is"): the .gmm protobuf stream parser and
host-side Hamming kernels. The shared objects are not committed: each is
built from source on first use (`make -C native <target>`, under a file
lock so concurrent processes do not race). If a build fails, the
pure-Python paths in utils/proto.py are used instead; the two libraries
build independently (the image IO one needs libpng).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgmmloc_native.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(path: str) -> bool:
    """Build one native/ target if it is missing; True if it exists."""
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return True
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR, os.path.basename(path)],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return False
    return os.path.exists(path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _build(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.gmm_parse.restype = ctypes.c_int64
        lib.gmm_serialize.restype = ctypes.c_int64
        _lib = lib
    except OSError:
        return None
    return _lib


def available() -> bool:
    return _load() is not None


def load_gmm_file(path: str, max_k: int = 1 << 20):
    """Native .gmm parse -> (means (K,3), covs (K,3,3), deg, sal) or None."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    means = np.zeros((max_k, 3), np.float64)
    covs = np.zeros((max_k, 9), np.float64)
    deg = np.zeros(max_k, np.uint8)
    sal = np.zeros(max_k, np.uint8)
    k = lib.gmm_parse(
        buf, len(buf),
        means.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        covs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        deg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sal.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_k,
    )
    if k < 0:
        return None
    return (
        means[:k].copy(),
        covs[:k].reshape(-1, 3, 3).copy(),
        deg[:k].astype(bool),
        sal[:k].astype(bool),
    )


def save_gmm_file(path: str, means, covs, deg=None, sal=None) -> bool:
    lib = _load()
    if lib is None:
        return False
    means = np.ascontiguousarray(means, np.float64)
    covs = np.ascontiguousarray(covs, np.float64).reshape(len(means), 9)
    k = len(means)
    deg = np.zeros(k, np.uint8) if deg is None else np.ascontiguousarray(deg, np.uint8)
    sal = np.zeros(k, np.uint8) if sal is None else np.ascontiguousarray(sal, np.uint8)
    cap = 16 + k * 128
    out = np.zeros(cap, np.uint8)
    n = lib.gmm_serialize(
        means.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        covs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        deg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sal.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if n < 0:
        return False
    with open(path, "wb") as f:
        f.write(out[:n].tobytes())
    return True


# ---------------------------------------------------------------------
# Native image IO (libgmmloc_io.so): libpng grayscale decode + threaded
# prefetch ring (ref dataloader.cpp:53-116 / gmmloc.cpp:241-249 roles).

_IO_LIB_PATH = os.path.join(_NATIVE_DIR, "libgmmloc_io.so")
_io_lib: Optional[ctypes.CDLL] = None
_io_tried = False


def _load_io() -> Optional[ctypes.CDLL]:
    global _io_lib, _io_tried
    if _io_lib is not None or _io_tried:
        return _io_lib
    _io_tried = True
    if not _build(_IO_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_IO_LIB_PATH)
        lib.euroc_decode_png_gray.restype = ctypes.c_int
        lib.euroc_prefetcher_create.restype = ctypes.c_void_p
        lib.euroc_prefetcher_take.restype = ctypes.c_int
        _io_lib = lib
    except OSError:
        return None
    return _io_lib


def io_available() -> bool:
    return _load_io() is not None


def decode_png_gray(path: str, max_pixels: int = 4096 * 3072):
    """Decode a PNG to (H,W) uint8 via libpng, or None if unavailable."""
    lib = _load_io()
    if lib is None:
        return None
    buf = np.empty(max_pixels, np.uint8)
    w = ctypes.c_int32(0)
    h = ctypes.c_int32(0)
    rc = lib.euroc_decode_png_gray(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_pixels, ctypes.byref(w), ctypes.byref(h),
    )
    if rc != 0:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


class NativePrefetcher:
    """In-order stereo-pair prefetcher backed by the C++ decode ring."""

    def __init__(self, files_left, files_right, capacity: int = 8,
                 n_threads: int = 2, max_pixels: int = 4096 * 3072):
        lib = _load_io()
        if lib is None:
            raise RuntimeError("native io library unavailable")
        self._lib = lib
        self._max_pixels = max_pixels
        self._n = len(files_left)
        self._handle = lib.euroc_prefetcher_create(
            "\n".join(files_left).encode(), "\n".join(files_right).encode(),
            ctypes.c_int64(max_pixels), capacity, n_threads,
        )
        if not self._handle:
            raise RuntimeError("native prefetcher creation failed")

    def take(self):
        """Next (left, right) uint8 pair in order; None when exhausted."""
        out_l = np.empty(self._max_pixels, np.uint8)
        out_r = np.empty(self._max_pixels, np.uint8)
        whwh = np.zeros(4, np.int32)
        rc = self._lib.euroc_prefetcher_take(
            ctypes.c_void_p(self._handle),
            out_l.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out_r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            whwh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if rc == -1:
            return None
        if rc != 0:
            raise IOError(f"native decode failed (rc={rc})")
        wl, hl, wr, hr = (int(x) for x in whwh)
        return (
            out_l[: wl * hl].reshape(hl, wl).copy(),
            out_r[: wr * hr].reshape(hr, wr).copy(),
        )

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.euroc_prefetcher_destroy(ctypes.c_void_p(self._handle))
            self._handle = None

    def __del__(self):
        self.close()


def hamming_matrix(a: np.ndarray, b: np.ndarray):
    """Host (N,32)x(M,32) -> (N,M) int32, or None if native unavailable."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    out = np.zeros((len(a), len(b)), np.int32)
    lib.hamming_matrix(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(a),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(b),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
