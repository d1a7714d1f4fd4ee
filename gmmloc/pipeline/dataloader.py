"""Dataset loaders: EuRoC ASL stereo sequences + synced GT trajectories.

JAX replacement for Dataloader/DataloaderEuRoC
(ref: /root/reference/gmmloc/src/utils/dataloader.cpp,
include/gmmloc/utils/dataloader.h:15-105). The reference reads
mav0/cam0/data.csv + cam0/cam1 image dirs (cam1 rides in the "depth"
slot — it is the right stereo image) and a TUM-style synced GT file.

Image decode runs on a host prefetch thread pool (the reference's
ephemeral-thread role); frames surface as float32 arrays ready for the
device front-end.
"""

from __future__ import annotations

import csv
import os
import threading
import queue
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class DataFrame:
    """Ref: dataloader.h DataFrame — mono = left, depth slot = right."""

    idx: int
    timestamp: float
    left: Optional[np.ndarray] = None
    right: Optional[np.ndarray] = None
    q_wc: Optional[np.ndarray] = None  # GT rotation (w,x,y,z)
    t_wc: Optional[np.ndarray] = None


def _imread_gray(path: str) -> np.ndarray:
    from ..utils import native

    img = native.decode_png_gray(path)
    if img is not None:
        return img.astype(np.float32)
    from PIL import Image

    pim = Image.open(path)
    if pim.mode != "L":
        pim = pim.convert("L")
    return np.asarray(pim, dtype=np.float32)


class EuRoCDataloader:
    """EuRoC ASL layout: <root>/mav0/cam{0,1}/data.csv + data/*.png.

    GT trajectory file: TUM format t x y z qx qy qz qw, one line per frame
    in sync with cam0 timestamps (ref: loadTrajectory dataloader.cpp:118).
    """

    def __init__(self, data_path: str, gt_path: Optional[str] = None,
                 prefetch: int = 4):
        self.root = data_path
        cam0 = os.path.join(data_path, "mav0", "cam0")
        cam1 = os.path.join(data_path, "mav0", "cam1")
        if not os.path.isdir(cam0):
            raise FileNotFoundError(f"EuRoC cam0 dir missing: {cam0}")
        self.timestamps = []
        self.files_left = []
        self.files_right = []
        with open(os.path.join(cam0, "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                ns, fname = row[0].strip(), row[1].strip()
                self.timestamps.append(int(ns) * 1e-9)
                self.files_left.append(os.path.join(cam0, "data", fname))
                self.files_right.append(os.path.join(cam1, "data", fname))
        self.gt_q = self.gt_t = None
        if gt_path:
            data = np.loadtxt(gt_path)
            self.gt_t = data[:, 1:4]
            q = data[:, [7, 4, 5, 6]]
            self.gt_q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        self._prefetch = prefetch

    def __len__(self) -> int:
        return len(self.timestamps)

    def get_frame(self, i: int) -> DataFrame:
        f = DataFrame(idx=i, timestamp=self.timestamps[i])
        f.left = _imread_gray(self.files_left[i])
        f.right = _imread_gray(self.files_right[i])
        if self.gt_q is not None and i < len(self.gt_q):
            f.q_wc, f.t_wc = self.gt_q[i], self.gt_t[i]
        return f

    def __iter__(self) -> Iterator[DataFrame]:
        """Prefetching iterator: decode runs ahead on worker threads.

        Prefers the native C++ decode ring (libpng + worker threads,
        native/euroc_loader.cpp); falls back to Python threads + PIL."""
        from ..utils import native

        if native.io_available():
            pf = native.NativePrefetcher(
                self.files_left, self.files_right,
                capacity=max(2, self._prefetch), n_threads=2,
            )
            try:
                for i in range(len(self)):
                    pair = pf.take()
                    if pair is None:
                        return
                    f = DataFrame(idx=i, timestamp=self.timestamps[i])
                    f.left = pair[0].astype(np.float32)
                    f.right = pair[1].astype(np.float32)
                    if self.gt_q is not None and i < len(self.gt_q):
                        f.q_wc, f.t_wc = self.gt_q[i], self.gt_t[i]
                    yield f
                return
            finally:
                pf.close()

        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()

        def worker():
            try:
                for i in range(len(self)):
                    if stop.is_set():
                        return
                    q.put(self.get_frame(i))
            finally:
                q.put(None)

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
