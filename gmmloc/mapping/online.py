"""Online (concurrent) mapping: the tracking/mapping thread pair.

Reference concurrency contract (SURVEY.md §2.3): a mapping thread consumes
a keyframe queue (localization.cpp spin:23-63), new-KF insertion sets an
abort flag that preempts a running BA (insertKeyFrame:401-405, g2o
setForceStopFlag), and the tracker throttles KF creation on queue length
and mapper idleness (gmmloc.cpp:349-361).

Shape: a host worker thread drives the same Localization
pipeline; the heavy stages are device calls that release the GIL, so
tracking (main thread) overlaps mapping (worker) like the reference's
thread pair. BA preemption is bounded-staleness: the abort flag is
checked between BA stages rather than mid-solve (the staged 5/5/40
schedule gives natural preemption points, mirroring the reference's
chunked optimize() calls).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .localization import Localization


class OnlineLocalization:
    """Wraps a Localization with the reference's spin() thread lifecycle."""

    def __init__(self, localizer: Localization, poll_s: float = 0.003):
        self.loc = localizer
        self.poll_s = poll_s  # ref: 3ms sleep (localization.cpp:61)
        self._shutdown = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # queue API (proxied; ref: insertKeyFrame/countKFsInQueue)

    @property
    def is_idle(self) -> bool:
        return self.loc.is_idle

    def insert_keyframe(self, kf: int) -> None:
        with self._lock:
            self.loc.insert_keyframe(kf)  # sets abort_ba

    def count_queue(self) -> int:
        with self._lock:
            return self.loc.count_queue()

    def interrupt_ba(self) -> None:
        self.loc.abort_ba = True

    # lifecycle (ref: spin/stop, localization.cpp:23-63)

    def start(self) -> None:
        self._shutdown = False
        self._thread = threading.Thread(target=self._spin, daemon=True)
        self._thread.start()

    def _spin(self) -> None:
        self.loc.is_finished = False
        while True:
            with self._lock:
                has_kf = bool(self.loc.queue)
            if self._shutdown and not has_kf:
                break
            if has_kf:
                self.loc.spin_once()
            time.sleep(self.poll_s)
        self.loc.is_finished = True

    def stop(self) -> None:
        """Drain the queue then join (ref: GMMLoc::stop gmmloc.cpp:366)."""
        self._shutdown = True
        if self._thread is not None:
            self._thread.join(timeout=300.0)
            self._thread = None
