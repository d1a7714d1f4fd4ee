"""Device->host transfer discipline: one overlapped fetch per logical step.

The reference runs on one CPU address space, so "readback" is free
(ref: /root/reference/gmmloc/src/modules/tracking.cpp operates in-place).
Every device->host transfer pays a fixed round-trip latency, so the
per-frame and per-keyframe paths must batch ALL their readbacks into a
single overlapped transfer instead of N sequential `np.asarray` calls.

`fetch(tree)` starts `copy_to_host_async` on every jax-array leaf first,
then materializes them — total cost ~= one round trip, not N. It also
counts transfers so tests/benches can assert the per-frame readback
budget (see tests/test_perf_contract.py).
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np

_lock = threading.Lock()
_stats = {"fetches": 0, "leaves": 0, "uploads": 0}


def reset_stats() -> None:
    with _lock:
        _stats["fetches"] = 0
        _stats["leaves"] = 0
        _stats["uploads"] = 0


def record_uploads(n: int = 1) -> None:
    """Count host->device array uploads (called at jnp.array sites on the
    per-frame hot path so the transfer budget is assertable in tests)."""
    with _lock:
        _stats["uploads"] += n


def stats() -> dict:
    with _lock:
        return dict(_stats)


def _leaves(tree: Any):
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        out = []
        for x in tree:
            out.extend(_leaves(x))
        return out
    return [tree]


def fetch(tree: Any):
    """Fetch a (nested) tuple/list of jax arrays to numpy in ONE overlapped
    round trip. Returns the same structure with numpy leaves.

    Non-jax leaves (numpy arrays, scalars) pass through unchanged.
    """
    leaves = _leaves(tree)
    n = 0
    for leaf in leaves:
        start = getattr(leaf, "copy_to_host_async", None)
        if start is not None:
            try:
                start()
            except Exception:
                pass  # backend without async copies: device_get still works
            n += 1
    with _lock:
        _stats["fetches"] += 1
        _stats["leaves"] += n

    def mat(x):
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return type(x)(mat(v) for v in x)
        if hasattr(x, "copy_to_host_async") or type(x).__module__.startswith("jax"):
            return np.asarray(x)
        return x

    return mat(tree)


class AsyncFetch:
    """Deferred fetch: start the async copies now, materialize later.

    Used by the pipelined tracker: start copying frame N's packed result
    while the host does frame N-1's bookkeeping, then `get()` blocks only
    on whatever is still in flight.
    """

    def __init__(self, tree: Any):
        self.tree = tree
        for leaf in _leaves(tree):
            start = getattr(leaf, "copy_to_host_async", None)
            if start is not None:
                try:
                    start()
                except Exception:
                    pass

    def get(self):
        return fetch(self.tree)
