"""Multi-host (multi-process) distribution: jax.distributed init + job
sharding for the eval sweep + the cross-host BA mesh.

The reference is single-process (SURVEY.md §2.3 — threads + mutex queues
only); multi-host is a capability EXTENSION (SURVEY §5.8 plan):
`jax.distributed.initialize` for the runtime, sequence-sharded eval
sweeps across hosts (embarrassingly parallel: each (seq, run) job
touches its own world state), and the GSPMD local-BA mesh spanning all
hosts' devices so the Schur-reduced camera system psums across them.

Environment contract (set by the launcher, one process per host):
  GMMLOC_COORDINATOR   host:port of process 0 (default 127.0.0.1:9911)
  GMMLOC_NUM_PROCESSES total process count (default 1 -> no-op)
  GMMLOC_PROCESS_ID    this process's id

With GMMLOC_NUM_PROCESSES <= 1 everything degrades to single-process
behavior — a real multi-host run is a config change, not new code
(VERDICT r1 next #7).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple


def env_spec() -> Tuple[str, int, int]:
    return (
        os.environ.get("GMMLOC_COORDINATOR", "127.0.0.1:9911"),
        int(os.environ.get("GMMLOC_NUM_PROCESSES", "1")),
        int(os.environ.get("GMMLOC_PROCESS_ID", "0")),
    )


def init_distributed(local_device_count: int | None = None) -> Tuple[int, int]:
    """Initialize the jax distributed runtime from the env contract.

    Returns (process_id, num_processes). No-op (0, 1) when unconfigured.
    Call BEFORE any jax backend use; JAX_PLATFORMS picks the backend.
    `local_device_count` forces that many CPU devices per process
    (testing on one box; None = hardware default).
    """
    coord, nproc, pid = env_spec()
    import jax

    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", local_device_count)
    if nproc <= 1:
        return 0, 1
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=nproc,
        process_id=pid,
    )
    return pid, nproc


def shard_jobs(jobs: Sequence, pid: int, nproc: int) -> List:
    """Round-robin job sharding for the sequence sweep (deterministic:
    every process derives the same global assignment)."""
    return list(jobs[pid::nproc])


def global_mesh(axis: str = "shard"):
    """Mesh over ALL processes' devices (jax.devices() is global after
    init_distributed): the cross-host BA/association mesh."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def barrier_and_gather_json(out_dir: str, name: str, payload: dict,
                            pid: int, nproc: int, timeout_s: float = 600.0):
    """Filesystem results exchange for the sweep driver: each process
    writes `<name>.host<pid>.json`; process 0 waits for all and returns
    the merged list (None on other processes)."""
    import json
    import time

    os.makedirs(out_dir, exist_ok=True)
    mine = os.path.join(out_dir, f"{name}.host{pid}.json")
    with open(mine + ".tmp", "w") as f:
        json.dump(payload, f, indent=2, default=float)
    os.replace(mine + ".tmp", mine)
    if pid != 0:
        return None
    t0 = time.time()
    want = [os.path.join(out_dir, f"{name}.host{i}.json") for i in range(nproc)]
    while time.time() - t0 < timeout_s:
        if all(os.path.exists(p) for p in want):
            break
        time.sleep(0.5)
    merged = []
    for p in want:
        try:
            with open(p) as f:
                merged.append(json.load(f))
        except OSError:
            merged.append(None)
    return merged
