"""Multi-process distribution tests (SURVEY §5.8): jax.distributed init,
cross-process collectives, cross-process sharded local BA, and the sweep
job sharding. Runs 2 LOCAL processes over the CPU backend — the same code
path a real multi-host deployment uses (only the env contract changes).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    sys.path.insert(0, %r)
    from gmmloc.parallel import distributed as dist

    pid, nproc = dist.init_distributed(local_device_count=2)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert nproc == 2, nproc
    assert len(jax.devices()) == 4, jax.devices()   # 2 procs x 2 local

    # cross-process psum via GSPMD: global array sharded over all devices
    mesh = dist.global_mesh()
    x_global = np.arange(8, dtype=np.float32)       # 2 per device
    sharding = NamedSharding(mesh, P("shard"))
    xs = jax.make_array_from_callback(
        (8,), sharding, lambda idx: x_global[idx]
    )
    with jax.set_mesh(mesh):
        total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(xs)
    total = float(np.asarray(total.addressable_data(0)))
    assert abs(total - 28.0) < 1e-6, total

    # cross-process sharded local BA == single-process result
    from gmmloc.config import CameraConfig
    from gmmloc.geometry import camera as cam_mod
    from gmmloc.solver import local_ba
    from gmmloc.parallel import sharding as sh

    cam = cam_mod.CameraParams.from_config(CameraConfig())
    rng = np.random.default_rng(0)
    L, C, Pn, MO = 4, 8, 64, 4
    cam_t = np.zeros((C, 3), np.float32); cam_t[:, 0] = np.arange(C) * 0.05
    cam_q = np.tile(np.array([1.0, 0, 0, 0], np.float32), (C, 1))
    pts = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-1, 1, Pn),
                    rng.uniform(3, 8, Pn)], -1).astype(np.float32)
    obs_cam = rng.integers(0, C, (Pn, MO)).astype(np.int32)
    pc = pts[:, None, :] + cam_t[obs_cam]
    uvr = np.stack([
        cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
        cam.fy * pc[..., 1] / pc[..., 2] + cam.cy,
        cam.fx * pc[..., 0] / pc[..., 2] + cam.cx - cam.bf / pc[..., 2],
    ], -1).astype(np.float32)
    uvr += rng.normal(0, 0.3, uvr.shape).astype(np.float32)
    prob = local_ba.BAProblem(
        cam_q=jnp.array(cam_q), cam_t=jnp.array(cam_t),
        cam_valid=jnp.ones(C, bool),
        pts=jnp.array(pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)),
        pt_valid=jnp.ones(Pn, bool),
        obs_cam=jnp.array(obs_cam), obs_uvr=jnp.array(uvr),
        obs_stereo=jnp.ones((Pn, MO), bool),
        obs_sigma2_inv=jnp.ones((Pn, MO), jnp.float32),
        obs_valid=jnp.ones((Pn, MO), bool),
        str_type=jnp.zeros(Pn, jnp.int32),
        str_normal=jnp.tile(jnp.array([0.0, 0, 1], jnp.float32), (Pn, 1)),
        str_mean=jnp.array(pts),
        str_sqrt_info=jnp.tile(jnp.eye(3, dtype=jnp.float32), (Pn, 1, 1)),
        prior_q=jnp.array(cam_q[0]), prior_t=jnp.array(cam_t[0]),
        has_prior=jnp.array(True),
    )
    res_single = local_ba.solve_local_ba(cam, prob, n_free=L)
    prob_sh = sh.shard_ba_problem(prob, mesh)
    res_sh = sh.solve_local_ba_sharded(cam, prob_sh, mesh, n_free=L)
    from jax.experimental import multihost_utils

    pts_s = np.asarray(res_single.pts)
    pts_d = np.asarray(multihost_utils.process_allgather(res_sh.pts, tiled=True))
    err_pts = float(np.max(np.abs(pts_s - pts_d)))
    cam_t_d = np.asarray(
        multihost_utils.process_allgather(res_sh.cam_t, tiled=True)
    )
    err_cam = float(np.max(np.abs(np.asarray(res_single.cam_t) - cam_t_d)))

    # job sharding: disjoint + covering
    jobs = [(s, r) for s in ["a", "b", "c"] for r in range(5)]
    mine = dist.shard_jobs(jobs, pid, nproc)
    merged = dist.barrier_and_gather_json(
        sys.argv[1], "t", {"pid": pid, "mine": mine,
                           "err_pts": err_pts, "err_cam": err_cam},
        pid, nproc)
    if pid == 0:
        allj = [tuple(j) for h in merged for j in h["mine"]]
        assert sorted(allj) == sorted(jobs), allj
        print(json.dumps({"ok": True, "err_pts": err_pts,
                          "err_cam": err_cam}))
    """
) % (ROOT,)


@pytest.mark.slow
def test_two_process_distributed(tmp_path):
    procs = []
    for i in range(2):
        env = dict(os.environ)
        env.update(
            GMMLOC_COORDINATOR="127.0.0.1:9977",
            GMMLOC_NUM_PROCESSES="2",
            GMMLOC_PROCESS_ID=str(i),
            JAX_PLATFORMS="cpu",
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(tmp_path)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err}"
        outs.append(out)
    payload = json.loads(outs[0].strip().splitlines()[-1])
    assert payload["ok"]
    # sharded-vs-single equality: identical program semantics; GSPMD
    # reduction order may differ at float32 ulp level
    assert payload["err_pts"] < 1e-4, payload
    assert payload["err_cam"] < 1e-4, payload
