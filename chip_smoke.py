"""Smoke test of the localization main path on one GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

Phases (one process, no retries; any failure exits non-zero):
  1. device: the default JAX device must be a GPU (no CPU fallback);
  2. kernels against their plain references, compiled for the card at
     production widths, each timed beside XLA's version;
  3. the main path, GMMLocSystem.step after prewarm, on the seeded V1-size
     room: offline (inline mapping) and online (mapping thread), then the
     image path (ORB front-end over rendered 752x480 stereo).

The last stdout line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
The numbers printed before it are smoke numbers, not a benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gmmloc.utils import jaxenv  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

CARD = "not read"


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, read
    by a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def check_device(count: int = 1) -> dict:
    """The default JAX device must be a GPU, with at least `count` of
    them. Raises otherwise: there is no CPU fallback."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX found {devs[0].platform!r}")
    if len(devs) < count:
        raise RuntimeError(f"needs {count} GPUs, found {len(devs)}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def report(phase: str, **kw) -> None:
    """One labelled result line (card name and power limit beside every
    number)."""
    print(json.dumps({"phase": phase, "card": CARD, **kw}, default=float),
          flush=True)


def time_call(fn, *args, reps: int = 20) -> float:
    """Median wall time (ms) of fn(*args) to completion, after a warm-up
    call that compiles."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def _rot_deg(qa, qb) -> float:
    """Angle (deg) between two rotations given as quaternions; both are
    renormalised in float64 first (a float32 |q| off 1 by 1e-7 alone
    reads as ~0.04 deg)."""
    qa = np.asarray(qa, np.float64)
    qb = np.asarray(qb, np.float64)
    d = abs(float(np.dot(qa / np.linalg.norm(qa), qb / np.linalg.norm(qb))))
    return float(np.degrees(2 * np.arccos(min(d, 1.0))))


# ---------------------------------------------------------------------------
# phase 2: kernels against the plain references
# ---------------------------------------------------------------------------


def pose_problem(cam, F: int, seed: int = 0, anchored: bool = False):
    """The pose-solver comparison problem of tests/test_pallas_pose.py at
    F features: (args, anchor_args or None)."""
    from gmmloc.solver import pose_solver

    rng = np.random.default_rng(seed)
    uv = rng.uniform([40, 40], [cam.width - 40, cam.height - 40], (F, 2))
    z = rng.uniform(1.0, 12.0, F)
    x_w = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z,
                    (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
    obs = np.concatenate([uv, (uv[:, 0] - cam.bf / z)[:, None]], -1)
    obs += rng.normal(0, 0.4, obs.shape)
    n_out = int(0.12 * F)
    obs[:n_out] += rng.normal(0, 30.0, obs[:n_out].shape)
    is_stereo = rng.random(F) < 0.8
    s2i = (1.0 / 1.2 ** (2 * rng.integers(0, 8, F))).astype(np.float32)
    valid = rng.random(F) < 0.95
    q0 = np.array([1.0, 0.004, -0.006, 0.002])
    q0 = q0 / np.linalg.norm(q0)
    args = (jnp.array(q0, jnp.float32),
            jnp.array([0.02, -0.015, 0.01], jnp.float32),
            jnp.array(x_w, jnp.float32), jnp.array(obs, jnp.float32),
            jnp.array(is_stereo), jnp.array(s2i), jnp.array(valid))
    if not anchored:
        return args, None
    disp = obs[:, 0] - obs[:, 2]
    zs = np.where(np.abs(disp) < 1e-6, 1e9,
                  cam.bf / np.clip(disp, 1e-6, None))
    anc_xc = np.stack([(obs[:, 0] - cam.cx) / cam.fx * zs,
                       (obs[:, 1] - cam.cy) / cam.fy * zs, zs], -1)
    nrm = rng.normal(size=(F, 3))
    a_type = np.where(
        rng.random(F) < 0.3, pose_solver.ANCHOR_NONE,
        np.where(rng.random(F) < 0.5, pose_solver.ANCHOR_DEG,
                 pose_solver.ANCHOR_NONDEG)).astype(np.int32)
    a_type = np.where((zs > 0) & (zs < 1e3), a_type, pose_solver.ANCHOR_NONE)
    a_w = np.where(a_type == pose_solver.ANCHOR_DEG,
                   400.0 * np.maximum(zs, 1.0) ** 2, 1.0)
    aargs = (jnp.array(anc_xc, jnp.float32),
             jnp.array(x_w + rng.normal(0, 0.01, (F, 3)), jnp.float32),
             jnp.array(nrm / np.linalg.norm(nrm, axis=1, keepdims=True),
                       jnp.float32),
             jnp.array(np.tile(np.eye(3, dtype=np.float32) * 3.0, (F, 1, 1))),
             jnp.array(a_type), jnp.array(a_w, jnp.float32), jnp.float32(2.56))
    return args, aargs


def phase_kernels(F: int = 1280, P: int = 4096, n_hamming=(1280, 4096),
                  interpret: bool = False, reps: int = 20) -> dict:
    """Each kernel of the per-frame path against its plain reference on
    the default device, with f32 contractions at "highest" precision.

    Tolerances (tests/test_pallas_pose.py): pose kernel vs pose_solver:
    rotation < 0.01 deg / 0.02 deg (anchored), |dt| < 1e-3 / 2e-3 m,
    outlier flags differ on <= 2 / <= 3 features. XLA Hamming: exact vs a
    numpy bit count. Packed fused track step on the default device vs the
    CPU backend of this process: < 0.01 deg, < 1e-3 m, inliers +-2."""
    import __graft_entry__ as graft
    from gmmloc.config import euroc_v1_config
    from gmmloc.features import matching
    from gmmloc.geometry import camera as cam_mod
    from gmmloc.solver import pallas_pose, pose_solver

    jax.config.update("jax_default_matmul_precision", "highest")
    cam = cam_mod.CameraParams.from_config(euroc_v1_config().camera)
    res = {}

    # pose kernel vs the XLA solver
    for anchored, rot_tol, t_tol, flag_tol in ((False, 0.01, 1e-3, 2),
                                               (True, 0.02, 2e-3, 3)):
        args, aargs = pose_problem(cam, F, seed=3 if anchored else 0,
                                   anchored=anchored)
        if anchored:
            def ref_fn(*a):
                return pose_solver.optimize_pose_anchored(cam, *a)

            def ker_fn(*a):
                return pallas_pose.optimize_pose_anchored(
                    cam, *a, interpret=interpret)
            a_all = args + aargs
        else:
            def ref_fn(*a):
                return pose_solver.optimize_pose(cam, *a)

            def ker_fn(*a):
                return pallas_pose.optimize_pose(cam, *a, interpret=interpret)
            a_all = args
        ref, out = ref_fn(*a_all), ker_fn(*a_all)
        name = "pose_anchored" if anchored else "pose"
        r = {
            "rot_deg": _rot_deg(ref.q, out.q),
            "dt_m": float(jnp.linalg.norm(ref.t - out.t)),
            "flags_differ": int(jnp.sum(ref.is_outlier != out.is_outlier)),
            "inliers": [int(ref.num_inliers), int(out.num_inliers)],
        }
        assert r["rot_deg"] < rot_tol and r["dt_m"] < t_tol, (name, r)
        assert r["flags_differ"] <= flag_tol, (name, r)
        if anchored:
            r["anchor_flags_differ"] = int(
                jnp.sum(ref.anc_outlier != out.anc_outlier))
            assert r["anchor_flags_differ"] <= flag_tol, (name, r)
        r["kernel_ms"] = time_call(ker_fn, *a_all, reps=reps)
        r["xla_ms"] = time_call(ref_fn, *a_all, reps=reps)
        res[name] = r

    # XLA Hamming matrix vs numpy popcount
    rng = np.random.default_rng(1)
    n, m = n_hamming
    a = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    ref = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)
    ham = jax.jit(matching.hamming_matrix)
    da, db = jnp.array(a), jnp.array(b)
    assert np.array_equal(np.asarray(ham(da, db)), ref), "hamming mismatch"
    res["hamming_xla"] = {"shape": [n, m],
                          "xla_ms": time_call(ham, da, db, reps=reps)}

    # packed fused track step: default device vs the CPU backend (whose
    # pose solve is the XLA reference)
    fn, fargs = graft.entry(F=F, P=P)
    fn_x, _ = graft.entry(F=F, P=P, pose_impl="xla")
    step = jax.jit(fn)
    out_dev = np.asarray(step(*fargs))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        out_cpu = np.asarray(jax.jit(fn_x)(*jax.device_put(fargs, cpu)))
    r = {
        "rot_deg": _rot_deg(out_dev[:4], out_cpu[:4]),
        "dt_m": float(np.linalg.norm(out_dev[4:7] - out_cpu[4:7])),
        "inliers": [int(out_dev[7]), int(out_cpu[7])],
    }
    assert r["inliers"][0] > 0, r
    assert r["rot_deg"] < 0.01 and r["dt_m"] < 1e-3, ("fused_track", r)
    assert abs(r["inliers"][0] - r["inliers"][1]) <= 2, ("fused_track", r)
    if not interpret:
        r["step_ms"] = time_call(step, *fargs, reps=reps)
        r["step_xla_pose_ms"] = time_call(jax.jit(fn_x), *fargs, reps=reps)
    res["fused_track_step"] = r
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path on the seeded room
# ---------------------------------------------------------------------------


def _config(online: bool, image: bool = False, camera=None):
    """The bench's production configuration: velocity damping 0.9 and
    the depth-4 chained pipeline, mapping inline (offline) or threaded
    (online)."""
    from gmmloc.config import euroc_v1_config

    cfg = euroc_v1_config()
    cam = camera or cfg.camera
    if image:
        cam = dataclasses.replace(cam, do_rectify=False, do_equalization=False)
    return cfg.replace(
        camera=cam,
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9,
                                     pipeline_depth=4),
        online=online,
    )


def _peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _counts() -> dict:
    """Mapping work done, from the timing registry (utils/timing.py)."""
    from gmmloc.utils.timing import REGISTRY

    return {k: REGISTRY.accs[t].count if t in REGISTRY.accs else 0
            for k, t in (("ba", "loc/ba"), ("triangulate", "loc/triangulate"),
                         ("fuse", "loc/fuse"))}


def phase_main_path(online: bool, n_frames: int = 300, seed: int = 0,
                    n_components: int = None, n_landmarks: int = 30000,
                    min_kfs: int = 20, max_rmse: float = 0.02,
                    prewarm: bool = True) -> dict:
    """GMMLocSystem.step over the seeded room (feature-level front-end).
    Asserts no loss, >= min_kfs keyframes, >= 1 local BA, triangulation
    and fusion, and translation ATE RMSE <= max_rmse against the seeded
    ground truth."""
    from gmmloc.eval import ate, synthetic
    from gmmloc.pipeline import prewarm as prewarm_mod
    from gmmloc.pipeline.system import GMMLocSystem
    from gmmloc.utils import timing

    timing.reset()
    cfg = _config(online)
    t0 = time.perf_counter()
    gmap, fe, ts, q_wc, t_wc = synthetic.room_run(
        cfg, n_frames, seed=seed,
        n_components=n_components or synthetic.ROOM_COMPONENTS,
        n_landmarks=n_landmarks, disp_noise=0.1, pixel_noise=0.25,
        drop_frac=0.1,
    )
    system = GMMLocSystem(cfg, gmap)
    if prewarm:
        prewarm_mod.prewarm(cfg, system.cam)
    # the synthetic front-end is harness: frames are made off the clock
    frames = [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in range(n_frames)]
    setup_s = time.perf_counter() - t0
    dts = []
    t_run = time.perf_counter()
    for i, f in enumerate(frames):
        t1 = time.perf_counter()
        system.step(f, q_wc[i], t_wc[i])
        dts.append(time.perf_counter() - t1)
        assert not system.track_failed, f"tracking lost at frame {i}"
    system.stop()
    run_s = time.perf_counter() - t_run
    assert not system.track_failed, "tracking lost while draining"
    ts_e, _, p_e = system.export_trajectory()
    err = ate.ate_rmse(ts_e, p_e, ts, t_wc, with_scale=False)
    r = {
        "mode": "online" if online else "offline",
        "frames": len(ts_e), "keyframes": int(system.world.n_keyframes()),
        "points": int(system.world.n_points()),
        "ate_rmse_m": err["rmse"], **_counts(),
        "p50_frame_ms": float(np.median(dts) * 1e3),
        "mean_fps": n_frames / run_s, "setup_s": setup_s,
        "peak_bytes_in_use": _peak_bytes(),
    }
    assert r["frames"] == n_frames, r
    assert r["keyframes"] >= min_kfs, r
    assert min(r["ba"], r["triangulate"], r["fuse"]) >= 1, r
    assert r["ate_rmse_m"] <= max_rmse, r
    return r


def phase_image_path(n_frames: int = 60, seed: int = 0,
                     n_components: int = None, n_landmarks: int = 9000,
                     camera=None) -> dict:
    """ImageFrontend over SpriteRenderer stereo (752x480 by default),
    double-buffered into GMMLocSystem.step (online, pipeline_depth=4).
    Asserts that tracking is never lost."""
    from gmmloc.eval import synthetic
    from gmmloc.eval.image_synthetic import SpriteRenderer
    from gmmloc.pipeline.frontend import ImageFrontend
    from gmmloc.pipeline.system import GMMLocSystem

    cfg = _config(True, image=True, camera=camera)
    t0 = time.perf_counter()
    room = synthetic.seeded_room(
        n_frames, seed, n_components or synthetic.ROOM_COMPONENTS)
    world = synthetic.sample_world_from_gmm(
        room.means, room.covs, n_landmarks=n_landmarks, seed=seed)
    renderer = SpriteRenderer(world, cfg)
    imgs = [tuple(np.clip(np.round(x), 0, 255).astype(np.uint8)
                  for x in renderer.render_stereo(room.q_wc[i], room.t_wc[i]))
            for i in range(n_frames)]
    frontend = ImageFrontend(cfg)
    from gmmloc.gmm import mixture

    system = GMMLocSystem(cfg, mixture.for_config(room.means, room.covs, cfg))
    setup_s = time.perf_counter() - t0
    dts = []
    pend, i_prev = None, -1
    for i in range(n_frames + 1):
        t1 = time.perf_counter()
        nxt = frontend.dispatch(i, room.ts[i], *imgs[i]) if i < n_frames else None
        if pend is not None:
            frame = frontend.complete(pend)
            system.step(frame, room.q_wc[i_prev], room.t_wc[i_prev])
            assert not system.track_failed, f"image path lost at {i_prev}"
            dts.append(time.perf_counter() - t1)
        pend, i_prev = nxt, i
    system.stop()
    assert not system.track_failed, "image path lost while draining"
    ts_e, _, _ = system.export_trajectory()
    r = {"frames": len(ts_e), "keyframes": int(system.world.n_keyframes()),
         "p50_frame_ms": float(np.median(dts) * 1e3), "setup_s": setup_s,
         "peak_bytes_in_use": _peak_bytes()}
    assert r["frames"] == n_frames, r
    return r


# ---------------------------------------------------------------------------
# --four-cards: the sharded path and its single-device comparison
# ---------------------------------------------------------------------------


def phase_four_cards(n: int = 4) -> dict:
    """Sharded association and local BA (parallel/sharding.py) on an
    n-device mesh against one device: association exactly equal, BA
    within __graft_entry__.BA_*_TOL."""
    import __graft_entry__ as graft

    return graft.dryrun_multichip(n)


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)
    jaxenv.setup_compile_cache()
    jax.config.update("jax_default_matmul_precision", "highest")
    dev = check_device(4 if args.four_cards else 1)
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    report("device", **dev, jax=jax.__version__,
           matmul_precision=jax.config.jax_default_matmul_precision)
    if args.four_cards:
        report("four_cards", **phase_four_cards(4))
    else:
        for name, r in phase_kernels().items():
            report(f"kernel/{name}", **r)
        report("main_path", **phase_main_path(online=False))
        report("main_path", **phase_main_path(online=True))
        report("image_path", **phase_image_path())
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
