"""Benchmark: tracked frames/sec through the REAL pipeline.

Prints ONE JSON line:
  {"metric": "tracked_frames_per_sec_chip", "value": N, "unit": "fps",
   "vs_baseline": N / 20.0, "platform": ..., "device_kind": ...,
   "device_count": ...}

Headline: mean end-to-end tracked frames/sec through GMMLocSystem.step on
the synthetic feature path (1280 features/frame, 752x480 geometry) over
the seeded V1-size room (eval/synthetic.py seeded_room: 3,299 components,
30,000 landmarks), in the production operating configuration: online
threaded mapping + device-chained pipeline_depth=4 — the reference's own
two-thread operating point (gmmloc.cpp:56-59, ros::Rate(20)). p50/p95
frame times are reported alongside, plus the offline single-thread
protocol configuration and the image path (ORB front-end) on stderr.

The baseline divisor is the reference's 20 Hz camera-rate operating
point (cfg/v1.yaml fps: 20).

The end-to-end legs run one after another in child processes (one
process on the device at a time); the parent touches JAX only after they
have finished. A leg that fails or stops short fails the bench, and so
does a machine without a GPU.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np


def timeit(fn, *args, warmup=2, iters=20):
    """Median wall time (s) of fn(*args) to completion (block_until_ready)
    after `warmup` calls that compile."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


_E2E_CHILD = """
import sys, time, dataclasses
sys.path.insert(0, sys.argv[1])
from gmmloc.utils import jaxenv
jaxenv.setup_compile_cache()
import jax
if jax.devices()[0].platform != "gpu":
    sys.exit("bench.py measures the GPU; JAX found no GPU")
jax.config.update("jax_default_matmul_precision", "highest")
from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.pipeline import prewarm as prewarm_mod
from gmmloc.pipeline.system import GMMLocSystem

N_FRAMES = int(sys.argv[2])
MODE = sys.argv[3]
cfg = euroc_v1_config()
# both modes use the device-chained deep pipeline; offline keeps mapping
# synchronous inline (DSO protocol, gmmloc.cpp:172-174), online moves it
# to the mapping thread
cfg = cfg.replace(
    online=MODE == "online",
    tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9,
                                 pipeline_depth=4),
)
gmap, fe, ts, q_wc, t_wc = synthetic.room_run(
    cfg, N_FRAMES, seed=0, n_landmarks=30000,
    disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1)
sys_ = GMMLocSystem(cfg, gmap)
# pre-compile every shape tier a long run can hit (BA window tiers,
# fusion buckets) so no jit compile lands inside the measured window
prewarm_mod.prewarm(cfg, sys_.cam)
# harness OFF the clock: pre-generate every frame
frames = [fe.make_frame(i, ts[i], q_wc[i], t_wc[i]) for i in range(N_FRAMES)]
for i, f in enumerate(frames):
    sys_.step(f, q_wc[i], t_wc[i])
    if sys_.track_failed:
        break
    print("%d %.6f" % (i, time.perf_counter()), flush=True)
sys_.stop()
print("done" if not sys_.track_failed else "lost", flush=True)
"""


_IMG_CHILD = """
import sys, time, dataclasses
sys.path.insert(0, sys.argv[1])
from gmmloc.utils import jaxenv
jaxenv.setup_compile_cache()
import numpy as np
import jax
if jax.devices()[0].platform != "gpu":
    sys.exit("bench.py measures the GPU; JAX found no GPU")
jax.config.update("jax_default_matmul_precision", "highest")
from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.eval.image_synthetic import SpriteRenderer
from gmmloc.gmm import mixture
from gmmloc.pipeline.frontend import ImageFrontend
from gmmloc.pipeline.system import GMMLocSystem

N = int(sys.argv[2])
cfg = euroc_v1_config()
cfg = cfg.replace(
    camera=dataclasses.replace(cfg.camera, do_rectify=False,
                               do_equalization=False),
    tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9,
                                 pipeline_depth=4),
    online=True,
)
room = synthetic.seeded_room(N, seed=0)
world = synthetic.sample_world_from_gmm(room.means, room.covs,
                                        n_landmarks=9000)
renderer = SpriteRenderer(world, cfg)
frontend = ImageFrontend(cfg)
sys_ = GMMLocSystem(cfg, mixture.for_config(room.means, room.covs, cfg))
# sprite rendering is harness, not system: render OFF the clock
imgs = [tuple(np.clip(np.round(x), 0, 255).astype(np.uint8)
              for x in renderer.render_stereo(room.q_wc[i], room.t_wc[i]))
        for i in range(N)]
pend, i_prev = None, -1
for i in range(N + 1):
    nxt = frontend.dispatch(i, room.ts[i], *imgs[i]) if i < N else None
    if pend is not None:
        sys_.step(frontend.complete(pend), room.q_wc[i_prev],
                  room.t_wc[i_prev])
        if sys_.track_failed:
            break
        print("%d %.6f" % (i_prev, time.perf_counter()), flush=True)
    pend, i_prev = nxt, i
sys_.stop()
print("done" if not sys_.track_failed else "lost", flush=True)
"""


def _run_child(code: str, args, n_frames: int, warm: int, timeout_s: float,
               name: str) -> dict:
    """Run one end-to-end leg in a child process; fps over the frames
    after `warm`, and p50/p95 frame time. Raises if the leg fails."""
    proc = subprocess.run(
        [sys.executable, "-u", "-c", code, ROOT, *map(str, args)],
        capture_output=True, text=True, timeout=timeout_s,
    )
    lines = proc.stdout.split("\n")
    rows = [(int(p[0]), float(p[1])) for p in
            (ln.split() for ln in lines) if len(p) == 2]
    if proc.returncode != 0 or "done" not in lines or len(rows) != n_frames:
        raise RuntimeError(
            f"{name} leg failed: rc={proc.returncode}, {len(rows)}/{n_frames}"
            f" frames\n{proc.stderr[-4000:]}")
    (i0, t_a), (i1, t_b) = rows[warm], rows[-1]
    dts = np.diff([t for _, t in rows[warm:]])
    return {
        "fps": (i1 - i0) / max(t_b - t_a, 1e-9),
        "frame_ms_p50": round(float(np.percentile(dts, 50)) * 1e3, 3),
        "frame_ms_p95": round(float(np.percentile(dts, 95)) * 1e3, 3),
        "frames": len(rows),
    }


def main():
    # ---- end-to-end legs first, one child at a time ---------------------
    online = _run_child(_E2E_CHILD, (600, "online"), 600, 60, 1500.0, "online")
    offline = _run_child(_E2E_CHILD, (175, "offline"), 175, 25, 1200.0,
                         "offline")
    image = _run_child(_IMG_CHILD, (250,), 250, 40, 1200.0, "image")

    import jax
    import jax.numpy as jnp

    from gmmloc.utils import jaxenv

    jaxenv.setup_compile_cache()
    # the accurate operating point: f32 contractions at full precision
    # (the production default, SystemConfig.matmul_precision)
    jax.config.update("jax_default_matmul_precision", "highest")

    import __graft_entry__ as graft
    from gmmloc.config import euroc_v1_config
    from gmmloc.eval import synthetic
    from gmmloc.features import matching
    from gmmloc.geometry import camera as cam_mod
    from gmmloc.gmm import mixture, render
    from gmmloc.solver import local_ba, pose_solver

    cfg = euroc_v1_config()
    cam = cam_mod.CameraParams.from_config(cfg.camera)
    rng = np.random.default_rng(0)
    F = cfg.frame.feat_cap  # 1280
    dev = jax.devices()[0]
    detail = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}

    # ---- per-frame tracking work ---------------------------------------
    uv = rng.uniform([40, 40], [cam.width - 40, cam.height - 40], (F, 2))
    z = rng.uniform(1.0, 12.0, F)
    x_w = np.stack(
        [(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z], -1
    )
    obs = np.concatenate([uv, (uv[:, 0] - cam.bf / z)[:, None]], -1).astype(np.float32)
    desc = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    octv = rng.integers(0, 8, F).astype(np.int32)
    args_match = (
        jnp.array(uv, jnp.float32), jnp.array(obs[:, 2]), jnp.array(desc),
        jnp.array(octv), jnp.zeros(F, jnp.float32), jnp.ones(F, bool),
        jnp.full(F, 15.0, jnp.float32), jnp.array(octv - 1), jnp.array(octv + 1),
        jnp.array(uv, jnp.float32), jnp.array(obs[:, 2]), jnp.array(desc),
        jnp.array(octv), jnp.zeros(F, jnp.float32), jnp.ones(F, bool),
        jnp.zeros(F, bool),
    )
    detail["match_ms"] = timeit(matching.search_by_projection, *args_match) * 1e3

    q0 = jnp.array([1.0, 0.001, -0.002, 0.0005])
    q0 = q0 / jnp.linalg.norm(q0)
    args_pose = (
        q0, jnp.array([0.01, -0.02, 0.005]),
        jnp.array(x_w, jnp.float32), jnp.array(obs), jnp.ones(F, bool),
        jnp.ones(F, jnp.float32), jnp.ones(F, bool),
    )
    detail["pose_opt_xla_ms"] = timeit(
        lambda *a: pose_solver.optimize_pose(cam, *a), *args_pose) * 1e3

    # fused single-dispatch track step (the production per-frame path)
    fused_fn, fused_args = graft.entry()
    detail["fused_track_step_ms"] = timeit(jax.jit(fused_fn), *fused_args) * 1e3

    # ---- per-keyframe GMM association ----------------------------------
    room = synthetic.seeded_room(1, seed=0)
    gmap = mixture.from_arrays(room.means, room.covs, pad_to=3328)
    qr = jnp.array([1.0, 0, 0, 0], jnp.float32)
    tr = jnp.array([0.0, 0.0, 1.35], jnp.float32)
    detail["render_view_ms"] = timeit(
        lambda q, t: render.render_view(gmap, cam, q, t), qr, tr, iters=10) * 1e3
    r2d = render.render_view(gmap, cam, qr, tr)
    detail["search_corr_ms"] = timeit(
        lambda r, u: render.search_correspondence(r, u, jnp.ones(F, bool)),
        r2d, jnp.array(uv, jnp.float32), iters=10) * 1e3

    # ---- per-keyframe local BA (production window shape) ---------------
    import tools.ba_bench as ba_bench

    L, C, P, MO = 16, 48, 8192, cfg.caps.ba_obs_per_point
    prob = ba_bench.build(rng, cam, L, C, P, MO)
    t_ba = timeit(
        lambda p: local_ba.solve_local_ba(
            cam, p, n_free=L, schur_impl=cfg.loc.ba_schur_impl
        ),
        prob, warmup=1, iters=5,
    )
    detail["local_ba_ms"] = t_ba * 1e3
    detail["ba_solves_per_sec"] = 1.0 / t_ba
    detail["ba_schur_impl"] = cfg.loc.ba_schur_impl

    detail["e2e_config"] = "online threaded mapping + pipeline_depth=4"
    detail["e2e_online"] = online
    detail["e2e_offline"] = offline
    detail["image_path"] = image
    print(json.dumps(detail, default=float), file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "tracked_frames_per_sec_chip",
                "value": round(online["fps"], 2),
                "unit": "fps",
                "vs_baseline": round(online["fps"] / 20.0, 2),
                "platform": detail["platform"],
                "device_kind": detail["device_kind"],
                "device_count": detail["device_count"],
            }
        )
    )


if __name__ == "__main__":
    main()
