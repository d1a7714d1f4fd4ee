"""Dense-map stress benchmark: 10x GMM component count.

BASELINE.json stress config: "Dense GMM map stress: 10x component count +
relocalization via DBoW2 place recognition". Builds a 10x-dense map by
jittered replication of a base map's components (the EuRoC v1.gmm, or
the seeded room) and times the per-KF association path (renderView +
searchCorrespondence) at that scale, single-device and sharded over the
available mesh.

Usage: python tools/stress.py --map room|DIR [--factor 10] [--reloc]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gmmloc.utils import jaxenv

jaxenv.setup_compile_cache()

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from gmmloc.config import CameraConfig, euroc_v1_config
from gmmloc.geometry import camera as cam_mod
from gmmloc.gmm import mixture, render
from gmmloc.eval import synthetic
from gmmloc.parallel import sharding


def densify(means, covs, factor: int, seed: int = 0):
    """Replicate components with small jitter around their own covariance."""
    rng = np.random.default_rng(seed)
    out_m = [means]
    out_c = [covs]
    evals, evecs = np.linalg.eigh(covs)
    for _ in range(factor - 1):
        z = rng.standard_normal(means.shape) * np.sqrt(np.clip(evals, 0, None))
        jitter = np.einsum("kij,kj->ki", evecs, z)
        out_m.append(means + jitter * 0.5)
        out_c.append(covs * rng.uniform(0.5, 1.5, (len(covs), 1, 1)))
    return np.concatenate(out_m), np.concatenate(out_c)


def timeit(fn, *args, warmup=2, iters=10):
    """Median wall time (s) of fn(*args) to completion, after warm-up."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def reloc_under_stress(map_arg: str, factor: int, seed: int = 0):
    """Relocalization on the 10x-dense map (BASELINE config #4's second
    half): map a stretch of V1_01, blackout-teleport back into mapped
    territory, require BoW place recognition to re-anchor — with the
    full system running against the densified prior map. Reports
    association cost per KF at stress scale + post-recovery error."""
    import dataclasses

    from gmmloc.pipeline.system import GMMLocSystem
    from gmmloc.utils import timing as timing_mod
    from gmmloc.vocab.bow import Vocabulary

    cfg = euroc_v1_config()
    cfg = cfg.replace(
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9)
    )
    base_means, base_covs, trajectory = synthetic.load_map_and_trajectory(
        map_arg, "V1_01_easy", 500, seed=seed)
    means, covs = densify(base_means, base_covs, factor, seed=seed)
    K = len(means)
    pad = ((K + 255) // 256) * 256
    cfg = cfg.replace(caps=dataclasses.replace(cfg.caps, gmm_components_pad=pad))
    t0 = time.time()
    gmap = mixture.from_arrays(
        means, covs, pad_to=pad, neighbor_cap=cfg.gmm.neighbor_cap,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
    )
    t_build = time.time() - t0
    print(f"[reloc-stress] map build K={K}: {t_build:.1f}s", flush=True)

    fe, ts, q_wc, t_wc = synthetic.make_sequence(
        cfg, gmm=(base_means, base_covs), trajectory=trajectory,
        n_frames=500, stride=1, n_landmarks=30000,
        disp_noise=0.1, pixel_noise=0.25, drop_frac=0.1, seed=seed,
    )
    voc = Vocabulary.train(fe.world.desc[::4], k=10, depth=3, seed=0)
    s = GMMLocSystem(cfg, gmap, vocabulary=voc)
    timing_mod.reset()

    START, MAPPED, BLACK, RETURN = 150, 90, 5, 10
    step = 0
    t_run0 = time.time()
    for i in range(MAPPED):
        fi = START + i
        f = fe.make_frame(step, ts[fi], q_wc[fi], t_wc[fi])
        s.step(f, q_wc[fi], t_wc[fi])
        step += 1
        assert not s.track_failed
    saved = fe.drop_frac
    fe.drop_frac = 1.0
    for _ in range(BLACK):
        fi = START + RETURN
        f = fe.make_frame(step, ts[fi], q_wc[fi], t_wc[fi])
        s.step(f, q_wc[fi], t_wc[fi])
        step += 1
    fe.drop_frac = saved
    went_lost = s.lost or s.n_lost > 0
    errs_after = []
    for j in range(40):
        fi = START + RETURN + j
        f = fe.make_frame(step, ts[fi], q_wc[fi], t_wc[fi])
        st = s.step(f, q_wc[fi], t_wc[fi])
        step += 1
        if s.track_failed:
            break
        if st is not None and st.res and not s.lost:
            R = np.array([
                [1 - 2 * (f.q_cw[2] ** 2 + f.q_cw[3] ** 2),
                 2 * (f.q_cw[1] * f.q_cw[2] - f.q_cw[0] * f.q_cw[3]),
                 2 * (f.q_cw[1] * f.q_cw[3] + f.q_cw[0] * f.q_cw[2])],
                [2 * (f.q_cw[1] * f.q_cw[2] + f.q_cw[0] * f.q_cw[3]),
                 1 - 2 * (f.q_cw[1] ** 2 + f.q_cw[3] ** 2),
                 2 * (f.q_cw[2] * f.q_cw[3] - f.q_cw[0] * f.q_cw[1])],
                [2 * (f.q_cw[1] * f.q_cw[3] - f.q_cw[0] * f.q_cw[2]),
                 2 * (f.q_cw[2] * f.q_cw[3] + f.q_cw[0] * f.q_cw[1]),
                 1 - 2 * (f.q_cw[1] ** 2 + f.q_cw[2] ** 2)],
            ])
            errs_after.append(np.linalg.norm(-R.T @ f.t_cw - t_wc[fi]))
    s.flush()
    s.stop()
    wall = time.time() - t_run0
    kf_assoc_ms = {}
    with timing_mod.REGISTRY.lock:
        for tag in ("loc/render_view", "map/search_corr", "kf/point_opt"):
            a = timing_mod.REGISTRY.accs.get(tag)
            if a is not None and a.count:
                kf_assoc_ms[tag] = round(a.mean() * 1e3, 2)
    med = float(np.median(errs_after)) if errs_after else float("nan")
    out = {
        "K": K, "map_build_s": round(t_build, 1),
        "frames": step, "wall_s": round(wall, 1),
        "kfs": int(s.world.n_keyframes()),
        "went_lost": bool(went_lost),
        "relocalized": bool(not s.lost and len(errs_after) > 0),
        "post_recovery_median_err_m": round(med, 4),
        "assoc_ms_per_kf": kf_assoc_ms,
    }
    print("[reloc-stress]", out, flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--map", required=True, help=synthetic.MAP_HELP)
    ap.add_argument("--factor", type=int, default=10)
    ap.add_argument("--reloc", action="store_true")
    args = ap.parse_args()
    factor = args.factor
    cam = cam_mod.CameraParams.from_config(CameraConfig())
    means, covs, _ = synthetic.load_map_and_trajectory(args.map, "V1_01_easy", 1)
    means, covs = densify(means, covs, factor)
    K = len(means)
    pad = ((K + 255) // 256) * 256
    print(f"stress map: K={K} (pad {pad})")

    t0 = time.time()
    gmap = mixture.from_arrays(
        means, covs, pad_to=pad, neighbor_cap=16, neighbor_dist_thresh=2.5,
        build_neighbors=False,  # not exercised by this bench; O(K^2) at 33k
    )
    print(f"build: {time.time()-t0:.1f}s")

    q = jnp.array([1.0, 0, 0, 0], jnp.float32)
    t = jnp.zeros(3, jnp.float32)
    rng = np.random.default_rng(0)
    feat_uv = jnp.array(
        rng.uniform([0, 0], [cam.width, cam.height], (1280, 2)), jnp.float32
    )
    fv = jnp.ones(1280, bool)

    t_render = timeit(lambda q_, t_: render.render_view(gmap, cam, q_, t_), q, t)
    r2d = render.render_view(gmap, cam, q, t)
    t_assoc = timeit(lambda r_, u_: render.search_correspondence(r_, u_, fv), r2d, feat_uv)
    print(f"single-device: render {t_render*1e3:.2f}ms assoc {t_assoc*1e3:.2f}ms")

    n_dev = len(jax.devices())
    if n_dev > 1:
        mesh = sharding.make_mesh(n_dev)
        gmap_sh = sharding.shard_gmm_map(gmap, mesh)
        t_r_sh = timeit(
            lambda: sharding.render_view_sharded(gmap_sh, cam, q, t, mesh),
        )
        r_sh = sharding.render_view_sharded(gmap_sh, cam, q, t, mesh)
        t_a_sh = timeit(
            lambda: sharding.search_correspondence_sharded(r_sh, feat_uv, fv, mesh),
        )
        print(
            f"{n_dev}-device sharded: render {t_r_sh*1e3:.2f}ms assoc {t_a_sh*1e3:.2f}ms "
            f"(speedup {t_render/t_r_sh:.2f}x / {t_assoc/t_a_sh:.2f}x)"
        )
    if args.reloc:
        reloc_under_stress(args.map, factor)


if __name__ == "__main__":
    main()
