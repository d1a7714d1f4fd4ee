"""Synthetic stereo-sequence generation for end-to-end evaluation.

The EuRoC image assets are not redistributable with the reference repo
(only the GMM maps + synced GT trajectories are, SURVEY.md §2.2), so the
end-to-end harness renders synthetic observations along a trajectory
against landmarks sampled from a prior GMM map. Map and trajectory come
from one of two places, always chosen by the caller:
  - the EuRoC files (data/map/v1.gmm, gt_sync/*.txt), given by path;
  - a seeded room (`seeded_room`): a V1-sized map of planar components on
    the surfaces of a Vicon-room-sized box plus clutter, and a smooth
    20 Hz camera path inside it.

Two tiers:
  - feature-level (this module): emit per-frame Feature arrays directly
    (projected landmarks + noise + descriptor corruption + spurious
    detections), bypassing the image pipeline;
  - image-level (eval/image_synthetic.py): rasterized sprite images for
    the ORB front-end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import SystemConfig
from ..geometry import camera as cam_mod
from ..mapping.map_state import _quat_to_mat
from ..tracking.frame import Frame, make_frame

# EuRoC Vicon-room scale (x, y, z extent in m; floor at z=0, centred in x/y)
ROOM_SIZE = (8.0, 8.0, 3.0)
# the V1 prior map's component count (SURVEY.md §2.2)
ROOM_COMPONENTS = 3299


@dataclass
class SeededRoom:
    means: np.ndarray    # (K,3) prior-map component means
    covs: np.ndarray     # (K,3,3)
    ts: np.ndarray       # (N,) timestamps (s)
    q_wc: np.ndarray     # (N,4) camera-to-world rotation (w,x,y,z)
    t_wc: np.ndarray     # (N,3) camera position

    @property
    def trajectory(self):
        return self.ts, self.q_wc, self.t_wc


def _room_surfaces(size):
    """(centre, u, v, normal-into-room, extent_u, extent_v) per surface."""
    sx, sy, sz = size
    ex, ey, ez = np.eye(3)
    return [
        (np.array([0.0, 0.0, 0.0]), ex, ey, ez, sx, sy),        # floor
        (np.array([0.0, 0.0, sz]), ex, ey, -ez, sx, sy),        # ceiling
        (np.array([-sx / 2, 0.0, sz / 2]), ey, ez, ex, sy, sz),
        (np.array([sx / 2, 0.0, sz / 2]), ey, ez, -ex, sy, sz),
        (np.array([0.0, -sy / 2, sz / 2]), ex, ez, ey, sx, sz),
        (np.array([0.0, sy / 2, sz / 2]), ex, ez, -ey, sx, sz),
    ]


def room_gmm(seed: int = 0, n_components: int = ROOM_COMPONENTS,
             size=ROOM_SIZE, clutter_frac: float = 0.12):
    """Seeded prior map of a room: (means (K,3), covs (K,3,3)).

    Most components are planar ("degenerate": normal variance far below
    GMMMapConfig.degenerate_eig_thresh) and tile the floor, ceiling and
    walls; `clutter_frac` of them are full-rank blobs standing within a
    metre of a surface, like furniture and mats in the Vicon room."""
    rng = np.random.default_rng(seed)
    n_clutter = int(round(n_components * clutter_frac))
    n_planar = n_components - n_clutter
    surfaces = _room_surfaces(size)
    area = np.array([s[4] * s[5] for s in surfaces])
    share = area / area.sum() * n_planar
    per = np.floor(share).astype(int)
    per[np.argsort(share - per)[::-1][: n_planar - per.sum()]] += 1

    means, covs = [], []
    for (c, u, v, n, eu, ev), k in zip(surfaces, per):
        # stratified positions: one jittered cell per component
        nu = max(1, int(round(np.sqrt(k * eu / ev))))
        nv = -(-k // nu)
        cells = rng.permutation(nu * nv)[:k]
        fu = (cells % nu + rng.uniform(0.1, 0.9, k)) / nu - 0.5
        fv = (cells // nu + rng.uniform(0.1, 0.9, k)) / nv - 0.5
        means.append(c + fu[:, None] * eu * u + fv[:, None] * ev * v)
        th = rng.uniform(0, np.pi, k)
        a1 = np.cos(th)[:, None] * u + np.sin(th)[:, None] * v
        a2 = -np.sin(th)[:, None] * u + np.cos(th)[:, None] * v
        var = np.stack([
            rng.uniform(0.05, 0.12, k) ** 2,
            rng.uniform(0.05, 0.12, k) ** 2,
            rng.uniform(1e-6, 2e-5, k),
        ], -1)
        R = np.stack([a1, a2, np.broadcast_to(n, (k, 3))], -1)  # (k,3,3)
        covs.append(np.einsum("kij,kj,klj->kil", R, var, R))

    idx = rng.integers(0, len(surfaces), n_clutter)
    c = np.stack([surfaces[i][0] for i in idx])
    u = np.stack([surfaces[i][1] for i in idx])
    v = np.stack([surfaces[i][2] for i in idx])
    n = np.stack([surfaces[i][3] for i in idx])
    ext = np.stack([[surfaces[i][4], surfaces[i][5]] for i in idx])
    f = rng.uniform(-0.45, 0.45, (n_clutter, 2)) * ext
    means.append(c + f[:, :1] * u + f[:, 1:] * v
                 + rng.uniform(0.1, 0.9, (n_clutter, 1)) * n)
    R, _ = np.linalg.qr(rng.standard_normal((n_clutter, 3, 3)))
    var = rng.uniform(0.002, 0.03, (n_clutter, 3))
    covs.append(np.einsum("kij,kj,klj->kil", R, var, R))
    return np.concatenate(means), np.concatenate(covs)


def _look_rotation(yaw, pitch, roll):
    """Camera-to-world rotation (N,3,3) for a camera looking along
    (yaw, pitch) with z up; camera axes x right, y down, z forward."""
    f = np.stack([np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch),
                  np.sin(pitch)], -1)
    right = np.cross(f, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    down = np.cross(f, right)
    cr, sr = np.cos(roll)[:, None], np.sin(roll)[:, None]
    right, down = cr * right + sr * down, -sr * right + cr * down
    return np.stack([right, down, f], -1)


def _mat_to_quat(R):
    """(N,3,3) rotation matrices -> (N,4) unit quaternions (w,x,y,z)."""
    from scipy.spatial.transform import Rotation

    xyzw = Rotation.from_matrix(R).as_quat()
    q = xyzw[:, [3, 0, 1, 2]]
    return q * np.where(q[:, :1] < 0, -1.0, 1.0)


def room_trajectory(n_frames: int, seed: int = 0, fps: float = 20.0,
                    size=ROOM_SIZE):
    """Smooth stereo-rig path through the middle of the room: ts (N,),
    q_wc (N,4), t_wc (N,3). Speed ~0.5 m/s and a yaw rate of 15-45 deg/s
    (EuRoC V1_01 ranges), so the keyframe policy fires every few
    frames."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames) / fps
    ph = rng.uniform(0, 2 * np.pi, 8)
    rx, ry = 0.25 * size[0], 0.25 * size[1]
    pos = np.stack([
        rx * np.sin(2 * np.pi * 0.05 * t + ph[0])
        + 0.3 * np.sin(2 * np.pi * 0.13 * t + ph[1]),
        ry * np.sin(2 * np.pi * 0.04 * t + ph[2])
        + 0.3 * np.sin(2 * np.pi * 0.11 * t + ph[3]),
        0.45 * size[2] + 0.2 * np.sin(2 * np.pi * 0.07 * t + ph[4]),
    ], -1)
    yaw = ph[5] + 0.5 * t + 0.3 * np.sin(2 * np.pi * 0.12 * t + ph[6])
    pitch = -0.1 + 0.12 * np.sin(2 * np.pi * 0.09 * t + ph[7])
    roll = 0.04 * np.sin(2 * np.pi * 0.15 * t)
    return t, _mat_to_quat(_look_rotation(yaw, pitch, roll)), pos


def seeded_room(n_frames: int, seed: int = 0,
                n_components: int = ROOM_COMPONENTS) -> SeededRoom:
    """The seeded room: prior map + ground-truth trajectory."""
    means, covs = room_gmm(seed, n_components)
    ts, q_wc, t_wc = room_trajectory(n_frames, seed)
    return SeededRoom(means, covs, ts, q_wc, t_wc)


def load_gt_trajectory(path: str):
    """gt_sync format: t x y z qx qy qz qw, T_w_c per frame
    (ref: dataloader.cpp:118-138)."""
    data = np.loadtxt(path)
    ts = data[:, 0]
    t_wc = data[:, 1:4]
    q_wc = data[:, [7, 4, 5, 6]]  # -> (w,x,y,z)
    q_wc /= np.linalg.norm(q_wc, axis=-1, keepdims=True)
    return ts, q_wc, t_wc


@dataclass
class SyntheticWorld:
    landmarks: np.ndarray      # (N,3)
    desc: np.ndarray           # (N,32) uint8
    base_angle: np.ndarray     # (N,) degrees
    ref_dist: np.ndarray       # (N,) scale-reference distance A_l
    comp_id: np.ndarray        # (N,) source GMM component (or -1)
    response: np.ndarray       # (N,) persistent corner strength — per-frame
    # selection ranks by response so the detected set is stable across
    # frames (real detectors re-find the same strong corners), with churn
    # entering only through per-frame response jitter + dropout.


def sample_world_from_gmm(
    means: np.ndarray,
    covs: np.ndarray,
    n_landmarks: int = 12000,
    seed: int = 0,
    flatten_degenerate: bool = True,
) -> SyntheticWorld:
    """Sample landmarks from GMM components (planar comps -> on-plane)."""
    rng = np.random.default_rng(seed)
    K = len(means)
    per = np.full(K, n_landmarks // K)
    per[: n_landmarks - per.sum()] += 1
    pts, comp_ids = [], []
    evals, evecs = np.linalg.eigh(covs)
    for k in range(K):
        n = per[k]
        if n == 0:
            continue
        w = evals[k].copy()
        if flatten_degenerate and w[0] < 1e-4:
            w[0] = 0.0  # exact on-plane samples for degenerate comps
        z = rng.standard_normal((n, 3)) * np.sqrt(np.clip(w, 0, None))
        pts.append(means[k] + z @ evecs[k].T)
        comp_ids.append(np.full(n, k))
    pts = np.concatenate(pts)
    comp_ids = np.concatenate(comp_ids)
    N = len(pts)
    return SyntheticWorld(
        landmarks=pts,
        desc=rng.integers(0, 256, size=(N, 32), dtype=np.uint8),
        base_angle=rng.uniform(0, 360, N).astype(np.float32),
        ref_dist=rng.uniform(1.5, 12.0, N),
        comp_id=comp_ids.astype(np.int32),
        response=rng.uniform(0.0, 1.0, N).astype(np.float32),
    )


class SyntheticFrontend:
    """Feature-level frontend: GT pose -> Frame with noisy observations."""

    def __init__(
        self,
        world: SyntheticWorld,
        cfg: SystemConfig,
        pixel_noise: float = 0.3,
        disp_noise: float = 0.25,
        desc_flip_bits: int = 8,
        stereo_frac: float = 0.9,
        spurious_frac: float = 0.08,
        drop_frac: float = 0.05,
        seed: int = 1,
    ):
        self.world = world
        self.cfg = cfg
        self.cam = cam_mod.CameraParams.from_config(cfg.camera)
        self.pixel_noise = pixel_noise
        self.disp_noise = disp_noise
        self.desc_flip_bits = desc_flip_bits
        self.stereo_frac = stereo_frac
        self.spurious_frac = spurious_frac
        self.drop_frac = drop_frac
        self.rng = np.random.default_rng(seed)
        self.log_sf = np.log(cfg.frame.scale_factor)
        self.num_levels = cfg.frame.num_levels
        self.last_landmark_ids: Optional[np.ndarray] = None
        # Temporally-correlated observation noise: a static camera sees the
        # SAME image, so detections repeat almost exactly (iid per-frame
        # noise would inject drift energy a real sensor never produces).
        # Per-landmark AR(1) noise states, refreshed in proportion to the
        # actual camera motion between frames.
        N = len(world.landmarks)
        self._noise_uv = self.rng.standard_normal((N, 2))
        self._noise_disp = self.rng.standard_normal(N)
        self._noise_det = self.rng.standard_normal(N)
        self._prev_q: Optional[np.ndarray] = None
        self._prev_t: Optional[np.ndarray] = None

    def _advance_noise(self, q_wc, t_wc):
        if self._prev_t is not None:
            dt = np.linalg.norm(t_wc - self._prev_t)
            dq = abs(float(np.dot(q_wc, self._prev_q)))
            dang = 2.0 * np.arccos(min(1.0, dq))
            rho = float(np.exp(-(dt / 0.01 + dang / 0.005)))
        else:
            rho = 0.0
        self._prev_q, self._prev_t = q_wc.copy(), t_wc.copy()
        N = len(self.world.landmarks)
        fresh_uv = self.rng.standard_normal((N, 2))
        fresh_d = self.rng.standard_normal(N)
        c = np.sqrt(max(0.0, 1.0 - rho * rho))
        self._noise_uv = rho * self._noise_uv + c * fresh_uv
        self._noise_disp = rho * self._noise_disp + c * fresh_d
        self._noise_det = rho * self._noise_det + c * self.rng.standard_normal(N)

    def make_frame(self, idx: int, timestamp: float, q_wc, t_wc) -> Frame:
        cam = self.cam
        w = self.world
        self._advance_noise(np.asarray(q_wc), np.asarray(t_wc))
        R_wc = _quat_to_mat(q_wc)
        R_cw = R_wc.T
        t_cw = -R_cw @ t_wc

        pc = w.landmarks @ R_cw.T + t_cw
        z = pc[:, 2]
        vis = z > 0.3
        u = np.where(vis, cam.fx * pc[:, 0] / np.where(vis, z, 1.0) + cam.cx, -1)
        v = np.where(vis, cam.fy * pc[:, 1] / np.where(vis, z, 1.0) + cam.cy, -1)
        margin = 8.0
        vis &= (u >= margin) & (v >= margin) & (u < cam.width - margin) & (v < cam.height - margin)
        vis &= z < 45.0
        ids = np.where(vis)[0]

        # detection dropout + budget: rank by persistent response with small
        # per-frame jitter, so the detected set is stable across frames
        from scipy.stats import norm as _norm
        keep = _norm.cdf(self._noise_det[ids]) > self.drop_frac
        ids = ids[keep]
        n_budget = self.cfg.frame.num_features
        n_spur = int(n_budget * self.spurious_frac)
        if len(ids) > n_budget - n_spur:
            score = w.response[ids] + 0.02 * self._noise_det[ids]
            ids = ids[np.argsort(-score)[: n_budget - n_spur]]
        n = len(ids)

        dist = np.linalg.norm(w.landmarks[ids] - t_wc, axis=-1)
        octave = np.clip(
            np.round(np.log(w.ref_dist[ids] / np.clip(dist, 0.1, None)) / self.log_sf),
            0,
            self.num_levels - 1,
        ).astype(np.int32)

        sf = self.cfg.frame.scale_factors()[octave]
        uu = u[ids] + self._noise_uv[ids, 0] * self.pixel_noise * sf
        vv = v[ids] + self._noise_uv[ids, 1] * self.pixel_noise * sf

        # stereo: disparity with noise; a fraction fails stereo matching
        disp = cam.bf / z[ids] + self._noise_disp[ids] * self.disp_noise * sf
        has_st = (self.rng.random(n) < self.stereo_frac) & (disp > 0.3)
        ur = np.where(has_st, uu - disp, -1.0).astype(np.float32)
        depth = np.where(has_st, cam.bf / np.clip(disp, 0.3, None), -1.0).astype(np.float32)

        # descriptors: landmark signature + per-observation bit flips
        desc = w.desc[ids].copy()
        flips = self.rng.integers(0, 256, size=(n, self.desc_flip_bits))
        for b in range(self.desc_flip_bits):
            byte, bit = flips[:, b] >> 3, flips[:, b] & 7
            desc[np.arange(n), byte] ^= (1 << bit).astype(np.uint8)

        # orientation: base angle minus camera yaw (deterministic, smooth)
        yaw = np.degrees(np.arctan2(R_cw[0, 1], R_cw[0, 0]))
        angle = (w.base_angle[ids] - yaw) % 360.0

        # spurious detections
        su = self.rng.uniform(margin, cam.width - margin, n_spur)
        sv = self.rng.uniform(margin, cam.height - margin, n_spur)
        sdesc = self.rng.integers(0, 256, (n_spur, 32), dtype=np.uint8)

        uv = np.concatenate([np.stack([uu, vv], -1), np.stack([su, sv], -1)])
        ur_all = np.concatenate([ur, np.full(n_spur, -1.0, np.float32)])
        depth_all = np.concatenate([depth, np.full(n_spur, -1.0, np.float32)])
        oct_all = np.concatenate([octave, self.rng.integers(0, 3, n_spur)])
        ang_all = np.concatenate([angle, self.rng.uniform(0, 360, n_spur)])
        desc_all = np.concatenate([desc, sdesc])

        frame = make_frame(
            idx, timestamp, uv, ur_all, depth_all, oct_all, ang_all, desc_all,
            self.cfg.frame.feat_cap,
        )
        lm = np.full(frame.feat_cap, -1, np.int64)
        lm[:n] = ids
        self.last_landmark_ids = lm
        return frame


def make_sequence(
    cfg: SystemConfig,
    gt_path: Optional[str] = None,
    gmm_path: Optional[str] = None,
    n_frames: Optional[int] = None,
    stride: int = 1,
    n_landmarks: int = 12000,
    seed: int = 0,
    *,
    gmm=None,
    trajectory=None,
    **frontend_kw,
):
    """Build (frontend, timestamps, q_wc, t_wc) for a synthetic run.

    The map is `gmm=(means, covs)` or the .gmm file at `gmm_path`; the
    trajectory is `trajectory=(ts, q_wc, t_wc)` or the gt_sync file at
    `gt_path`. One of each is required; a missing file raises."""
    from ..utils import proto

    if gmm is not None:
        means, covs = gmm
    elif gmm_path is not None:
        means, covs, _, _ = proto.load_gmm_file(gmm_path)
    else:
        raise ValueError("make_sequence needs a map: gmm_path or gmm=")
    if trajectory is not None:
        ts, q_wc, t_wc = (np.asarray(a) for a in trajectory)
    elif gt_path is not None:
        ts, q_wc, t_wc = load_gt_trajectory(gt_path)
    else:
        raise ValueError("make_sequence needs a trajectory: gt_path or "
                         "trajectory=")
    world = sample_world_from_gmm(means, covs, n_landmarks=n_landmarks, seed=seed)
    sl = slice(0, None if n_frames is None else n_frames * stride, stride)
    fe = SyntheticFrontend(world, cfg, seed=seed + 1, **frontend_kw)
    return fe, ts[sl], q_wc[sl], t_wc[sl]


def euroc_files(data_dir: str, seq: str):
    """(gmm_path, gt_path) of EuRoC sequence `seq` under data_dir:
    map/v1.gmm or map/v2.gmm by room, and gt_sync/<seq>.txt."""
    import os

    room = "v2" if seq.startswith("V2") else "v1"
    return (os.path.join(data_dir, "map", f"{room}.gmm"),
            os.path.join(data_dir, "gt_sync", f"{seq}.txt"))


MAP_HELP = ("'room' for the seeded V1-size room, or the EuRoC data "
            "directory holding map/v1.gmm, map/v2.gmm and gt_sync/<seq>.txt")


def load_map_and_trajectory(map_arg: str, seq: str, n_frames: int,
                            seed: int = 0):
    """(means, covs, (ts, q_wc, t_wc)) for a tool's --map argument: the
    seeded room with an n_frames-long path, or the EuRoC files of `seq`.
    A missing file raises; nothing is substituted."""
    if map_arg == "room":
        room = seeded_room(n_frames, seed)
        return room.means, room.covs, room.trajectory
    from ..utils import proto

    gmm_path, gt_path = euroc_files(map_arg, seq)
    means, covs, _, _ = proto.load_gmm_file(gmm_path)
    return means, covs, load_gt_trajectory(gt_path)


def room_run(cfg: SystemConfig, n_frames: int, seed: int = 0,
             n_components: int = ROOM_COMPONENTS, n_landmarks: int = 30000,
             **frontend_kw):
    """The seeded room ready to run: (gmap, frontend, ts, q_wc, t_wc)."""
    from ..gmm import mixture

    room = seeded_room(n_frames, seed, n_components)
    fe, ts, q_wc, t_wc = make_sequence(
        cfg, gmm=(room.means, room.covs), trajectory=room.trajectory,
        n_landmarks=n_landmarks, seed=seed, **frontend_kw,
    )
    return mixture.for_config(room.means, room.covs, cfg), fe, ts, q_wc, t_wc
