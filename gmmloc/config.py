"""Typed configuration tree for the gmmloc framework.

Captures all three config tiers of the reference system
(/root/reference/gmmloc/include/gmmloc/config.h, src/config.cpp,
include/gmmloc/init_config.hpp, gmmloc_ros/cfg/v1.yaml):
  1. ROS params -> global namespaces (common/camera/frame/gmmmap/loc)
  2. launch-file composition (paths, per-room yaml)
  3. hard-coded inline algorithm constants (chi2 gates, view-cos, etc.)

Everything is an explicit, named field here; nothing hides in kernel bodies.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class CameraConfig:
    """Rectified pinhole stereo camera (ref: cfg/v1.yaml camera section)."""

    fx: float = 435.2046959714599
    fy: float = 435.2046959714599
    cx: float = 367.4517211914062
    cy: float = 252.2008514404297
    width: int = 752
    height: int = 480
    bf: float = 47.90639384423901  # baseline * fx
    fps: float = 20.0
    do_rectify: bool = True
    do_equalization: bool = True

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


@dataclass(frozen=True)
class FrameConfig:
    """Per-frame feature / pyramid settings (ref: config.cpp frame ns)."""

    num_features: int = 1200
    num_levels: int = 8              # ref: config.cpp:53 (const)
    scale_factor: float = 1.2        # ref: config.cpp:55 (const)
    th_depth_raw: float = 35.0       # ref yaml frame/th_depth (pre-derivation)
    grid_cols: int = 64              # ref: config.h grid constants
    grid_rows: int = 48
    # Feature capacity (static shape): num_features padded up.
    feat_cap: int = 1280
    # keypoint spatial distribution: "quota" (per-cell winners, default)
    # or "octree" (coarse-to-fine multi-scale cell emulation of
    # DistributeOctTree, orb_extractor.cpp:529-737 — A/B option)
    detect_distribution: str = "quota"

    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.num_levels, dtype=np.float64)

    def sigma2(self) -> np.ndarray:
        s = self.scale_factors()
        return s * s

    def th_depth(self, cam: CameraConfig) -> float:
        # ref: init_config.hpp:61  th_depth = bf * th / fx
        return cam.bf * self.th_depth_raw / cam.fx


@dataclass(frozen=True)
class GMMMapConfig:
    """Prior GMM map settings (ref: gmmmap ns + inline constants)."""

    neighbor_dist_thresh: float = 2.5   # Bhattacharyya gate (yaml map/)
    neighbor_cap: int = 16              # static cap on neighbor list length
    degenerate_eig_thresh: float = 1e-4  # ref: gaussian.cpp:44
    salient_eig_thresh: float = 0.2      # ref: gaussian.cpp:52
    # renderView gates (ref: gaussian_mixture.cpp:271-371 inline consts)
    view_cos_deg: float = 78.0
    cov2d_scale_thresh: float = 4.0
    occlusion_bh_thresh: float = 0.8
    # searchCorrespondence (ref: gaussian_mixture.cpp:484-534)
    assoc_knn: int = 5
    assoc_mdist2_thresh: float = 9.0
    # 3D fallback query (ref: gaussian_mixture.cpp:545-576)
    query3d_knn: int = 5


@dataclass(frozen=True)
class LocConfig:
    """Back-end / structure-constraint settings (ref: loc ns + inline)."""

    tri_use_stereo: bool = True
    tri_check_deg: bool = True
    tri_lambda2: float = 400.0
    tri_check_str_chi2: bool = True
    tri_str_thresh: float = 0.0064
    ba_lambda2: float = 400.0
    ba_first_as_prior: bool = True
    # chi2 gates (inline constants, ref: tracking_opt.cpp / localization_opt.cpp)
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    chi2_fuse_mono: float = 5.99     # fuseObservations (localization.cpp:269)
    chi2_fuse_stereo: float = 7.8
    chi2_assoc_3d: float = 9.0       # checkMapAssociation accept gate
    # pose-only optimization schedule (tracking_opt.cpp:150-152)
    pose_opt_rounds: int = 4
    pose_opt_iters: int = 10
    # point opt (gmmloc_opt.cpp:330 / localization_opt.cpp:177)
    point_opt_iters: int = 5
    tri_opt_iters: int = 20
    # local BA staged schedule (localization_opt.cpp:769-831)
    ba_iters_stage1: int = 5
    ba_iters_stage2: int = 5
    ba_iters_stage3: int = 40
    # LM early-termination relative-gain threshold (0 disables; g2o also
    # stops when chi2 improvement vanishes). 1e-5 measured on noisy
    # production-tier problems: converges in ~7 LM iterations with final
    # cost identical to 1e-6's (which burns 11-18) — tools note in
    # solver/local_ba.py docstring.
    ba_term_gain: float = 1e-5
    # Schur camera-system assembly: "flatpm" (lane-major (k, P*MO)
    # layout, block-diagonal H_cc GEMMs; see _solve_flat_pm docstring),
    # "flat" (Z-tensor GEMMs), or "onehot". Their GPU ranking is not
    # measured yet (ROADMAP C4).
    ba_schur_impl: str = "flatpm"
    # reduced-system solve: "lu" (exact, sequential lowering) or "cg"
    # (Jacobi-PCG matvecs; LM accepts inexact steps)
    ba_linear_solver: str = "lu"
    ba_cg_iters: int = 48
    # first-KF prior sigmas (localization_opt.cpp:568-573)
    prior_sigma_rot_deg: float = 2.0
    prior_sigma_trans: float = 0.01
    # covisibility threshold (keyframe.cpp:282)
    covis_weight_thresh: int = 15
    # culling (localization.cpp:127-150, 334-397)
    cull_found_ratio: float = 0.25
    cull_min_obs: int = 3
    kf_cull_redundancy: float = 0.9
    # matcher thresholds (orb_matcher.cpp:20-22, 544-576)
    desc_th_low: int = 50
    desc_th_high: int = 100
    match_nn_ratio_motion: float = 0.9
    match_nn_ratio_local: float = 0.8
    match_nn_ratio_tri: float = 0.6
    rot_hist_bins: int = 30
    # Device-resident world mirror (mapping/device_world.py): keyframe
    # feature tables + landmark attributes live in HBM and the per-KF
    # fusion/triangulation kernels gather ON DEVICE; only dirty rows and
    # small masks cross the host link instead of re-uploading the
    # gathered tables every keyframe.
    use_device_world: bool = True
    # Fused per-KF association: render + candidate search + the full
    # checkMapAssociation chain (neighbor refinement, queryPoint
    # fallback) as ONE device program with ONE fetch instead of 4-6
    # dispatch+fetch round trips (association.associate_and_check_kernel).
    fused_kf_assoc: bool = True
    # Fused triangulation: epipolar search + DLT/stereo init +
    # GMM-constrained solve + acceptance gates + first-wins selection as
    # ONE device program (mapping/tri_kernel.py) instead of 4 device
    # boundaries. Requires use_device_world.
    fused_tri: bool = True
    # Assemble the local-BA problem ON DEVICE from the DeviceWorld
    # mirror's observation tables, fused with the solve into one program
    # (mapping/ba_assemble.py): the host uploads only slot lists instead
    # of 17 (P,MO)-shaped arrays per solve (~1 MB and 17 transfers).
    # Requires use_device_world.
    ba_device_assembly: bool = True
    # DeviceWorld.sync barrier policy: "always" blocks after every
    # dirty-row scatter, "kf" blocks only when keyframe rows scattered
    # (once per KF). Kept from the first platform, where unbarriered
    # scatters stalled the transfer path; whether the GPU needs any
    # barrier is not measured yet (ROADMAP C2).
    sync_barrier: str = "always"


@dataclass(frozen=True)
class TrackingConfig:
    """Front-end settings (inline constants in tracking.cpp)."""

    min_matches_motion: int = 20
    min_matches_track: int = 10
    motion_search_radius: float = 7.0
    local_search_radius: float = 3.0
    local_kf_cap: int = 80           # tracking.cpp:166
    temporal_points_cap: int = 100   # tracking.cpp:448
    # keyframe policy (gmmloc.cpp:324-364)
    kf_ref_ratio_few: float = 0.4
    kf_ref_ratio: float = 0.75
    kf_map_ratio_many: float = 0.2
    kf_map_ratio: float = 0.35
    kf_min_inliers: int = 15
    kf_queue_cap: int = 3
    # Online mode: when a keyframe is wanted but the mapping queue is
    # full, wait up to this long for the mapper to drain before giving
    # up (0 = drop immediately, the reference's behavior at
    # gmmloc.cpp:361). On 600-frame V1_01 online runs (round 4),
    # waiting (250 ms) yielded MORE keyframes (17-20 vs 5-7) but WORSE
    # ATE (0.48 vs 0.39 cm) — each queued KF was processed later, so
    # denser-but-staler mapping lost to sparser-but-fresher. Default 0 =
    # reference drop behavior.
    kf_wait_ms: float = 0.0
    # Use the fused single-dispatch track-step megakernel (tracking/fused.py)
    # instead of the multi-call host-orchestrated path. Same algorithm;
    # the local-map snapshot is one frame stale (bounded staleness).
    # Default ON since round 2: full-length from-frame-0 protocol runs
    # (expr_r3: V1_01 0.15-0.19cm, V1_02 0.57cm, 100% completion) match
    # or beat the round-1 classic-path numbers, and the packed/pipelined
    # perf path is bit-identical to this configuration (VERDICT r1 #2).
    use_fused_track: bool = True
    fused_local_map_cap: int = 4096
    # Packed-IO fused tracking: per-frame transfers collapse to three
    # small f32 arrays in (descriptors bitcast into f32 lanes; GMM anchor
    # geometry + pyramid scales resident on device) and ONE packed vector
    # out. Bit-exact vs the unpacked path (same _track_core; see
    # tests/test_fused_track.py::test_packed_matches_unpacked).
    fused_packed_io: bool = True
    # Local-map snapshot refresh cadence for the packed fused path.
    # "frame": rebuild + upload the (P,MAP_W) table every frame (matches
    #   the classic per-frame local-map update; ~400KB/frame through the
    #   host link). "kf": refresh only when the map itself changed (new
    #   keyframe / BA / culling — tracked via a (n_kfs, n_pts) token);
    #   between refreshes the kernel drops map slots already carried by
    #   the last frame (map_is_stale exclusion), so per-frame staleness
    #   matches the one-frame-stale doctrine. ATE-parity gated
    #   (test_fused_track.test_kf_refresh_ate_parity).
    fused_map_refresh: str = "frame"
    # Pipelined fused tracking: the per-frame device round trip is
    # overlapped with the caller's next-frame work (system.step returns
    # the PREVIOUS frame's stat; see GMMLocSystem.step/drain/flush).
    # Pure reordering of the blocking point — completion order, and hence
    # every computed value, is identical to the synchronous fused path
    # (tests/test_pipelined.py asserts trajectory equality).
    pipelined_track: bool = True
    # Deep device-chained pipeline: dispatch frame N+1 from frame N's
    # UN-FETCHED device output (pose prediction, landmark chain and
    # temporal points computed on device — fused.fused_track_step_chained)
    # and drain results with this lag, hiding the per-frame readback RTT
    # behind `pipeline_depth` dispatches. 1 = the classic 1-deep pipeline
    # (drain before every dispatch). >1 requires packed IO + kf-cadence
    # map refresh + the device world mirror; host bookkeeping (KF policy,
    # mapping, counters) runs at drain time, pipeline_depth frames behind
    # the dispatch front — the same bounded-staleness contract as the
    # reference's online tracking/mapping split (gmmloc.cpp:56-59).
    # Anomalies (under-match, plausibility coast, loss) rewind the
    # in-flight frames onto the synchronous path and re-prime.
    pipeline_depth: int = 1
    # Constant-velocity model damping. 1.0 reproduces the reference
    # (gmmloc.cpp:288 delta * Tcw); <1.0 geometrically decays the
    # extrapolated velocity, bounding the pose random-walk gain during
    # near-stationary, depth-degenerate stretches (e_pre = (1+g)e1 - g e2
    # has spectral radius 1 instead of 2). Deliberate, documented deviation.
    velocity_damping: float = 1.0
    # Physical-plausibility gate on the per-frame solve: a solved pose
    # farther than this from the (KF-re-anchored, EMA-velocity) prediction
    # exceeds any real camera motion at 20 Hz — the solve jumped to a
    # mis-structured attractor (points created during a slip). Coast on
    # the prediction for that frame instead.
    max_jump_trans: float = 0.15     # meters/frame (V1_03 max is 0.089)
    max_jump_rot_deg: float = 8.0    # deg/frame (V1_03 max is 3.7)
    max_coast_frames: int = 2        # consecutive coasts before accepting
    # Staged pose-solve route inside the fused track step: "auto" = the
    # single-program Pallas kernel (solver/pallas_pose.py, the whole 4x10
    # schedule in one program) on the GPU, the XLA op chain on the CPU;
    # "xla" / "pallas" force one (tracking/fused.use_pose_kernel).
    pose_impl: str = "auto"
    # Per-frame GMM structure anchoring in the final pose solve
    # (capability extension; see pose_solver.optimize_pose_anchored).
    use_gmm_pose_anchor: bool = True
    anchor_lambda2: float = 400.0   # deg-edge info scale (x z^2), cf tri_lambda2
    anchor_chi2_gate: float = 2.56  # = tri_str_thresh * tri_lambda2
    anchor_min_edges: int = 10
    # EMA smoothing of the constant-velocity motion model: vel(n) =
    # slerp(vel(n-1), delta(n), velocity_ema). Raw frame-differencing
    # (ema=1.0, the reference behavior, gmmloc.cpp:288) DIFFERENTIATES the
    # per-frame solve noise: along weakly-observable pose directions (all
    # visible landmarks at similar depth -> lateral translation and a tiny
    # compensating rotation are near-invisible) the extrapolation doubles
    # the invisible error every frame and tracking runs away. Averaging
    # the velocity breaks that feedback with sub-frame prediction lag.
    velocity_ema: float = 0.5


@dataclass(frozen=True)
class CapacityConfig:
    """Static array capacities for the on-device world state."""

    max_keyframes: int = 512
    max_points: int = 65536
    max_obs_per_point: int = 24
    local_ba_kfs: int = 32       # local (free) keyframes in one BA window
    fixed_ba_kfs: int = 64       # fixed observer keyframes
    local_ba_points: int = 8192
    # per-point obs slots inside one BA window. Measured occupancy on the
    # protocol runs: mean 2.3, p95 4.2, zero points at 12 — 8 keeps slack
    # while cutting the dominant (P,MO,·) BA traffic by a third.
    ba_obs_per_point: int = 8
    gmm_components_pad: int = 5120   # padded K (v1:3299, v2:5096 -> 5120)
    # fused-triangulation per-KF match budget (static shape). Observed
    # per-KF match counts on the protocol runs are 100-800; overflow is
    # confessed in the run log (Localization._triangulate_fused).
    tri_match_budget: int = 2048


@dataclass(frozen=True)
class SystemConfig:
    """Top-level config (ref: common ns + launch files)."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    frame: FrameConfig = field(default_factory=FrameConfig)
    gmm: GMMMapConfig = field(default_factory=GMMMapConfig)
    loc: LocConfig = field(default_factory=LocConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    caps: CapacityConfig = field(default_factory=CapacityConfig)

    gmm_path: str = ""
    data_path: str = ""
    gt_path: str = ""
    output_path: str = "traj_est.txt"
    voc_path: str = ""
    rect_config: str = ""
    online: bool = False
    verbose: bool = False
    # f32 matmul precision for XLA contractions. "highest" keeps f32
    # products in full f32: on the GPU the default may run them in TF32
    # (~3 decimal digits), which is too coarse for the geometry/solver
    # contractions. The throughput-critical kernels are integer
    # (Hamming) or explicitly bf16-staged (BA Hessian assembly) and are
    # unaffected.
    matmul_precision: str = "highest"
    # capability extensions (absent in the reference)
    enable_relocalization: bool = True   # used when a vocabulary is provided
    enable_loop_closing: bool = False    # pose-graph loop closure

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


def euroc_v1_config(**overrides) -> SystemConfig:
    """The reference's V1 room configuration (cfg/v1.yaml)."""
    return SystemConfig(**overrides)


def derived_pyramid(cfg: SystemConfig):
    """Pyramid-derived arrays (ref: init_config.hpp:63-79)."""
    f = cfg.frame
    sf = f.scale_factors()
    return {
        "scale_factors": sf,
        "scale_factors_inv": 1.0 / sf,
        "sigma2": sf * sf,
        "sigma2_inv": 1.0 / (sf * sf),
        "log_scale_factor": math.log(f.scale_factor),
        "th_depth": f.th_depth(cfg.camera),
    }
