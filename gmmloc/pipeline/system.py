"""System orchestrator: the full tracking + mapping loop.

JAX replacement for GMMLoc (ref:
/root/reference/gmmloc/src/gmmloc.cpp, gmmloc_opt.cpp). Wires the GMM
map, tracker, associator and back-end; runs the per-frame loop
(spin, gmmloc.cpp:123-197) with the keyframe policy
(needNewKeyFrame:324-364) and the frame-relative trajectory records.

Offline mode (the benchmark configuration, evaluate_euroc.sh protocol):
the back-end runs synchronously after each keyframe insertion.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from ..config import SystemConfig
from ..geometry import camera as cam_mod
from ..gmm import mixture
from ..mapping import map_state as ms
from ..mapping.association import GMMAssociator
from ..mapping.localization import Localization
from ..tracking.frame import Frame
from ..utils.timing import Timer
from ..tracking.tracker import Tracker, TrackStat


class GMMLocSystem:
    def __init__(self, cfg: SystemConfig, gmap: mixture.GMMMap, vocabulary=None):
        self.cfg = cfg
        if cfg.matmul_precision:
            import jax

            jax.config.update(
                "jax_default_matmul_precision", cfg.matmul_precision
            )
        self.cam = cam_mod.CameraParams.from_config(cfg.camera)
        self.gmap = gmap
        self.world = ms.MapState(cfg)
        self.assoc = GMMAssociator(cfg, self.cam, gmap)
        self.tracker = Tracker(
            cfg, self.cam, self.world,
            gmm_views=mixture.host_view(gmap),
        )
        self.localizer = Localization(cfg, self.cam, self.world, self.assoc)
        self.relocalizer = None
        self.loop_closer = None
        if vocabulary is not None and cfg.enable_relocalization:
            from ..tracking.relocalize import Relocalizer

            self.relocalizer = Relocalizer(
                cfg, self.cam, self.world, vocabulary,
                gmm_views=mixture.host_view(gmap), gmap=gmap,
            )
            if cfg.enable_loop_closing:
                from ..mapping.loop_closing import LoopCloser

                self.loop_closer = LoopCloser(cfg, self.world, self.relocalizer.db)
        self.online = None
        if cfg.online:
            from ..mapping.online import OnlineLocalization

            self.online = OnlineLocalization(self.localizer)
            self.online.start()
        self.initialized = False
        self._pending = None  # in-flight FusedPending (pipelined mode)
        # deep device-chained pipeline (pipeline_depth > 1): FIFO of
        # in-flight FusedPendings, drained `pipeline_depth` frames late
        from collections import deque

        self._pendq = deque()
        tk = cfg.tracking
        self._depth = max(1, tk.pipeline_depth)
        if self._depth > 1:
            # chained mode requires packed IO + kf-cadence map refresh +
            # the device world mirror (set below)
            if not (tk.use_fused_track and tk.pipelined_track
                    and tk.fused_packed_io):
                self._depth = 1
            elif tk.fused_map_refresh != "kf":
                import dataclasses as _dc

                self.cfg = cfg = cfg.replace(
                    tracking=_dc.replace(tk, fused_map_refresh="kf")
                )
                self.tracker.cfg = cfg
        self.tracker.dev_world = self.localizer.dev_world
        if self.localizer.dev_world is None:
            self._depth = 1
        self._last_done = None  # frame the most recent stat belongs to
        self.curr_frame: Optional[Frame] = None
        self.last_frame: Optional[Frame] = None
        self.curr_keyframe: int = -1
        self.n_tracked = 0
        # EMA-smoothed constant-velocity model (see TrackingConfig.velocity_ema)
        self.vel_q: Optional[np.ndarray] = None
        self.vel_t: Optional[np.ndarray] = None
        self.track_failed = False   # fatal: no recovery path available
        self.lost = False           # recoverable: awaiting relocalization
        self.n_lost = 0             # lifetime count of lost frames
        # frame indices where relocalization re-anchored the run (for
        # split-at-recovery trajectory scoring — the divergence window
        # before a rescue should not pollute the post-recovery segment)
        self.recovery_frames: list = []
        # chained-pipeline health counters (tools/step_profile.py)
        self.n_primes = 0
        self.n_rewinds = 0
        self.n_rewound_frames = 0

    # ------------------------------------------------------------------

    @classmethod
    def from_gmm_file(cls, cfg: SystemConfig, path: str) -> "GMMLocSystem":
        gmap = mixture.load(
            path,
            pad_to=cfg.caps.gmm_components_pad,
            neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
            neighbor_cap=cfg.gmm.neighbor_cap,
            degenerate_eig_thresh=cfg.gmm.degenerate_eig_thresh,
            salient_eig_thresh=cfg.gmm.salient_eig_thresh,
        )
        return cls(cfg, gmap)

    # ------------------------------------------------------------------

    def init_pose_guess(self, frame: Frame, gt_q_wc=None, gt_t_wc=None) -> None:
        """Pose initialization (gmmloc.cpp:269-292): frame 0 from GT,
        frame 1 copies, else constant velocity; previous frame re-anchored
        to its (possibly BA-refined) reference keyframe."""
        if self.curr_frame is not None and self.curr_frame.ref_kf >= 0:
            # re-anchor prev frame: T_cw = T_cr * T_rw (gmmloc.cpp:272-275)
            info = self.world.frame_infos[-1] if self.world.frame_infos else None
            if info is not None:
                ref = info.ref_kf
                q_rc, t_rc = info.q_cr, info.t_cr
                q_cr, t_cr = ms._inverse(q_rc, t_rc)
                q, t = ms._compose(q_cr, t_cr, self.world.kf_q[ref], self.world.kf_t[ref])
                self.curr_frame.set_pose(q, t)

        if frame.idx == 0 or not self.initialized:
            q_cw = gt_q_wc * np.array([1.0, -1, -1, -1])
            t_cw = -ms._quat_to_mat(q_cw) @ gt_t_wc
            frame.set_pose(q_cw, t_cw)
            self.vel_q = self.vel_t = None
        elif self.last_frame is None or frame.idx == 1:
            frame.set_pose(self.curr_frame.q_cw, self.curr_frame.t_cw)
            self.vel_q = self.vel_t = None
        else:
            dq, dt = self._advance_velocity(self.curr_frame, self.last_frame)
            q, t = ms._compose(dq, dt, self.curr_frame.q_cw, self.curr_frame.t_cw)
            frame.set_pose(q, t)

        self.last_frame = self.curr_frame
        self.curr_frame = frame

    def _advance_velocity(self, curr: Frame, last: Frame):
        """Update the EMA/damped constant-velocity state from two solved
        poses and return the prediction delta (mirrored on device by
        fused._chain_prep for the chained pipeline)."""
        # delta = T_curr * T_last^-1 ; init = vel * T_curr
        # (optionally EMA-smoothed/damped — TrackingConfig)
        ql_wc, tl_wc = ms._inverse(last.q_cw, last.t_cw)
        dq, dt = ms._compose(curr.q_cw, curr.t_cw, ql_wc, tl_wc)
        a = self.cfg.tracking.velocity_ema
        if a < 1.0 and self.vel_q is not None:
            # nlerp toward the new delta (deltas are small per frame)
            if np.dot(self.vel_q, dq) < 0:
                dq = -dq
            dq = (1.0 - a) * self.vel_q + a * dq
            dq /= np.linalg.norm(dq)
            dt = (1.0 - a) * self.vel_t + a * dt
        g = self.cfg.tracking.velocity_damping
        if g < 1.0:
            dt = dt * g
            dq = dq.copy()
            dq[1:] *= g  # shrink rotation toward identity
            dq /= np.linalg.norm(dq)
        self.vel_q, self.vel_t = dq.copy(), dt.copy()
        return dq, dt

    # ------------------------------------------------------------------

    def process_keyframe(self, frame: Frame, is_first: bool = False) -> int:
        """Ref: processKeyFrame (gmmloc_opt.cpp:19-34)."""
        frame.is_keyframe = True
        kf = self.world.alloc_keyframe(frame)
        frame.ref_kf = kf
        # bind tracked landmarks as observations-to-be (consumed by
        # Localization::processNewKeyFrame)
        idx = np.where(frame.mappoint >= 0)[0]
        p = frame.mappoint[idx]
        ok = self.world.pt_valid[p]
        self.world.kf_obs_point[kf, idx[ok]] = p[ok]
        if self.cfg.loc.fused_kf_assoc:
            self.assoc.associate_and_check_keyframe(self.world, kf)
        else:
            self.assoc.associate_keyframe(self.world, kf)
        self.assoc.create_map_points_from_stereo(
            self.world, frame, kf, check_depth=not is_first
        )
        if self.relocalizer is not None:
            self.relocalizer.add_keyframe(kf)
        return kf

    def need_new_keyframe(self, stat: TrackStat) -> bool:
        """Ref: needNewKeyFrame (gmmloc.cpp:324-364)."""
        w = self.world
        cfg = self.cfg.tracking
        num_kfs = w.n_keyframes()
        th_ref_ratio = cfg.kf_ref_ratio_few if num_kfs < 2 else cfg.kf_ref_ratio
        th_map_ratio = (
            cfg.kf_map_ratio_many if stat.num_match_inliers > 300 else cfg.kf_map_ratio
        )
        num_obs = 2 if num_kfs <= 2 else 3
        ref_kf = self.tracker.ref_keyframe
        # count ref-KF points with >= num_obs weighted observations
        obs = w.kf_obs_point[ref_kf]
        pts = obs[obs >= 0]
        num_ref = int((w.pt_n_obs[pts] >= num_obs).sum()) if len(pts) else 0

        c1a = (
            self.curr_frame.idx
            >= w.kf_frame_idx[self.curr_keyframe] + self.cfg.camera.fps
        )
        c1b = (
            stat.num_match_inliers < num_ref * 0.25
            or stat.ratio_map < 0.3
        )
        c2 = (
            stat.num_match_inliers < num_ref * th_ref_ratio
            or stat.ratio_map < th_map_ratio
        ) and stat.num_match_inliers > cfg.kf_min_inliers

        mapper = self.online if self.online is not None else self.localizer
        if (c1a or c1b or mapper.is_idle) and c2:
            if mapper.is_idle:
                return True
            if self.online is not None:
                self.online.interrupt_ba()
            else:
                self.localizer.abort_ba = True
            if mapper.count_queue() < cfg.kf_queue_cap:
                return True
            if self.online is not None and cfg.kf_wait_ms > 0:
                # bounded back-pressure wait (see TrackingConfig.kf_wait_ms):
                # preserve KF density when tracking outruns the mapper
                import time as _time

                deadline = _time.monotonic() + cfg.kf_wait_ms * 1e-3
                while _time.monotonic() < deadline:
                    _time.sleep(0.002)
                    if mapper.count_queue() < cfg.kf_queue_cap:
                        return True
            return False
        return False

    # ------------------------------------------------------------------

    def _recover(self, frame: Frame) -> bool:
        """Relocalize + reset the motion model / tracker state."""
        if not self.relocalizer.relocalize(frame):
            return False
        self.recovery_frames.append(int(frame.idx))
        self.tracker.last_frame = frame
        self.tracker.ref_keyframe = frame.ref_kf
        self.tracker.temp_points.clear()
        # break the constant-velocity chain across the gap
        self.last_frame = None
        self.curr_frame = frame
        self.vel_q = self.vel_t = None
        self.lost = False
        return True

    def step(self, frame: Frame, gt_q_wc=None, gt_t_wc=None) -> TrackStat:
        """One iteration of the main loop (gmmloc.cpp:128-195).

        Pipelined mode (TrackingConfig.pipelined_track): the fused track
        dispatch for THIS frame goes out and its readback + bookkeeping
        are deferred to the next step() call, overlapping the device
        round trip with the caller's next-frame work. The returned stat
        then belongs to the PREVIOUS frame (None until one completes);
        call flush() after the last frame. Completion order (drain ->
        keyframe processing -> next dispatch) is identical to sync mode,
        so the algorithm is unchanged — only the blocking point moves.
        """
        tk = self.cfg.tracking
        if not (tk.pipelined_track and tk.use_fused_track):
            return self._step_sync(frame, gt_q_wc, gt_t_wc)
        if self._depth > 1:
            return self._step_chained(frame, gt_q_wc, gt_t_wc)
        stat_prev = self.drain()
        if self.track_failed:
            return stat_prev
        if self.lost or not self.initialized:
            # lost-recovery and bootstrap run synchronously
            return self._step_sync(frame, gt_q_wc, gt_t_wc)
        self.init_pose_guess(frame, gt_q_wc, gt_t_wc)
        pend = self.tracker.fused_dispatch(frame)
        if pend is None:
            # rare: too few carried landmarks — classic synchronous path
            return self._track_and_map(frame)
        self._pending = pend
        return stat_prev

    # ---------------- deep device-chained pipeline --------------------

    def _step_chained(self, frame: Frame, gt_q_wc=None, gt_t_wc=None):
        """pipeline_depth-deep variant of step(): frames are dispatched
        from device-chained state (tracker.fused_dispatch_chained) and
        drained `pipeline_depth` frames late, hiding the readback RTT
        behind the dispatch front. The returned stat belongs to the
        frame drained this call (None while the pipeline fills)."""
        stat_prev = None
        if len(self._pendq) >= self._depth:
            stat_prev = self._drain_one()
            if self.track_failed:
                return stat_prev
        if self.lost or not self.initialized:
            self._drain_all()
            if self.track_failed:
                return stat_prev
            return self._step_sync(frame, gt_q_wc, gt_t_wc)
        if self.tracker._chain is None or not self._pendq:
            # prime: the previous frame must be fully drained so the
            # host can build the first link's inputs itself
            st = self._drain_all()
            stat_prev = st if st is not None else stat_prev
            if self.track_failed or self.lost or not self.initialized:
                return stat_prev
            self.init_pose_guess(frame, gt_q_wc, gt_t_wc)
            self.tracker.host_vel = (self.vel_q, self.vel_t)
            self.n_primes += 1
            pend = self.tracker.fused_dispatch(frame, prime_chain=True)
            if pend is None:
                return self._track_and_map(frame)
            self._pendq.append(pend)
            return stat_prev
        pend = self.tracker.fused_dispatch_chained(frame)
        if pend is None:
            # chain unavailable (no device world): fall back for good
            self._depth = 1
            self._drain_all()
            return self.step(frame, gt_q_wc, gt_t_wc)
        self._pendq.append(pend)
        return stat_prev

    def _drain_one(self) -> Optional[TrackStat]:
        """Drain the oldest in-flight chained frame: fetch (already
        landed in steady state), host bookkeeping, KF policy + mapping.
        Anomalies rewind the remaining in-flight frames onto the
        synchronous path (their device results assumed a pose chain the
        anomaly invalidated)."""
        pend = self._pendq.popleft()
        stat = self.tracker.fused_complete(pend)
        # rotate the system frame chain at drain time (poses are final
        # here; init_pose_guess rotates it on the synchronous paths)
        self.last_frame = self.curr_frame
        self.curr_frame = pend.frame
        if stat is None:
            # under-match: classic re-run for this frame, then rewind
            st = self._track_and_map(pend.frame, classic_only=True)
            self._update_host_vel()
            return self._rewind_rest(st)
        st = self._track_and_map(pend.frame, pre_stat=stat)
        self._update_host_vel()
        if self.track_failed or self.lost:
            return self._rewind_rest(st)
        if self.tracker.dbg.get("coasted"):
            # the gate replaced the solved pose with the prediction; the
            # device chain continued from the solved pose — rewind
            return self._rewind_rest(st)
        return st

    def _drain_all(self) -> Optional[TrackStat]:
        st = None
        while self._pendq:
            s = self._drain_one()
            st = s if s is not None else st
            if self.track_failed:
                break
        return st

    def _rewind_rest(self, stat_first) -> Optional[TrackStat]:
        """Re-run the remaining in-flight frames synchronously: their
        device results were computed against a chain the just-drained
        frame invalidated (coast / fallback / loss). Rare (anomaly
        rate ~ coast rate); costs one synchronous frame each."""
        frames = [p.frame for p in self._pendq]
        self._pendq.clear()
        self.tracker.invalidate_chain()
        self.n_rewinds += 1
        self.n_rewound_frames += len(frames)
        st = stat_first
        for f in frames:
            f._dev_cur = None  # host re-pack (pose/assignments reset)
            f.mappoint[:] = -1
            f.is_outlier[:] = False
            s = self.step(f)  # depth branch re-primes via _step_chained
            st = s if s is not None else st
            if self.track_failed:
                break
        return st

    def _update_host_vel(self) -> None:
        """Keep the host velocity mirror current from drained poses (the
        device chain advances its own copy; the host one seeds primes
        and rewinds)."""
        if self.last_frame is not None and self.curr_frame is not None:
            self._advance_velocity(self.curr_frame, self.last_frame)

    def drain(self) -> Optional[TrackStat]:
        """Complete the in-flight frame, run its mapping-side work, and
        record its trajectory entry. No-op without a pending dispatch."""
        if self._pending is None:
            return None
        pend, self._pending = self._pending, None
        stat = self.tracker.fused_complete(pend)
        if stat is None:
            # fused step under-matched: rerun this frame on the classic
            # path (incl. trackKeyFrame fallback), synchronously — going
            # straight to classic, NOT a second fused dispatch (which
            # would pay another blocking round trip likely to fail the
            # same way and re-run the temporal-point prep)
            return self._track_and_map(pend.frame, classic_only=True)
        return self._track_and_map(pend.frame, pre_stat=stat)

    def flush(self) -> Optional[TrackStat]:
        """Drain all in-flight frames (end of sequence)."""
        st = self.drain()
        st2 = self._drain_all()
        return st2 if st2 is not None else st

    def _step_sync(self, frame: Frame, gt_q_wc=None, gt_t_wc=None) -> TrackStat:
        if self.lost:
            # LOST state (capability extension, SURVEY §5.3): the reference
            # terminates on tracking failure (gmmloc.cpp:157-159); we keep
            # consuming frames and retry place recognition on each.
            self.n_lost += 1
            if self._recover(frame):
                stat = TrackStat(res=True, num_match_inliers=30, ratio_map=0.3)
                self.world.update_frame_info(frame)
                self._last_done = frame
                return stat
            return TrackStat(res=False)

        self.init_pose_guess(frame, gt_q_wc, gt_t_wc)

        if not self.initialized:
            kf = self.process_keyframe(frame, is_first=True)
            if self.online is not None:
                self.online.insert_keyframe(kf)
            else:
                self.localizer.insert_keyframe(kf)
                self.localizer.spin_once()
            frame.ref_kf = kf
            self.curr_keyframe = kf
            self.tracker.initialize(frame)
            self.initialized = True
            stat = TrackStat(res=True, num_match_inliers=0, ratio_map=1.0)
            if frame.ref_kf < 0:
                frame.ref_kf = self.tracker.ref_keyframe
            self.world.update_frame_info(frame)
            self._last_done = frame
            return stat
        return self._track_and_map(frame)

    def _track_and_map(
        self,
        frame: Frame,
        pre_stat: Optional[TrackStat] = None,
        classic_only: bool = False,
    ):
        """Post-track half of the loop body: failure/relocalization
        handling, keyframe policy + mapping, trajectory record. pre_stat
        carries an already-completed fused result (pipelined drain);
        classic_only skips the fused re-dispatch after an under-match."""
        if pre_stat is None:
            with Timer("track"):
                if classic_only:
                    stat = self.tracker.track_classic_fallback(frame)
                else:
                    stat = self.tracker.track(frame)
        else:
            stat = pre_stat
        if not stat.res and self.relocalizer is not None:
            # capability extension: attempt relocalization instead of
            # terminating (the reference breaks the loop here,
            # gmmloc.cpp:157-159)
            if self._recover(frame):
                stat = TrackStat(res=True, num_match_inliers=30, ratio_map=0.3)
            else:
                self.lost = True
                self.n_lost += 1
                return stat
        if not stat.res:
            self.track_failed = True
            return stat
        if self.need_new_keyframe(stat) and not self.tracker.dbg.get("coasted"):
            with Timer("kf/process"):
                kf = self.process_keyframe(frame)
            self.curr_keyframe = kf
            if self.online is not None:
                self.online.insert_keyframe(kf)
            else:
                self.localizer.insert_keyframe(kf)
                self.localizer.spin_once()
            if self.loop_closer is not None and self.world.kf_valid[kf]:
                self.loop_closer.close(kf)
        self.n_tracked += 1

        if frame.ref_kf < 0:
            frame.ref_kf = self.tracker.ref_keyframe
        self.world.update_frame_info(frame)
        self._last_done = frame  # the frame this stat belongs to (run())
        return stat

    # ------------------------------------------------------------------

    def run(
        self,
        frames: Iterable,
        gt_q_wc=None,
        gt_t_wc=None,
        on_frame: Optional[Callable] = None,
    ):
        """Offline batch run. `frames` yields Frame objects; optional GT
        arrays provide the frame-0 pose anchor. In pipelined mode each
        stat belongs to the PREVIOUS frame; on_frame receives the frame
        the stat was computed for, and the final in-flight frame's stat
        (from flush) goes through the same accounting (ADVICE r2 low)."""
        import time as _time

        from ..utils.control import control as ctl

        self._last_done = None
        i = -1
        for i, frame in enumerate(frames):
            # run-control gate (ref: gmmloc.cpp:128-131 — spin while
            # paused unless single-stepped; stop breaks the loop)
            while not ctl.should_run() and not ctl.stop:
                _time.sleep(0.001)
            ctl.consume_step()
            if ctl.stop:
                break
            g_q = gt_q_wc[i] if gt_q_wc is not None else None
            g_t = gt_t_wc[i] if gt_t_wc is not None else None
            stat = self.step(frame, g_q, g_t)
            if self.track_failed:
                break
            if stat is not None and stat.res and on_frame is not None:
                on_frame(i, self._last_done or frame, stat)
        stat = self.flush()
        if stat is not None and stat.res and on_frame is not None:
            on_frame(i, self._last_done, stat)
        return self.world

    def stop(self) -> None:
        """Drain in-flight work (pipelined tracking + the online mapping
        thread; ref gmmloc.cpp:366)."""
        self.flush()
        if self.online is not None:
            self.online.stop()

    def export_trajectory(self, path: Optional[str] = None):
        if path is not None:
            self.world.save_trajectory_tum(path)
        return self.world.export_trajectory()
