"""Image-level front-end: stereo images -> Frame.

JAX replacement for the per-frame image block of
GMMLoc::processFrame (ref: /root/reference/gmmloc/src/gmmloc.cpp:199-267):
rectify -> equalize -> dual ORB extraction (the reference's two ephemeral
threads become one batched device program per image) -> stereo matching ->
Frame assembly.

Two operating modes:

- process(): the original per-stage path (several dispatches + fetches
  per frame) — kept for tests and piecewise debugging.
- dispatch()/complete(): the production path. ONE fused jit runs
  rectify + equalize + both pyramids + both detections + stereo
  matching/refinement/median-cut and returns ONE packed (N,16) f32
  table; inputs are the two uint8 images (4x less upload than f32).
  dispatch() starts the device work and the overlapped readback;
  complete() blocks only on the packed result. Interleaving
  dispatch(N+1) before complete(N) double-buffers the front-end
  against the tracker the way the reference overlaps its extractor
  threads with the main loop (gmmloc.cpp:241-249).

The per-stage path moves 2 f32 images + ~8 result arrays per frame; the
packed path moves 2 uint8 images in and one 80 KB table out.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SystemConfig
from ..features import detect, pyramid, stereo
from ..tracking.frame import Frame, make_frame
from ..utils.fetch import AsyncFetch, record_uploads
from .rectify import Rectifier, equalize_hist

# packed output layout: uv(2) ur(1) depth(1) octave(1) angle(1) valid(1)
# resp(1) desc-as-f32-lanes(8) = 16 columns
PACK_W = 16


@dataclass
class FrontendPending:
    idx: int
    timestamp: float
    fetch: AsyncFetch
    n: int


class ImageFrontend:
    def __init__(self, cfg: SystemConfig, rectifier: Optional[Rectifier] = None):
        self.cfg = cfg
        self.rect = rectifier
        cam = cfg.camera
        self.detector = detect.ORBDetector(
            cam.height, cam.width,
            num_features=cfg.frame.num_features,
            num_levels=cfg.frame.num_levels,
            scale=cfg.frame.scale_factor,
            distribution=cfg.frame.detect_distribution,
        )
        self.scale_factors = cfg.frame.scale_factors().astype(np.float32)
        self.baseline = cam.bf / cam.fx
        self.bf = cam.bf
        self._packed = jax.jit(self._packed_impl)

    # ---------------- per-stage path (tests / debugging) ---------------

    def process(self, idx: int, timestamp: float, left, right) -> Frame:
        cfg = self.cfg
        left = jnp.asarray(left, jnp.float32)
        right = jnp.asarray(right, jnp.float32)
        if cfg.camera.do_rectify and self.rect is not None:
            left = self.rect.rectify_left(left)
            right = self.rect.rectify_right(right)
        if cfg.camera.do_equalization:
            left = equalize_hist(left)
            right = equalize_hist(right)

        det_l = self.detector(left)
        det_r = self.detector(right)

        pyr_l = pyramid.build_pyramid(left, self.detector.shapes)
        pyr_r = pyramid.build_pyramid(right, self.detector.shapes)
        u_right, depth = stereo.compute_stereo_matches(
            pyr_l, pyr_r,
            det_l.uv, det_l.octave, det_l.desc, det_l.valid,
            det_r.uv, det_r.octave, det_r.desc, det_r.valid,
            self.scale_factors, bf=self.bf, baseline=self.baseline,
            n_levels=cfg.frame.num_levels,
        )

        valid = np.asarray(det_l.valid)
        n = len(valid)
        frame = make_frame(
            idx, timestamp,
            np.asarray(det_l.uv),
            np.asarray(u_right),
            np.asarray(depth),
            np.asarray(det_l.octave),
            np.asarray(det_l.angle),
            np.asarray(det_l.desc),
            max(cfg.frame.feat_cap, n),
        )
        frame.valid[:n] = valid
        return frame

    # ---------------- fused packed path (production) -------------------

    def _packed_impl(self, left_u8, right_u8):
        cfg = self.cfg
        left = left_u8.astype(jnp.float32)
        right = right_u8.astype(jnp.float32)
        if cfg.camera.do_rectify and self.rect is not None:
            left = self.rect.rectify_left(left)
            right = self.rect.rectify_right(right)
        if cfg.camera.do_equalization:
            left = equalize_hist(left)
            right = equalize_hist(right)

        # ONE pyramid per image shared by detection AND stereo refinement;
        # both images' detections run as ONE FAST+NMS dispatch + ONE
        # orientation/descriptor gather pass (detect_pair_from_levels)
        pyr_l = pyramid.build_pyramid(left, self.detector.shapes)
        pyr_r = pyramid.build_pyramid(right, self.detector.shapes)
        det_l, det_r = self.detector.detect_pair_from_levels(pyr_l, pyr_r)

        best, _ = stereo.match_stereo(
            det_l.uv, det_l.octave, det_l.desc, det_l.valid,
            det_r.uv, det_r.octave, det_r.desc, det_r.valid,
            jnp.asarray(self.scale_factors), bf=self.bf, min_z=self.baseline,
        )
        matched = best >= 0
        u_r0 = jnp.where(matched, det_r.uv[jnp.clip(best, 0), 0], 0.0)
        u_right, depth, good, sad = stereo.refine_subpixel(
            tuple(pyr_l), tuple(pyr_r), det_l.uv, det_l.octave, u_r0,
            matched, jnp.asarray(self.scale_factors),
            bf=self.bf, min_z=self.baseline,
            n_levels=cfg.frame.num_levels,
        )
        # median SAD outlier cut (frame.cpp:337-348) — in-jit nanmedian
        med = jnp.nanmedian(jnp.where(good, sad, jnp.nan))
        med = jnp.where(jnp.isfinite(med), med, 0.0)
        good = good & (sad <= 1.5 * 1.4 * med)
        u_right = jnp.where(good, u_right, -1.0)
        depth = jnp.where(good, depth, -1.0)

        n = det_l.uv.shape[0]
        desc_f32 = jax.lax.bitcast_convert_type(
            det_l.desc.reshape(n, 8, 4), jnp.float32
        )
        out = jnp.concatenate(
            [
                det_l.uv,
                u_right[:, None], depth[:, None],
                det_l.octave.astype(jnp.float32)[:, None],
                det_l.angle[:, None],
                det_l.valid.astype(jnp.float32)[:, None],
                det_l.response[:, None],
                desc_f32,
            ],
            axis=1,
        )
        return out

    def dispatch(self, idx: int, timestamp: float, left, right) -> FrontendPending:
        """Upload the uint8 stereo pair, run the fused front-end program,
        start the overlapped readback of the packed feature table."""
        l8 = jnp.asarray(np.asarray(left, np.uint8))
        r8 = jnp.asarray(np.asarray(right, np.uint8))
        record_uploads(2)
        out = self._packed(l8, r8)
        return FrontendPending(
            idx=idx, timestamp=timestamp, fetch=AsyncFetch((out,)),
            n=self.cfg.frame.num_features,
        )

    def complete(self, pend: FrontendPending) -> Frame:
        (out,) = pend.fetch.get()
        n = pend.n
        uv = out[:, 0:2].astype(np.float64)
        u_right = out[:, 2].astype(np.float64)
        depth = out[:, 3].astype(np.float64)
        octave = out[:, 4].astype(np.int32)
        angle = out[:, 5].astype(np.float64)
        valid = out[:, 6] > 0.5
        desc = np.ascontiguousarray(out[:, 8:16]).view(np.uint8).reshape(n, 32)
        frame = make_frame(
            pend.idx, pend.timestamp, uv, u_right, depth, octave, angle,
            desc, max(self.cfg.frame.feat_cap, n),
        )
        frame.valid[:n] = valid
        return frame

    def process_packed(self, idx: int, timestamp: float, left, right) -> Frame:
        """Fused single-dispatch front-end, synchronous completion."""
        return self.complete(self.dispatch(idx, timestamp, left, right))
