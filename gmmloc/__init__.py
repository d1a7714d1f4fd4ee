"""gmmloc: GMM-map stereo visual localization in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
HyHuang1995/gmmloc (RA-L 2020): stereo visual tracking against a prior
dense map compressed into a 3D Gaussian mixture, with structure-consistent
local bundle adjustment.

Layout:
  geometry/   batched SE3 + pinhole camera ops
  gmm/        prior-map engine: loading, rendering, association
  features/   ORB-style front-end (pyramid, FAST, BRIEF, stereo, matching)
  solver/     Gauss-Newton/LM engines (pose-only, point-only, local BA)
  tracking/   per-frame front-end pipeline
  mapping/    keyframe/landmark world state + back-end pipeline
  pipeline/   system orchestration, dataloaders, trajectory export
  parallel/   device-mesh sharded variants (association, distributed BA)
  vocab/      BoW vocabulary + keyframe database (relocalization)
  eval/       ATE metrics, synthetic world generation
  utils/      timing registry, protobuf varint IO
"""

__version__ = "0.1.0"
