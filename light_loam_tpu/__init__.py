"""light_loam_tpu — a LiDAR odometry & mapping (SLAM) engine in JAX.

A JAX/XLA/Pallas implementation of the Light-LOAM pipeline (RA-L 2024,
arXiv 2310.04162; reference C++/ROS implementation surveyed in
SURVEY.md), run on an NVIDIA GPU:

  * curvature-based edge/planar feature extraction over ring-organized
    point clouds (reference: src/scanRegistration.cpp),
  * scan-to-scan odometry with graph-matching correspondence-consistency
    voting (reference: src/laserOdometry.cpp),
  * scan-to-map refinement against a sliding voxel-cube world map
    (reference: src/laserMapping.cpp),
  * a batched Gauss-Newton/Levenberg-Marquardt solver on SE(3) with
    analytic Jacobians replacing Ceres (reference: src/lidarFactor.hpp).

Everything on the compute path is pure-functional JAX with static shapes
(padded tensors + validity masks); the pipeline around it is a thin host
runtime.  Multi-device scaling uses jax.sharding Meshes (see
light_loam_tpu.parallel).
"""

import os as _os

import jax as _jax

# Geometry demands real f32 matmuls.  World coordinates reach ~100 m, so
# the cross terms of the distance matmuls (|q|²+|r|²-2q·r) are ~1e4 m²;
# any reduced-precision product rounds them by more than the 1 m² 5-NN
# gate and the vote's 1 m length scale, and long trajectories diverge.
# LLT_MATMUL_PRECISION sets the tier for every matmul of the package:
#
#   highest (default) — exact f32 on the GPU and the CPU.  The only tier
#                       that is safe for the gates.
#   high, default     — both mean TF32 on an H100 (10 mantissa bits,
#                       ~5e-4 relative: ~5 m² on the 1e4 m² cross terms).
#                       Unsafe for the gates; kept for experiments only.
_PRECISION = _os.environ.get("LLT_MATMUL_PRECISION", "highest")
if _PRECISION not in ("highest", "high", "default"):
    raise ValueError(
        f"LLT_MATMUL_PRECISION={_PRECISION!r}: use highest|high|default"
    )
_jax.config.update("jax_default_matmul_precision", _PRECISION)


def dist_precision() -> "_jax.lax.Precision":
    """Precision for the distance-critical matmuls (kNN tiles, vote
    compatibility): the package tier of LLT_MATMUL_PRECISION."""
    return {
        "highest": _jax.lax.Precision.HIGHEST,
        "high": _jax.lax.Precision.HIGH,
        "default": _jax.lax.Precision.DEFAULT,
    }[_PRECISION]

from light_loam_tpu.config import (
    ScanConfig,
    OdometryConfig,
    MappingConfig,
    PipelineConfig,
    HDL64_KITTI,
    HDL64_SMALL,
    VLP16,
    HDL32,
    M2DGR_VLP32C,
)

__version__ = "0.1.0"

__all__ = [
    "ScanConfig",
    "OdometryConfig",
    "MappingConfig",
    "PipelineConfig",
    "HDL64_KITTI",
    "HDL64_SMALL",
    "VLP16",
    "HDL32",
    "M2DGR_VLP32C",
    "__version__",
]
