"""Pytree containers for point clouds and per-frame feature sets.

Accelerator layout: every container is a fixed-capacity padded array plus a
validity mask (static shapes under jit).  The reference's ``intensity``
channel trick — ``intensity = scanID + scanPeriod * relTime``
(src/scanRegistration.cpp:208) — is carried as the ``rel`` channel, since
downstream stages recover the ring id as ``int(intensity)``
(src/laserOdometry.cpp:500) and the time fraction as the remainder.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class PointCloud(NamedTuple):
    """Fixed-capacity padded point cloud."""

    xyz: jnp.ndarray   # (N, 3) float32
    rel: jnp.ndarray   # (N,)  float32: ring + scan_period * rel_time
    mask: jnp.ndarray  # (N,)  bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    def ring(self) -> jnp.ndarray:
        """Integer ring id, mirroring ``int(intensity)``."""
        return jnp.floor(self.rel).astype(jnp.int32)

    @staticmethod
    def zeros(capacity: int, dtype=jnp.float32) -> "PointCloud":
        return PointCloud(
            xyz=jnp.zeros((capacity, 3), dtype=dtype),
            rel=jnp.zeros((capacity,), dtype=dtype),
            mask=jnp.zeros((capacity,), dtype=bool),
        )


class RangeImage(NamedTuple):
    """Ring-organized scan: (n_scans, h_max) grid in within-ring order.

    Mirrors the reference's ring-ordered concatenation
    (src/scanRegistration.cpp:216-221) as a padded 2-D layout; ``counts``
    plays the role of the per-ring extents that scanStartInd/scanEndInd
    delimit.
    """

    xyz: jnp.ndarray     # (R, H, 3) float32
    rel: jnp.ndarray     # (R, H) float32
    mask: jnp.ndarray    # (R, H) bool
    counts: jnp.ndarray  # (R,) int32 valid points per ring

    def flatten(self) -> PointCloud:
        R, H, _ = self.xyz.shape
        return PointCloud(
            xyz=self.xyz.reshape(R * H, 3),
            rel=self.rel.reshape(R * H),
            mask=self.mask.reshape(R * H),
        )


class ScanFeatures(NamedTuple):
    """Output of the feature-extraction stage — the five clouds the
    reference publishes (src/scanRegistration.cpp:382-410)."""

    full: RangeImage        # /velodyne_cloud_2
    sharp: PointCloud       # /laser_cloud_sharp        (label 2)
    less_sharp: PointCloud  # /laser_cloud_less_sharp   (label >= 1)
    flat: PointCloud        # /laser_cloud_flat         (label -1)
    less_flat: PointCloud   # /laser_cloud_less_flat    (label <= 0, voxelized)
