"""Nearest-neighbour correspondence search without KD-trees.

The reference uses per-frame pcl::KdTreeFLANN rebuilds plus linear scans
that exploit the ring-sorted array order (src/laserOdometry.cpp:491-737,
src/laserMapping.cpp:1882,1948).  Here the same queries are brute-force
masked argmins over matmul-shaped distance tiles — the (Q, N) squared
distance matrix is computed as ‖q‖² + ‖r‖² − 2·q·rᵀ, streamed in chunks
to bound device memory.

Ring-window semantics (exactly the reference's array-scan behaviour, which
on a ring-sorted array reduces to ring-set membership):

  * corner 2nd point (laserOdometry.cpp:504-553): nearest point whose ring
    differs from the 1-NN's ring by 1..NEARBY_SCAN;
  * surf 2nd point (laserOdometry.cpp:668-721): nearest point on the SAME
    ring as the 1-NN (excluding it);
  * surf 3rd point: nearest point on a different ring within NEARBY_SCAN.

All gated by DISTANCE_SQ_THRESHOLD = 25 (laserOdometry.cpp:29).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from light_loam_tpu.core.frame import PointCloud

_BIG = 1e30


def pairwise_sq_dist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(Q,3),(N,3) -> (Q,N) squared distances as a matmul.

    Full f32 precision is load-bearing: with coordinates up to ~100 m the
    cross term reaches ~10⁴ m², so a reduced-precision product (TF32 on
    the GPU: ~5e-4 relative) injects metres² of error — above the 1 m²
    5-NN gate.  The tier comes from LLT_MATMUL_PRECISION (highest, the
    default, is exact f32: ~5e-3 m² at 100 m, chip_smoke.py's precision
    phase).
    """
    from light_loam_tpu import dist_precision

    a2 = jnp.sum(a * a, axis=-1, keepdims=True)
    b2 = jnp.sum(b * b, axis=-1, keepdims=True)
    cross = jnp.matmul(a, b.T, precision=dist_precision())
    d = a2 + b2.T - 2.0 * cross
    return jnp.maximum(d, 0.0)


def _masked_min(d: jnp.ndarray, mask: jnp.ndarray):
    """Row-wise (min, argmin) of d with invalid columns masked out."""
    dm = jnp.where(mask, d, _BIG)
    idx = jnp.argmin(dm, axis=-1).astype(jnp.int32)
    val = jnp.take_along_axis(dm, idx[:, None], axis=-1)[:, 0]
    return val, idx


class CornerMatches(NamedTuple):
    a_idx: jnp.ndarray  # (Q,) index of 1-NN in ref
    b_idx: jnp.ndarray  # (Q,) index of cross-ring 2nd point
    valid: jnp.ndarray  # (Q,) bool


class SurfMatches(NamedTuple):
    a_idx: jnp.ndarray  # (Q,) 1-NN
    b_idx: jnp.ndarray  # (Q,) same-ring 2nd point
    c_idx: jnp.ndarray  # (Q,) cross-ring 3rd point
    valid: jnp.ndarray  # (Q,) bool


def corner_correspondences(
    query_xyz: jnp.ndarray,
    query_mask: jnp.ndarray,
    ref: PointCloud,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
) -> CornerMatches:
    """Edge-line correspondences (laserOdometry.cpp:491-554).

    ``query_xyz`` is the motion-compensated query (pointSel).  The corner
    reference cloud is small enough (≤8k) for one full distance matrix.
    """
    d = pairwise_sq_dist(query_xyz, ref.xyz)
    ring = ref.ring()
    d1, a_idx = _masked_min(d, ref.mask[None, :])
    ring_a = ring[a_idx]

    ring_diff = ring[None, :] - ring_a[:, None]
    window = (
        ref.mask[None, :]
        & (ring_diff != 0)
        & (jnp.abs(ring_diff).astype(jnp.float32) <= nearby_scan)
    )
    d2, b_idx = _masked_min(d, window)

    valid = (
        query_mask
        & (d1 < dist_sq_threshold)
        & (d2 < dist_sq_threshold)
    )
    return CornerMatches(a_idx=a_idx, b_idx=b_idx, valid=valid)


def surf_correspondences(
    query_xyz: jnp.ndarray,
    query_mask: jnp.ndarray,
    ref: PointCloud,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
    tile: int = 8192,
    ref_count=None,
) -> SurfMatches:
    """Planar-triangle correspondences (laserOdometry.cpp:653-737),
    streamed over the (large) surf reference cloud in ``tile`` chunks.

    ``ref_count`` (dynamic scalar) asserts that all live reference
    entries sit in the index prefix ``[0, ref_count)`` (a compacted
    cloud, ops.voxel.compact_rows); the tile loops then visit only
    ceil(ref_count/tile) tiles.  Exact by construction: a skipped tile
    is all-masked and can never win a min.  This is the odometry-side
    twin of the mapping 5-NN's count-aware skip (knn_tiled below) —
    the less-flat cloud runs ~40 % full at HDL-64 flagship capacity, so
    both sweep passes drop ~half their tiles."""
    Q = query_xyz.shape[0]
    N = ref.capacity
    ring = ref.ring()
    n_tiles = -(-N // tile)
    pad = n_tiles * tile - N
    ref_xyz = jnp.pad(ref.xyz, ((0, pad), (0, 0)))
    ref_mask = jnp.pad(ref.mask, (0, pad))
    ring_p = jnp.pad(ring, (0, pad))
    if ref_count is None:
        n_live = n_tiles
    else:
        n_live = jnp.minimum(
            (jnp.asarray(ref_count, jnp.int32) + (tile - 1)) // tile,
            jnp.int32(n_tiles),
        )

    # ---- pass 1: plain 1-NN over tiles ----
    def nn_body(i, carry):
        best_d, best_i = carry
        sl = i * tile
        chunk = jax.lax.dynamic_slice_in_dim(ref_xyz, sl, tile, axis=0)
        cmask = jax.lax.dynamic_slice_in_dim(ref_mask, sl, tile, axis=0)
        d = pairwise_sq_dist(query_xyz, chunk)
        dv, di = _masked_min(d, cmask[None, :])
        upd = dv < best_d
        best_i = jnp.where(upd, di + sl, best_i)
        best_d = jnp.where(upd, dv, best_d)
        return (best_d, best_i)

    init = (jnp.full((Q,), _BIG, jnp.float32), jnp.zeros((Q,), jnp.int32))
    d1, a_idx = jax.lax.fori_loop(0, n_live, nn_body, init)
    ring_a = ring_p[a_idx]

    # ---- pass 2: same-ring 2nd and cross-ring 3rd points ----
    def win_body(i, carry):
        (bd2, bi2, bd3, bi3) = carry
        sl = i * tile
        chunk = jax.lax.dynamic_slice_in_dim(ref_xyz, sl, tile, axis=0)
        cmask = jax.lax.dynamic_slice_in_dim(ref_mask, sl, tile, axis=0)
        cring = jax.lax.dynamic_slice_in_dim(ring_p, sl, tile, axis=0)
        d = pairwise_sq_dist(query_xyz, chunk)
        gidx = jnp.arange(tile, dtype=jnp.int32)[None, :] + sl
        not_self = gidx != a_idx[:, None]
        ring_diff = cring[None, :] - ring_a[:, None]
        same = cmask[None, :] & not_self & (ring_diff == 0)
        adj = (
            cmask[None, :]
            & (ring_diff != 0)
            & (jnp.abs(ring_diff).astype(jnp.float32) <= nearby_scan)
        )
        dv2, di2 = _masked_min(d, same)
        dv3, di3 = _masked_min(d, adj)
        u2 = dv2 < bd2
        u3 = dv3 < bd3
        return (
            jnp.where(u2, dv2, bd2),
            jnp.where(u2, di2 + sl, bi2),
            jnp.where(u3, dv3, bd3),
            jnp.where(u3, di3 + sl, bi3),
        )

    init2 = (
        jnp.full((Q,), _BIG, jnp.float32),
        jnp.zeros((Q,), jnp.int32),
        jnp.full((Q,), _BIG, jnp.float32),
        jnp.zeros((Q,), jnp.int32),
    )
    d2, b_idx, d3, c_idx = jax.lax.fori_loop(0, n_live, win_body, init2)

    valid = (
        query_mask
        & (d1 < dist_sq_threshold)
        & (d2 < dist_sq_threshold)
        & (d3 < dist_sq_threshold)
    )
    return SurfMatches(a_idx=a_idx, b_idx=b_idx, c_idx=c_idx, valid=valid)


def surf_correspondences_grid(
    query_xyz: jnp.ndarray,
    query_mask: jnp.ndarray,
    ref: PointCloud,
    n_rings: int,
    dist_sq_threshold: float = 25.0,
    nearby_scan: float = 2.5,
    rings_per_tile: int = 8,
) -> SurfMatches:
    """Single-pass surf correspondences over a ring-slotted reference.

    Exact-semantics fast path for `surf_correspondences`: when the
    reference cloud is in grid layout (ring r owns rows [r*C, r*C+C),
    produced by ops.voxel.voxel_downsample_rings), the same-ring 2nd and
    nearby-ring 3rd points (laserOdometry.cpp:668-721) fall out of
    per-ring top-2 reductions on ONE distance tile — the two-pass version
    computes every distance twice because pass 2's ring classes depend on
    pass 1's argmin.  Halves the dominant matmul cost of the odometry
    stage.  Tie-breaking matches the two-pass version: per-ring argmin
    picks the first column, the cross-ring reduction picks the first
    ring, and ring-major grid order IS global index order.
    """
    Q = query_xyz.shape[0]
    R = n_rings
    C = ref.capacity // R
    if R * C != ref.capacity:
        raise ValueError(
            f"grid layout requires capacity {ref.capacity} divisible by "
            f"n_rings {R}"
        )
    rpt = min(rings_per_tile, R)
    if R % rpt != 0:
        rpt = 1
    n_tiles = R // rpt

    def body(carry, i):
        rd1, ri1, rd2, ri2 = carry  # (Q, R) each
        col0 = i * (rpt * C)
        chunk = jax.lax.dynamic_slice_in_dim(ref.xyz, col0, rpt * C, axis=0)
        cmask = jax.lax.dynamic_slice_in_dim(ref.mask, col0, rpt * C, axis=0)
        d = pairwise_sq_dist(query_xyz, chunk)
        d = jnp.where(cmask[None, :], d, _BIG).reshape(Q, rpt, C)
        i1 = jnp.argmin(d, axis=-1).astype(jnp.int32)          # (Q, rpt)
        d1 = jnp.take_along_axis(d, i1[..., None], axis=-1)[..., 0]
        cols = jnp.arange(C, dtype=jnp.int32)
        d_wo = jnp.where(cols[None, None, :] == i1[..., None], _BIG, d)
        i2 = jnp.argmin(d_wo, axis=-1).astype(jnp.int32)
        d2 = jnp.take_along_axis(d_wo, i2[..., None], axis=-1)[..., 0]
        r0 = i * rpt
        rd1 = jax.lax.dynamic_update_slice_in_dim(rd1, d1, r0, axis=1)
        ri1 = jax.lax.dynamic_update_slice_in_dim(ri1, i1, r0, axis=1)
        rd2 = jax.lax.dynamic_update_slice_in_dim(rd2, d2, r0, axis=1)
        ri2 = jax.lax.dynamic_update_slice_in_dim(ri2, i2, r0, axis=1)
        return (rd1, ri1, rd2, ri2), None

    init = (
        jnp.full((Q, R), _BIG, jnp.float32),
        jnp.zeros((Q, R), jnp.int32),
        jnp.full((Q, R), _BIG, jnp.float32),
        jnp.zeros((Q, R), jnp.int32),
    )
    (rd1, ri1, rd2, ri2), _ = jax.lax.scan(
        body, init, jnp.arange(n_tiles, dtype=jnp.int32)
    )

    ring_a = jnp.argmin(rd1, axis=1).astype(jnp.int32)         # (Q,)
    take = lambda arr: jnp.take_along_axis(arr, ring_a[:, None], axis=1)[:, 0]
    d1 = take(rd1)
    a_idx = ring_a * C + take(ri1)
    d2 = take(rd2)
    b_idx = ring_a * C + take(ri2)

    rr = jnp.arange(R, dtype=jnp.int32)[None, :]
    ring_diff = rr - ring_a[:, None]
    win = (ring_diff != 0) & (
        jnp.abs(ring_diff).astype(jnp.float32) <= nearby_scan
    )
    d3m = jnp.where(win, rd1, _BIG)
    ring_c = jnp.argmin(d3m, axis=1).astype(jnp.int32)
    d3 = jnp.take_along_axis(d3m, ring_c[:, None], axis=1)[:, 0]
    c_idx = ring_c * C + jnp.take_along_axis(
        ri1, ring_c[:, None], axis=1
    )[:, 0]

    valid = (
        query_mask
        & (d1 < dist_sq_threshold)
        & (d2 < dist_sq_threshold)
        & (d3 < dist_sq_threshold)
    )
    return SurfMatches(a_idx=a_idx, b_idx=b_idx, c_idx=c_idx, valid=valid)


def knn_tiled(
    query_xyz: jnp.ndarray,
    ref_xyz: jnp.ndarray,
    ref_mask: jnp.ndarray,
    k: int,
    tile: int = 8192,
    ref_count=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k-NN over a large reference cloud, streamed in tiles.

    Returns (sq_dists (Q,k) ascending, indices (Q,k)).  Replacement for
    the mapping stage's nearestKSearch(5) (laserMapping.cpp:1882,1948).

    ``ref_count`` (dynamic scalar) asserts the reference is a live-prefix
    buffer (entries >= ref_count masked); tiles past it skip their
    distance block + top-k merge entirely (a masked tile can never win a
    slot, so the skip is exact).
    """
    Q = query_xyz.shape[0]
    N = ref_xyz.shape[0]
    n_tiles = -(-N // tile)
    pad = n_tiles * tile - N
    rx = jnp.pad(ref_xyz, ((0, pad), (0, 0)))
    rm = jnp.pad(ref_mask, (0, pad))

    def tile_update(carry, sl):
        best_d, best_i = carry
        chunk = jax.lax.dynamic_slice_in_dim(rx, sl, tile, axis=0)
        cmask = jax.lax.dynamic_slice_in_dim(rm, sl, tile, axis=0)
        d = jnp.where(cmask[None, :], pairwise_sq_dist(query_xyz, chunk), _BIG)
        # top-k smallest in this chunk
        neg_d, di = jax.lax.top_k(-d, k)
        cat_d = jnp.concatenate([best_d, -neg_d], axis=1)
        cat_i = jnp.concatenate([best_i, di + sl], axis=1)
        nd, sel = jax.lax.top_k(-cat_d, k)
        return -nd, jnp.take_along_axis(cat_i, sel, axis=1)

    def body(carry, i):
        sl = i * tile
        if ref_count is None:
            return tile_update(carry, sl), None
        return jax.lax.cond(
            sl < ref_count, tile_update, lambda c, _sl: c, carry, sl
        ), None

    init = (
        jnp.full((Q, k), _BIG, jnp.float32),
        jnp.zeros((Q, k), jnp.int32),
    )
    (best_d, best_i), _ = jax.lax.scan(
        body, init, jnp.arange(n_tiles, dtype=jnp.int32)
    )
    return best_d, best_i
