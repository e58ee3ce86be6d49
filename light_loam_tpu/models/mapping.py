"""Scan-to-map back end with the sliding voxel-cube world map
(reference: src/laserMapping.cpp).

Static-shape re-design of the reference's 21×21×11 array of per-cell point
clouds (ref:45-75): the map lives as two flat fixed-capacity point stores
(corner/surf), each point tagged with its linear cube-cell index.  The
pointer-shuffle recentering (six while-loops, ref:1595-1779) becomes pure
index arithmetic: shifting the grid adds a constant to every point's cell
index and drops points that roll out of the grid — no data movement.  The
per-cell voxel re-filter (ref:2154-2168) becomes one fused
voxel-dedup over the whole store with the cell id folded into the voxel
key (idempotent for untouched cells, so equivalent to filtering only
touched ones).

Per frame (`process`, ref:1502-2354):
  1. odom→map association (ref:113-117,1581);
  2. grid recentering with ≥3-cell margin (ref:1584-1779);
  3. 5×5×3 local-map gather (ref:1784-1809) + stack downsample
     (ref:1814-1822);
  4. if the local map is big enough (ref:1826): 2 outer iterations of
     5-NN → line/plane fit → LM (ref:1834-2094);
  5. transformUpdate (ref:119-123,2101);
  6. scatter registered stack into the map + voxel dedup (ref:2104-2168).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from light_loam_tpu.config import MappingConfig
from light_loam_tpu.core import quaternion as quat
from light_loam_tpu.core.frame import PointCloud
from light_loam_tpu.ops import graphvote, knn, pallas_knn
from light_loam_tpu.ops.eig3 import eigh3x3
from light_loam_tpu.ops.voxel import compact_rows, voxel_downsample
from light_loam_tpu.solver import (
    EdgeFactors,
    FactorSet,
    PlaneNormFactors,
    lm_solve,
)


class MapStore(NamedTuple):
    """Flat point store for one feature type over the whole cube grid."""

    xyz: jnp.ndarray   # (N, 3) world coordinates
    cell: jnp.ndarray  # (N,) linear cube index i + W*j + W*H*k
    mask: jnp.ndarray  # (N,)

    @staticmethod
    def zeros(capacity: int) -> "MapStore":
        return MapStore(
            xyz=jnp.zeros((capacity, 3), jnp.float32),
            cell=jnp.zeros((capacity,), jnp.int32),
            mask=jnp.zeros((capacity,), bool),
        )


class MappingState(NamedTuple):
    corner: MapStore
    surf: MapStore
    cen: jnp.ndarray   # (3,) int32 — laserCloudCenWidth/Height/Depth
    q_wm: jnp.ndarray  # (4,) map←odom rotation (q_wmap_wodom)
    t_wm: jnp.ndarray  # (3,)
    frame: jnp.ndarray  # int32 — mapped-frame counter (`now_frame` analog,
    #                     gates the scan-to-map vote, laserMapping.cpp:2057)

    @staticmethod
    def init(cfg: MappingConfig) -> "MappingState":
        return MappingState(
            corner=MapStore.zeros(cfg.map_corner_capacity),
            surf=MapStore.zeros(cfg.map_surf_capacity),
            # initial grid center (laserMapping.cpp:45-47)
            cen=jnp.asarray([10, 10, 5], jnp.int32),
            q_wm=quat.quat_identity(),
            t_wm=jnp.zeros(3),
            frame=jnp.int32(0),
        )


class MappingOutput(NamedTuple):
    q_w: jnp.ndarray
    t_w: jnp.ndarray
    corner_factors: jnp.ndarray
    surf_factors: jnp.ndarray
    map_corner_points: jnp.ndarray
    map_surf_points: jnp.ndarray
    # points of the 5×5×3 neighbourhood that did not fit the local-map
    # capacities this step (0 = healthy; >0 means local_*_capacity is
    # undersized for the scene density and whole cells were dropped)
    local_overflow: jnp.ndarray
    # sharded path only: input points + output voxels the per-device
    # stack-downsample shard buffers could not hold (hash skew past the
    # 2× input slack or past stack_*_capacity//n distinct owned voxels).
    # Always 0 on the single-chip path, whose stack buffers are full-size.
    # Kept separate from local_overflow: that one means "grow
    # local_*_capacity", this one means "rebalance/grow the stack shards".
    stack_overflow: jnp.ndarray


def rslidar_quat_remap(q: jnp.ndarray) -> jnp.ndarray:
    """The high-frequency publish path's dataset-frame quirk
    (laserMapping.cpp:189-242): decompose to roll/pitch/yaw, add +π/2 to
    roll and yaw, recompose, then shuffle coefficients as
    (x,y,z,w) ← (q_after.y, −q_after.x, q_after.w, −q_after.z).

    This is an rslidar frame convention hack the reference applies only on
    /aft_mapped_to_init_high_frec (the main-path pose write at
    laserMapping.cpp:2266-2269 publishes the plain quaternion); provided
    for behavioural parity of that topic."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = jnp.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    sinp = 2 * (w * y - z * x)
    pitch = jnp.where(
        jnp.abs(sinp) >= 1, jnp.sign(sinp) * (jnp.pi / 2), jnp.arcsin(
            jnp.clip(sinp, -1.0, 1.0)
        )
    )
    yaw = jnp.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    roll = roll + jnp.pi / 2
    yaw = yaw + jnp.pi / 2
    cy, sy = jnp.cos(yaw * 0.5), jnp.sin(yaw * 0.5)
    cp, sp = jnp.cos(pitch * 0.5), jnp.sin(pitch * 0.5)
    cr, sr = jnp.cos(roll * 0.5), jnp.sin(roll * 0.5)
    qa_w = cy * cp * cr + sy * sp * sr
    qa_x = cy * cp * sr - sy * sp * cr
    qa_y = sy * cp * sr + cy * sp * cr
    qa_z = sy * cp * cr - cy * sp * sr
    return jnp.stack([qa_y, -qa_x, qa_w, -qa_z], axis=-1)


def _cube_of(xyz: jnp.ndarray, cen: jnp.ndarray, cfg: MappingConfig):
    """World position -> (i, j, k) cube coordinate (laserMapping.cpp:1584-1593:
    int((x+25)/50)+cen with a −1 correction for negatives == floor)."""
    half = cfg.cube_size / 2.0
    return (
        jnp.floor((xyz + half) / cfg.cube_size).astype(jnp.int32) + cen[None, :]
    )


def _cell_linear(ijk: jnp.ndarray, cfg: MappingConfig):
    return (
        ijk[..., 0]
        + cfg.cube_width * ijk[..., 1]
        + cfg.cube_width * cfg.cube_height * ijk[..., 2]
    )


def _cell_split(cell: jnp.ndarray, cfg: MappingConfig):
    i = cell % cfg.cube_width
    j = (cell // cfg.cube_width) % cfg.cube_height
    k = cell // (cfg.cube_width * cfg.cube_height)
    return jnp.stack([i, j, k], axis=-1)


def _recenter(state: MappingState, t_w: jnp.ndarray, cfg: MappingConfig):
    """Shift the grid so the pose cube keeps a ≥3-cell margin
    (ref:1595-1779); returns (new state fields, center cube ijk)."""
    dims = jnp.asarray(
        [cfg.cube_width, cfg.cube_height, cfg.cube_depth], jnp.int32
    )
    center = _cube_of(t_w[None, :], state.cen, cfg)[0]
    m = cfg.recenter_margin
    shift = jnp.maximum(0, m - center) - jnp.maximum(0, center - (dims - m - 1))
    center = center + shift
    cen = state.cen + shift

    def apply(store: MapStore) -> MapStore:
        ijk = _cell_split(store.cell, cfg) + shift[None, :]
        inside = jnp.all((ijk >= 0) & (ijk < dims[None, :]), axis=-1)
        return MapStore(
            xyz=store.xyz,
            cell=jnp.where(
                inside, _cell_linear(ijk, cfg), 0
            ).astype(jnp.int32),
            mask=store.mask & inside,
        )

    return apply(state.corner), apply(state.surf), cen, center


def _gather_local(store: MapStore, center: jnp.ndarray, cfg: MappingConfig,
                  capacity: int, cell_ordered: bool = True):
    """Compact points of the 5×5×3 neighbourhood (ref:1784-1809) into a
    fixed-capacity buffer ordered by cell id.

    Returns (xyz, mask, overflow): overflow is the number of neighbourhood
    points that did NOT fit in `capacity`.  Because the compaction is
    ordered by cell id, an overflow drops whole high-index cells
    systematically — it must be surfaced to operators (analogous to the
    map-store saturation counter), not silently truncated.

    ``cell_ordered=True`` (default): the store's live rows are already
    cell-nondecreasing — every single-chip store is (voxel_downsample /
    merge_sorted emit voxel-key order whose major component embeds the
    cell, and recentering adds one constant to every live cell id) — so
    a stable mask compaction in store order IS the sort by cell id; use
    the O(N) prefix-sum scatter (ops.voxel.compact_rows), bitwise equal
    to the argsort it replaces.  Pass False for stores in any other
    layout (the voxel-hash-sharded distributed store), which pay the
    argsort to keep the documented cell-ordered overflow semantics."""
    ijk = _cell_split(store.cell, cfg)
    d = jnp.abs(ijk - center[None, :])
    local = (
        store.mask
        & (d[:, 0] <= cfg.local_half_i)
        & (d[:, 1] <= cfg.local_half_j)
        & (d[:, 2] <= cfg.local_half_k)
    )
    count = jnp.sum(local.astype(jnp.int32))
    overflow = jnp.maximum(count - capacity, 0)
    if cell_ordered:
        out_mask, xyz = compact_rows(local, capacity, store.xyz)
        return xyz, out_mask, overflow
    key = jnp.where(local, store.cell, jnp.int32(2**31 - 1))
    order = jnp.argsort(key, stable=True)[:capacity]
    out_mask = jnp.arange(capacity, dtype=jnp.int32) < count
    return store.xyz[order], out_mask, overflow


def _solve3x3(A: jnp.ndarray, b: jnp.ndarray):
    """Batched 3×3 solve via adjugate (A (...,3,3), b (...,3))."""
    a = A
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    adjT = jnp.stack(
        [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    safe_det = jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    x = jnp.einsum("...ij,...j->...i", adjT, b) / safe_det[..., None]
    ok = jnp.abs(det) > 1e-20
    return x, ok


def line_fit_factors(stack_xyz, stack_mask, d, near, cfg: MappingConfig):
    """Line factors from 5-NN covariance eigen-analysis (ref:1886-1921),
    given precomputed neighbour sets (d (Q,k) ascending, near (Q,k,3))."""
    center = jnp.mean(near, axis=1)
    diff = near - center[:, None, :]
    cov = jnp.einsum("qni,qnj->qij", diff, diff)
    vals, vmax = eigh3x3(cov)
    is_line = vals[:, 2] > cfg.line_eig_ratio * vals[:, 1]
    ok = stack_mask & (d[:, cfg.knn_k - 1] < cfg.knn_sq_gate) & is_line
    a = center + cfg.line_point_offset * vmax
    b = center - cfg.line_point_offset * vmax
    n = stack_xyz.shape[0]
    return EdgeFactors(
        cp=stack_xyz, a=a, b=b,
        s=jnp.ones(n, jnp.float32),
        weight=jnp.ones(n, jnp.float32),
        mask=ok,
    )


def plane_fit_factors(stack_xyz, stack_mask, d, near, cfg: MappingConfig):
    """Plane factors from 5-NN least-squares fit A·n = −1 (ref:1948-2036),
    given precomputed neighbour sets."""
    AtA = jnp.einsum("qni,qnj->qij", near, near)
    Atb = -jnp.sum(near, axis=1)
    nvec, solv_ok = _solve3x3(AtA, Atb)
    norm = jnp.sqrt(jnp.maximum(jnp.sum(nvec * nvec, axis=-1), 1e-20))
    neg_d = 1.0 / norm
    n_hat = nvec / norm[:, None]
    resid = jnp.abs(jnp.einsum("qni,qi->qn", near, n_hat) + neg_d[:, None])
    plane_ok = jnp.all(resid <= cfg.plane_fit_gate, axis=1)
    ok = (
        stack_mask
        & (d[:, cfg.knn_k - 1] < cfg.knn_sq_gate)
        & plane_ok
        & solv_ok
    )
    n = stack_xyz.shape[0]
    return PlaneNormFactors(
        cp=stack_xyz, n=n_hat, d=neg_d,
        weight=jnp.ones(n, jnp.float32),
        mask=ok,
    )


def _merge_full(store: MapStore, new_xyz, new_cell, new_mask, cfg,
                leaf: float, capacity: int) -> MapStore:
    """Append registered points and voxel-dedup the whole store by a full
    re-sort (ref:2104-2168).  Output is lex-sorted by voxel key with dead
    rows at the tail — the invariant the sorted fast path relies on."""
    all_xyz = jnp.concatenate([store.xyz, new_xyz], axis=0)
    all_cell = jnp.concatenate([store.cell, new_cell], axis=0)
    all_mask = jnp.concatenate([store.mask, new_mask], axis=0)
    xyz, _, mask, cell = voxel_downsample(
        all_xyz, jnp.zeros(all_xyz.shape[0], jnp.float32), all_mask,
        leaf, capacity, extra_key=all_cell,
    )
    return MapStore(xyz=xyz, cell=cell, mask=mask)


def _merge_into_store(store: MapStore, new_xyz, new_mask, cen, cfg,
                      leaf: float, capacity: int,
                      recentered=None) -> MapStore:
    """Register a frame's stack into the map store (ref:2104-2168);
    points outside the grid are dropped (ref:2119-2121).

    With cfg.map_store_mode == "sorted" and a ``recentered`` scalar, the
    full re-sort runs only on recenter frames (rows are only evicted
    there, so between recenters the store is a key-sorted live prefix +
    sentinel tail and the O(new·log N + N) sorted merge applies —
    ops/sorted_store.py).  ``recentered=None`` forces the full path."""
    ijk = _cube_of(new_xyz, cen, cfg)
    dims = jnp.asarray(
        [cfg.cube_width, cfg.cube_height, cfg.cube_depth], jnp.int32
    )
    inside = jnp.all((ijk >= 0) & (ijk < dims[None, :]), axis=-1)
    new_cell = jnp.where(inside, _cell_linear(ijk, cfg), 0).astype(jnp.int32)
    new_mask = new_mask & inside

    if recentered is None or cfg.map_store_mode == "resort":
        return _merge_full(store, new_xyz, new_cell, new_mask, cfg,
                           leaf, capacity)

    from light_loam_tpu.ops.sorted_store import merge_sorted

    def fast(st):
        xyz, cell, mask = merge_sorted(
            st.xyz, st.cell, st.mask, new_xyz, new_cell, new_mask, leaf
        )
        return MapStore(xyz=xyz, cell=cell, mask=mask)

    return jax.lax.cond(
        recentered,
        lambda st: _merge_full(st, new_xyz, new_cell, new_mask, cfg,
                               leaf, capacity),
        fast,
        store,
    )


def surround_cloud(state: MappingState, t_w: jnp.ndarray, cfg: MappingConfig,
                   capacity: int = 131072):
    """Points of the 5×5×3 cells around the pose — the /laser_cloud_surround
    output the reference publishes every 5 frames (laserMapping.cpp:2173-2188).
    Returns (xyz (capacity,3), mask)."""
    center = _cube_of(t_w[None, :], state.cen, cfg)[0]

    def gather(store):
        return _gather_local(store, center, cfg, capacity)[:2]

    cx, cm = gather(state.corner)
    sx, sm = gather(state.surf)
    xyz = jnp.concatenate([cx, sx], axis=0)
    mask = jnp.concatenate([cm, sm], axis=0)
    out_mask, out_xyz = compact_rows(mask, capacity, xyz)
    return out_xyz, out_mask


def full_map_cloud(state: MappingState):
    """All cells' points — the /laser_cloud_map output published every 20
    frames (laserMapping.cpp:2190-2203).  Returns (xyz, mask) pairs for
    (corner, surf)."""
    return (
        (state.corner.xyz, state.corner.mask),
        (state.surf.xyz, state.surf.mask),
    )


def register_cloud(q_w: jnp.ndarray, t_w: jnp.ndarray, xyz: jnp.ndarray):
    """Transform a frame's cloud into the map frame — the
    /velodyne_cloud_registered output (laserMapping.cpp:2205-2215)."""
    return quat.quat_rotate(q_w[None, :], xyz) + t_w[None, :]


@partial(jax.jit, static_argnames=("cfg",))
def mapping_step(
    state: MappingState,
    corner_last: PointCloud,
    surf_last: PointCloud,
    q_odom: jnp.ndarray,
    t_odom: jnp.ndarray,
    cfg: MappingConfig,
) -> Tuple[MappingState, MappingOutput]:
    # 1. initial guess from odometry (ref:113-117)
    q_w = quat.quat_normalize(quat.quat_multiply(state.q_wm, q_odom))
    t_w = quat.quat_rotate(state.q_wm, t_odom) + state.t_wm

    # 2. recenter grid
    corner_store, surf_store, cen, center = _recenter(state, t_w, cfg)

    # 3. local map + stacks
    local_c_xyz, local_c_mask, ovf_c = _gather_local(
        corner_store, center, cfg, cfg.local_corner_capacity
    )
    local_s_xyz, local_s_mask, ovf_s = _gather_local(
        surf_store, center, cfg, cfg.local_surf_capacity
    )
    stack_c_xyz, _, stack_c_mask, _ = voxel_downsample(
        corner_last.xyz, corner_last.rel, corner_last.mask,
        cfg.line_resolution, cfg.stack_corner_capacity,
    )
    stack_s_xyz, _, stack_s_mask, _ = voxel_downsample(
        surf_last.xyz, surf_last.rel, surf_last.mask,
        cfg.plane_resolution, cfg.stack_surf_capacity,
    )

    n_local_c = jnp.sum(local_c_mask.astype(jnp.int32))
    n_local_s = jnp.sum(local_s_mask.astype(jnp.int32))
    n_stack_c = jnp.sum(stack_c_mask.astype(jnp.int32))
    n_stack_s = jnp.sum(stack_s_mask.astype(jnp.int32))
    big_enough = (n_local_c > cfg.min_corner_map_points) & (
        n_local_s > cfg.min_surf_map_points
    )

    # 4. scan-to-map refinement (2 outer × 4 LM).  Both k-NN operands are
    # live-prefix buffers (_gather_local / voxel_downsample compact live
    # entries to the front), so the search cost scales with CONTENT via
    # count-aware tile skipping, not with the static capacities (~10k
    # live points in the 65,536-point local surf buffer).
    def neighbours(stack_xyz, n_stack, local_xyz, local_mask, n_local,
                   q_w, t_w):
        p_sel = quat.quat_rotate(q_w[None, :], stack_xyz) + t_w[None, :]
        backend = cfg.knn_backend
        if backend == "auto":
            # the fused kernel compiles for the GPU only (config.py note)
            backend = "pallas" if jax.default_backend() == "gpu" else "xla"
        if backend == "pallas":
            d, idx = pallas_knn.knn_pallas(
                p_sel, local_xyz, local_mask, k=cfg.knn_k,
                query_count=n_stack, ref_count=n_local)
        else:
            d, idx = knn.knn_tiled(p_sel, local_xyz, local_mask,
                                   k=cfg.knn_k, tile=cfg.knn_tile,
                                   ref_count=n_local)
        return d, local_xyz[idx]

    n_cf = jnp.int32(0)
    n_sf = jnp.int32(0)
    use_vote = (cfg.vote_mode != "off") and (
        state.frame > cfg.vote_start_frame
    )

    # One lax.scan body instead of a Python unroll — same rationale as
    # odometry_step's re-association loop: the body dominates the HLO and
    # unrolling it only multiplied compile time.
    def _outer(carry, _):
        q_w, t_w, n_cf, n_sf = carry
        d_c, near_c = neighbours(stack_c_xyz, n_stack_c,
                                 local_c_xyz, local_c_mask, n_local_c,
                                 q_w, t_w)
        ef = line_fit_factors(
            stack_c_xyz, stack_c_mask & big_enough, d_c, near_c, cfg
        )
        d_s, near_s = neighbours(stack_s_xyz, n_stack_s,
                                 local_s_xyz, local_s_mask, n_local_s,
                                 q_w, t_w)
        pf = plane_fit_factors(
            stack_s_xyz, stack_s_mask & big_enough, d_s, near_s, cfg
        )
        if cfg.vote_mode != "off":
            # latent mapping-stage vote (laserMapping.cpp:2057-2072):
            # src = stack point in sensor frame, tgt = 5-NN centroid
            # (the Corre_Match recorded at laserMapping.cpp:1993-2003);
            # survivors keep their plane factor, the rest are dropped.
            chunk_cap = (
                cfg.stack_surf_capacity // cfg.vote_regions + cfg.vote_regions
            )
            sel, w = graphvote.run_vote(
                cfg.vote_mode, stack_s_xyz, jnp.mean(near_s, axis=1), pf.mask,
                n_regions=cfg.vote_regions, chunk_capacity=chunk_cap,
                score_threshold=cfg.vote_score_threshold,
                resolution=cfg.vote_resolution,
                selected_ratio=cfg.vote_selected_ratio,
                low_vote_count=cfg.vote_low_vote_count,
                low_vote_weight=cfg.vote_low_vote_weight,
                high_vote_weight=cfg.vote_high_vote_weight,
            )
            pf = pf._replace(
                mask=pf.mask & jnp.where(use_vote, sel, True),
                weight=jnp.where(
                    use_vote & cfg.vote_apply_weights, w, pf.weight
                ),
            )
        q_w, t_w, _cost = lm_solve(
            q_w, t_w, FactorSet(edge=ef, plane_norm=pf),
            n_iterations=cfg.inner_iterations,
            huber_delta=cfg.huber_delta,
        )
        n_cf = jnp.sum(ef.mask.astype(jnp.int32))
        n_sf = jnp.sum(pf.mask.astype(jnp.int32))
        return (q_w, t_w, n_cf, n_sf), None

    (q_w, t_w, n_cf, n_sf), _ = jax.lax.scan(
        _outer, (q_w, t_w, n_cf, n_sf), None,
        length=cfg.outer_iterations,
    )

    # 5. refresh odom→map correction (ref:119-123)
    q_wm = quat.quat_normalize(
        quat.quat_multiply(q_w, quat.quat_inverse(q_odom))
    )
    t_wm = t_w - quat.quat_rotate(q_wm, t_odom)

    # 6. register stacks into the map.  Rows are only evicted at grid
    # recentering, so non-recenter frames take the sorted fast-path
    # merge (ops/sorted_store.py) under the cond.
    recentered = jnp.any(cen != state.cen)
    reg_c = quat.quat_rotate(q_w[None, :], stack_c_xyz) + t_w[None, :]
    reg_s = quat.quat_rotate(q_w[None, :], stack_s_xyz) + t_w[None, :]
    corner_store = _merge_into_store(
        corner_store, reg_c, stack_c_mask, cen, cfg,
        cfg.line_resolution, cfg.map_corner_capacity,
        recentered=recentered,
    )
    surf_store = _merge_into_store(
        surf_store, reg_s, stack_s_mask, cen, cfg,
        cfg.plane_resolution, cfg.map_surf_capacity,
        recentered=recentered,
    )

    new_state = MappingState(
        corner=corner_store, surf=surf_store, cen=cen, q_wm=q_wm, t_wm=t_wm,
        frame=state.frame + 1,
    )
    out = MappingOutput(
        q_w=q_w, t_w=t_w,
        corner_factors=n_cf, surf_factors=n_sf,
        map_corner_points=jnp.sum(corner_store.mask.astype(jnp.int32)),
        map_surf_points=jnp.sum(surf_store.mask.astype(jnp.int32)),
        local_overflow=ovf_c + ovf_s,
        stack_overflow=jnp.int32(0),
    )
    return new_state, out
