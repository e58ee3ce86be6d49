"""Multi-device map sharding over a jax.sharding Mesh.

The reference's only distribution mechanism is ROS pub/sub between four
processes (SURVEY.md §2.7).  The accelerator scaling axis is *spatial map
sharding* (BASELINE.json north star): the cube map's point stores are
partitioned across devices by **dedup-voxel hash** — each point's owner is
a spatial hash of its absolute leaf-voxel coordinates (the same
world-anchored lattice ops/voxel.py dedups on), so

  * voxel dedup stays purely local (all points of one dedup voxel share
    one owner by construction);
  * load balances over thousands of fine voxels.  (Hashing the 50 m cube
    CELL id instead — the first design — skews whole heavy cells onto one
    device: a single cell near the trajectory can exceed the per-shard
    capacity slice and silently drop points the single-chip store keeps,
    measured as a 2%+ map-content gap at 8 devices);
  * ownership is recenter-invariant: _recenter shifts cell IDS only,
    never coordinates, so no point migrates on recenter;
  * the 5×5×3 local-map gather is local filtering;
  * k-NN: the live local neighbourhood (a few hundred KB, bounded by
    local_*_capacity — never the map stores) is all_gathered to every
    device, and each device computes exact k-NN for its own Q/n query
    slice against it — per-device work (Q/n)·live_total, exact 1/n
    strong scaling (the r3 candidate-exchange design paid a one-tile
    Q×tile floor per device whenever the live neighbourhood was smaller
    than a knn tile — see _merged_knn_sliced); the vote path all_gathers
    the (Q/n, k) results back to the full query set;
  * Gauss-Newton normal equations are computed per-device over a slice of
    the query stack and psum-reduced (lm_solve(axis_name=...)), every
    device then solves the identical 6×6 system.

The same program runs unchanged on a virtual CPU mesh
(xla_force_host_platform_device_count) and on real GPUs.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from light_loam_tpu.config import MappingConfig
from light_loam_tpu.core import quaternion as quat
from light_loam_tpu.core.frame import PointCloud
from light_loam_tpu.models.mapping import (
    MapStore,
    MappingOutput,
    MappingState,
    _cell_linear,
    _cube_of,
    _gather_local,
    _recenter,
    line_fit_factors,
    plane_fit_factors,
)
from light_loam_tpu.ops import graphvote, knn
from light_loam_tpu.ops.voxel import compact_rows, voxel_downsample
from light_loam_tpu.solver import FactorSet, lm_solve

AXIS = "map"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(devs[:n], (AXIS,))


def voxel_owner(xyz: jnp.ndarray, leaf: float, n: int) -> jnp.ndarray:
    """Shard owner of each point: spatial hash of its absolute dedup-voxel
    coordinates (same world-anchored floor(xyz/leaf) lattice ops/voxel.py
    keys on, so every point of one dedup voxel maps to one owner).  The
    classic 3-prime spatial hash spreads adjacent voxels across devices.
    """
    ijk = jnp.floor(xyz / leaf).astype(jnp.int32)
    h = (ijk[..., 0] * 73856093) ^ (ijk[..., 1] * 19349663) ^ (
        ijk[..., 2] * 83492791
    )
    return (h & 0x7FFFFFFF) % n


def redistribute_state(
    state: MappingState, n: int, cfg: MappingConfig
) -> MappingState:
    """Re-pack both point stores so points land on their voxel-hash
    owner's contiguous slice (slice i covers [i*cap/n, (i+1)*cap/n)).
    Pure array computation — placement onto a mesh happens separately
    (shard_mapping_state locally, parallel.multihost.place_state_global
    across processes)."""

    def redistribute(store: MapStore, capacity: int, leaf: float) -> MapStore:
        # within each owner, pack points contiguously at slot
        # owner*cap_shard + rank.
        cap_shard = capacity // n
        owner = jnp.where(store.mask, voxel_owner(store.xyz, leaf, n), n)
        key = owner * capacity + jnp.arange(store.cell.shape[0], dtype=jnp.int32)
        order = jnp.argsort(key, stable=True)
        # rank within owner group
        owner_s = owner[order]
        idx = jnp.arange(order.shape[0], dtype=jnp.int32)
        first = jnp.full((n + 1,), order.shape[0], jnp.int32).at[owner_s].min(idx)
        rank = idx - first[owner_s]
        dest = jnp.where(
            (owner_s < n) & (rank < cap_shard),
            owner_s * cap_shard + rank,
            capacity,
        )
        xyz = jnp.zeros((capacity + 1, 3), store.xyz.dtype).at[dest].set(
            store.xyz[order]
        )[:capacity]
        cell = jnp.zeros((capacity + 1,), jnp.int32).at[dest].set(
            store.cell[order]
        )[:capacity]
        mask = jnp.zeros((capacity + 1,), bool).at[dest].set(
            store.mask[order]
        )[:capacity]
        return MapStore(xyz=xyz, cell=cell, mask=mask)

    corner = redistribute(
        state.corner, state.corner.xyz.shape[0], cfg.line_resolution
    )
    surf = redistribute(
        state.surf, state.surf.xyz.shape[0], cfg.plane_resolution
    )
    return state._replace(corner=corner, surf=surf)


def shard_mapping_state(
    state: MappingState, mesh: Mesh, cfg: MappingConfig
) -> MappingState:
    """Place the point stores sharded over the mesh (points dimension) and
    re-assign each point to its owner device by dedup-voxel hash."""
    state = redistribute_state(state, mesh.shape[AXIS], cfg)

    shard_pts = NamedSharding(mesh, P(AXIS))
    shard_pts2 = NamedSharding(mesh, P(AXIS, None))
    repl = NamedSharding(mesh, P())

    def place(store: MapStore) -> MapStore:
        return MapStore(
            xyz=jax.device_put(store.xyz, shard_pts2),
            cell=jax.device_put(store.cell, shard_pts),
            mask=jax.device_put(store.mask, shard_pts),
        )

    return MappingState(
        corner=place(state.corner),
        surf=place(state.surf),
        cen=jax.device_put(state.cen, repl),
        q_wm=jax.device_put(state.q_wm, repl),
        t_wm=jax.device_put(state.t_wm, repl),
        frame=jax.device_put(state.frame, repl),
    )


def _gathered_live_map(local_xyz, local_mask, n: int):
    """All_gather every shard's local-map buffer and re-compact the result
    to one global live prefix, so the tiled k-NN's count-aware skip sees a
    single live range.

    Payload is the 5×5×3 LOCAL neighbourhood only (bounded by
    local_*_capacity — a few hundred KB), never the map stores.  Each
    shard's buffer is already live-prefix-compacted by _gather_local, so
    at n=1 the gather is an identity and the re-compaction is skipped.
    """
    if n == 1:
        cnt = jnp.sum(local_mask.astype(jnp.int32))
        return local_xyz, local_mask, cnt
    cap_shard = local_xyz.shape[0]
    cap = cap_shard * n
    g_xyz = jax.lax.all_gather(local_xyz, AXIS).reshape(cap, 3)
    g_mask = jax.lax.all_gather(local_mask, AXIS).reshape(cap)
    m_c, xyz_c = compact_rows(g_mask, cap, g_xyz)
    return xyz_c, m_c, jnp.sum(g_mask.astype(jnp.int32))


def _merged_knn_sliced(p_sel, local_xyz, local_mask, cfg: MappingConfig, n: int):
    """Exact k-NN for THIS device's Q/n query slice against the
    all-gathered live local map.

    This replaces the r3 candidate-exchange design (per-shard top-k over
    the FULL query set + all_to_all + sliced merge).  That design's
    per-device cost was Q × ceil(live_shard/tile)·tile — and because the
    live 5×5×3 neighbourhood is routinely far smaller than one knn tile,
    every device paid the same one-tile Q×tile floor regardless of n:
    measured 59.8/114/216 ms at n=1/2/4 on the pinned proxy
    (diag_strong.py) — the exact strong-axis collapse a review
    flagged.  Gathering refs instead of exchanging candidates makes the
    per-device cost (Q/n) × ceil(live_total/tile)·tile: the same total
    distance work, exact 1/n scaling, and no (n·k)-candidate merge at
    all.  The gather payload is the live local neighbourhood (≤
    local_*_capacity points), not the map, and the result is the global
    top-k exactly (values identical to the old merge up to distance
    ties)."""
    xyz_c, m_c, cnt = _gathered_live_map(local_xyz, local_mask, n)
    q = _slice_for_device(p_sel, n)
    d, idx = knn.knn_tiled(
        q, xyz_c, m_c, k=cfg.knn_k, tile=cfg.knn_tile, ref_count=cnt,
    )
    return d, xyz_c[idx]


def _merged_knn(p_sel, local_xyz, local_mask, cfg: MappingConfig, n: int):
    """Full-query-set variant for consumers that need every query's
    neighbours on every device (the scan-to-map vote): compute the sliced
    k-NN, then all_gather the (Q/n, k) results — slice-major order IS
    query order, so the concatenation is exactly the full answer."""
    d_d, near_d = _merged_knn_sliced(p_sel, local_xyz, local_mask, cfg, n)
    if n == 1:
        return d_d, near_d
    Q = p_sel.shape[0]
    d = jax.lax.all_gather(d_d, AXIS).reshape(Q, d_d.shape[-1])
    near = jax.lax.all_gather(near_d, AXIS).reshape(Q, d_d.shape[-1], 3)
    return d, near


def _slice_for_device(x, n):
    i = jax.lax.axis_index(AXIS)
    size = x.shape[0] // n
    return jax.lax.dynamic_slice_in_dim(x, i * size, size, axis=0)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def sharded_mapping_step(
    state: MappingState,
    corner_last: PointCloud,
    surf_last: PointCloud,
    q_odom: jnp.ndarray,
    t_odom: jnp.ndarray,
    cfg: MappingConfig,
    mesh: Mesh,
) -> Tuple[MappingState, MappingOutput]:
    """Mapping step with cell-hash-sharded map stores.

    Identical semantics to models.mapping.mapping_step up to three
    gated divergence sources: k-NN tie-breaking, dedup slot assignment,
    and — in vote mode — vote-region membership: the gathered stack is
    owner-grouped (device-major) rather than globally voxel-key-sorted,
    and graphvote chunks the query set by contiguous index ranges, so
    hash-interleaved points land in different vote regions than the
    single-chip path (all three are bounded by test_sharded's gates).
    The map never leaves its shard — only (Q, k) candidate sets and 6×6
    normal equations cross the interconnect.
    """
    n = mesh.shape[AXIS]
    for name, cap in (
        ("stack_corner_capacity", cfg.stack_corner_capacity),
        ("stack_surf_capacity", cfg.stack_surf_capacity),
        ("map_corner_capacity", cfg.map_corner_capacity),
        ("map_surf_capacity", cfg.map_surf_capacity),
        ("local_corner_capacity", cfg.local_corner_capacity),
        ("local_surf_capacity", cfg.local_surf_capacity),
    ):
        if cap % n:
            raise ValueError(
                f"MappingConfig.{name}={cap} must be divisible by the "
                f"mesh size {n} (per-device query slices and the "
                f"all_to_all candidate exchange split it evenly)"
            )

    store_specs = MapStore(xyz=P(AXIS, None), cell=P(AXIS), mask=P(AXIS))
    state_specs = MappingState(
        corner=store_specs, surf=store_specs, cen=P(), q_wm=P(), t_wm=P(),
        frame=P(),
    )
    cloud_spec = PointCloud(xyz=P(), rel=P(), mask=P())
    out_specs = (
        state_specs,
        MappingOutput(
            q_w=P(), t_w=P(), corner_factors=P(), surf_factors=P(),
            map_corner_points=P(), map_surf_points=P(), local_overflow=P(),
            stack_overflow=P(),
        ),
    )

    def body(state, corner_last, surf_last, q_odom, t_odom):
        q_w = quat.quat_normalize(quat.quat_multiply(state.q_wm, q_odom))
        t_w = quat.quat_rotate(state.q_wm, t_odom) + state.t_wm

        corner_store, surf_store, cen, center = _recenter(state, t_w, cfg)

        # the hash-redistributed shard store is NOT cell-ordered —
        # keep the argsort path (see _gather_local docstring)
        local_c_xyz, local_c_mask, ovf_c = _gather_local(
            corner_store, center, cfg, cfg.local_corner_capacity // n,
            cell_ordered=False,
        )
        local_s_xyz, local_s_mask, ovf_s = _gather_local(
            surf_store, center, cfg, cfg.local_surf_capacity // n,
            cell_ordered=False,
        )

        # Owner-sharded stack downsample.  The dedup-voxel partition by
        # sensor-frame voxel hash is owner-disjoint (owner is a function
        # of the voxel's lattice cell at the SAME leaf the dedup keys
        # on), so each device downsampling only its owned input points
        # produces exactly the global downsample split by owner —
        # bitwise, since stable compaction preserves in-voxel
        # accumulation order.  This was the step's largest replicated
        # cost (every device ran the identical full-input sort); now
        # each sorts ~1/n of the input.  Hash skew drops points on BOTH
        # sides of the shard buffers — input points past the 2× compact
        # slack AND distinct owned voxels past out_cap_shard — and both
        # drops feed the returned overflow counter (ADVICE r4: the
        # output-side drop used to be silent).
        def owner_stack(cloud: PointCloud, leaf, out_cap_shard,
                        in_cap_shard):
            dev = jax.lax.axis_index(AXIS)
            mine = cloud.mask & (voxel_owner(cloud.xyz, leaf, n) == dev)
            m_c, xyz_c, rel_c = compact_rows(
                mine, in_cap_shard, cloud.xyz, cloud.rel
            )
            ovf = jnp.maximum(
                jnp.sum(mine.astype(jnp.int32)) - in_cap_shard, 0
            )
            sx, sr, sm, _, n_vox = voxel_downsample(
                xyz_c, rel_c, m_c, leaf, out_cap_shard, with_count=True
            )
            ovf = ovf + jnp.maximum(n_vox - out_cap_shard, 0)
            return sx, sm, ovf

        in_c = (corner_last.xyz.shape[0] if n == 1
                else corner_last.xyz.shape[0] // n * 2)
        in_s = (surf_last.xyz.shape[0] if n == 1
                else surf_last.xyz.shape[0] // n * 2)
        stack_c_xyz_d, stack_c_mask_d, ovf_sc = owner_stack(
            corner_last, cfg.line_resolution,
            cfg.stack_corner_capacity // n, in_c,
        )
        stack_s_xyz_d, stack_s_mask_d, ovf_ss = owner_stack(
            surf_last, cfg.plane_resolution,
            cfg.stack_surf_capacity // n, in_s,
        )
        # stack-shard skew (ovf_sc/ovf_ss) is reported on its own output
        # field, NOT folded into local_overflow: the two counters demand
        # different operator responses (grow local_*_capacity vs
        # rebalance/grow the stack shards) — ADVICE r4.
        ovf_stack = ovf_sc + ovf_ss

        # global query set, owner-grouped: slice i IS device i's points,
        # so the sliced all_to_all candidate merge hands every device
        # the neighbour sets of exactly its own stack
        def gathered(x_d, cap):
            g = jax.lax.all_gather(x_d, AXIS)
            return g.reshape((cap,) + x_d.shape[1:])

        stack_c_xyz = gathered(stack_c_xyz_d, cfg.stack_corner_capacity)
        stack_c_mask = gathered(stack_c_mask_d, cfg.stack_corner_capacity)
        stack_s_xyz = gathered(stack_s_xyz_d, cfg.stack_surf_capacity)
        stack_s_mask = gathered(stack_s_mask_d, cfg.stack_surf_capacity)

        n_local_c = jax.lax.psum(
            jnp.sum(local_c_mask.astype(jnp.int32)), AXIS
        )
        n_local_s = jax.lax.psum(
            jnp.sum(local_s_mask.astype(jnp.int32)), AXIS
        )
        big_enough = (n_local_c > cfg.min_corner_map_points) & (
            n_local_s > cfg.min_surf_map_points
        )

        n_cf = jnp.int32(0)
        n_sf = jnp.int32(0)
        for _ in range(cfg.outer_iterations):
            # every device builds factors for its own query slice; the
            # normal equations are psum-reduced inside lm_solve.  Corners
            # never feed the vote, so their candidate merge is sliced
            # (all_to_all) — each device merges only its own queries.
            p_sel_c = quat.quat_rotate(q_w[None, :], stack_c_xyz) + t_w[None, :]
            d_c, near_c = _merged_knn_sliced(
                p_sel_c, local_c_xyz, local_c_mask, cfg, n
            )
            ef = line_fit_factors(
                stack_c_xyz_d,
                stack_c_mask_d & big_enough,
                d_c,
                near_c,
                cfg,
            )
            p_sel_s = quat.quat_rotate(q_w[None, :], stack_s_xyz) + t_w[None, :]
            if cfg.vote_mode == "off":
                # no vote: sliced merge for the surf queries too
                d_s, near_s = _merged_knn_sliced(
                    p_sel_s, local_s_xyz, local_s_mask, cfg, n
                )
                pf = plane_fit_factors(
                    stack_s_xyz_d,
                    stack_s_mask_d & big_enough,
                    d_s,
                    near_s,
                    cfg,
                )
            else:
                # vote path: the scan-to-map vote (laserMapping.cpp:
                # 2057-2072) chunks over the FULL query set, so the
                # candidate merge stays replicated (all_gather) and the
                # plane fit runs over the full stack, then slices
                d_s, near_s = _merged_knn(
                    p_sel_s, local_s_xyz, local_s_mask, cfg, n
                )
                pf_full = plane_fit_factors(
                    stack_s_xyz, stack_s_mask & big_enough, d_s, near_s, cfg
                )
                use_vote = state.frame > cfg.vote_start_frame
                chunk_cap = (
                    cfg.stack_surf_capacity // cfg.vote_regions
                    + cfg.vote_regions
                )
                sel, w = graphvote.run_vote(
                    cfg.vote_mode, stack_s_xyz, jnp.mean(near_s, axis=1),
                    pf_full.mask,
                    n_regions=cfg.vote_regions, chunk_capacity=chunk_cap,
                    score_threshold=cfg.vote_score_threshold,
                    resolution=cfg.vote_resolution,
                    selected_ratio=cfg.vote_selected_ratio,
                    low_vote_count=cfg.vote_low_vote_count,
                    low_vote_weight=cfg.vote_low_vote_weight,
                    high_vote_weight=cfg.vote_high_vote_weight,
                )
                pf_full = pf_full._replace(
                    mask=pf_full.mask & jnp.where(use_vote, sel, True),
                    weight=jnp.where(
                        use_vote & cfg.vote_apply_weights, w, pf_full.weight
                    ),
                )
                pf = jax.tree_util.tree_map(
                    lambda x: _slice_for_device(x, n), pf_full
                )
            q_w, t_w, _cost = lm_solve(
                q_w, t_w, FactorSet(edge=ef, plane_norm=pf),
                n_iterations=cfg.inner_iterations,
                huber_delta=cfg.huber_delta,
                axis_name=AXIS,
            )
            n_cf = jax.lax.psum(jnp.sum(ef.mask.astype(jnp.int32)), AXIS)
            n_sf = jax.lax.psum(jnp.sum(pf.mask.astype(jnp.int32)), AXIS)

        q_wm = quat.quat_normalize(
            quat.quat_multiply(q_w, quat.quat_inverse(q_odom))
        )
        t_wm = t_w - quat.quat_rotate(q_wm, t_odom)

        # merge registered stacks: each device keeps only the cells it owns
        def merge(store: MapStore, stack_xyz, stack_mask, leaf, capacity):
            reg = quat.quat_rotate(q_w[None, :], stack_xyz) + t_w[None, :]
            ijk = _cube_of(reg, cen, cfg)
            dims = jnp.asarray(
                [cfg.cube_width, cfg.cube_height, cfg.cube_depth], jnp.int32
            )
            inside = jnp.all((ijk >= 0) & (ijk < dims[None, :]), axis=-1)
            cell = jnp.where(inside, _cell_linear(ijk, cfg), 0).astype(jnp.int32)
            # reg is replicated (stack + pose are), so every device
            # computes identical owners and exactly one keeps each point
            mine = voxel_owner(reg, leaf, n) == jax.lax.axis_index(AXIS)
            new_mask = stack_mask & inside & mine
            all_xyz = jnp.concatenate([store.xyz, reg], axis=0)
            all_cell = jnp.concatenate([store.cell, cell], axis=0)
            all_mask = jnp.concatenate([store.mask, new_mask], axis=0)
            xyz, _, mask, out_cell = voxel_downsample(
                all_xyz, jnp.zeros(all_xyz.shape[0], jnp.float32), all_mask,
                leaf, capacity // n, extra_key=all_cell,
            )
            return MapStore(xyz=xyz, cell=out_cell, mask=mask)

        corner_store = merge(
            corner_store, stack_c_xyz, stack_c_mask,
            cfg.line_resolution, cfg.map_corner_capacity,
        )
        surf_store = merge(
            surf_store, stack_s_xyz, stack_s_mask,
            cfg.plane_resolution, cfg.map_surf_capacity,
        )

        new_state = MappingState(
            corner=corner_store, surf=surf_store, cen=cen,
            q_wm=q_wm, t_wm=t_wm, frame=state.frame + 1,
        )
        out = MappingOutput(
            q_w=q_w, t_w=t_w,
            corner_factors=n_cf, surf_factors=n_sf,
            map_corner_points=jax.lax.psum(
                jnp.sum(corner_store.mask.astype(jnp.int32)), AXIS
            ),
            map_surf_points=jax.lax.psum(
                jnp.sum(surf_store.mask.astype(jnp.int32)), AXIS
            ),
            local_overflow=jax.lax.psum(ovf_c + ovf_s, AXIS),
            stack_overflow=jax.lax.psum(ovf_stack, AXIS),
        )
        return new_state, out

    shard_fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(state_specs, cloud_spec, cloud_spec, P(), P()),
        out_specs=out_specs,
        check_vma=False,
    )
    return shard_fn(state, corner_last, surf_last, q_odom, t_odom)
