"""Sorted-store merge: O(new·log N + N) map-store insertion without
re-sorting the whole store.

The map stores (models/mapping.py MapStore) hold ~131k/262k points and
receive ~2k/8k new stack points per frame.  The original merge
(`_merge_into_store`) concatenated store+new and re-ran the full
voxel-dedup sort every frame — a 270k+ three-operand stable sort.
This module replaces it with dense passes.

Invariant exploited: every merge output is lex-sorted by voxel key
(major, minor) with dead rows (key = sentinel) at the tail — that is
exactly what `voxel_downsample`'s sort-by-key produces, and the fast
path below preserves it.  Rows only die at grid recentering, and
recenter frames fall back to the full re-sort merge (models/mapping.py
`_merge_into_store` takes that branch under `lax.cond`), so between
recenters the store is always a sorted live prefix + sentinel tail.

Fast-path algorithm per frame:
  1. voxel-key and sort the ~8k NEW points only (small sort);
  2. segment-reduce them to per-voxel (sum, count) — same head/cumsum/
     scatter-add scheme as voxel_downsample;
  3. lex binary-search each unique new voxel into the sorted store
     (18 iterations of two small gathers);
  4. matched voxels: scatter-add into the store row and recompute the
     running centroid ((c_old·w + Σnew)/(w + n) — identical arithmetic
     to the reference's per-cell pcl::VoxelGrid re-filter,
     laserMapping.cpp:2154-2168, up to float association);
  5. fresh voxels: insertion positions p + rank give each row's final
     slot; the store shifts right by a cumsum of an insert-indicator —
     a gather, not a sort.  Overflow drops the highest keys, matching
     the full path's capacity truncation.

Everything is static-shape, vmap-safe, and exact: output keys/cells/
masks equal the full re-sort merge bitwise, centroids up to float
reassociation (tests/test_sorted_store.py).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import lax

from light_loam_tpu.ops.voxel import voxel_keys

_SENTINEL = 2**31 - 1


def searchsorted2(
    a_major: jnp.ndarray,
    a_minor: jnp.ndarray,
    q_major: jnp.ndarray,
    q_minor: jnp.ndarray,
) -> jnp.ndarray:
    """Vectorized side='left' binary search over a lexicographically
    sorted (major, minor) int32 key-pair array.

    jnp.searchsorted cannot compare two-part keys and the pair does not
    fit one int32 (x64 is disabled).  A plain binary search probes both
    halves of the key as ONE 2-wide row gather per step — half the
    serial gather chain of separate major/minor probes.
    """
    n = a_major.shape[0]
    a_pair = jnp.stack([a_major, a_minor], axis=1)  # (n, 2)
    # the search space is [0, n] — n+1 values; one extra halving over
    # bit_length(n-1) guarantees convergence for every n
    nbits = max(1, n.bit_length() + 1)
    lo = jnp.zeros(q_major.shape, jnp.int32)
    hi = jnp.full(q_major.shape, n, jnp.int32)

    def body(_, carry):
        lo, hi = carry
        mid = jnp.minimum((lo + hi) // 2, n - 1)
        pr = jnp.take(a_pair, mid, axis=0, mode="clip")  # (m, 2), 1 gather
        m1, m2 = pr[:, 0], pr[:, 1]
        less = (m1 < q_major) | ((m1 == q_major) & (m2 < q_minor))
        # fixed trip count: freeze converged lanes so lo never passes hi
        open_ = lo < hi
        return (
            jnp.where(open_ & less, mid + 1, lo),
            jnp.where(open_ & ~less, mid, hi),
        )

    lo, hi = lax.fori_loop(0, nbits, body, (lo, hi))
    return lo


def voxel_segment_reduce(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    leaf: float,
    cell: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sort a small cloud by voxel key and reduce to per-voxel sums.

    Returns (kmaj (M,), kmin (M,), sum_xyz (M,3), cnt (M,), cell (M,)):
    the unique voxels occupy a key-sorted dense prefix (cnt > 0); the
    arithmetic matches voxel_downsample's segment accumulation exactly.
    """
    m = xyz.shape[0]
    kmaj, kmin = voxel_keys(xyz, mask, leaf, extra_key=cell)
    iota = jnp.arange(m, dtype=jnp.int32)
    kmaj_s, kmin_s, order = lax.sort((kmaj, kmin, iota), num_keys=2,
                                     is_stable=True)
    xyz_s = xyz[order]
    cell_s = cell[order]
    valid_s = kmaj_s != _SENTINEL

    prev_maj = jnp.concatenate([jnp.full((1,), -1, jnp.int32), kmaj_s[:-1]])
    prev_min = jnp.concatenate([jnp.full((1,), -1, jnp.int32), kmin_s[:-1]])
    head = ((kmaj_s != prev_maj) | (kmin_s != prev_min)) & valid_s
    seg = jnp.cumsum(head.astype(jnp.int32)) - 1
    seg = jnp.where(valid_s, jnp.clip(seg, 0, m), m)

    cnt = jnp.zeros((m + 1,), jnp.float32).at[seg].add(
        valid_s.astype(jnp.float32)
    )
    sum_xyz = jnp.zeros((m + 1, 3), xyz.dtype).at[seg].add(
        jnp.where(valid_s[:, None], xyz_s, 0.0)
    )
    # exactly one head per segment, so .add writes each key/cell once
    ukmaj = jnp.zeros((m + 1,), jnp.int32).at[seg].add(
        jnp.where(head, kmaj_s, 0)
    )
    ukmin = jnp.zeros((m + 1,), jnp.int32).at[seg].add(
        jnp.where(head, kmin_s, 0)
    )
    ucell = jnp.zeros((m + 1,), jnp.int32).at[seg].add(
        jnp.where(head, cell_s, 0)
    )
    return ukmaj[:m], ukmin[:m], sum_xyz[:m], cnt[:m], ucell[:m]


def merge_sorted(
    store_xyz: jnp.ndarray,
    store_cell: jnp.ndarray,
    store_mask: jnp.ndarray,
    new_xyz: jnp.ndarray,
    new_cell: jnp.ndarray,
    new_mask: jnp.ndarray,
    leaf: float,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Merge new points into a key-sorted store (see module docstring).

    The store MUST be lex-sorted by voxel_keys(xyz, mask, leaf, cell)
    with dead rows at the tail; the output preserves that invariant.
    Returns (xyz, cell, mask) with the store's static shape.
    """
    n = store_xyz.shape[0]
    m = new_xyz.shape[0]
    smaj, smin = voxel_keys(store_xyz, store_mask, leaf,
                            extra_key=store_cell)

    ukmaj, ukmin, usum, ucnt, ucell = voxel_segment_reduce(
        new_xyz, new_mask, leaf, new_cell
    )
    umask = ucnt > 0

    p = searchsorted2(smaj, smin, ukmaj, ukmin)
    pm = jnp.minimum(p, n - 1)
    match = (
        umask & (p < n) & (smaj[pm] == ukmaj) & (smin[pm] == ukmin)
    )

    # matched voxels: running centroid (c_old·w + Σnew)/(w + cnt);
    # untouched live rows divide by exactly 1 and stay bitwise intact
    tgt = jnp.where(match, pm, n)
    add_cnt = jnp.zeros((n + 1,), jnp.float32).at[tgt].add(ucnt)[:n]
    add_sum = jnp.zeros((n + 1, 3), store_xyz.dtype).at[tgt].add(usum)[:n]
    w = store_mask.astype(jnp.float32)
    denom = jnp.maximum(w + add_cnt, 1.0)
    sxyz = (store_xyz * w[:, None] + add_sum) / denom[:, None]
    smask = store_mask | (add_cnt > 0)

    # fresh voxels: final slot = insertion position + rank among fresh
    # (strictly increasing, so slots are unique); the store shifts right
    # by the cumulative insert count — a gather, never a sort
    fresh = umask & ~match
    frank = jnp.cumsum(fresh.astype(jnp.int32)) - 1
    fpos = p + frank
    fp = jnp.where(fresh & (fpos < n), fpos, n)
    iota_m = jnp.arange(m, dtype=jnp.int32)
    ind = jnp.zeros((n + 1,), jnp.int32).at[fp].add(1)[:n]
    fidx = jnp.zeros((n + 1,), jnp.int32).at[fp].add(
        jnp.where(fresh, iota_m, 0)
    )[:n]
    is_f = ind > 0
    cumf = jnp.cumsum(ind)
    o = jnp.arange(n, dtype=jnp.int32)
    src = jnp.clip(o - cumf, 0, n - 1)

    ucent = usum / jnp.maximum(ucnt, 1.0)[:, None]
    # ONE 5-wide row gather instead of five n-item gathers: packing
    # [xyz, bitcast(cell), mask] and selecting store-shift vs fresh rows
    # through a virtual concat collapses the whole output pass to a
    # single n-item gather.  Bit-exact: the gather only moves bits; cell
    # rides as its f32 bit-pattern (a denormal for small ids) and is
    # bitcast straight back (checked on the GPU by chip_smoke.py).
    pk_store = jnp.concatenate(
        [sxyz,
         lax.bitcast_convert_type(store_cell, jnp.float32)[:, None],
         smask.astype(jnp.float32)[:, None]], axis=1)          # (n, 5)
    pk_new = jnp.concatenate(
        [ucent,
         lax.bitcast_convert_type(ucell, jnp.float32)[:, None],
         jnp.ones((m, 1), jnp.float32)], axis=1)               # (m, 5)
    src_all = jnp.where(is_f, n + fidx, src)
    out = jnp.take(jnp.concatenate([pk_store, pk_new], axis=0),
                   src_all, axis=0, mode="clip")               # (n, 5)
    out_xyz = out[:, :3]
    out_cell = lax.bitcast_convert_type(out[:, 3], jnp.int32)
    out_mask = out[:, 4] > 0.5
    return out_xyz, out_cell, out_mask


def is_key_sorted(xyz, cell, mask, leaf) -> jnp.ndarray:
    """Invariant check (tests): lex-sorted keys, dead rows at the tail."""
    kmaj, kmin = voxel_keys(xyz, mask, leaf, extra_key=cell)
    ok_maj = kmaj[:-1] <= kmaj[1:]
    ok_min = (kmaj[:-1] != kmaj[1:]) | (kmin[:-1] <= kmin[1:])
    return jnp.all(ok_maj & ok_min)
