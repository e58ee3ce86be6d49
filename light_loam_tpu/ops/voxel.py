"""Voxel-grid centroid downsampling with static shapes.

Static-shape replacement for ``pcl::VoxelGrid`` (used by the reference for the
less-flat cloud at 0.2 m leaf, src/scanRegistration.cpp:370-376, and for the
mapping input stacks / cube cells, src/laserMapping.cpp:1814-1822,2154-2168).

Implementation: voxel keys -> lexicographic sort -> segment mean.  Unlike
PCL, the voxel lattice is anchored at the world origin rather than at the
cloud's min corner; this changes which boundary a point lands on by a
sub-leaf shift but is deterministic and jit-stable.  Output order is sorted
by voxel key.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
from jax import lax


# Plain Python ints: module-level jnp constants would be materialized on the
# default backend at import time and then baked into traces as device
# constants, which some PJRT plugins reject.
_SENTINEL = 2**31 - 1
# Voxel indices are biased into [0, 2**15) per axis; supports |coord| up to
# ~3200 m at a 0.2 m leaf.
_BIAS = 1 << 14
_AXIS_RANGE = 1 << 15


def voxel_keys(
    xyz: jnp.ndarray,
    mask: jnp.ndarray,
    leaf: float,
    extra_key: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Return (major, minor) int32 key pair identifying each point's voxel.

    ``extra_key`` (e.g. a cube-cell id) separates otherwise-identical
    lattices so multiple cells can be filtered in one fused call.
    """
    ijk = jnp.floor(xyz / leaf).astype(jnp.int32) + _BIAS
    ijk = jnp.clip(ijk, 0, _AXIS_RANGE - 1)
    minor = ijk[..., 0] * _AXIS_RANGE + ijk[..., 1]
    major = ijk[..., 2]
    if extra_key is not None:
        major = major + extra_key.astype(jnp.int32) * _AXIS_RANGE
    major = jnp.where(mask, major, _SENTINEL)
    minor = jnp.where(mask, minor, _SENTINEL)
    return major, minor


def voxel_downsample(
    xyz: jnp.ndarray,
    rel: jnp.ndarray,
    mask: jnp.ndarray,
    leaf: float,
    capacity: int,
    extra_key: Optional[jnp.ndarray] = None,
    with_count: bool = False,
):
    """Centroid-downsample a masked cloud.

    Returns (xyz_out, rel_out, mask_out, extra_out) with static shapes
    (capacity, 3)/(capacity,); ``extra_out`` carries each surviving voxel's
    ``extra_key`` (or zeros when not supplied).  Voxels beyond ``capacity``
    are dropped (callers size capacity so this does not happen in practice;
    pass ``with_count=True`` to get a fifth return — the total number of
    distinct live voxels BEFORE the capacity clip — so callers that shard
    the output capacity can surface the drop instead of losing it
    silently)."""
    n = xyz.shape[0]
    major, minor = voxel_keys(xyz, mask, leaf, extra_key)

    # Stable lexicographic sort by (major, minor) in ONE variadic sort —
    # identical order to stable-argsort(minor) followed by
    # stable-argsort(major), at half the sort passes and one less gather.
    # The sort RETURNS the sorted keys (no re-gather), and the payload
    # rides as ONE wide-row gather: packing [xyz, rel, mask] collapses
    # three n-item gathers into one.
    iota = jnp.arange(n, dtype=jnp.int32)
    major_s, minor_s, order = lax.sort(
        (major, minor, iota), num_keys=2, is_stable=True)

    packed = jnp.concatenate(
        [xyz, rel[:, None], mask.astype(xyz.dtype)[:, None]], axis=1)
    ps = jnp.take(packed, order, axis=0, mode="clip")      # (n, 5)
    xyz_s = ps[:, :3]
    rel_s = ps[:, 3]
    valid_s = ps[:, 4] > 0.5

    # Head of each voxel segment.
    prev_major = jnp.concatenate([jnp.full((1,), -1, jnp.int32), major_s[:-1]])
    prev_minor = jnp.concatenate([jnp.full((1,), -1, jnp.int32), minor_s[:-1]])
    head = ((major_s != prev_major) | (minor_s != prev_minor)) & valid_s
    seg = jnp.cumsum(head.astype(jnp.int32)) - 1
    seg = jnp.where(valid_s, jnp.clip(seg, 0, capacity), capacity)

    # one 5-wide row scatter instead of three: columns
    # [xyz·valid, rel·valid, valid]
    ones = valid_s.astype(xyz.dtype)
    acc = jnp.zeros((capacity + 1, 5), xyz.dtype).at[seg].add(
        jnp.concatenate(
            [jnp.where(valid_s[:, None], xyz_s, 0.0),
             jnp.where(valid_s, rel_s, 0.0)[:, None],
             ones[:, None]], axis=1)
    )
    sx = acc[:, :3]
    sr = acc[:, 3]
    cnt = acc[:, 4]
    if extra_key is not None:
        extra_s = extra_key[order]
        ex = jnp.zeros((capacity + 1,), jnp.int32).at[seg].max(
            jnp.where(valid_s, extra_s, 0)
        )
        extra_out = ex[:capacity]
    else:
        extra_out = jnp.zeros((capacity,), jnp.int32)

    cnt_out = cnt[:capacity]
    mask_out = cnt_out > 0
    denom = jnp.maximum(cnt_out, 1.0)
    xyz_out = sx[:capacity] / denom[:, None]
    rel_out = sr[:capacity] / denom
    if with_count:
        n_voxels = jnp.sum(head.astype(jnp.int32))
        return xyz_out, rel_out, mask_out, extra_out, n_voxels
    return xyz_out, rel_out, mask_out, extra_out


def voxel_downsample_rings(
    xyz: jnp.ndarray,
    rel: jnp.ndarray,
    mask: jnp.ndarray,
    leaf: float,
    ring_capacity: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-ring voxel downsample into a ring-slotted grid.

    Inputs are range-image grids (R, H, 3)/(R, H); output is
    (R, ring_capacity, ...) where ring r's surviving voxels occupy the
    row-r prefix.  Flattened row-major this gives the ring-major
    *grid layout* the single-pass correspondence search
    (ops.knn.surf_correspondences_grid) exploits: point i belongs to ring
    i // ring_capacity, so same-ring / nearby-ring candidate sets are
    contiguous static slices instead of data-dependent membership tests.

    Semantics match the reference's per-ring pcl::VoxelGrid loop
    (src/scanRegistration.cpp:361-376) exactly while a ring has at most
    ``ring_capacity`` surviving voxels.  Overflowing rings (dense
    close-range rings on HDL-64 scans) are decimated by a uniform stride
    over the key-sorted (spatially ordered) voxel list — an unbiased
    density bound, unlike capacity truncation which would drop a
    contiguous spatial arc.
    """
    import jax

    H = xyz.shape[1]
    C = ring_capacity

    def per_ring(x, r, m):
        vx, vr, vm, _ = voxel_downsample(x, r, m, leaf, H)
        n = jnp.sum(vm.astype(jnp.int32))
        j = jnp.arange(C, dtype=jnp.int32)
        src = jnp.where(n > C, (j * n) // C, j)
        keep = j < jnp.minimum(n, C)
        # one 4-wide row gather for [xyz, rel] (gather cost is per item)
        out = jnp.take(jnp.concatenate([vx, vr[:, None]], axis=1),
                       src, axis=0, mode="clip")
        return out[:, :3], out[:, 3], keep

    return jax.vmap(per_ring)(xyz, rel, mask)


def _batched_searchsorted(a: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Per-row side='left' binary search: a (R, H) row-nondecreasing,
    q (R, C); returns (R, C) insertion positions."""
    R, H = a.shape
    nbits = max(1, H.bit_length() + 1)
    lo = jnp.zeros(q.shape, jnp.int32)
    hi = jnp.full(q.shape, H, jnp.int32)
    rows = jnp.arange(R, dtype=jnp.int32)[:, None]

    def body(_, carry):
        lo, hi = carry
        mid = jnp.minimum((lo + hi) // 2, H - 1)
        less = a[rows, mid] < q
        open_ = lo < hi
        return (
            jnp.where(open_ & less, mid + 1, lo),
            jnp.where(open_ & ~less, mid, hi),
        )

    lo, hi = lax.fori_loop(0, nbits, body, (lo, hi))
    return lo


def voxel_downsample_rings_runs(
    xyz: jnp.ndarray,
    rel: jnp.ndarray,
    mask: jnp.ndarray,
    leaf: float,
    ring_capacity: int,
    max_run: int = 32,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Sort-free per-ring voxel downsample: run-length merge along the
    azimuth axis (ScanConfig.lessflat_mode="runs").

    A laser ring is a 1-D space curve, so points sharing a 0.2 m voxel
    are almost always azimuth-consecutive; merging maximal same-voxel
    runs reproduces the per-ring VoxelGrid up to (a) voxels the ring
    re-enters later (one output centroid per visit — a few % denser
    cloud) and (b) runs longer than ``max_run`` slots including masked
    gaps (tail points dropped from the centroid; at HDL-64 geometry a
    0.2 m voxel spans ≲13 azimuth slots at the 5 m minimum range).
    Masked slots are transparent: a run continues across them.

    Same output layout as voxel_downsample_rings — (R, ring_capacity)
    ring-slotted, uniform-stride decimated when a ring overflows — but
    rows are azimuth-ordered (still spatially ordered along the ring)
    instead of key-ordered.  Everything is cumsum / gather / elementwise:
    no sort and no scatter, the two ops of the exact mode.
    """
    R, H = mask.shape
    C = ring_capacity
    major, minor = voxel_keys(xyz, mask, leaf)

    # previous VALID slot per position (exclusive cummax of valid iota)
    iota_h = jnp.broadcast_to(jnp.arange(H, dtype=jnp.int32)[None, :], (R, H))
    vidx = jnp.where(mask, iota_h, -1)
    prev = jnp.concatenate(
        [jnp.full((R, 1), -1, jnp.int32),
         lax.cummax(vidx, axis=1)[:, :-1]], axis=1
    )
    rows = jnp.arange(R, dtype=jnp.int32)[:, None]
    prev_c = jnp.maximum(prev, 0)
    new_key = (
        (major != major[rows, prev_c]) | (minor != minor[rows, prev_c])
    )
    head = mask & ((prev < 0) | new_key)

    # run ids: nondecreasing along the ring (masked slots alias the
    # previous run, which keeps searchsorted exact: the first slot with
    # seg >= j is run j's head)
    seg = jnp.cumsum(head.astype(jnp.int32), axis=1) - 1
    n_runs = seg[:, -1] + 1  # (R,)

    j = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (R, C))
    n = n_runs[:, None]
    src_run = jnp.where(n > C, (j * n) // C, j)
    keep = j < jnp.minimum(n, C)

    start = _batched_searchsorted(seg, src_run)        # (R, C)
    end = _batched_searchsorted(seg, src_run + 1)      # (R, C)

    # windowed gather-mean over each run
    def accum(k, carry):
        sum_xyz, sum_rel, cnt = carry
        idx = jnp.minimum(start + k, H - 1)
        w = ((start + k) < end) & mask[rows, idx]
        wf = w.astype(xyz.dtype)
        return (
            sum_xyz + wf[..., None] * xyz[rows, idx],
            sum_rel + wf * rel[rows, idx],
            cnt + wf,
        )

    sum_xyz, sum_rel, cnt = lax.fori_loop(
        0, max_run, accum,
        (jnp.zeros((R, C, 3), xyz.dtype), jnp.zeros((R, C), rel.dtype),
         jnp.zeros((R, C), xyz.dtype)),
    )
    denom = jnp.maximum(cnt, 1.0)
    out_xyz = jnp.where(keep[..., None], sum_xyz / denom[..., None], 0.0)
    out_rel = jnp.where(keep, sum_rel / denom, 0.0)
    return out_xyz, out_rel, keep & (cnt > 0)


def compact_rows(
    mask: jnp.ndarray,
    capacity: int,
    *arrays: jnp.ndarray,
) -> Tuple[jnp.ndarray, ...]:
    """O(N) stable mask compaction by prefix-sum + scatter — no sort.

    Moves rows where ``mask`` is True to the output prefix in input
    order; rows past ``capacity`` are dropped from the high end.  On the
    live prefix (the first ``min(count, capacity)`` rows) and on
    ``out_mask`` the result is bitwise identical to gathering with
    ``argsort(where(mask, 0, 1), stable=True)[:capacity]``; dead rows
    past the prefix are ZEROED here, where the argsort gather would
    carry arbitrary surviving input rows (all consumers mask, and zeros
    are the safer filler).  Cost is a fraction of the sort's (one 1-word
    index scatter + one row gather instead of ~log2(N) sort passes — the
    sort ran ~8×/frame).

    Returns ``(out_mask, *compacted_arrays)``; ``out_mask[i]`` is True
    for the first ``min(count, capacity)`` output rows.
    """
    n = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask & (pos < capacity), pos, capacity)
    # scatter only the 1-word source indices, then gather rows once
    src = jnp.zeros((capacity + 1,), jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32)
    )[:capacity]
    count = pos[-1] + 1
    out_mask = jnp.arange(capacity, dtype=jnp.int32) < count

    # one packed wide-row gather for ALL payload arrays: 32-bit payloads
    # ride as their f32 bit patterns (small ints are denormals) and are
    # bitcast straight back — bit-exact (tests/test_voxel.py; on the GPU,
    # chip_smoke.py).
    def to_cols(a):
        col = a.reshape(n, -1)
        return (lax.bitcast_convert_type(col, jnp.float32)
                if a.dtype != jnp.float32 else col)

    packable = all(
        a.dtype in (jnp.float32, jnp.int32, jnp.uint32) for a in arrays
    ) and len(arrays) > 1
    if packable:
        widths = []
        for a in arrays:
            w = 1
            for d in a.shape[1:]:
                w *= int(d)
            widths.append(w)
        packed = jnp.concatenate([to_cols(a) for a in arrays], axis=1)
        got = jnp.take(packed, src, axis=0, mode="clip")
        outs, off = [], 0
        for a, w in zip(arrays, widths):
            col = got[:, off:off + w]
            off += w
            if a.dtype != jnp.float32:
                col = lax.bitcast_convert_type(col, a.dtype)
            out = col.reshape((capacity,) + a.shape[1:])
            mm = out_mask.reshape((capacity,) + (1,) * (a.ndim - 1))
            outs.append(jnp.where(mm, out, jnp.zeros((), a.dtype)))
        return (out_mask, *outs)

    outs = []
    for a in arrays:
        out = a[src]
        mm = out_mask.reshape((capacity,) + (1,) * (a.ndim - 1))
        outs.append(jnp.where(mm, out, jnp.zeros((), a.dtype)))
    return (out_mask, *outs)


def compact(
    values: jnp.ndarray,
    mask: jnp.ndarray,
    capacity: int,
    keys: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gather masked rows to the front, optionally ordered by ``keys``.

    Returns (gather_indices (capacity,), out_mask (capacity,), order) where
    ``values[gather_indices]`` is the compacted array.  ``values`` is only
    used for its leading dimension.
    """
    n = values.shape[0]
    if keys is None:
        keys = jnp.arange(n, dtype=jnp.int32)
    sort_key = jnp.where(mask, keys, jnp.int32(2**31 - 1))
    order = jnp.argsort(sort_key, stable=True)
    idx = order[:capacity]
    count = jnp.sum(mask.astype(jnp.int32))
    out_mask = jnp.arange(capacity, dtype=jnp.int32) < count
    return idx, out_mask, order
