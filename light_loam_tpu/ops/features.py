"""Feature extraction: ring split, curvature, edge/planar classification.

Data-parallel re-design of the reference's scan registration stage
(src/scanRegistration.cpp:87-428).  The whole stage is one jitted,
static-shape program over an (n_scans, h_max) padded range image:

  * range/NaN filtering is masking, not compaction (ref:58-85,105-110);
  * ring id and sweep-relative time are elementwise math (ref:133-210);
  * the ring-ordered concatenation (ref:216-221) becomes a stable sort
    into the (ring, column) grid;
  * curvature is an 11-tap stencil along each ring (ref:225-235);
  * the greedy per-sector selection with neighbor suppression
    (ref:246-368) is re-expressed as a bounded sequence of masked
    argmax/argmin picks.  Walking a descending-sorted candidate list and
    skipping suppressed entries is equivalent to repeatedly taking the
    extremal *eligible* candidate, because suppression only ever removes
    candidates — so the pick loop has a static trip count
    (2+20 corner / 4 flat picks per sector) instead of a data-dependent
    sort-and-walk.

The sequential semantics that matter are preserved: sectors are processed
in order (suppression leaks across sector boundaries), corner picks happen
before flat picks, and the 4th flat pick skips suppression exactly like
the reference's post-increment break (ref:327-331).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from light_loam_tpu.config import ScanConfig
from light_loam_tpu.core.frame import PointCloud, RangeImage, ScanFeatures
from light_loam_tpu.ops.voxel import voxel_downsample_rings


def _trunc_int(x: jnp.ndarray) -> jnp.ndarray:
    """C-style int() truncation toward zero."""
    return jnp.trunc(x).astype(jnp.int32)


def compute_ring_ids(xyz: jnp.ndarray, mask: jnp.ndarray, cfg: ScanConfig):
    """Vertical angle -> ring id, replicating the three per-sensor formulas
    (src/scanRegistration.cpp:142-169) including C truncation semantics."""
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    angle = jnp.arctan(z / jnp.sqrt(x * x + y * y)) * (180.0 / math.pi)
    if cfg.ring_formula == "bounds" or cfg.n_scans == 64:
        # Linear bound formula — the 64-beam default and the reference's
        # per-dataset override recipe (M2DGR VLP-32C etc.,
        # paramter_configuration_for_benchmarks.txt:19-37).
        factor = (cfg.n_scans - 1) / (cfg.upper_bound_deg - cfg.lower_bound_deg)
        ring = _trunc_int((angle - cfg.lower_bound_deg) * factor + 0.5)
    elif cfg.n_scans == 16:
        ring = _trunc_int((angle + 15.0) / 2.0 + 0.5)
    elif cfg.n_scans == 32:
        ring = _trunc_int((angle + 92.0 / 3.0) * 3.0 / 4.0)
    else:
        raise ValueError(f"unsupported n_scans={cfg.n_scans}")
    ok = mask & (ring >= 0) & (ring < cfg.n_scans)
    return ring, ok


def compute_rel_time(
    xyz: jnp.ndarray, in_mask: jnp.ndarray, ring_ok: jnp.ndarray
) -> jnp.ndarray:
    """Sweep-relative time in [0, 1] via the start/end azimuth unwrap with
    the sequential `halfPassed` flip (src/scanRegistration.cpp:114-207),
    vectorized as an exclusive prefix-OR of the flip trigger."""
    n = xyz.shape[0]
    ori_raw = -jnp.arctan2(xyz[:, 1], xyz[:, 0])

    idx = jnp.arange(n, dtype=jnp.int32)
    first = jnp.argmax(in_mask.astype(jnp.int32))
    last = n - 1 - jnp.argmax(in_mask[::-1].astype(jnp.int32))
    start_ori = ori_raw[first]
    end_ori = ori_raw[last] + 2.0 * math.pi
    span = end_ori - start_ori
    end_ori = jnp.where(
        span > 3.0 * math.pi,
        end_ori - 2.0 * math.pi,
        jnp.where(span < math.pi, end_ori + 2.0 * math.pi, end_ori),
    )

    # Branch 1 (pre-flip) adjustment.
    o1 = ori_raw
    o1 = jnp.where(o1 < start_ori - math.pi / 2, o1 + 2.0 * math.pi, o1)
    o1 = jnp.where(o1 > start_ori + math.pi * 1.5, o1 - 2.0 * math.pi, o1)
    trigger = (o1 - start_ori > math.pi) & ring_ok
    # halfPassed for point i: some earlier surviving point triggered.
    half_passed = (jnp.cumsum(trigger.astype(jnp.int32)) - trigger.astype(jnp.int32)) > 0

    # Branch 2 (post-flip) adjustment.
    o2 = ori_raw + 2.0 * math.pi
    o2 = jnp.where(o2 < end_ori - math.pi * 1.5, o2 + 2.0 * math.pi, o2)
    o2 = jnp.where(o2 > end_ori + math.pi / 2, o2 - 2.0 * math.pi, o2)

    ori = jnp.where(half_passed, o2, o1)
    return (ori - start_ori) / (end_ori - start_ori)


def build_range_image(
    xyz: jnp.ndarray,
    rel: jnp.ndarray,
    ring: jnp.ndarray,
    ok: jnp.ndarray,
    cfg: ScanConfig,
) -> RangeImage:
    """Stable-sort points into the (ring, column) grid, preserving the
    within-ring arrival order of the reference's per-ring push_back
    (src/scanRegistration.cpp:209,216-221)."""
    n = xyz.shape[0]
    R, H = cfg.n_scans, cfg.h_max
    sort_key = jnp.where(ok, ring, R).astype(jnp.int32)
    order = jnp.argsort(sort_key, stable=True)
    ring_s = sort_key[order]
    ok_s = ok[order]

    pos = jnp.arange(n, dtype=jnp.int32)
    ring_start = jnp.full((R + 1,), n, jnp.int32).at[ring_s].min(pos)
    col = pos - ring_start[ring_s]
    keep = ok_s & (col < H)
    flat_idx = jnp.where(keep, ring_s * H + col, R * H)

    grid_xyz = (
        jnp.zeros((R * H + 1, 3), xyz.dtype).at[flat_idx].set(xyz[order])[: R * H]
    ).reshape(R, H, 3)
    grid_rel = (
        jnp.zeros((R * H + 1,), rel.dtype).at[flat_idx].set(rel[order])[: R * H]
    ).reshape(R, H)
    grid_mask = (
        jnp.zeros((R * H + 1,), bool).at[flat_idx].set(keep)[: R * H]
    ).reshape(R, H)
    counts = jnp.zeros((R + 1,), jnp.int32).at[ring_s].add(keep.astype(jnp.int32))[:R]
    return RangeImage(xyz=grid_xyz, rel=grid_rel, mask=grid_mask, counts=counts)


def compute_curvature(grid_xyz: jnp.ndarray) -> jnp.ndarray:
    """11-tap second-difference curvature per ring
    (src/scanRegistration.cpp:225-235)."""
    R, H, _ = grid_xyz.shape
    pad = jnp.pad(grid_xyz, ((0, 0), (5, 5), (0, 0)))
    acc = -10.0 * grid_xyz
    for off in range(11):
        if off == 5:
            continue
        acc = acc + jax.lax.dynamic_slice_in_dim(pad, off, H, axis=1)
    return jnp.sum(acc * acc, axis=-1)


def _gap_ok(d2: jnp.ndarray, cand: jnp.ndarray, cfg: ScanConfig):
    """Cumulative suppression-continue flags on both sides of each pick.

    ok_plus[:, l] — suppress cand+1+l; ok_minus[:, l] — suppress cand-1-l
    (src/scanRegistration.cpp:288-311)."""
    rad = cfg.suppression_radius
    H = d2.shape[1]
    offs = jnp.arange(rad, dtype=jnp.int32)
    ip = jnp.clip(cand[:, None] + offs[None, :], 0, H - 1)
    im = jnp.clip(cand[:, None] - 1 - offs[None, :], 0, H - 1)
    gp = jnp.take_along_axis(d2, ip, axis=1) <= cfg.suppression_gap_sq
    gm = jnp.take_along_axis(d2, im, axis=1) <= cfg.suppression_gap_sq
    ok_plus = jnp.cumprod(gp.astype(jnp.int32), axis=1).astype(bool)
    ok_minus = jnp.cumprod(gm.astype(jnp.int32), axis=1).astype(bool)
    return ok_plus, ok_minus


def _suppression_mask(col_ids, cand, ok_plus, ok_minus, cfg: ScanConfig):
    delta = col_ids - cand[:, None]
    m = delta == 0
    for l in range(cfg.suppression_radius):
        m = m | ((delta == l + 1) & ok_plus[:, l : l + 1])
        m = m | ((delta == -(l + 1)) & ok_minus[:, l : l + 1])
    return m


def occlusion_mask(grid: RangeImage, cfg: ScanConfig) -> jnp.ndarray:
    """Unreliable-point mask: shadow boundaries and parallel beams
    (original LOAM §V-A; an accuracy extension over the reference — see
    ScanConfig.occlusion_filter).

    Returns (R, H) bool, True = suppress.  For a range discontinuity
    between columns i and i+1 the FARTHER side's window is suppressed
    (those points sit on an occlusion boundary that moves with sensor
    parallax); beams grazing a surface (both neighbor gaps large relative
    to range) are suppressed as unstable.
    """
    r = jnp.sqrt(jnp.sum(grid.xyz * grid.xyz, axis=-1))
    r = jnp.where(grid.mask, r, 0.0)
    R, H = r.shape
    nxt = jnp.concatenate([r[:, 1:], r[:, -1:]], axis=1)
    both = grid.mask & jnp.concatenate(
        [grid.mask[:, 1:], jnp.zeros((R, 1), bool)], axis=1
    )
    # trigger at column i about the (i, i+1) pair
    far_here = both & (r - nxt > cfg.occlusion_gap)   # i is farther
    far_next = both & (nxt - r > cfg.occlusion_gap)   # i+1 is farther

    sup = jnp.zeros_like(grid.mask)
    pad = cfg.occlusion_radius
    fh = jnp.pad(far_here, ((0, 0), (0, pad)))
    fn = jnp.pad(far_next, ((0, 0), (pad + 1, 0)))
    for l in range(pad + 1):
        # far_here at i suppresses i-l (l=0..radius)
        sup = sup | jax.lax.dynamic_slice_in_dim(fh, l, H, axis=1)
        # far_next at i suppresses i+1+l
        sup = sup | jax.lax.dynamic_slice_in_dim(fn, pad - l, H, axis=1)

    prv = jnp.concatenate([r[:, :1], r[:, :-1]], axis=1)
    diff_p = jnp.abs(r - prv)
    diff_n = jnp.abs(nxt - r)
    parallel = (
        grid.mask
        & (diff_p > cfg.parallel_beam_ratio * r)
        & (diff_n > cfg.parallel_beam_ratio * r)
    )
    return sup | parallel


def select_features(
    grid: RangeImage,
    curv: jnp.ndarray,
    cfg: ScanConfig,
    pre_suppressed: jnp.ndarray | None = None,
):
    """Greedy per-sector classification (src/scanRegistration.cpp:246-368).

    ``pre_suppressed`` (R, H) marks points excluded before any pick (the
    occlusion filter); they behave like already-picked neighbors.

    Returns (label, order_key) over the grid:
      label: 2 sharp, 1 less-sharp, -1 flat, 0 untouched (int8)
      order_key: reference push order within the frame (ring-major,
      sector-major, pick-rank-minor) for selected points, else INT32_MAX.
    """
    R, H = curv.shape
    col_ids = jnp.broadcast_to(jnp.arange(H, dtype=jnp.int32)[None, :], (R, H))

    # Adjacent-point squared gaps along each ring; out-of-cloud gaps are
    # irrelevant (picks live in [5, count-7]).
    nxt = jnp.concatenate([grid.xyz[:, 1:], grid.xyz[:, -1:]], axis=1)
    d2 = jnp.sum((nxt - grid.xyz) ** 2, axis=-1)

    counts = grid.counts
    seg_len = counts - 11  # scanEndInd - scanStartInd per ring
    ring_active = seg_len >= cfg.n_sectors  # ref:248 (strictly <6 skipped)

    picked = ~grid.mask  # invalid cells can never be picked
    if pre_suppressed is not None:
        picked = picked | pre_suppressed
    label = jnp.zeros((R, H), jnp.int8)
    okey = jnp.full((R, H), jnp.int32(2**31 - 1))

    n_corner = cfg.max_less_sharp_per_sector
    n_flat = cfg.max_flat_per_sector
    sector_stride = n_corner + n_flat + 8  # order-key stride per sector

    neg_inf = jnp.float32(-jnp.inf)
    pos_inf = jnp.float32(jnp.inf)

    def corner_pick(state, rank, sector_mask, j):
        picked, label, okey = state
        eligible = sector_mask & ~picked & (curv > cfg.curvature_threshold)
        do = jnp.any(eligible, axis=1)
        cand = jnp.argmax(jnp.where(eligible, curv, neg_inf), axis=1).astype(jnp.int32)
        ok_p, ok_m = _gap_ok(d2, cand, cfg)
        sup = _suppression_mask(col_ids, cand, ok_p, ok_m, cfg) & do[:, None]
        center = (col_ids == cand[:, None]) & do[:, None]
        lab_val = jnp.where(rank < cfg.max_sharp_per_sector, jnp.int8(2), jnp.int8(1))
        picked = picked | sup
        label = jnp.where(center, lab_val, label)
        okey = jnp.where(center, j * sector_stride + rank, okey)
        return (picked, label, okey)

    def flat_pick(state, rank, sector_mask, j):
        picked, label, okey = state
        eligible = sector_mask & ~picked & (curv < cfg.curvature_threshold)
        do = jnp.any(eligible, axis=1)
        cand = jnp.argmin(jnp.where(eligible, curv, pos_inf), axis=1).astype(jnp.int32)
        center = (col_ids == cand[:, None]) & do[:, None]
        label = jnp.where(center, jnp.int8(-1), label)
        okey = jnp.where(center, j * sector_stride + n_corner + rank, okey)
        # The final flat pick breaks before marking/suppressing (ref:327-331).
        suppress_this = rank < n_flat - 1
        ok_p, ok_m = _gap_ok(d2, cand, cfg)
        sup = _suppression_mask(col_ids, cand, ok_p, ok_m, cfg) & do[:, None]
        picked = jnp.where(suppress_this, picked | sup, picked | center)
        # NOTE: `picked | center` for the last rank is a no-op for parity
        # (the sector's flat loop is over) but keeps the point from being
        # re-picked if budgets are reconfigured larger than 4.
        return (picked, label, okey)

    state = (picked, label, okey)
    for j in range(cfg.n_sectors):
        sp = 5 + (seg_len * j) // cfg.n_sectors
        ep = 5 + (seg_len * (j + 1)) // cfg.n_sectors - 1
        sector_mask = (
            ring_active[:, None]
            & (col_ids >= sp[:, None])
            & (col_ids <= ep[:, None])
        )

        def corner_body(st, rank):
            return corner_pick(st, rank, sector_mask, j), None

        state, _ = jax.lax.scan(
            corner_body, state, jnp.arange(n_corner, dtype=jnp.int32)
        )

        def flat_body(st, rank):
            return flat_pick(st, rank, sector_mask, j), None

        state, _ = jax.lax.scan(
            flat_body, state, jnp.arange(n_flat, dtype=jnp.int32)
        )

    picked, label, okey = state
    return label, okey


def _compact_selected(grid: RangeImage, sel, okey, capacity: int) -> PointCloud:
    """Gather selected grid cells into a fixed-capacity cloud in reference
    push order (ring-major, then order key)."""
    R, H = sel.shape
    flat_sel = sel.reshape(-1)
    row_ids = jnp.broadcast_to(
        jnp.arange(R, dtype=jnp.int32)[:, None], (R, H)
    ).reshape(-1)
    stride = jnp.int32(1 << 12)
    keys = row_ids * stride + jnp.minimum(okey.reshape(-1), stride - 1)
    sort_key = jnp.where(flat_sel, keys, jnp.int32(2**31 - 1))
    order = jnp.argsort(sort_key, stable=True)[:capacity]
    count = jnp.sum(flat_sel.astype(jnp.int32))
    out_mask = jnp.arange(capacity, dtype=jnp.int32) < count
    xyz = grid.xyz.reshape(-1, 3)[order]
    rel = grid.rel.reshape(-1)[order]
    return PointCloud(
        xyz=jnp.where(out_mask[:, None], xyz, 0.0),
        rel=jnp.where(out_mask, rel, 0.0),
        mask=out_mask,
    )


@partial(jax.jit, static_argnames=("cfg",))
def extract_features(
    xyz: jnp.ndarray, mask: jnp.ndarray, cfg: ScanConfig
) -> ScanFeatures:
    """Full feature-extraction stage for one frame.

    xyz: (max_points, 3) raw sensor points; mask: validity of each slot.
    """
    finite = jnp.all(jnp.isfinite(xyz), axis=-1)
    r2 = jnp.sum(xyz * xyz, axis=-1)
    in_mask = mask & finite & (r2 >= cfg.minimum_range**2)

    ring, ring_ok = compute_ring_ids(xyz, in_mask, cfg)
    rel_time = compute_rel_time(xyz, in_mask, ring_ok)
    rel = ring.astype(xyz.dtype) + cfg.scan_period * rel_time

    grid = build_range_image(xyz, rel, ring, ring_ok, cfg)
    curv = compute_curvature(grid.xyz)
    occluded = occlusion_mask(grid, cfg) if cfg.occlusion_filter else None
    label, okey = select_features(grid, curv, cfg, pre_suppressed=occluded)

    sharp = _compact_selected(grid, label == 2, okey, cfg.max_sharp)
    less_sharp = _compact_selected(grid, label >= 1, okey, cfg.max_less_sharp)
    flat = _compact_selected(grid, label == -1, okey, cfg.max_flat)

    # Less-flat: everything not corner-labeled inside the selection band,
    # voxel-filtered per ring at 0.2 m (ref:361-376).
    R, H = label.shape
    col_ids = jnp.broadcast_to(jnp.arange(H, dtype=jnp.int32)[None, :], (R, H))
    seg_len = grid.counts - 11
    band = (
        (seg_len >= cfg.n_sectors)[:, None]
        & (col_ids >= 5)
        & (col_ids <= (grid.counts - 7)[:, None])
    )
    lf_sel = band & (label <= 0) & grid.mask
    if occluded is not None:
        lf_sel = lf_sel & ~occluded
    # Per-ring downsample into the ring-slotted grid layout: ring r's
    # voxels occupy rows [r*C, r*C + C) of the flattened cloud (C =
    # max_less_flat // n_scans).  This matches the reference's per-ring
    # VoxelGrid loop (ref:361-376) AND gives the single-pass
    # correspondence search its static ring structure
    # (ops.knn.surf_correspondences_grid).
    if cfg.lessflat_mode == "runs":
        # sort-free run-length merge along the ring (see config note)
        from light_loam_tpu.ops.voxel import voxel_downsample_rings_runs

        lf_xyz, lf_rel, lf_mask = voxel_downsample_rings_runs(
            grid.xyz,
            grid.rel,
            lf_sel,
            cfg.less_flat_leaf,
            cfg.max_less_flat // cfg.n_scans,
        )
    else:
        lf_xyz, lf_rel, lf_mask = voxel_downsample_rings(
            grid.xyz,
            grid.rel,
            lf_sel,
            cfg.less_flat_leaf,
            cfg.max_less_flat // cfg.n_scans,
        )
    less_flat = PointCloud(
        xyz=lf_xyz.reshape(-1, 3),
        rel=lf_rel.reshape(-1),
        mask=lf_mask.reshape(-1),
    )

    return ScanFeatures(
        full=grid,
        sharp=sharp,
        less_sharp=less_sharp,
        flat=flat,
        less_flat=less_flat,
    )
