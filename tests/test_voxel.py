import numpy as np
import pytest
import jax.numpy as jnp

from light_loam_tpu.ops.voxel import voxel_downsample


def test_voxel_centroids():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    mask = np.ones(500, bool)
    mask[400:] = False
    leaf = 1.0
    xyz, rel, m, _ = voxel_downsample(
        jnp.asarray(pts), jnp.zeros(500), jnp.asarray(mask), leaf, 1024
    )
    xyz, m = np.asarray(xyz), np.asarray(m)

    # NumPy reference: centroid per occupied voxel
    keys = np.floor(pts[:400] / leaf).astype(int)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    cent = np.zeros((len(uniq), 3))
    cnt = np.zeros(len(uniq))
    np.add.at(cent, inv, pts[:400])
    np.add.at(cnt, inv, 1)
    cent /= cnt[:, None]

    assert m.sum() == len(uniq)
    got = xyz[m]
    # order-insensitive comparison
    got_sorted = got[np.lexsort(got.T)]
    cent_sorted = cent[np.lexsort(cent.T)]
    np.testing.assert_allclose(got_sorted, cent_sorted, atol=1e-5)


def test_voxel_extra_key_separates():
    pts = np.zeros((10, 3), np.float32)  # all in one voxel
    mask = np.ones(10, bool)
    extra = np.array([0] * 5 + [1] * 5, np.int32)
    xyz, rel, m, ex = voxel_downsample(
        jnp.asarray(pts), jnp.arange(10.0), jnp.asarray(mask), 0.5, 16,
        extra_key=jnp.asarray(extra),
    )
    m = np.asarray(m)
    assert m.sum() == 2  # one centroid per extra-key group
    rel = np.asarray(rel)[m]
    np.testing.assert_allclose(sorted(rel), [2.0, 7.0])


def test_voxel_empty():
    pts = np.zeros((8, 3), np.float32)
    mask = np.zeros(8, bool)
    _, _, m, _ = voxel_downsample(
        jnp.asarray(pts), jnp.zeros(8), jnp.asarray(mask), 0.5, 16
    )
    assert not np.asarray(m).any()


def test_voxel_rings_grid_layout():
    """Per-ring downsample: same voxels as per-ring flat calls, slotted
    into the (R, C) grid with a valid prefix per ring."""
    from light_loam_tpu.ops.voxel import voxel_downsample_rings

    rng = np.random.default_rng(11)
    R, H, C = 4, 64, 32
    xyz = rng.uniform(-4, 4, (R, H, 3)).astype(np.float32)
    rel = np.broadcast_to(
        np.arange(R, dtype=np.float32)[:, None], (R, H)
    ).copy()
    mask = rng.random((R, H)) < 0.7
    gx, gr, gm = voxel_downsample_rings(
        jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask), 0.5, C
    )
    gx, gr, gm = np.asarray(gx), np.asarray(gr), np.asarray(gm)
    for r in range(R):
        fx, fr, fm, _ = voxel_downsample(
            jnp.asarray(xyz[r]), jnp.asarray(rel[r]), jnp.asarray(mask[r]),
            0.5, H,
        )
        fx, fm = np.asarray(fx), np.asarray(fm)
        n = fm.sum()
        if n <= C:
            assert gm[r].sum() == n
            np.testing.assert_allclose(gx[r][: n], fx[: n], rtol=1e-6)
        else:
            assert gm[r].sum() == C  # decimated, uniform stride
            kept = fx[(np.arange(C) * n) // C]
            np.testing.assert_allclose(gx[r][:C], kept, rtol=1e-6)
        # valid prefix
        assert not gm[r][gm[r].argmin():].any() or gm[r].all()


def test_voxel_rings_overflow_decimates_uniformly():
    from light_loam_tpu.ops.voxel import voxel_downsample_rings

    R, H, C = 1, 128, 16
    # 128 distinct voxels on a line -> n=128 > C=16
    xyz = np.zeros((R, H, 3), np.float32)
    xyz[0, :, 0] = np.arange(H) * 1.0
    mask = np.ones((R, H), bool)
    gx, _, gm = voxel_downsample_rings(
        jnp.asarray(xyz), jnp.zeros((R, H)), jnp.asarray(mask), 0.5, C
    )
    gm = np.asarray(gm)
    assert gm[0].sum() == C
    xs = np.sort(np.asarray(gx)[0, :, 0])
    gaps = np.diff(xs)
    assert gaps.max() <= 2 * gaps.min() + 1e-6  # uniform coverage


def _runs_reference(xyz, rel, mask, leaf):
    """Host-side reference for the run-length merge: maximal runs of the
    same voxel key along the ring, masked slots transparent."""
    from light_loam_tpu.ops.voxel import voxel_keys

    km, kn = map(np.asarray, voxel_keys(jnp.asarray(xyz), jnp.asarray(mask),
                                        leaf))
    runs = []
    cur = None
    for h in range(len(mask)):
        if not mask[h]:
            continue
        key = (km[h], kn[h])
        if cur is None or cur["key"] != key:
            if cur is not None:
                runs.append(cur)
            cur = {"key": key, "xyz": [], "rel": []}
        cur["xyz"].append(xyz[h])
        cur["rel"].append(rel[h])
    if cur is not None:
        runs.append(cur)
    out = [(np.mean(r["xyz"], axis=0), np.mean(r["rel"])) for r in runs]
    return out


def test_voxel_rings_runs_matches_run_reference():
    """runs mode == host run-length reference (azimuth order), masked
    gaps transparent, revisited voxels one centroid per visit."""
    from light_loam_tpu.ops.voxel import voxel_downsample_rings_runs

    rng = np.random.default_rng(12)
    R, H, C = 3, 96, 64
    # a slow 1-D walk so same-voxel points are consecutive, plus a
    # deliberate revisit (ring returns to its start region)
    t = np.linspace(0, 2 * np.pi, H, dtype=np.float32)
    xyz = np.zeros((R, H, 3), np.float32)
    for r in range(R):
        xyz[r, :, 0] = 3.0 * np.cos(t) + 0.01 * rng.normal(size=H)
        xyz[r, :, 1] = 3.0 * np.sin(t) + 0.01 * rng.normal(size=H)
        xyz[r, :, 2] = 0.1 * r
    rel = rng.uniform(0, 1, (R, H)).astype(np.float32)
    mask = rng.random((R, H)) < 0.85
    gx, gr, gm = voxel_downsample_rings_runs(
        jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask), 0.5, C
    )
    gx, gr, gm = np.asarray(gx), np.asarray(gr), np.asarray(gm)
    for r in range(R):
        ref = _runs_reference(xyz[r], rel[r], mask[r], 0.5)
        n = len(ref)
        assert n <= C, "fixture should not overflow"
        assert gm[r].sum() == n
        for j in range(n):
            np.testing.assert_allclose(gx[r, j], ref[j][0], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(gr[r, j], ref[j][1], rtol=1e-5,
                                       atol=1e-5)
        assert not gm[r][n:].any()


def test_voxel_rings_runs_equals_exact_when_no_revisit():
    """On a monotonic (no-revisit) ring the runs mode yields the SAME
    voxel set and centroids as the exact sort-based mode."""
    from light_loam_tpu.ops.voxel import (
        voxel_downsample_rings,
        voxel_downsample_rings_runs,
    )

    rng = np.random.default_rng(13)
    R, H, C = 2, 128, 128
    xyz = np.zeros((R, H, 3), np.float32)
    # strictly increasing x: every voxel is one contiguous run
    xyz[:, :, 0] = np.cumsum(rng.uniform(0.05, 0.2, (R, H)), axis=1)
    xyz[:, :, 1] = rng.uniform(0, 0.4, (R, H))
    rel = rng.uniform(0, 1, (R, H)).astype(np.float32)
    mask = rng.random((R, H)) < 0.9
    ex, er, em = map(np.asarray, voxel_downsample_rings(
        jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask), 0.5, C))
    ux, ur, um = map(np.asarray, voxel_downsample_rings_runs(
        jnp.asarray(xyz), jnp.asarray(rel), jnp.asarray(mask), 0.5, C))
    for r in range(R):
        n_e, n_u = em[r].sum(), um[r].sum()
        assert n_e == n_u
        # same centroid SET (exact is key-ordered, runs azimuth-ordered)
        se = sorted(map(tuple, np.round(ex[r][:n_e], 4)))
        su = sorted(map(tuple, np.round(ux[r][:n_u], 4)))
        assert se == su


def test_extract_features_runs_mode_close_to_exact():
    """End-to-end: lessflat_mode='runs' produces a less-flat cloud whose
    live count is within a few % of exact mode on a realistic scan."""
    import dataclasses

    from light_loam_tpu.config import HDL64_SMALL
    from light_loam_tpu.ops.features import extract_features
    from light_loam_tpu.utils.synthetic import World, pad_cloud, simulate_scan

    world = World.urban(seed=3)
    pts = simulate_scan(world, np.array([0.0, 0.0, 0.0]), n_azimuth=600,
                        noise=0.01, seed=3)
    cfg_e = HDL64_SMALL.scan
    cfg_r = dataclasses.replace(cfg_e, lessflat_mode="runs")
    x, m = pad_cloud(pts, cfg_e.max_points)
    fe = extract_features(jnp.asarray(x), jnp.asarray(m), cfg_e)
    fr = extract_features(jnp.asarray(x), jnp.asarray(m), cfg_r)
    n_e = int(fe.less_flat.mask.sum())
    n_r = int(fr.less_flat.mask.sum())
    assert n_e > 0
    # runs mode may only ADD duplicate-visit centroids (and drop points
    # beyond the max_run window) — counts stay within a few percent
    assert 0.97 * n_e <= n_r <= 1.10 * n_e, (n_e, n_r)
    # the other feature clouds are untouched by the mode
    np.testing.assert_array_equal(np.asarray(fe.sharp.mask),
                                  np.asarray(fr.sharp.mask))


def test_compact_rows_equals_stable_argsort():
    """compact_rows is bitwise the argsort-by-drop-key compaction it
    replaces (ops/voxel.py), including overflow truncation."""
    from light_loam_tpu.ops.voxel import compact_rows

    rng = np.random.default_rng(11)
    for n, cap in [(257, 64), (64, 64), (100, 128)]:
        mask = jnp.asarray(rng.random(n) < 0.4)
        vals = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
        order = jnp.argsort(jnp.where(mask, 0, 1), stable=True)[:cap]
        count = int(mask.sum())
        out_mask, out_vals = compact_rows(mask, cap, vals)
        np.testing.assert_array_equal(
            np.asarray(out_mask),
            np.arange(cap) < count,
        )
        k = min(count, cap)
        np.testing.assert_array_equal(
            np.asarray(out_vals)[:k], np.asarray(vals[order])[:k]
        )


@pytest.mark.parametrize("n, cap", [(257, 64), (300, 512)])
def test_compact_rows_packed_equals_single_array(n, cap):
    """The packed multi-array path (f32, int32 and uint32 payloads riding
    one f32 row gather) is bitwise the single-array path, denormal and
    NaN bit patterns included."""
    from light_loam_tpu.ops.voxel import compact_rows

    rng = np.random.default_rng(12)
    mask = jnp.asarray(rng.random(n) < 0.6)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    bits = rng.integers(0, 2**32, n, dtype=np.uint32)
    bits[:6] = [1, 0x7FFFFF, 0x7FC00000, 0xFFC00001, 0x80000001, 0xFFFFFFFF]
    ci = bits.view(np.int32)
    cu = np.roll(bits, 3).reshape(n, 1)  # a 2-D payload too
    packed = compact_rows(mask, cap, jnp.asarray(xyz), jnp.asarray(ci),
                          jnp.asarray(cu))
    for a, got in zip((xyz, ci, cu), packed[1:]):
        m1, want = compact_rows(mask, cap, jnp.asarray(a))
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(packed[0]))
        assert got.dtype == a.dtype and got.shape == want.shape
        np.testing.assert_array_equal(np.asarray(got).view(np.uint32),
                                      np.asarray(want).view(np.uint32))


def test_gather_local_compact_equals_argsort_on_sorted_store():
    """On a cell-ordered store (the single-chip invariant) the sort-free
    _gather_local equals the argsort path bitwise — live prefix AND the
    overflow counter (models/mapping.py)."""
    from light_loam_tpu.config import HDL64_SMALL
    from light_loam_tpu.models.mapping import MapStore, _gather_local

    cfg = HDL64_SMALL.mapping
    rng = np.random.default_rng(5)
    n = 4096
    # live prefix with nondecreasing cells, dead tail
    n_live = 3000
    cells = np.sort(rng.integers(0, 21 * 21 * 11, n_live)).astype(np.int32)
    cell = np.zeros(n, np.int32)
    cell[:n_live] = cells
    mask = np.arange(n) < n_live
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    store = MapStore(jnp.asarray(xyz), jnp.asarray(cell), jnp.asarray(mask))
    center = jnp.asarray([10, 10, 5], jnp.int32)
    for cap in (4096, 256):  # no-overflow and overflow
        x1, m1, o1 = _gather_local(store, center, cfg, cap, cell_ordered=True)
        x2, m2, o2 = _gather_local(store, center, cfg, cap, cell_ordered=False)
        np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
        assert int(o1) == int(o2)
        k = int(m1.sum())
        assert k > 0
        np.testing.assert_array_equal(np.asarray(x1)[:k], np.asarray(x2)[:k])
