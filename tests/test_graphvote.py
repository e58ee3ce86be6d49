"""Validate the batched vote kernels against a literal NumPy port of the
reference's sequential vote (laserOdometry.cpp:165-342)."""

import numpy as np
import jax.numpy as jnp

from light_loam_tpu.ops import graphvote as gv

from oracle import literal_simple_vote


def test_simple_vote_matches_literal():
    rng = np.random.default_rng(0)
    n = 200
    # consistent correspondences: rigid transform + small noise
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    theta = 0.1
    R = np.array([[np.cos(theta), -np.sin(theta), 0],
                  [np.sin(theta), np.cos(theta), 0], [0, 0, 1]], np.float32)
    tgt = src @ R.T + np.array([1.0, 0.5, 0.0], np.float32)
    # corrupt 20% with gross outliers
    bad = rng.random(n) < 0.2
    tgt[bad] += rng.uniform(-8, 8, (bad.sum(), 3)).astype(np.float32)

    n_regions = 5
    oracle = literal_simple_vote(src, tgt, n_regions)

    out = gv.simple_vote(
        jnp.asarray(src), jnp.asarray(tgt), jnp.ones(n, bool),
        n_regions=n_regions, chunk_capacity=64,
    )
    sel = np.asarray(out.selected)
    w = np.asarray(out.weight)
    votes = np.asarray(out.votes)

    for i in range(n):
        if i in oracle:
            assert sel[i], f"corr {i} should be selected (votes={votes[i]})"
            assert w[i] == oracle[i][0], f"corr {i} weight {w[i]} != {oracle[i][0]}"
            assert votes[i] == oracle[i][1]
        else:
            assert not sel[i], f"corr {i} should be rejected (votes={votes[i]})"


def test_simple_vote_rejects_outliers():
    rng = np.random.default_rng(1)
    n = 300
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = src + np.array([0.5, -0.2, 0.1], np.float32)
    bad = np.zeros(n, bool)
    bad[::7] = True
    tgt[bad] += rng.uniform(3, 10, (bad.sum(), 3)).astype(np.float32)

    out = gv.simple_vote(
        jnp.asarray(src), jnp.asarray(tgt), jnp.ones(n, bool),
        n_regions=10, chunk_capacity=48,
    )
    sel = np.asarray(out.selected)
    # outliers should receive many votes and be dropped or downweighted
    good_rate = sel[~bad].mean()
    bad_rate = sel[bad].mean()
    assert good_rate > 0.95
    assert bad_rate < 0.30


def test_simple_vote_with_padding():
    rng = np.random.default_rng(2)
    n, q = 120, 200
    src = np.zeros((q, 3), np.float32)
    tgt = np.zeros((q, 3), np.float32)
    valid = np.zeros(q, bool)
    # valid slots scattered through the padded array
    slots = np.sort(rng.choice(q, n, replace=False))
    pts = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    src[slots] = pts
    tgt[slots] = pts + 0.3
    valid[slots] = True

    oracle = literal_simple_vote(pts, pts + 0.3, 5)
    out = gv.simple_vote(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid),
        n_regions=5, chunk_capacity=48,
    )
    sel = np.asarray(out.selected)
    assert not sel[~valid].any()
    for rank, slot in enumerate(slots):
        assert sel[slot] == (rank in oracle)


def test_full_graph_vote_scores_inliers_higher():
    rng = np.random.default_rng(3)
    n = 200
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = src + np.array([0.5, -0.2, 0.1], np.float32)
    tgt += rng.normal(scale=0.02, size=tgt.shape).astype(np.float32)
    bad = np.zeros(n, bool)
    bad[::6] = True
    tgt[bad] += rng.uniform(2, 6, (bad.sum(), 3)).astype(np.float32)

    out = gv.full_graph_vote(
        jnp.asarray(src), jnp.asarray(tgt), jnp.ones(n, bool),
        n_regions=10, chunk_capacity=48,
    )
    sel = np.asarray(out.selected)
    score = np.asarray(out.score)
    assert sel[~bad].mean() > 0.9
    assert score[~bad].mean() > 3 * max(score[bad].mean(), 1e-6)


def test_full_graph_vote_matches_literal():
    """full_graph_vote vs a literal loop port of the reference pipeline
    (graph_construction_partial + graph_based_correspondence_vote_partial,
    laserMapping.cpp:261-834): same selection set, same scores."""
    from oracle import literal_full_vote

    rng = np.random.default_rng(3)
    n, n_regions = 90, 3
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = src + np.array([1.5, -0.7, 0.2], np.float32)
    tgt += rng.normal(0, 0.02, (n, 3)).astype(np.float32)
    out_idx = rng.choice(n, n // 4, replace=False)
    tgt[out_idx] += rng.uniform(2.0, 8.0, (len(out_idx), 3)).astype(np.float32)

    oracle = literal_full_vote(src, tgt, n_regions=n_regions)
    assert len(oracle) > n // 3, "scenario degenerate: too few selected"

    K = n // n_regions + n_regions
    res = gv.full_graph_vote(
        jnp.asarray(src), jnp.asarray(tgt), jnp.ones(n, bool),
        n_regions=n_regions, chunk_capacity=K,
    )
    sel = np.asarray(res.selected)
    score = np.asarray(res.score)
    assert set(np.nonzero(sel)[0]) == set(oracle)
    for i, s in oracle.items():
        assert abs(score[i] - s) < 1e-3, (i, score[i], s)

    # most outliers rejected, most inliers kept
    inl = np.ones(n, bool); inl[out_idx] = False
    assert sel[inl].mean() > 0.8
    assert sel[~inl].mean() < 0.35

    # the documented [DEV]: the reference's pow(x, 1/3) integer-division
    # bug makes every tight triangle weight 1.0 — selection may agree but
    # the scores must differ from the intended cube root the kernel uses
    buggy = literal_full_vote(src, tgt, n_regions=n_regions,
                              bug_faithful=True)
    diffs = [abs(buggy[i] - oracle[i]) for i in oracle if i in buggy]
    assert max(diffs) > 1e-3


def test_full_graph_vote_with_padding_matches_literal():
    """Padding slots interleaved: the kernel chunks by rank over VALID
    entries exactly like the reference chunks its compacted vector."""
    from oracle import literal_full_vote

    rng = np.random.default_rng(5)
    n_valid, n_regions = 60, 3
    src_c = rng.uniform(-15, 15, (n_valid, 3)).astype(np.float32)
    tgt_c = src_c + np.array([0.4, 0.9, -0.1], np.float32)
    tgt_c += rng.normal(0, 0.02, (n_valid, 3)).astype(np.float32)
    bad = rng.choice(n_valid, 12, replace=False)
    tgt_c[bad] += rng.uniform(2.0, 6.0, (12, 3)).astype(np.float32)

    oracle = literal_full_vote(src_c, tgt_c, n_regions=n_regions)

    n_pad = 100
    valid = np.zeros(n_pad, bool)
    slots = np.sort(rng.choice(n_pad, n_valid, replace=False))
    valid[slots] = True
    src = np.zeros((n_pad, 3), np.float32)
    tgt = np.zeros((n_pad, 3), np.float32)
    src[slots] = src_c
    tgt[slots] = tgt_c

    K = n_valid // n_regions + n_regions
    res = gv.full_graph_vote(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid),
        n_regions=n_regions, chunk_capacity=K,
    )
    sel = np.asarray(res.selected)
    score = np.asarray(res.score)
    assert not sel[~valid].any()
    for rank, slot in enumerate(slots):
        want = oracle.get(rank)
        assert bool(sel[slot]) == (want is not None), (rank, slot)
        if want is not None:
            assert abs(score[slot] - want) < 1e-3


def _chunks(rng, R, K, outlier=0.25, scale=20.0):
    src = rng.uniform(-scale, scale, (R, K, 3)).astype(np.float32)
    tgt = src + np.float32(0.3)
    bad = rng.random((R, K)) < outlier
    tgt = tgt + np.where(bad[..., None], rng.uniform(2, 8, (R, K, 3)),
                         0.0).astype(np.float32)
    valid = (rng.random((R, K)) < 0.9).astype(np.float32)
    return src * valid[..., None], tgt * valid[..., None], valid


def test_compat_votes_match_float64():
    """The XLA vote against a float64 NumPy vote: f32 distances move a
    score next to the threshold by a few 1e-3, so at most 1 % of rows
    may differ, by one vote."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import check_votes

    rng = np.random.default_rng(0)
    src, tgt, valid = _chunks(rng, 4, 96)
    votes = gv.compat_votes(jnp.asarray(src), jnp.asarray(tgt),
                            jnp.asarray(valid))
    frac, worst = check_votes(votes, src, tgt, valid)
    assert frac <= 0.01 and worst <= 1, (frac, worst)
    assert np.asarray(votes).max() > 0


def test_compat_votes_empty_chunks():
    R, K = 3, 64
    src = np.zeros((R, K, 3), np.float32)
    v = np.zeros((R, K), np.float32)
    out = np.asarray(gv.compat_votes(jnp.asarray(src), jnp.asarray(src),
                                     jnp.asarray(v)))
    assert (out == 0).all()


def test_simple_vote_counts_are_compat_votes():
    """simple_vote's per-correspondence votes are compat_votes over its
    chunk layout (R regions of chunk_capacity slots)."""
    rng = np.random.default_rng(1)
    n, R, K = 150, 5, 48
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    tgt = src + np.float32(0.4)
    bad = np.zeros(n, bool)
    bad[::6] = True
    tgt[bad] += rng.uniform(3, 9, (bad.sum(), 3)).astype(np.float32)
    out = gv.simple_vote(jnp.asarray(src), jnp.asarray(tgt),
                         jnp.ones(n, bool), n_regions=R, chunk_capacity=K)
    # contiguous chunks of n // R (the last absorbs the remainder)
    base = n // R
    want = np.zeros(n, np.float32)
    for r in range(R):
        lo, hi = r * base, (n if r == R - 1 else (r + 1) * base)
        cs = np.zeros((1, K, 3), np.float32)
        ct = np.zeros((1, K, 3), np.float32)
        cv = np.zeros((1, K), np.float32)
        cs[0, :hi - lo], ct[0, :hi - lo], cv[0, :hi - lo] = (
            src[lo:hi], tgt[lo:hi], 1.0)
        want[lo:hi] = np.asarray(gv.compat_votes(
            jnp.asarray(cs), jnp.asarray(ct), jnp.asarray(cv)))[0, :hi - lo]
    np.testing.assert_array_equal(np.asarray(out.votes), want)
    assert want[bad].min() > want[~bad].max()


def test_compat_votes_vmap_matches_per_lane():
    """Batched programs (models/batch.py) vmap the vote: per-lane results
    must equal per-lane calls, batched or broadcast operands alike."""
    import jax

    rng = np.random.default_rng(7)
    B = 3
    lanes = [_chunks(rng, 4, 96) for _ in range(B)]
    src, tgt, valid = (np.stack([lane[i] for lane in lanes])
                       for i in range(3))
    fn = jax.jit(gv.compat_votes)
    batched = np.asarray(jax.vmap(fn)(jnp.asarray(src), jnp.asarray(tgt),
                                      jnp.asarray(valid)))
    singles = np.stack([np.asarray(fn(jnp.asarray(src[b]),
                                      jnp.asarray(tgt[b]),
                                      jnp.asarray(valid[b])))
                        for b in range(B)])
    np.testing.assert_array_equal(batched, singles)
    batched2 = np.asarray(jax.vmap(fn, in_axes=(0, None, None))(
        jnp.asarray(src), jnp.asarray(tgt[0]), jnp.asarray(valid[0])))
    singles2 = np.stack([np.asarray(fn(jnp.asarray(src[b]),
                                       jnp.asarray(tgt[0]),
                                       jnp.asarray(valid[0])))
                         for b in range(B)])
    np.testing.assert_array_equal(batched2, singles2)
