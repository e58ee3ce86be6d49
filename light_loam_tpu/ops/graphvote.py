"""Graph-matching correspondence-consistency voting.

THE Light-LOAM contribution (RA-L 2024 §III): correspondences vote on each
other's reliability through pairwise rigid-motion compatibility

    score(i, j) = exp(−(‖pᵢ−pⱼ‖_src − ‖pᵢ−pⱼ‖_tgt)² / res²)

Two kernels:

  * ``simple_vote`` — the live-path "simple" variant
    (src/laserOdometry.cpp:165-342): correspondences are split into
    ``n_regions`` contiguous chunks; each incompatible pair (score <
    threshold) adds one vote against both endpoints; correspondences with
    votes ≤ 0.9·chunk_size survive, weighted 5.0 when votes ≤ 50 else 1.0.
    The reference's sort-then-walk-with-break is equivalent to the direct
    predicate ``votes ≤ 0.9·k`` since the walk ascends votes.

  * ``full_graph_vote`` — the paper's full pipeline, present but latent in
    the reference (graph_construction_partial +
    graph_based_correspondence_vote_partial,
    src/laserMapping.cpp:261-834; call sites commented out): per-vertex
    degree over a 0.95-thresholded adjacency, first-order reliability via
    mean geometric-mean triangle weight, adaptive threshold, neighbor
    pruning, then a 0.1·loose + 0.9·tight final score.
    NOTE: the reference's tight-score pass computes ``pow(x, 1/3)`` with
    INTEGER 1/3 == 0 (laserMapping.cpp:597), i.e. every surviving triangle
    contributes exactly 1.0; we implement the intended cube root (as in
    the first-order pass, laserMapping.cpp:457) — deviation documented in
    PARITY.md.

Both kernels are chunked batched dense (K×K) compatibility matrices —
data-parallel tensor work replacing the reference's O(k²) scalar loops
(and its OpenMP pragmas) entirely.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp


def _chunk_layout(valid: jnp.ndarray, n_regions: int):
    """Replicate the reference's contiguous chunking of the compacted
    correspondence list (laserOdometry.cpp:202-214).

    Returns (rank, chunk_id, offset, n_valid, base) where base is the
    per-chunk size n_valid // n_regions (the last chunk absorbs the
    remainder).
    """
    v = valid.astype(jnp.int32)
    rank = jnp.cumsum(v) - v
    n_valid = jnp.sum(v)
    base = n_valid // n_regions
    safe_base = jnp.maximum(base, 1)
    chunk_id = jnp.where(
        base == 0,
        n_regions - 1,
        jnp.minimum(rank // safe_base, n_regions - 1),
    ).astype(jnp.int32)
    offset = rank - chunk_id * base
    return rank, chunk_id, offset, n_valid, base


def _chunk_sizes(n_valid, base, n_regions: int):
    sizes = jnp.full((n_regions,), base, jnp.int32)
    last = n_valid - base * (n_regions - 1)
    return sizes.at[n_regions - 1].set(last)


def _scatter_chunks(values, valid, chunk_id, offset, n_regions: int, K: int):
    """Scatter (Q, ...) values into (n_regions, K, ...) chunk buffers."""
    dest = jnp.where(valid, chunk_id * K + jnp.minimum(offset, K - 1), n_regions * K)
    flat_shape = (n_regions * K + 1,) + values.shape[1:]
    out = jnp.zeros(flat_shape, values.dtype).at[dest].set(values)
    return out[: n_regions * K].reshape((n_regions, K) + values.shape[1:])


def _compat_scores(src, tgt, resolution: float):
    """(R, K, K) compatibility matrix per chunk."""
    def dists(p):
        # full f32 precision: see ops.knn.pairwise_sq_dist — reduced-
        # precision cross terms at ~100 m coordinates corrupt metre-scale
        # distances
        from light_loam_tpu import dist_precision

        d2 = (
            jnp.sum(p * p, axis=-1)[:, :, None]
            + jnp.sum(p * p, axis=-1)[:, None, :]
            - 2.0 * jnp.einsum(
                "rkd,rld->rkl", p, p, precision=dist_precision()
            )
        )
        return jnp.sqrt(jnp.maximum(d2, 0.0))

    gap = dists(src) - dists(tgt)
    return jnp.exp(-(gap * gap) / (resolution * resolution))


def compat_votes(src, tgt, valid, threshold: float = 0.96,
                 resolution: float = 1.0) -> jnp.ndarray:
    """(R, K) incompatibility votes per chunked correspondence: the number
    of valid partners j != i whose compatibility score is below
    ``threshold`` (laserOdometry.cpp:228-252).  XLA fuses distance ->
    exp -> threshold -> row-sum; the (R, K, K) scores stay in L2."""
    K = src.shape[-2]
    scores = _compat_scores(src, tgt, resolution)
    eye = jnp.eye(K, dtype=bool)
    pair_ok = (valid[..., :, None] * valid[..., None, :]) > 0
    incompat = (scores < threshold) & pair_ok & ~eye
    return jnp.sum(incompat.astype(jnp.float32), axis=-1)


class VoteResult(NamedTuple):
    selected: jnp.ndarray  # (Q,) bool — survived the vote
    weight: jnp.ndarray    # (Q,) float — optimization weight (0 if not selected)
    votes: jnp.ndarray     # (Q,) float — incompatibility votes received


def simple_vote(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    valid: jnp.ndarray,
    n_regions: int,
    chunk_capacity: int,
    score_threshold: float = 0.96,
    resolution: float = 1.0,
    selected_ratio: float = 0.90,
    low_vote_count: float = 50.0,
    low_vote_weight: float = 5.0,
    high_vote_weight: float = 1.0,
) -> VoteResult:
    """Live-path vote (laserOdometry.cpp:165-342).

    src: (Q, 3) current-frame correspondence points; tgt: (Q, 3) their
    matched previous-frame anchors; valid: (Q,) active slots.
    ``chunk_capacity`` must cover Q // n_regions + n_regions.
    """
    Q = src.shape[0]
    K = chunk_capacity
    rank, chunk_id, offset, n_valid, base = _chunk_layout(valid, n_regions)
    in_chunk = valid & (offset < K)

    csrc = _scatter_chunks(src, in_chunk, chunk_id, offset, n_regions, K)
    ctgt = _scatter_chunks(tgt, in_chunk, chunk_id, offset, n_regions, K)
    cval = _scatter_chunks(
        in_chunk.astype(jnp.float32), in_chunk, chunk_id, offset, n_regions, K
    )

    votes_chunk = compat_votes(csrc, ctgt, cval, score_threshold, resolution)

    sizes = _chunk_sizes(n_valid, base, n_regions).astype(jnp.float32)  # (R,)
    num_selected = selected_ratio * sizes
    sel_chunk = (votes_chunk <= num_selected[:, None]) & (cval > 0)
    w_chunk = jnp.where(
        votes_chunk <= low_vote_count, low_vote_weight, high_vote_weight
    ) * sel_chunk

    # gather back to the original (Q,) layout
    flat_idx = jnp.where(in_chunk, chunk_id * K + offset, 0)
    selected = jnp.where(in_chunk, sel_chunk.reshape(-1)[flat_idx], False)
    weight = jnp.where(in_chunk, w_chunk.reshape(-1)[flat_idx], 0.0)
    votes = jnp.where(in_chunk, votes_chunk.reshape(-1)[flat_idx], 0.0)
    return VoteResult(selected=selected, weight=weight, votes=votes)


def run_vote(
    mode: str,
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    valid: jnp.ndarray,
    n_regions: int,
    chunk_capacity: int,
    score_threshold: float = 0.96,
    resolution: float = 1.0,
    selected_ratio: float = 0.90,
    low_vote_count: float = 50.0,
    low_vote_weight: float = 5.0,
    high_vote_weight: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dispatch to the configured vote kernel; returns (selected, weight).

    Shared by the odometry stage (laserOdometry.cpp:796) and the mapping
    stage's latent call sites (laserMapping.cpp:2057-2072), which run the
    same kernels on scan-to-map correspondences."""
    if mode == "off":
        return valid, jnp.ones_like(src[:, 0])
    if mode == "simple":
        v = simple_vote(
            src, tgt, valid,
            n_regions=n_regions, chunk_capacity=chunk_capacity,
            score_threshold=score_threshold,
            resolution=resolution,
            selected_ratio=selected_ratio,
            low_vote_count=low_vote_count,
            low_vote_weight=low_vote_weight,
            high_vote_weight=high_vote_weight,
        )
        return v.selected, v.weight
    if mode == "full":
        v = full_graph_vote(
            src, tgt, valid,
            n_regions=n_regions, chunk_capacity=chunk_capacity,
            resolution=resolution,
        )
        return v.selected, v.score
    raise ValueError(f"unknown vote mode: {mode}")


class FullVoteResult(NamedTuple):
    selected: jnp.ndarray  # (Q,) bool
    score: jnp.ndarray     # (Q,) float reliability in [0, 1]
    degree: jnp.ndarray    # (Q,) pruned degree


def full_graph_vote(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    valid: jnp.ndarray,
    n_regions: int,
    chunk_capacity: int,
    edge_threshold: float = 0.95,
    resolution: float = 1.0,
    weight_balance: float = 0.9,
) -> FullVoteResult:
    """The paper's full reliability pipeline (laserMapping.cpp:321-834).

    Triangle sums are evaluated as fused matmul chains: with B = A ⊙ G^⅓
    (adjacency-masked cube-root weights),
        Σ_{j<k∈N(i)} (G_ij G_ik G_jk)^⅓ = ½ · rowsum(B ⊙ (B @ G^⅓)).
    """
    K = chunk_capacity
    rank, chunk_id, offset, n_valid, base = _chunk_layout(valid, n_regions)
    in_chunk = valid & (offset < K)

    csrc = _scatter_chunks(src, in_chunk, chunk_id, offset, n_regions, K)
    ctgt = _scatter_chunks(tgt, in_chunk, chunk_id, offset, n_regions, K)
    cval = _scatter_chunks(
        in_chunk.astype(jnp.float32), in_chunk, chunk_id, offset, n_regions, K
    )

    G = _compat_scores(csrc, ctgt, resolution)
    eye = jnp.eye(K, dtype=G.dtype)[None]
    pair_ok = cval[:, :, None] * cval[:, None, :]
    G = G * pair_ok * (1.0 - eye)  # zero diagonal + padding, like setZero + skipped self

    # chunk connectivity guard (laserMapping.cpp:392-396)
    connected = jnp.sqrt(jnp.sum(G * G, axis=(1, 2))) > 0  # (R,)

    A = (G > edge_threshold).astype(G.dtype)
    degree = jnp.sum(A, axis=-1)  # (R, K)

    G3 = jnp.cbrt(G)
    B = A * G3
    tri = 0.5 * jnp.sum(B * jnp.einsum("rij,rjk->rik", B, G3), axis=-1)  # (R, K)

    denom = degree * (degree - 1.0) * 0.5
    has_tri = degree > 1.0
    first_order = jnp.where(has_tri, tri / jnp.maximum(denom, 1.0), 0.0)

    # adaptive threshold: min(global ratio, mean score) (laserMapping.cpp:490-492)
    num_a = jnp.sum(jnp.where(has_tri, tri, 0.0), axis=-1)
    den_a = jnp.sum(jnp.where(has_tri, denom, 0.0), axis=-1)
    param_a = num_a / jnp.maximum(den_a, 1e-12)
    n_in_chunk = jnp.maximum(jnp.sum(cval, axis=-1), 1.0)
    param_b = jnp.sum(first_order, axis=-1) / n_in_chunk
    threshold = jnp.minimum(param_a, param_b)[:, None]  # (R, 1)

    # prune neighbors whose first-order score is below threshold
    keep = (first_order >= threshold).astype(G.dtype)  # (R, K) per-vertex keep
    A2 = A * keep[:, None, :]
    deg2 = jnp.sum(A2, axis=-1)

    # loose = mean kept-neighbor edge weight; tight = mean kept-triangle
    # geometric mean (computed only when pruned degree > 2,
    # laserMapping.cpp:581-611)
    B2 = A2 * G3
    tri2 = 0.5 * jnp.sum(B2 * jnp.einsum("rij,rjk->rik", B2, G3), axis=-1)
    # integer division in the reference: deg*(deg-2)/2 with int truncation
    tight_den = jnp.floor(deg2 * (deg2 - 2.0) / 2.0)
    loose = jnp.sum(A2 * G, axis=-1) / jnp.maximum(deg2, 1.0)
    big_enough = deg2 > 2.0
    tight = jnp.where(big_enough, tri2 / jnp.maximum(tight_den, 1.0), 0.0)
    loose = jnp.where(big_enough & (deg2 > 0), loose, 0.0)

    score_chunk = (1.0 - weight_balance) * loose + weight_balance * tight
    score_chunk = score_chunk * connected[:, None].astype(G.dtype)
    sel_chunk = (score_chunk != 0.0) & (cval > 0)

    flat_idx = jnp.where(in_chunk, chunk_id * K + offset, 0)
    selected = jnp.where(in_chunk, sel_chunk.reshape(-1)[flat_idx], False)
    score = jnp.where(in_chunk, score_chunk.reshape(-1)[flat_idx], 0.0)
    deg_out = jnp.where(in_chunk, deg2.reshape(-1)[flat_idx], 0.0)
    return FullVoteResult(selected=selected, score=score, degree=deg_out)
