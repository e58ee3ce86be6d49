"""Fused streamed k-NN for the GPU: distance + running top-k in registers.

The mapping stage's 5-NN queries (ops/knn.knn_tiled, the replacement for
nearestKSearch(5), laserMapping.cpp:1882,1948) are the scan-to-map hot
loop: per outer iteration, Q stack points search N local-map points.
The XLA path writes every (Q, tile) distance block, and two ``lax.top_k``
per tile, through device memory.  This Pallas kernel (Triton route) keeps
each (QB, T) distance block and the running (QB, k) best set in
registers and reads only the operands: O(3·(Q+N)) floats in, 2·Q·k out.

Design:
  * one program per (lane, query block of QB rows); each loops over
    T-wide reference tiles.  The reference rides as four contiguous rows
    [x, y, z, mask] so tile loads are coalesced; the live local map
    (~10k points, ~170 KB) stays in L2 across programs;
  * the contraction is 3-wide, so distances are three subtract-multiply-
    adds per pair on the CUDA cores ((q-r)·(q-r) directly, no
    |q|²+|r|²-2q·r cancellation and no TF32 question);
  * k extraction passes per tile, each a ``min`` and then a ``min`` over
    ``where(d == m, col, BIG)`` (first-index argmin from min reductions
    only), each winner inserted into the running sorted list with ties
    going to the running side — knn_tiled's order (ascending distance,
    lower index first);
  * count-aware skipping: both operands are live-prefix buffers
    (_gather_local and voxel_downsample compact live entries to the
    front), so query blocks past ``query_count`` exit at once with the
    all-masked answer (+BIG, 0) and the tile loop stops at
    ceil(ref_count / T).  A tile whose nearest point is no closer than
    every row's current k-th best skips extraction (spatial prune: both
    operands are voxel/cell-key ordered).  Exact: a skipped block or tile
    holds only entries that could never take a top-k slot.

A custom vmap rule folds a batch axis into the grid, each lane with its
own reference cloud, so batched programs (models/batch.py) keep the
kernel.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.custom_batching import custom_vmap
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BIG = 1e30
_BIG_I = 2**31 - 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _insert(best_d, best_i, v, vi):
    """Insert (v, vi) per row into the ascending k-lists (tuples of (QB,)
    vectors).  Strict <: an entry equal to a held one lands after it."""
    lt = [v < b for b in best_d]
    nd, ni = [], []
    for p in range(len(best_d)):
        if p == 0:
            nd.append(jnp.where(lt[0], v, best_d[0]))
            ni.append(jnp.where(lt[0], vi, best_i[0]))
        else:
            nd.append(jnp.where(lt[p], jnp.where(lt[p - 1], best_d[p - 1], v),
                                best_d[p]))
            ni.append(jnp.where(lt[p], jnp.where(lt[p - 1], best_i[p - 1], vi),
                                best_i[p]))
    return tuple(nd), tuple(ni)


def _knn_kernel(cnt_ref, q_ref, r_ref, out_d_ref, out_i_ref, *,
                k, tile, n_tiles, q_block):
    # refs: cnt (2,) [query_count, ref_count]; q (3, QB) rows x, y, z;
    #       r (4, Np) rows x, y, z, mask; out (QB, k) f32 / i32
    q_count = cnt_ref[0]
    r_count = cnt_ref[1]
    block_live = pl.program_id(1) * q_block < q_count

    @pl.when(jnp.logical_not(block_live))
    def _dead_block():
        for j in range(k):
            out_d_ref[:, j] = jnp.full((q_block,), _BIG, jnp.float32)
            out_i_ref[:, j] = jnp.zeros((q_block,), jnp.int32)

    @pl.when(block_live)
    def _live_block():
        qx, qy, qz = q_ref[0, :], q_ref[1, :], q_ref[2, :]

        def body(t, carry):
            best_d, best_i = carry
            sl = pl.ds(t * tile, tile)
            dx = qx[:, None] - r_ref[0, sl][None, :]
            dy = qy[:, None] - r_ref[1, sl][None, :]
            dz = qz[:, None] - r_ref[2, sl][None, :]
            d = dx * dx + dy * dy + dz * dz
            d = jnp.where(r_ref[3, sl][None, :] > 0, d, _BIG)

            def extract(carry):
                best_d, best_i = carry
                col = (jax.lax.broadcasted_iota(jnp.int32, (q_block, tile), 1)
                       + t * tile)
                dd = d
                for _ in range(k):
                    m = jnp.min(dd, axis=1)
                    j = jnp.min(jnp.where(dd == m[:, None], col, _BIG_I),
                                axis=1)
                    dd = jnp.where(col == j[:, None], _BIG, dd)
                    best_d, best_i = _insert(best_d, best_i, m, j)
                return best_d, best_i

            # extraction only if some row can still improve; >= is exact
            # because a tie with the k-th best loses to the held entry
            need = jnp.max(
                (jnp.min(d, axis=1) < best_d[k - 1]).astype(jnp.int32)) > 0
            return jax.lax.cond(need, extract, lambda c: c, (best_d, best_i))

        init = (tuple(jnp.full((q_block,), _BIG, jnp.float32)
                      for _ in range(k)),
                tuple(jnp.zeros((q_block,), jnp.int32) for _ in range(k)))
        n_live = jnp.minimum((r_count + (tile - 1)) // tile, n_tiles)
        best_d, best_i = jax.lax.fori_loop(0, n_live, body, init)
        for j in range(k):
            out_d_ref[:, j] = best_d[j]
            out_i_ref[:, j] = best_i[j]


def _knn_impl(
    query: jnp.ndarray,   # (B, Q, 3)
    ref: jnp.ndarray,     # (B, N, 3)
    mask: jnp.ndarray,    # (B, N) bool/float
    counts: jnp.ndarray,  # (B, 2) int32 [query_count, ref_count]
    *,
    k: int,
    q_block: int,
    tile: int,
    interpret: bool,
):
    B, Q, _ = query.shape
    N = ref.shape[1]
    Qp = _round_up(Q, q_block)
    Np = _round_up(N, tile)

    qT = jnp.moveaxis(jnp.pad(query, ((0, 0), (0, Qp - Q), (0, 0))), -1, 1)
    rT = jnp.concatenate([
        jnp.moveaxis(jnp.pad(ref, ((0, 0), (0, Np - N), (0, 0))), -1, 1),
        jnp.pad(mask.astype(jnp.float32), ((0, 0), (0, Np - N)))[:, None, :],
    ], axis=1)                                                # (B, 4, Np)

    kernel = partial(_knn_kernel, k=k, tile=tile, n_tiles=Np // tile,
                     q_block=q_block)
    d, idx = pl.pallas_call(
        kernel,
        grid=(B, Qp // q_block),
        in_specs=[
            pl.BlockSpec((None, 2), lambda b, i: (b, 0)),
            pl.BlockSpec((None, 3, q_block), lambda b, i: (b, 0, i)),
            pl.BlockSpec((None, 4, Np), lambda b, i: (b, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, q_block, k), lambda b, i: (b, i, 0)),
            pl.BlockSpec((None, q_block, k), lambda b, i: (b, i, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B, Qp, k), jnp.float32),
            jax.ShapeDtypeStruct((B, Qp, k), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="knn_topk",
    )(counts, qT, rT)
    return d[:, :Q], idx[:, :Q]


@lru_cache(maxsize=None)
def _knn_fn(k: int, q_block: int, tile: int, interpret: bool):
    impl = partial(_knn_impl, k=k, q_block=q_block, tile=tile,
                   interpret=interpret)

    @custom_vmap
    def fn(query, ref, mask, counts):
        d, i = impl(query[None], ref[None], mask[None], counts[None])
        return d[0], i[0]

    @fn.def_vmap
    def _rule(axis_size, in_batched, query, ref, mask, counts):
        def ensure(x, b):
            return x if b else jnp.broadcast_to(
                x[None], (axis_size,) + x.shape)

        query, ref, mask, counts = (
            ensure(a, b)
            for a, b in zip((query, ref, mask, counts), in_batched)
        )
        d, i = impl(query, ref, mask, counts)
        return (d, i), (True, True)

    return fn


@partial(jax.jit, static_argnames=("k", "q_block", "tile", "interpret"))
def knn_pallas(
    query_xyz: jnp.ndarray,  # (Q, 3)
    ref_xyz: jnp.ndarray,    # (N, 3)
    ref_mask: jnp.ndarray,   # (N,)
    k: int,
    q_block: int = 8,
    tile: int = 512,
    interpret: bool = False,
    query_count=None,
    ref_count=None,
):
    """Drop-in for ops.knn.knn_tiled: (sq_dists (Q,k) ascending,
    indices (Q,k)).  Compiles for the GPU only; ``interpret=True`` runs
    the same kernel through the Pallas interpreter (tests).  Under
    ``jax.vmap`` the batch axis folds into the kernel grid.

    ``query_count``/``ref_count`` (dynamic scalars) assert that entries
    at index >= count are masked (live-prefix buffers); the kernel then
    skips dead query blocks and dead reference tiles.  Outputs for
    skipped query rows are (+BIG, 0), what an all-masked search returns.
    Omit them (None) for buffers without the prefix guarantee."""
    platform = jax.default_backend()
    if not interpret and platform != "gpu":
        raise ValueError(
            f"knn_pallas compiles for the GPU only; the platform is "
            f"{platform!r} (use ops.knn.knn_tiled there)")
    Q = query_xyz.shape[0]
    N = ref_xyz.shape[0]
    qc = jnp.asarray(Q if query_count is None else query_count, jnp.int32)
    rc = jnp.asarray(N if ref_count is None else ref_count, jnp.int32)
    counts = jnp.stack([qc, rc]).reshape(2)
    fn = _knn_fn(int(k), int(q_block), int(tile), bool(interpret))
    return fn(query_xyz, ref_xyz, ref_mask, counts)
