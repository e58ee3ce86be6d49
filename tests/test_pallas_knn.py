"""The fused 5-NN kernel (Triton route, interpret mode here) against
knn_tiled and a float64 brute force.

The kernel's contract is drop-in equivalence with ops.knn.knn_tiled:
ascending distances, first-index tie-break, same masking, so the mapping
stage can switch backends without an accuracy question
(laserMapping.cpp:1882,1948 semantics).  The kernel computes (q-r)·(q-r)
directly while knn_tiled expands |q|²+|r|²-2q·r, so distances agree to
the expansion's f32 cancellation and indices agree wherever the float64
neighbour distances are not tied within it.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from light_loam_tpu.ops import knn
from light_loam_tpu.ops.pallas_knn import knn_pallas

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import check_knn  # noqa: E402

pallas_knn = functools.partial(knn_pallas, interpret=True)
TOL = 1e-3  # m²: a few ulps of |q|²+|r|² <= 2700 m² for these clouds


def _cloud(rng, n, scale=60.0):
    return (rng.random((n, 3), np.float32) - 0.5) * scale


@pytest.mark.parametrize("Q,N", [(128, 1024), (300, 5000), (256, 2048)])
def test_matches_knn_tiled(Q, N):
    rng = np.random.default_rng(0)
    q = _cloud(rng, Q)
    r = _cloud(rng, N)
    m = rng.random(N) > 0.2

    d_ref, i_ref = knn.knn_tiled(jnp.asarray(q), jnp.asarray(r),
                                 jnp.asarray(m), k=5, tile=1024)
    d_pal, i_pal = pallas_knn(jnp.asarray(q), jnp.asarray(r),
                              jnp.asarray(m), k=5)
    np.testing.assert_allclose(np.asarray(d_pal), np.asarray(d_ref),
                               rtol=0, atol=TOL)
    for d, i in ((d_pal, i_pal), (d_ref, i_ref)):
        err, bad, rows = check_knn(np.asarray(d), np.asarray(i), q, r, m, 5,
                                   TOL)
        assert err <= TOL and bad == 0 and rows > 0.9 * Q, (err, bad, rows)
    # the kernel's direct differences are far closer to float64
    err, _, _ = check_knn(np.asarray(d_pal), np.asarray(i_pal), q, r, m, 5,
                          TOL)
    assert err < 1e-4


def test_masked_columns_never_selected():
    rng = np.random.default_rng(1)
    q = _cloud(rng, 64)
    r = _cloud(rng, 512)
    m = np.zeros(512, bool)
    m[:7] = True  # only 7 valid < k=5 still fine; 5 nearest of the 7
    d, i = pallas_knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), k=5)
    assert np.asarray(i).max() < 7
    assert np.isfinite(np.asarray(d)).all()
    d_t, i_t = knn.knn_tiled(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                             k=5, tile=128)
    np.testing.assert_array_equal(np.asarray(i), np.asarray(i_t))


def test_all_masked_returns_big():
    rng = np.random.default_rng(2)
    q = _cloud(rng, 32)
    r = _cloud(rng, 256)
    m = np.zeros(256, bool)
    d, i = pallas_knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m), k=5)
    # sentinel distances survive the gates downstream (>> 1 m² threshold)
    assert (np.asarray(d) > 1e20).all()
    assert (np.asarray(i) == 0).all()
    d_t, i_t = knn.knn_tiled(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                             k=5, tile=128)
    assert (np.asarray(d_t) > 1e20).all() and (np.asarray(i_t) == 0).all()


def test_count_skip_matches_full_search():
    """With live-prefix operands, passing query_count/ref_count must not
    change any live result (skipped tiles/blocks hold only masked
    entries), and dead query blocks must come back as the all-masked
    sentinel (+BIG, 0)."""
    rng = np.random.default_rng(4)
    Q, N = 600, 5000
    q = _cloud(rng, Q)
    r = _cloud(rng, N)
    n_live_r, n_live_q = 1800, 450
    m = np.zeros(N, bool)
    m[:n_live_r] = True

    d_full, i_full = pallas_knn(jnp.asarray(q), jnp.asarray(r),
                                jnp.asarray(m), k=5)
    d_skip, i_skip = pallas_knn(jnp.asarray(q), jnp.asarray(r),
                                jnp.asarray(m), k=5,
                                query_count=jnp.int32(n_live_q),
                                ref_count=jnp.int32(n_live_r))
    # live query rows: bitwise-identical results
    np.testing.assert_array_equal(np.asarray(d_skip)[:n_live_q],
                                  np.asarray(d_full)[:n_live_q])
    np.testing.assert_array_equal(np.asarray(i_skip)[:n_live_q],
                                  np.asarray(i_full)[:n_live_q])
    # dead query rows (whole blocks past the count): sentinel outputs
    q_block = 8
    dead_from = ((n_live_q + q_block - 1) // q_block) * q_block
    assert dead_from < Q
    assert (np.asarray(d_skip)[dead_from:] > 1e20).all()
    assert (np.asarray(i_skip)[dead_from:] == 0).all()

    # XLA path: ref_count must be a no-op on results too
    d_t, i_t = knn.knn_tiled(jnp.asarray(q), jnp.asarray(r), jnp.asarray(m),
                             k=5, tile=1024)
    d_tc, i_tc = knn.knn_tiled(jnp.asarray(q), jnp.asarray(r),
                               jnp.asarray(m), k=5, tile=1024,
                               ref_count=jnp.int32(n_live_r))
    np.testing.assert_array_equal(np.asarray(d_tc), np.asarray(d_t))
    np.testing.assert_array_equal(np.asarray(i_tc), np.asarray(i_t))


def test_vmap_folds_batch_into_grid():
    """Batched programs (models/batch.py) vmap mapping_step; the custom
    vmap rule must give per-lane results identical to per-lane calls —
    each lane searching its OWN reference cloud — and match the vmapped
    XLA path."""
    rng = np.random.default_rng(3)
    B, Q, N = 3, 96, 700
    qs = np.stack([_cloud(rng, Q) for _ in range(B)])
    rs = np.stack([_cloud(rng, N) for _ in range(B)])
    ms = rng.random((B, N)) > 0.3

    d_b, i_b = jax.vmap(lambda a, b, c: pallas_knn(a, b, c, k=5))(
        jnp.asarray(qs), jnp.asarray(rs), jnp.asarray(ms))
    d_t, _ = jax.vmap(lambda a, b, c: knn.knn_tiled(a, b, c, k=5, tile=256))(
        jnp.asarray(qs), jnp.asarray(rs), jnp.asarray(ms))
    np.testing.assert_allclose(np.asarray(d_b), np.asarray(d_t), atol=TOL)
    for b in range(B):
        d1, i1 = pallas_knn(jnp.asarray(qs[b]), jnp.asarray(rs[b]),
                            jnp.asarray(ms[b]), k=5)
        np.testing.assert_array_equal(np.asarray(d_b[b]), np.asarray(d1))
        np.testing.assert_array_equal(np.asarray(i_b[b]), np.asarray(i1))


def test_mapping_step_backend_equivalence(monkeypatch):
    """mapping_step(knn_backend='pallas') must reproduce the XLA-backend
    pose and map updates on a real frame (same neighbours → same gates →
    same factors)."""
    import dataclasses

    from light_loam_tpu.models.mapping import MappingState, mapping_step
    from light_loam_tpu.models.pipeline import PROFILES
    from light_loam_tpu.core import quaternion as quat
    from light_loam_tpu.core.frame import PointCloud
    from light_loam_tpu.ops import pallas_knn as pk
    from light_loam_tpu.utils.synthetic import World, simulate_scan

    # the kernel through the interpreter; the library itself never falls
    # back to interpret mode
    monkeypatch.setattr(pk, "knn_pallas",
                        functools.partial(pk.knn_pallas, interpret=True))
    cfg = PROFILES["hdl64-small"]
    world = World.urban(seed=7)
    rng = np.random.default_rng(7)

    def cloud(n_pts, cap, seed):
        pts = simulate_scan(world, np.zeros(3), n_azimuth=700, noise=0.01,
                            seed=seed)
        idx = rng.permutation(len(pts))[:n_pts]
        xyz = np.zeros((cap, 3), np.float32)
        m = np.zeros(cap, bool)
        xyz[: len(idx)] = pts[idx]
        m[: len(idx)] = True
        return PointCloud(xyz=jnp.asarray(xyz), rel=jnp.zeros(cap),
                          mask=jnp.asarray(m))

    corner = cloud(700, 1024, 3)
    surf = cloud(3000, 4096, 4)
    t_odom = jnp.asarray(np.array([0.4, 0.0, 0.0], np.float32))

    results = {}
    for backend in ("xla", "pallas"):
        mcfg = dataclasses.replace(cfg.mapping, knn_backend=backend)
        state = MappingState.init(mcfg)
        state, _ = mapping_step(state, corner, surf, quat.quat_identity(),
                                jnp.zeros(3), mcfg)
        state, out = mapping_step(state, corner, surf,
                                  quat.quat_identity(), t_odom, mcfg)
        results[backend] = (np.asarray(out.q_w), np.asarray(out.t_w),
                            int(out.map_corner_points))

    np.testing.assert_allclose(results["pallas"][1], results["xla"][1],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(results["pallas"][0], results["xla"][0],
                               rtol=0, atol=1e-5)
    assert results["pallas"][2] == results["xla"][2]
