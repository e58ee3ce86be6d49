"""Sharded mapping must match the single-chip step on a virtual 8-device
CPU mesh — the 'fake backend' for distributed tests
(SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from light_loam_tpu.config import MappingConfig
from light_loam_tpu.core import quaternion as quat
from light_loam_tpu.core.frame import PointCloud
from light_loam_tpu.models.mapping import MappingState, mapping_step
from light_loam_tpu.parallel import (
    make_mesh,
    shard_mapping_state,
    sharded_mapping_step,
)
from light_loam_tpu.utils.synthetic import World, simulate_scan

CFG = MappingConfig(
    map_corner_capacity=8192,
    map_surf_capacity=16384,
    local_corner_capacity=8192,
    local_surf_capacity=16384,
    stack_corner_capacity=512,
    stack_surf_capacity=2048,
    knn_tile=1024,
)


def clouds_for_frame(world, pos, rng, seed):
    pts = simulate_scan(world, pos, n_azimuth=500, noise=0.005, seed=seed)
    idx = rng.permutation(len(pts))

    def as_cloud(p, cap):
        xyz = np.zeros((cap, 3), np.float32)
        mask = np.zeros(cap, bool)
        m = min(len(p), cap)
        xyz[:m] = p[:m]
        mask[:m] = True
        return PointCloud(xyz=jnp.asarray(xyz), rel=jnp.zeros(cap),
                          mask=jnp.asarray(mask))

    return as_cloud(pts[idx[:400]], 512), as_cloud(pts[idx[400:2400]], 2048)


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_sharded_matches_single_chip(n_devices):
    if len(jax.devices()) < n_devices:
        pytest.skip("not enough devices")
    world = World.urban(seed=11)
    rng = np.random.default_rng(0)
    mesh = make_mesh(n_devices)

    single = MappingState.init(CFG)
    sharded = shard_mapping_state(MappingState.init(CFG), mesh, CFG)

    # One-step equivalence at 10 successive map states: the sharded step
    # runs from a resharding of the SAME pre-step state the single-chip
    # step sees, so each frame is an independent equivalence check at a
    # progressively richer map.  (Free-running both paths instead turns
    # borderline 1 m^2 gate flips — which XLA CPU's load-dependent
    # threaded reduction order makes run-to-run nondeterministic — into a
    # compounding random walk through the map feedback loop, measured at
    # up to ~5 cm over 10 frames: that gates noise, not the algorithm.)
    for k in range(10):
        pos = np.array([0.5 * k, 0.0, 0.0])
        c, s = clouds_for_frame(world, pos, rng, seed=30 + k)
        # odometry slightly off on purpose
        t_odom = jnp.asarray(pos.astype(np.float32) + np.float32(0.05))
        q_odom = quat.quat_identity()
        sharded = shard_mapping_state(single, mesh, CFG)
        single, out_s = mapping_step(single, c, s, q_odom, t_odom, CFG)
        sharded, out_m = sharded_mapping_step(
            sharded, c, s, q_odom, t_odom, CFG, mesh
        )

        t_single = np.asarray(out_s.t_w)
        t_multi = np.asarray(out_m.t_w)
        gap = float(np.linalg.norm(t_multi - t_single))
        # one-step gap only carries intra-solve reduction noise plus a
        # handful of borderline-gate flips — no compounding
        assert gap < 2e-2, f"frame {k}: sharded-vs-single gap {gap:.4f} m"
        assert abs(int(out_m.surf_factors) - int(out_s.surf_factors)) <= max(
            5, 0.03 * int(out_s.surf_factors)
        )
        # post-step map point totals agree (dedup slot ties only)
        n_s, n_m = int(out_s.map_surf_points), int(out_m.map_surf_points)
        assert abs(n_m - n_s) <= max(10, 0.02 * n_s)


def test_sharded_vote_mode_matches_single_chip():
    """The scan-to-map vote path (MappingConfig.vote_mode, the latent
    laserMapping.cpp:2057-2072 sites) must run and agree under sharding.
    Regression: sharded_mapping_step's vote branch referenced graphvote
    without importing it, so any vote_mode != 'off' crashed at trace time
    on the sharded path only."""
    import dataclasses

    cfg = dataclasses.replace(CFG, vote_mode="simple", vote_start_frame=2)
    world = World.urban(seed=11)
    rng = np.random.default_rng(0)
    mesh = make_mesh(min(4, len(jax.devices())))

    single = MappingState.init(cfg)
    for k in range(5):
        pos = np.array([0.5 * k, 0.0, 0.0])
        c, s = clouds_for_frame(world, pos, rng, seed=60 + k)
        t_odom = jnp.asarray(pos.astype(np.float32) + np.float32(0.05))
        q_odom = quat.quat_identity()
        sharded = shard_mapping_state(single, mesh, cfg)
        single, out_s = mapping_step(single, c, s, q_odom, t_odom, cfg)
        sharded, out_m = sharded_mapping_step(
            sharded, c, s, q_odom, t_odom, cfg, mesh
        )
        gap = float(np.linalg.norm(np.asarray(out_m.t_w) - np.asarray(out_s.t_w)))
        assert gap < 2e-2, f"frame {k}: sharded-vs-single gap {gap:.4f} m"
        # once the vote engages (frame > vote_start_frame) both paths must
        # gate the same factor population (vote chunking is replicated)
        assert abs(int(out_m.surf_factors) - int(out_s.surf_factors)) <= max(
            5, 0.03 * int(out_s.surf_factors)
        )
    # the vote actually engaged: selection dropped factors vs the raw count
    assert int(out_s.surf_factors) > 0


def test_sharded_state_is_actually_sharded():
    mesh = make_mesh(8)
    state = shard_mapping_state(MappingState.init(CFG), mesh, CFG)
    sh = state.surf.xyz.sharding
    assert sh.is_fully_replicated is False


def test_voxel_ownership_partition():
    """Every point must land on its dedup-voxel-hash owner's slice, with
    nothing lost; same-voxel points must share an owner (dedup locality);
    and ownership must balance far better than the heavy-cell skew the
    old cell-hash design had (see parallel/sharded.py docstring)."""
    from light_loam_tpu.parallel.sharded import voxel_owner

    mesh = make_mesh(4)
    st = MappingState.init(CFG)
    n = 512
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-40, 40, size=(n, 3)).astype(np.float32)
    # include same-voxel duplicates
    xyz[n // 2:] = xyz[: n // 2] + rng.uniform(
        0, 0.05, size=(n // 2, 3)
    ).astype(np.float32)
    store = st.corner._replace(
        xyz=st.corner.xyz.at[:n].set(jnp.asarray(xyz)),
        cell=st.corner.cell.at[:n].set(0),
        mask=st.corner.mask.at[:n].set(True),
    )
    st = st._replace(corner=store)
    sharded = shard_mapping_state(st, mesh, CFG)
    cap = CFG.map_corner_capacity
    sx = np.asarray(sharded.corner.xyz)
    mask = np.asarray(sharded.corner.mask)
    shard_size = cap // 4
    counts = []
    for dev in range(4):
        seg = slice(dev * shard_size, (dev + 1) * shard_size)
        pts = sx[seg][mask[seg]]
        owners = np.asarray(
            voxel_owner(jnp.asarray(pts), CFG.line_resolution, 4)
        )
        assert (owners == dev).all()
        counts.append(len(pts))
    assert mask.sum() == n
    # hash balance: no shard holds more than half the points
    assert max(counts) <= n // 2, counts
