"""Batched multi-sequence mode vs single-stream equivalence.

models/batch.py promises "EXACTLY the single-stream pipeline per lane"
(the analog of running the reference once per KITTI sequence, BASELINE
eval config #4).  The headline bench number rides batched_frame_step, so
this gates that a vmapped lane computes the same trajectory as the
single-stream step functions it wraps — on distinct per-lane sequences,
over several frames, through both the odometry and mapping stages."""

import numpy as np
import jax

from light_loam_tpu.config import (
    MappingConfig,
    OdometryConfig,
    PipelineConfig,
    ScanConfig,
)
from light_loam_tpu.models.batch import batched_frame_step, init_batch_state
from light_loam_tpu.models.mapping import MappingState, mapping_step
from light_loam_tpu.models.odometry import OdometryState, odometry_step
from light_loam_tpu.ops.features import extract_features
from light_loam_tpu.utils.synthetic import World, simulate_scan, pad_cloud

CFG = PipelineConfig(
    # rich enough scans that lanes actually TRACK (~0.5 m/frame recovered)
    # — an equivalence gate between two diverged runs would prove nothing
    scan=ScanConfig(n_scans=16, h_max=512, max_points=8192),
    odometry=OdometryConfig(outer_iterations=2, inner_iterations=3),
    mapping=MappingConfig(
        map_corner_capacity=2048, map_surf_capacity=4096,
        local_corner_capacity=2048, local_surf_capacity=4096,
        stack_corner_capacity=512, stack_surf_capacity=1024,
        knn_tile=512,
    ),
)
B, N_FRAMES = 3, 4


def _lane_frames():
    world = World.urban(seed=6)
    frames = []  # frames[i] = list of (xyz, mask) per lane
    for i in range(N_FRAMES):
        lanes = []
        for b in range(B):
            # distinct trajectories per lane: different lateral offset
            # so lanes exercise different geometry
            pts = simulate_scan(
                world, np.array([0.5 * i, 0.6 * b - 0.6, 0.0]), n_rings=16,
                lower_deg=-15.0, upper_deg=15.0, n_azimuth=450,
                noise=0.01, seed=31 * b + i,
            )
            lanes.append(pad_cloud(pts, CFG.scan.max_points))
        frames.append(lanes)
    return frames


def test_batched_lanes_match_single_stream():
    frames = _lane_frames()

    # --- single-stream: the same step functions batched_frame_step wraps
    odo_cfg, map_cfg = CFG.odometry, CFG.mapping
    single_odo_t, single_map_t = [], []
    for b in range(B):
        odo_state = OdometryState.init(
            CFG.scan.max_less_sharp, CFG.scan.max_less_flat
        )
        map_state = MappingState.init(CFG.mapping)
        for i in range(N_FRAMES):
            xyz, mask = frames[i][b]
            feats = extract_features(xyz, mask, CFG.scan)
            odo_state, odo = odometry_step(
                odo_state, feats, odo_cfg, CFG.scan.scan_period
            )
            map_state, mout = mapping_step(
                map_state, odo_state.corner_last, odo_state.surf_last,
                odo.q_w, odo.t_w, map_cfg,
            )
        single_odo_t.append(np.asarray(odo.t_w))
        single_map_t.append(np.asarray(mout.t_w))

    # --- batched: all lanes in one vmapped program
    state = init_batch_state(CFG, B)
    for i in range(N_FRAMES):
        xs = np.stack([frames[i][b][0] for b in range(B)])
        ms = np.stack([frames[i][b][1] for b in range(B)])
        state, odo_b, mout_b = batched_frame_step(state, xs, ms, CFG)
    jax.block_until_ready(mout_b.t_w)

    # lanes moved (the comparison is not trivially 0==0)
    assert np.linalg.norm(np.asarray(mout_b.t_w), axis=1).min() > 0.5

    # vmap may re-associate reductions, so allow float32 slack — but the
    # trajectories must agree far below any physical tolerance
    np.testing.assert_allclose(
        np.asarray(odo_b.t_w), np.stack(single_odo_t), atol=5e-4
    )
    # the mapping gate is looser: reassociated reductions shift borderline
    # residual-gate/inlier decisions, and the resulting mm-level pose
    # deltas compound through the map CONTENT each later frame registers
    # against (same mechanism as the documented sharded-vs-single ~5 mm/
    # frame random walk in parallel/sharded.py) — still ~100x under any
    # physical tolerance on this 1.5 m run
    np.testing.assert_allclose(
        np.asarray(mout_b.t_w), np.stack(single_map_t), atol=1e-2
    )


def test_batched_chunk_matches_per_frame_batched():
    """batched_chunk_step (lax.scan over K batched frames in ONE
    program) must match K sequential batched_frame_step calls lane for
    lane.  Tolerance: the scan body is a different XLA compilation of
    the same trace — few-mm/frame reassociation-x-gate-flip random walk
    (see tests/test_fused.py::test_chunked_scan_matches_per_frame_fused);
    gate at 3 cm over 4 frames, frame 1 tight."""
    from light_loam_tpu.models.batch import batched_chunk_step

    frames = _lane_frames()
    xs = np.stack([np.stack([lane[0] for lane in f]) for f in frames])
    ms = np.stack([np.stack([lane[1] for lane in f]) for f in frames])

    state = init_batch_state(CFG, B)
    per_frame_map_t = []
    for k in range(N_FRAMES):
        state, odo, mout = batched_frame_step(state, xs[k], ms[k], CFG)
        per_frame_map_t.append(np.asarray(mout.t_w))

    state2 = init_batch_state(CFG, B)
    state2, outs = batched_chunk_step(state2, xs, ms, CFG)
    odom_q, odom_t, map_q, map_t = (np.asarray(o) for o in outs)

    assert map_t.shape == (N_FRAMES, B, 3)
    np.testing.assert_allclose(map_t, np.stack(per_frame_map_t),
                               rtol=0, atol=3e-2)
    np.testing.assert_allclose(map_t[1], per_frame_map_t[1],
                               rtol=0, atol=1e-3)
    # final carried state agrees
    np.testing.assert_allclose(np.asarray(state2.odometry.t_w),
                               np.asarray(state.odometry.t_w),
                               rtol=0, atol=3e-2)
