"""Hard synthetic accuracy gates.

The reference's only accuracy verification is offline KITTI scoring of the
written trajectory (SURVEY §4; laserMapping.cpp:2284-2326).  KITTI data is
not vendored here, so these gates replay the same protocol on synthetic
worlds that exercise the two regimes a straight run never touches:

  * a full 360-degree loop (sustained yaw rate + return to start — drift
    that a straight-line gate can't see shows up as loop-closure error);
  * a long corridor (near-degenerate geometry: the along-axis direction is
    only weakly constrained — the classic LiDAR-SLAM failure mode), gated
    on graceful degradation: finite poses, off-axis pinned, no crash.
    Probes showed forward motion is under-tracked ~10x even with clutter
    and an end wall — inherent to the reference's factor/vote mathematics
    (see World.corridor), so tracking is NOT gated there.

Probe context (2026-08-17, CPU): 72-frame loop r=25 tracks at ATE RMSE
0.082 m (0.05% of the 157 m path), loop-closure 0.039 m.  Gates are set
~10x looser than measured so they catch regressions, not noise.
"""

import numpy as np
import pytest

from light_loam_tpu.models.pipeline import PROFILES, Pipeline
from light_loam_tpu.utils.synthetic import World, pad_cloud, simulate_scan


def _run_trajectory(world, poses_yaw, cfg, n_azimuth=600, seed0=500):
    pipe = Pipeline(cfg)
    for i, (pos, yaw) in enumerate(poses_yaw):
        pts = simulate_scan(world, pos, sensor_yaw=yaw, n_azimuth=n_azimuth,
                            noise=0.01, seed=seed0 + i)
        xyz, mask = pad_cloud(pts, cfg.scan.max_points)
        pipe.process_frame(xyz, mask)
    pipe._retire_mapping(wait=True)
    return pipe


@pytest.mark.slow
def test_loop_trajectory_gate():
    """Full 360-degree loop on the ring-road world: ATE and loop-closure
    error must stay well under 1% of the path length.  The trajectory
    starts at the origin with yaw 0, so the SLAM frame (frame-0 sensor
    frame) coincides with the world frame and no alignment is needed."""
    cfg = PROFILES["hdl64-small"]
    radius = 25.0
    n_frames = 48  # 3.3 m / 7.5 deg per frame — KITTI-urban turn rates
    world = World.loop(seed=5, radius=radius)
    poses = []
    truth = []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        pos = np.array([radius * np.sin(th), radius * (1 - np.cos(th)), 0.0])
        poses.append((pos, th))
        truth.append(pos)
    pipe = _run_trajectory(world, poses, cfg)
    truth = np.asarray(truth)
    est = pipe.mapped_positions()
    n = min(len(est), len(truth))
    assert n >= n_frames - 1
    err = est[:n] - truth[:n]
    ate = float(np.sqrt((err ** 2).sum(1).mean()))
    path_len = 2 * np.pi * radius
    assert ate < 0.01 * path_len, f"loop ATE {ate:.3f} m on {path_len:.0f} m"
    closure = float(np.linalg.norm(err[n - 1]))
    assert closure < 0.8, f"loop-closure error {closure:.3f} m"


@pytest.mark.slow
def test_corridor_degenerate_is_contained():
    """Degenerate corridor: forward (x) translation is structurally
    under-observed and the pipeline under-tracks it ~10x — faithfully
    reproducing the reference algorithm's corridor degeneracy (see
    World.corridor's docstring for the two mechanisms; both are inherent
    to the factor/vote mathematics the reference uses).  The gate is
    graceful degradation, the property the system CAN promise: finite
    poses every frame, off-axis (y, z) pinned by the walls and ground to
    centimeters, no pipeline crash — the A3/M1 containment parity."""
    cfg = PROFILES["hdl64-small"]
    world = World.corridor(seed=3, n_clutter=6, end_wall_x=40.0)
    step = 0.8
    poses = [(np.array([step * i, 0.0, 0.0]), 0.0) for i in range(6)]
    pipe = _run_trajectory(world, poses, cfg, seed0=450)
    est = pipe.mapped_positions()
    assert np.isfinite(est).all(), "containment must keep poses finite"
    # off-axis (y, z) stays pinned by the walls and ground even though x
    # is free to drift (probe: |y| <= 0.002, |z| <= 0.007 over 8 frames)
    off_axis = np.abs(est[:, 1:])
    assert off_axis.max() < 0.1, f"off-axis drift {off_axis.max():.3f} m"
    # x must stay monotone-forward and bounded by truth: under-tracking,
    # never runaway
    assert (np.diff(est[:, 0]) > -0.05).all(), f"x not monotone: {est[:,0]}"
    assert est[:, 0].max() <= step * len(poses), "x overshot truth"
