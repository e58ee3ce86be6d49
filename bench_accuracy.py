"""On-device trajectory-accuracy probe.

Accuracy is a property of the device as well as of the algorithm: the
distance matmuls need exact f32 (see light_loam_tpu/__init__.py), and a
reduced-precision tier can make long trajectories diverge on an
accelerator while the identical program tracks on the CPU.  The CPU test
suite therefore cannot certify a precision tier — this probe replays the
loop-trajectory accuracy gate (tests/test_trajectory_gates.py) on
whatever device and LLT_MATMUL_PRECISION tier the process was started
with, and prints ONE JSON line so tiers can be compared:

    timeout 590 python bench_accuracy.py                 # highest (default)
    LLT_MATMUL_PRECISION=high timeout 590 python bench_accuracy.py

Protocol: 48-frame 360-degree loop on the ring-road world (World.loop,
r=25 — 157 m path, 3.3 m / 7.5 deg per frame), flagship HDL-64 profile.
The trajectory starts at the origin with yaw 0 so the SLAM frame
(frame-0 sensor frame) coincides with the world frame; ATE needs no
alignment.  Reference protocol: offline KITTI scoring of the written
trajectory (laserMapping.cpp:2284-2326, SURVEY §4).
"""

import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from light_loam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    from light_loam_tpu.models.pipeline import PROFILES, Pipeline
    from light_loam_tpu.utils.synthetic import World, pad_cloud, simulate_scan

    # sensor geometry per profile (BASELINE eval configs: the flagship
    # HDL-64 protocol plus the VLP-16 sparse one)
    profile = os.environ.get("LLT_ACC_PROFILE", "hdl64")
    beams = {
        "hdl64": dict(n_rings=64, lower_deg=-24.9, upper_deg=2.0),
        "vlp16": dict(n_rings=16, lower_deg=-15.0, upper_deg=15.0),
        "hdl32": dict(n_rings=32, lower_deg=-30.67, upper_deg=10.67),
        "m2dgr": dict(n_rings=32, lower_deg=-25.0, upper_deg=15.0),
    }[profile]
    cfg = PROFILES[profile]
    # LLT_ACC_FUSED=1: run the fused one-program-per-frame latency mode
    # (models/fused.py) — the accuracy A/B proving the fused path at
    # trajectory scale, beyond tests/test_fused.py's short gate.
    fused = os.environ.get("LLT_ACC_FUSED", "0") == "1"
    if fused:
        import dataclasses

        cfg = dataclasses.replace(cfg, fused_step=True)
    # LLT_LESSFLAT_MODE=exact|runs: accuracy A/B for the less-flat
    # downsample algorithm (ScanConfig.lessflat_mode) — pairs with
    # bench.py's same-named perf knob.
    lf_forced = os.environ.get("LLT_LESSFLAT_MODE", "").strip()
    if lf_forced:
        import dataclasses

        cfg = dataclasses.replace(
            cfg, scan=dataclasses.replace(cfg.scan,
                                          lessflat_mode=lf_forced))
        log(f"lessflat_mode forced to {lf_forced!r}")
    # LLT_ACC_CHUNK=K: replay through the chunked offline runner
    # (models/fused.run_chunked) — trajectory-scale validation that the
    # scan-compiled path's mm/frame compilation-variant walk stays
    # bounded (tests gate 6 frames; this gates a full loop).
    chunk = int(os.environ.get("LLT_ACC_CHUNK", "0"))
    tier = os.environ.get("LLT_MATMUL_PRECISION", "highest")
    log(f"devices: {jax.devices()}  precision tier: {tier}  "
        f"profile: {profile}  fused: {fused}")

    mode = os.environ.get("LLT_ACC_MODE", "loop")
    # long-horizon: LLT_ACC_REVS>1 drives REVS full revolutions of the
    # ring road (frame count scales with it) — revisits mapped territory,
    # so map-consistency errors compound instead of averaging out.
    revs = int(os.environ.get("LLT_ACC_REVS", "1"))
    n_frames = int(os.environ.get("LLT_ACC_FRAMES", str(48 * revs)
                                  if mode == "loop" else "100"))
    radius = 25.0
    frames = []
    truth = []
    yaws = []
    if mode == "loop":
        world = World.loop(seed=5, radius=radius)
        for i in range(n_frames):
            th = 2 * np.pi * revs * i / n_frames
            yaws.append(th)
            pos = np.array([radius * np.sin(th),
                            radius * (1 - np.cos(th)), 0.0])
            pts = simulate_scan(world, pos, sensor_yaw=th, n_azimuth=1800,
                                noise=0.01, seed=500 + i, **beams)
            frames.append(pad_cloud(pts, cfg.scan.max_points))
            truth.append(pos)
        path_len = 2 * np.pi * radius * revs
    else:  # straight: 1 m/frame down the urban corridor
        world = World.urban(seed=0)
        for i in range(n_frames):
            pos = np.array([1.0 * i, 0.0, 0.0])
            pts = simulate_scan(world, pos, n_azimuth=1800,
                                noise=0.01, seed=500 + i, **beams)
            frames.append(pad_cloud(pts, cfg.scan.max_points))
            truth.append(pos)
        path_len = 1.0 * (n_frames - 1)
    truth = np.asarray(truth)
    log(f"simulated {n_frames} {mode} frames (~{int(frames[0][1].sum())} pts)")

    t0 = time.time()
    if chunk > 1:
        from light_loam_tpu.models.fused import run_chunked

        _, _, outs = run_chunked(iter(frames), cfg, chunk_size=chunk)
        est_q, est = np.asarray(outs.map_q), np.asarray(outs.map_t)
        wall = time.time() - t0
    else:
        pipe = Pipeline(cfg)
        for i, (xyz, mask) in enumerate(frames):
            pipe.process_frame(xyz, mask)
            if i == 0:
                log(f"first frame (incl. compiles): {time.time()-t0:.1f}s")
            elif i % 48 == 0:  # heartbeat for multi-hour long-horizon runs
                log(f"frame {i}/{n_frames}  ({(time.time()-t0)/i:.2f} s/frame)")
        pipe._retire_mapping(wait=True)
        wall = time.time() - t0

        est_q, est = pipe.mapped_trajectory()
    n = min(len(est), len(truth))
    err = est[:n] - truth[:n]
    ate = float(np.sqrt((err ** 2).sum(1).mean()))
    closure = float(np.linalg.norm(err[n - 1]))

    # KITTI relative errors (the paper's headline metric) when the path
    # offers >=100 m segments; GT orientation is yaw-about-z (loop) or
    # identity (straight)
    kitti = None
    if path_len >= 110.0:
        from light_loam_tpu.io.evaluation import (
            kitti_relative_errors, poses_from_quat_trans,
        )
        gt_yaw = np.asarray(yaws[:n]) if yaws else np.zeros(n)
        gt_q = np.stack([np.zeros(n), np.zeros(n),
                         np.sin(gt_yaw / 2), np.cos(gt_yaw / 2)], axis=1)
        k = kitti_relative_errors(
            poses_from_quat_trans(est_q[:n], est[:n]),
            poses_from_quat_trans(gt_q, truth[:n]),
        )
        if k.n_segments:
            kitti = {"t_err_percent": round(k.t_err_percent, 4),
                     "r_err_deg_per_m": round(k.r_err_deg_per_m, 6),
                     "n_segments": k.n_segments}
    record = {
        "metric": f"{mode}{n_frames}_ate_rmse",
        "value": round(ate, 4),
        "unit": "m",
        "ate_pct_of_path": round(100 * ate / path_len, 4),
        "closure_m": round(closure, 4),
        "frames": n,
        "revs": revs if mode == "loop" else None,
        "kitti": kitti,
        "profile": profile,
        "precision": tier,
        "fused": fused,
        "chunk": chunk or None,
        "platform": jax.devices()[0].platform,
        "wall_s": round(wall, 1),
    }
    log(f"ATE {ate:.4f} m ({100*ate/path_len:.3f}% of {path_len:.0f} m), "
        f"closure {closure:.4f} m, wall {wall:.1f}s")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
