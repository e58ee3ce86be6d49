"""End-to-end benchmark: SLAM frames/s on the flagship HDL-64 profile.

Synthetic HDL-64 scans (~108k points/frame: utils/synthetic.World.urban,
1800 azimuth, σ = 0.01 m, straight at 0.8 m/frame) through every run
mode, all in this one process on one GPU:

  single   staged features → odometry → mapping, three programs per frame
  fused    one program per frame (models/fused.py)
  chunked  K frames of one sequence per dispatch (fused_chunk_step)
  batched  B independent sequences vmapped into one program
  bchunk   B lanes × K frames per dispatch

Inputs are staged on the device first; every timed window ends in
jax.block_until_ready.  Headline: the fastest mode's frames/s;
vs_baseline = frames/s / 10, the reference's real-time 10 Hz budget
(src/scanRegistration.cpp:426-427, src/laserOdometry.cpp:922-923).

Prints ONE JSON line to stdout; diagnostics go to stderr.
"""

import json
import sys
import time

import numpy as np
import jax

from light_loam_tpu.config import HDL64_KITTI
from light_loam_tpu.models.batch import (
    batched_chunk_step,
    batched_frame_step,
    init_batch_state,
)
from light_loam_tpu.models.fused import fused_chunk_step, fused_frame_step
from light_loam_tpu.models.mapping import MappingState, mapping_step
from light_loam_tpu.models.odometry import OdometryState, odometry_step
from light_loam_tpu.ops.features import extract_features
from light_loam_tpu.utils.synthetic import World, pad_cloud, simulate_scan

BATCH = 8
CHUNK = 6
N_WARM = 2
N_BENCH = 10


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_frames(cfg, n, n_azimuth=1800):
    """The bench protocol's frames: frame i is scanned at x = 0.8·i m."""
    world = World.urban(seed=0)
    return [
        pad_cloud(simulate_scan(world, np.array([0.8 * i, 0.0, 0.0]),
                                n_azimuth=n_azimuth, noise=0.01, seed=i),
                  cfg.scan.max_points)
        for i in range(n)
    ]


def _init_states(cfg):
    return (OdometryState.init(cfg.scan.max_less_sharp,
                               cfg.scan.max_less_flat),
            MappingState.init(cfg.mapping))


def _timed(fn, n):
    """Seconds per call of ``fn`` (which returns device arrays) over n
    calls, the window closed by block_until_ready."""
    t0 = time.perf_counter()
    for i in range(n):
        out = fn(i)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def bench_single(cfg, frames):
    """Staged path, one sequence; also the per-stage times."""
    odo_state, map_state = _init_states(cfg)
    puts = [jax.device_put(f) for f in frames]

    def step(i):
        nonlocal odo_state, map_state
        feats = extract_features(*puts[i % len(puts)], cfg.scan)
        odo_state, odo = odometry_step(odo_state, feats, cfg.odometry,
                                       cfg.scan.scan_period)
        map_state, mout = mapping_step(
            map_state, odo_state.corner_last, odo_state.surf_last,
            odo.q_w, odo.t_w, cfg.mapping)
        return mout.t_w

    _timed(step, N_WARM)
    dt = _timed(lambda i: step(N_WARM + i), N_BENCH)

    x0, m0 = puts[0]
    feats = extract_features(x0, m0, cfg.scan)
    _, odo = odometry_step(odo_state, feats, cfg.odometry,
                           cfg.scan.scan_period)
    stage_s = {
        "features": _timed(lambda i: extract_features(x0, m0, cfg.scan), 8),
        "odometry": _timed(lambda i: odometry_step(
            odo_state, feats, cfg.odometry, cfg.scan.scan_period), 8),
        "mapping": _timed(lambda i: mapping_step(
            map_state, odo_state.corner_last, odo_state.surf_last,
            odo.q_w, odo.t_w, cfg.mapping), 8),
    }
    return 1.0 / dt, {"stage_ms": {k: v * 1e3 for k, v in stage_s.items()}}


def bench_fused(cfg, frames):
    odo_state, map_state = _init_states(cfg)
    puts = [jax.device_put(f) for f in frames]

    def step(i):
        nonlocal odo_state, map_state
        odo_state, map_state, _, mout, _ = fused_frame_step(
            odo_state, map_state, *puts[i % len(puts)], cfg)
        return mout.t_w

    _timed(step, N_WARM)
    return 1.0 / _timed(lambda i: step(N_WARM + i), N_BENCH), {}


def bench_chunked(cfg, frames):
    odo_state, map_state = _init_states(cfg)
    xs = jax.device_put(np.stack([f[0] for f in frames]))
    ms = jax.device_put(np.stack([f[1] for f in frames]))

    def step(_):
        nonlocal odo_state, map_state
        odo_state, map_state, outs = fused_chunk_step(odo_state, map_state,
                                                      xs, ms, cfg)
        return outs.map_t

    _timed(step, 1)
    return len(frames) / _timed(step, 4), {"chunk_frames": len(frames)}


def bench_batched(cfg, frames):
    """B lanes, lane b replaying the sequence phase-shifted by b frames."""
    n_f = len(frames)
    state = init_batch_state(cfg, BATCH)
    puts = [
        (jax.device_put(np.stack([frames[(i + b) % n_f][0]
                                  for b in range(BATCH)])),
         jax.device_put(np.stack([frames[(i + b) % n_f][1]
                                  for b in range(BATCH)])))
        for i in range(n_f)
    ]

    def step(i):
        nonlocal state
        state, _, mout = batched_frame_step(state, *puts[i % n_f], cfg)
        return mout.t_w

    _timed(step, N_WARM)
    dt = _timed(lambda i: step(N_WARM + i), 2 * N_BENCH)
    return BATCH / dt, {"batch": BATCH}


def bench_bchunk(cfg, frames):
    n_f = len(frames)
    state = init_batch_state(cfg, BATCH)
    xs = jax.device_put(np.stack([[frames[(k + b) % n_f][0]
                                   for b in range(BATCH)]
                                  for k in range(CHUNK)]))
    ms = jax.device_put(np.stack([[frames[(k + b) % n_f][1]
                                   for b in range(BATCH)]
                                  for k in range(CHUNK)]))

    def step(_):
        nonlocal state
        state, outs = batched_chunk_step(state, xs, ms, cfg)
        return outs[3]

    _timed(step, 1)
    return (CHUNK * BATCH / _timed(step, 4),
            {"batch": BATCH, "chunk_frames": CHUNK})


MODES = {
    "single": bench_single,
    "fused": bench_fused,
    "chunked": bench_chunked,
    "batched": bench_batched,
    "bchunk": bench_bchunk,
}


def pick_headline(results):
    """(mode, fps) of the fastest measured mode, or None.  All fps are
    frames/s (aggregate modes count every lane's frames), so the fastest
    mode wins whatever its class."""
    best = None
    for mode, rec in results.items():
        if rec is not None and (best is None or rec["fps"] > best[1]):
            best = (mode, rec["fps"])
    return best


def main():
    from light_loam_tpu.utils.compile_cache import enable_compile_cache
    from light_loam_tpu.utils.device import nvidia_smi_line, require_gpu

    dev = require_gpu("bench.py")
    enable_compile_cache()
    cfg = HDL64_KITTI
    frames = make_frames(cfg, N_WARM + N_BENCH)
    log(f"{len(frames)} synthetic frames, ~{int(frames[0][1].sum())} pts")

    results = {}
    for mode, fn in MODES.items():
        t0 = time.time()
        fps, extras = fn(cfg, frames)
        results[mode] = {"fps": fps, **extras}
        log(f"{mode}: {fps:.2f} frames/s  {extras}  "
            f"(wall incl. compile {time.time() - t0:.1f} s)")

    mode, fps = pick_headline(results)
    print(json.dumps({
        "metric": "slam_frames_per_s_hdl64_e2e",
        "value": fps,
        "unit": "frames/s",
        "vs_baseline": fps / 10.0,
        "mode": mode,
        "modes": results,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": nvidia_smi_line(),
    }))


if __name__ == "__main__":
    main()
