"""Smoke test: the flagship HDL-64 SLAM pipeline on the GPU.

    python chip_smoke.py           # one card, every phase below
    python chip_smoke.py --four    # four cards: the sharded paths only

Phases, each printing its lines; any failure exits non-zero:

  device     JAX must find a GPU (never falls back to the CPU); prints the
             device kind, JAX version, XLA_FLAGS, compile cache, native
             loader and the nvidia-smi name and power limit
  precision  ops.knn.pairwise_sq_dist at ~100 m coordinates against
             float64 (≤ 1e-2 m²; TF32 would give metres²)
  bits       int32/uint32 payloads with denormal and NaN bit patterns
             through compact_rows' packed path and merge_sorted's output
             pass: bit-exact against NumPy
  main path  Pipeline(HDL64_KITTI).process_frame over 24 synthetic frames
             (bench.make_frames protocol) and the pipeline CLI's
             --synthetic entry point: finite poses, mapped ATE < 1 % of
             the path
  kernels    the fused 5-NN kernel and knn_tiled on a real local map at
             full width against float64; the XLA vote at R=10, K=163
  modes      fused, chunked (K=12) and batched (B=4) runs against the
             staged trajectory, at their CPU tests' tolerances

With --four only the sharded phase runs: sharded_mapping_step over a
4-card mesh against single-card mapping_step on the same odometry
outputs, and the lane-sharded batched step against the one-card one.

The last line of stdout is the result:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import os
import sys

FOUR = "--four" in sys.argv[1:]
if not FOUR:
    # JAX reserves most of the memory of every card it can see
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# tolerances (see each check's docstring)
DIST_TOL = 2e-3      # m²: f32 cancellation in |q|²+|r|²-2q·r at |p|² ~ 1e4
PRECISION_TOL = 1e-2  # m²
EPS32 = 2.0 ** -23
N_FRAMES = 24
STEP = 0.8           # m/frame, bench.make_frames


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def result_line(dev, count: int) -> str:
    """The contract's last line."""
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}})


# ---------------------------------------------------------------- checks


def knn_reference_f64(q, r, m, k):
    """Float64 brute force: (sorted sq distances (Q, k+1), indices)."""
    live = np.flatnonzero(m)
    r64 = r[live].astype(np.float64)
    ds, idx = [], []
    for s in range(0, len(q), 512):
        d = ((q[s:s + 512, None, :].astype(np.float64)
              - r64[None]) ** 2).sum(-1)
        o = np.argsort(d, axis=1, kind="stable")[:, :k + 1]
        ds.append(np.take_along_axis(d, o, axis=1))
        idx.append(live[o])
    return np.concatenate(ds), np.concatenate(idx)


def check_knn(d, i, q, r, m, k, tol=DIST_TOL):
    """(max |d - d64|, rows whose indices differ from float64 although
    the float64 (k+1)-nearest distances are all more than ``tol`` apart,
    rows checked).  Equal-distance tie order may differ."""
    d64, i64 = knn_reference_f64(q, r, m, k)
    err = float(np.abs(np.asarray(d, np.float64) - d64[:, :k]).max())
    separated = (np.diff(d64, axis=1) > tol).all(axis=1)
    bad = int((np.asarray(i)[separated] != i64[separated, :k])
              .any(axis=1).sum())
    return err, bad, int(separated.sum())


def votes_reference_f64(src, tgt, valid, threshold, resolution):
    def dist(p):
        p = p.astype(np.float64)
        return np.sqrt(((p[:, :, None] - p[:, None, :]) ** 2).sum(-1))

    gap = dist(src) - dist(tgt)
    score = np.exp(-gap * gap / resolution ** 2)
    K = src.shape[1]
    pair = (valid[:, :, None] > 0) & (valid[:, None, :] > 0) & ~np.eye(K, dtype=bool)
    return ((score < threshold) & pair).sum(-1).astype(np.float64)


def check_votes(votes, src, tgt, valid, threshold=0.96, resolution=1.0):
    """(share of rows whose vote count differs from float64, largest
    difference).  f32 distances move scores next to the threshold by a
    few 1e-3, so at most 1 % of rows may differ, by one vote."""
    v64 = votes_reference_f64(src, tgt, valid, threshold, resolution)
    diff = np.abs(np.asarray(votes, np.float64) - v64)
    return float((diff > 0).mean()), float(diff.max())


# ---------------------------------------------------------------- phases


def phase_device():
    from light_loam_tpu.utils.compile_cache import enable_compile_cache
    from light_loam_tpu.utils.device import nvidia_smi_line, require_gpu

    dev = require_gpu("chip_smoke.py")
    cache = enable_compile_cache()
    try:
        from light_loam_tpu import _native  # noqa: F401
        native = "built (C loader in use)"
    except ImportError:
        native = "not built (NumPy loader in use)"
    log(f"[device] kind={dev.device_kind!r} count={len(jax.devices())} "
        f"jax={jax.__version__}")
    log(f"[device] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[device] compile cache: {cache}")
    log(f"[device] native loader: {native}")
    log(f"[device] nvidia-smi: {nvidia_smi_line()}")
    return dev


def phase_precision():
    """Pairs inside the 25 m² correspondence gate, 100 m from the origin:
    the cross terms are ~1e4 m², so exact f32 is off by a few ulps of
    2e4 m² (~5e-3 m²) and TF32 (10 mantissa bits) by metres²."""
    from light_loam_tpu.ops.knn import pairwise_sq_dist

    rng = np.random.default_rng(0)
    u = rng.normal(size=(1024, 3))
    a = (100.0 * u / np.linalg.norm(u, axis=1, keepdims=True))
    b = a[rng.integers(0, 1024, 2048)] + rng.uniform(-3, 3, (2048, 3))
    a, b = a.astype(np.float32), b.astype(np.float32)
    d = np.asarray(jax.jit(pairwise_sq_dist)(jnp.asarray(a), jnp.asarray(b)))
    d64 = ((a[:, None].astype(np.float64) - b[None]) ** 2).sum(-1)
    near = d64 < 25.0
    err = float(np.abs(d - d64)[near].max())
    log(f"[precision] pairwise_sq_dist at 100 m, {int(near.sum())} pairs "
        f"under 25 m²: max |err| vs float64 {err:.3e} m² "
        f"(limit {PRECISION_TOL})")
    if not err <= PRECISION_TOL:
        fail(f"precision: {err} m² > {PRECISION_TOL}")


_PATTERNS = np.array([0, 1, 2, 0x7FFFFF, 0x800000 - 1, 0x7F800001,
                      0x7FC00000, 0xFFC00001, 0x80000001, 0xFFFFFFFF,
                      0x00400000, 0x7F7FFFFF], np.uint32)


def phase_bits():
    """Integer payloads ride packed f32 rows bit for bit."""
    from light_loam_tpu.ops.sorted_store import merge_sorted
    from light_loam_tpu.ops.voxel import compact_rows

    rng = np.random.default_rng(1)
    n, cap = 4096, 3000
    mask = rng.random(n) < 0.7
    xyz = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    bits = np.concatenate([_PATTERNS, rng.integers(0, 2**32, n - len(_PATTERNS),
                                                   dtype=np.uint32)])
    ci = bits.view(np.int32).copy()
    cu = np.roll(bits, 5)
    out = jax.jit(compact_rows, static_argnums=1)(
        jnp.asarray(mask), cap, jnp.asarray(xyz), jnp.asarray(ci),
        jnp.asarray(cu))
    live = np.flatnonzero(mask)[:cap]
    want = [np.zeros((cap, 3), np.float32), np.zeros(cap, np.int32),
            np.zeros(cap, np.uint32)]
    for w, a in zip(want, (xyz, ci, cu)):
        w[:len(live)] = a[live]
    ok_mask = np.array_equal(np.asarray(out[0]), np.arange(cap) < len(live))
    ok = [np.array_equal(np.asarray(o).view(np.uint32), w.view(np.uint32))
          for o, w in zip(out[1:], want)]
    log(f"[bits] compact_rows packed (f32, int32, uint32): mask "
        f"{ok_mask}, bit-exact {ok}")
    if not (ok_mask and all(ok)):
        fail("compact_rows changed payload bits")

    # merge_sorted: cell ids (small int32 = f32 denormals) ride the packed
    # output gather.  Points sit at voxel centres, one per voxel, all
    # fresh, so the NumPy answer is the key-sorted union.
    leaf, n_store, n_new = 0.8, 2048, 512
    cells_all = rng.integers(0, 4851, n_store + n_new).astype(np.int32)
    ijk = rng.choice(60 ** 3, n_store + n_new, replace=False)
    ijk = np.stack(np.unravel_index(ijk, (60, 60, 60)), axis=1) - 30
    pts = ((ijk + 0.5) * leaf).astype(np.float32)
    bias, rng_ax = 1 << 14, 1 << 15
    vox = ijk + bias
    major = vox[:, 2] + cells_all.astype(np.int64) * rng_ax
    minor = vox[:, 0] * rng_ax + vox[:, 1]
    order_s = np.lexsort((minor[:n_store], major[:n_store]))
    cap_s = 4096
    s_xyz = np.zeros((cap_s, 3), np.float32)
    s_cell = np.zeros(cap_s, np.int32)
    s_mask = np.zeros(cap_s, bool)
    s_xyz[:n_store] = pts[:n_store][order_s]
    s_cell[:n_store] = cells_all[:n_store][order_s]
    s_mask[:n_store] = True
    o_xyz, o_cell, o_mask = jax.jit(merge_sorted, static_argnums=6)(
        jnp.asarray(s_xyz), jnp.asarray(s_cell), jnp.asarray(s_mask),
        jnp.asarray(pts[n_store:]), jnp.asarray(cells_all[n_store:]),
        jnp.ones(n_new, bool), leaf)
    order = np.lexsort((minor, major))
    n_all = n_store + n_new
    ok = (np.array_equal(np.asarray(o_mask), np.arange(cap_s) < n_all)
          and np.array_equal(np.asarray(o_cell)[:n_all].view(np.uint32),
                             cells_all[order].view(np.uint32))
          and np.array_equal(np.asarray(o_xyz)[:n_all].view(np.uint32),
                             pts[order].view(np.uint32)))
    log(f"[bits] merge_sorted output pass (cell ids as f32 denormals): "
        f"bit-exact {ok}")
    if not ok:
        fail("merge_sorted changed cell-id bits")


def phase_main_path(cfg, frames):
    from light_loam_tpu.models.pipeline import Pipeline

    pipe = Pipeline(cfg)
    results, walls = [], []
    for xyz, mask in frames:
        t0 = time.perf_counter()
        results.append(pipe.process_frame(xyz, mask))
        walls.append(time.perf_counter() - t0)
    poses = np.stack([np.concatenate([r.odom_q, r.odom_t, r.map_q, r.map_t])
                      for r in results])
    est = pipe.mapped_positions()
    truth = np.stack([[STEP * i, 0.0, 0.0] for i in range(len(frames))])
    ate = float(np.sqrt(((est - truth) ** 2).sum(1).mean()))
    path = STEP * (len(frames) - 1)
    steady = np.median(walls[4:]) * 1e3
    log(f"[main] staged Pipeline(HDL64_KITTI), {len(frames)} frames: first "
        f"frame (compile) {walls[0]:.1f} s, steady {steady:.2f} ms/frame")
    log(f"[main] mapped ATE {ate:.4f} m = {100 * ate / path:.3f} % of "
        f"{path:.1f} m; all poses finite: {np.isfinite(poses).all()}; "
        f"diverged frames {pipe.diverged_frames}")
    log(pipe.timers.report())
    if not np.isfinite(poses).all():
        fail("non-finite pose on the staged path")
    if not ate < 0.01 * path:
        fail(f"mapped ATE {ate} m >= 1 % of {path} m")
    return pipe, results


def phase_cli(n_frames=8):
    from light_loam_tpu.models import pipeline

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pipeline.main(["--synthetic", "--frames", str(n_frames)])
    text = buf.getvalue()
    log("[cli] python -m light_loam_tpu.models.pipeline --synthetic "
        f"--frames {n_frames}:")
    log(text.rstrip())
    m = re.search(r"final mapped pose error: ([0-9.eE+-]+|nan|inf) m", text)
    if m is None:
        fail("CLI printed no mapped pose error")
    err, path = float(m.group(1)), 1.0 * (n_frames - 1)
    if not err < 0.01 * path:
        fail(f"CLI final mapped pose error {err} m >= 1 % of {path} m")


def phase_kernels(cfg, pipe, interpret=False):
    from light_loam_tpu.core import quaternion as quat
    from light_loam_tpu.models.mapping import _cube_of, _gather_local
    from light_loam_tpu.ops import knn
    from light_loam_tpu.ops.graphvote import compat_votes
    from light_loam_tpu.ops.pallas_knn import knn_pallas
    from light_loam_tpu.ops.voxel import voxel_downsample

    mcfg = cfg.mapping
    ms, surf = pipe.map_state, pipe.odo_state.surf_last
    q_w, t_w = (jnp.asarray(a) for a in pipe._last_map_pose)
    center = _cube_of(t_w[None], ms.cen, mcfg)[0]
    local, local_m, _ = _gather_local(ms.surf, center, mcfg,
                                      mcfg.local_surf_capacity)
    sx, _, sm, _ = voxel_downsample(surf.xyz, surf.rel, surf.mask,
                                    mcfg.plane_resolution,
                                    mcfg.stack_surf_capacity)
    query = quat.quat_rotate(q_w[None], sx) + t_w[None]
    n_q, n_r = int(sm.sum()), int(local_m.sum())
    k = mcfg.knn_k
    d_p, i_p = knn_pallas(query, local, local_m, k=k, interpret=interpret,
                          query_count=n_q, ref_count=n_r)
    d_x, i_x = jax.jit(knn.knn_tiled, static_argnames=("k", "tile"))(
        query, local, local_m, k=k, tile=mcfg.knn_tile, ref_count=n_r)
    q_h, r_h, m_h = (np.asarray(a) for a in (query, local, local_m))
    log(f"[kernels] 5-NN: Q={query.shape[0]} ({n_q} live) against a "
        f"{local.shape[0]}-point local map ({n_r} live)")
    # the kernel computes (q-r)·(q-r) directly; knn_tiled's expansion
    # loses a few ulps of |q|²+|r|², so its rows are held to that bound
    # (and where both match float64 on tie-free rows, they match each
    # other)
    sq = float((q_h[:n_q] ** 2).sum(1).max() + (r_h[m_h] ** 2).sum(1).max())
    cancel_tol = max(DIST_TOL, 4 * EPS32 * sq)
    for name, d, i, tol in (("pallas", d_p, i_p, DIST_TOL),
                            ("knn_tiled", d_x, i_x, cancel_tol)):
        err, bad, rows = check_knn(np.asarray(d)[:n_q], np.asarray(i)[:n_q],
                                   q_h[:n_q], r_h, m_h, k, tol)
        log(f"[kernels] {name}: max |d - d64| {err:.3e} m² (tolerance "
            f"{tol:.1e}), index mismatches {bad} of {rows} tie-free rows")
        if not (err <= tol and bad == 0):
            fail(f"{name} 5-NN outside tolerance")

    # vote: R=10 chunks of K = max_flat // 10 + 10 (models/odometry.py),
    # src = real flat features, tgt = src under a small motion with
    # outliers (laserOdometry.cpp:751-757 pairs)
    R = cfg.odometry.plane_vote_regions
    K = cfg.scan.max_flat // R + R
    pts = np.asarray(surf.xyz)[np.asarray(surf.mask)][: R * K]
    rng = np.random.default_rng(2)
    src = pts.reshape(R, K, 3).astype(np.float32)
    c, s = np.cos(0.02), np.sin(0.02)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = src @ rot.T + np.float32([0.8, 0.05, 0.0])
    out = rng.random((R, K)) < 0.2
    tgt = np.where(out[..., None], tgt + rng.uniform(-3, 3, (R, K, 3)),
                   tgt).astype(np.float32)
    valid = (rng.random((R, K)) < 0.95).astype(np.float32)
    votes = jax.jit(compat_votes)(jnp.asarray(src), jnp.asarray(tgt),
                                  jnp.asarray(valid))
    frac, worst = check_votes(votes, src, tgt, valid)
    log(f"[kernels] XLA vote R={R} K={K}: rows differing from float64 "
        f"{100 * frac:.2f} %, largest difference {worst:.0f} vote(s)")
    if not (frac <= 0.01 and worst <= 1):
        fail("vote outside tolerance")


def _staged_reference(cfg, frames):
    """Per-frame (odom_t, map_t) of the staged step functions."""
    from light_loam_tpu.models.mapping import MappingState, mapping_step
    from light_loam_tpu.models.odometry import OdometryState, odometry_step
    from light_loam_tpu.ops.features import extract_features

    odo_s = OdometryState.init(cfg.scan.max_less_sharp, cfg.scan.max_less_flat)
    map_s = MappingState.init(cfg.mapping)
    out = []
    for xyz, mask in frames:
        feats = extract_features(jnp.asarray(xyz), jnp.asarray(mask), cfg.scan)
        odo_s, odo = odometry_step(odo_s, feats, cfg.odometry,
                                   cfg.scan.scan_period)
        map_s, mout = mapping_step(map_s, odo_s.corner_last, odo_s.surf_last,
                                   odo.q_w, odo.t_w, cfg.mapping)
        out.append((np.asarray(odo.t_w), np.asarray(mout.t_w)))
    return out


def _gate(name, got, want, atol):
    gap = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    log(f"[modes] {name}: max |Δ| {gap:.2e} (tolerance {atol:g})")
    if not gap <= atol:
        fail(f"{name}: {gap} > {atol}")


def _walk_gate(name, got, want, tag="modes"):
    """Per-frame positions of two compilations of the same trace.  On the
    GPU they differ by a random walk of ~5 mm/frame: reassociated
    reductions flip borderline correspondence gates (the 3 cm / 6 frames
    of tests/test_fused.py::test_chunked_scan_matches_per_frame_fused),
    so frame k may differ by 5 mm·(k+1)."""
    gap = np.abs(np.asarray(got) - np.asarray(want)).reshape(len(got), -1)
    limit = 5e-3 * np.arange(1, len(got) + 1)
    ratio = gap.max(axis=1) / limit
    k = int(ratio.argmax())
    log(f"[{tag}] {name}: max |Δ| {gap.max():.2e} m; worst frame {k}: "
        f"{gap[k].max():.2e} m (limit {limit[k]:.3f})")
    if not (ratio <= 1).all():
        fail(f"{name}: frame {k} differs by {gap[k].max()} m")


def phase_modes(cfg, frames, staged):
    """staged: the main path's FrameResults for ``frames``."""
    from light_loam_tpu.models.batch import batched_frame_step, init_batch_state
    from light_loam_tpu.models.fused import fused_chunk_step
    from light_loam_tpu.models.mapping import MappingState
    from light_loam_tpu.models.odometry import OdometryState
    from light_loam_tpu.models.pipeline import Pipeline

    # fused, chunked and batched are other XLA compilations of the
    # staged trace: on the CPU fused matches staged to 1e-4 m
    # (tests/test_fused.py), on the GPU all three follow _walk_gate
    fused = Pipeline(dataclasses.replace(cfg, fused_step=True))
    got = [fused.process_frame(xyz, mask) for xyz, mask in frames[:6]]
    for field in ("odom_t", "map_t"):
        _walk_gate(f"fused 6 frames {field}",
                   [getattr(r, field) for r in got],
                   [getattr(r, field) for r in staged[:6]])
    for field in ("odom_q", "map_q"):
        _gate(f"fused 6 frames {field}", [getattr(r, field) for r in got],
              [getattr(r, field) for r in staged[:6]], 1e-3)

    # chunked K=12
    K = 12
    odo = OdometryState.init(cfg.scan.max_less_sharp, cfg.scan.max_less_flat)
    mp = MappingState.init(cfg.mapping)
    xs = jnp.asarray(np.stack([f[0] for f in frames[:K]]))
    ms = jnp.asarray(np.stack([f[1] for f in frames[:K]]))
    _, _, outs = fused_chunk_step(odo, mp, xs, ms, cfg)
    want = np.stack([r.map_t for r in staged[:K]])
    if np.asarray(outs.diverged).any():
        fail("chunked: a frame diverged")
    _walk_gate("chunked K=12 map_t", outs.map_t, want)

    # batched B=4: lane b replays frames b..b+n-1 (tests/test_batch.py
    # on the CPU: odometry 5e-4 m, mapping 1e-2 m)
    B, n = 4, 6
    state = init_batch_state(cfg, B)
    lanes = []
    for i in range(n):
        xb = np.stack([frames[b + i][0] for b in range(B)])
        mb = np.stack([frames[b + i][1] for b in range(B)])
        state, odo_b, mout_b = batched_frame_step(state, xb, mb, cfg)
        lanes.append((np.asarray(odo_b.t_w), np.asarray(mout_b.t_w)))
    for b in range(B):
        ref = _staged_reference(cfg, frames[b:b + n])
        _walk_gate(f"batched lane {b} odom_t", [l[0][b] for l in lanes],
                   [r[0] for r in ref])
        _walk_gate(f"batched lane {b} map_t", [l[1][b] for l in lanes],
                   [r[1] for r in ref])


def phase_four(cfg, frames):
    """Sharded mapping and lane sharding across four cards."""
    from light_loam_tpu.models.batch import batched_frame_step, init_batch_state
    from light_loam_tpu.models.mapping import MappingState, mapping_step
    from light_loam_tpu.models.odometry import OdometryState, odometry_step
    from light_loam_tpu.ops.features import extract_features
    from light_loam_tpu.parallel import (
        make_mesh,
        shard_mapping_state,
        sharded_mapping_step,
    )
    from light_loam_tpu.parallel.batch_sharded import (
        init_sharded_batch_state,
        make_data_mesh,
        put_frames,
        sharded_batched_frame_step,
    )

    if len(jax.devices()) < 4:
        fail(f"--four needs 4 devices, JAX found {len(jax.devices())}")
    mcfg = cfg.mapping

    odo_s = OdometryState.init(cfg.scan.max_less_sharp, cfg.scan.max_less_flat)
    odo_out = []
    for xyz, mask in frames:
        feats = extract_features(jnp.asarray(xyz), jnp.asarray(mask), cfg.scan)
        odo_s, odo = odometry_step(odo_s, feats, cfg.odometry,
                                   cfg.scan.scan_period)
        odo_out.append((odo_s.corner_last, odo_s.surf_last, odo.q_w, odo.t_w))

    mesh = make_mesh(4)
    single = MappingState.init(mcfg)
    sharded = shard_mapping_state(MappingState.init(mcfg), mesh, mcfg)
    t0 = time.perf_counter()
    for k, (c, s, q, t) in enumerate(odo_out):
        single, out_s = mapping_step(single, c, s, q, t, mcfg)
        sharded, out_m = sharded_mapping_step(sharded, c, s, q, t, mcfg, mesh)
        gap = float(np.linalg.norm(np.asarray(out_m.t_w)
                                   - np.asarray(out_s.t_w)))
        limit = 0.02 + 0.005 * k
        n_s, n_m = int(out_s.map_surf_points), int(out_m.map_surf_points)
        log(f"[four] sharded mapping frame {k}: |Δt| {gap:.4f} m (limit "
            f"{limit:.3f}), surf factors {int(out_m.surf_factors)} vs "
            f"{int(out_s.surf_factors)}, map surf points {n_m} vs {n_s}")
        if not np.isfinite(np.asarray(out_m.t_w)).all() or gap > limit:
            fail(f"sharded mapping frame {k}: gap {gap} m > {limit}")
        if abs(n_m - n_s) > max(10, 0.02 * n_s):
            fail(f"sharded mapping frame {k}: map content {n_m} vs {n_s}")
    log(f"[four] sharded mapping: {len(odo_out)} frames in "
        f"{time.perf_counter() - t0:.1f} s (incl. compile)")
    for name, leaf in (("surf.xyz", sharded.surf.xyz),
                       ("corner.mask", sharded.corner.mask)):
        devs = sorted({str(sh.device) for sh in leaf.addressable_shards})
        log(f"[four] map state {name}: shards on {devs}")
        if len(devs) != 4:
            fail(f"map state {name} is not on four devices")

    B, n = 4, 3
    xb = [np.stack([frames[b + i][0] for b in range(B)]) for i in range(n)]
    mb = [np.stack([frames[b + i][1] for b in range(B)]) for i in range(n)]
    ref = init_batch_state(cfg, B)
    ref_t = []
    for i in range(n):
        ref, ref_odo, ref_out = batched_frame_step(ref, xb[i], mb[i], cfg)
        ref_t.append((np.asarray(ref_odo.t_w), np.asarray(ref_out.t_w)))
    dmesh = make_data_mesh(4)
    sh = init_sharded_batch_state(cfg, B, dmesh)
    sh_t = []
    for i in range(n):
        dx, dm = put_frames(xb[i], mb[i], dmesh)
        sh, sh_odo, sh_out = sharded_batched_frame_step(sh, dx, dm, cfg)
        sh_t.append((np.asarray(sh_odo.t_w), np.asarray(sh_out.t_w)))
    devs = sorted({str(s.device) for s in sh.mapping.surf.xyz.addressable_shards})
    log(f"[four] lane-sharded batch state surf.xyz: shards on {devs}")
    if len(devs) != 4:
        fail("lane-sharded state is not on four devices")
    # each device runs its B/4 lanes as its own program, a different
    # batch width than the one-card program: another compilation of the
    # same trace (_walk_gate)
    for j, name in enumerate(("odom_t", "map_t")):
        _walk_gate(f"lane-sharded B={B} {name}", [t[j] for t in sh_t],
                   [t[j] for t in ref_t], tag="four")


def main():
    from bench import make_frames
    from light_loam_tpu.config import HDL64_KITTI

    dev = phase_device()
    cfg = HDL64_KITTI
    if FOUR:
        frames = make_frames(cfg, 12)
        phase_four(cfg, frames)
        print(result_line(dev, len(jax.devices())))
        return
    phase_precision()
    phase_bits()
    frames = make_frames(cfg, N_FRAMES)
    pipe, staged = phase_main_path(cfg, frames)
    phase_cli()
    phase_kernels(cfg, pipe)
    phase_modes(cfg, frames, staged)
    print(result_line(dev, len(jax.devices())))


if __name__ == "__main__":
    main()
