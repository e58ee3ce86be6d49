"""Backend A/B on the GPU: the measurements that set the backend defaults.

    python scripts/ab_backends.py kernel          # 5-NN kernel alone
    python scripts/ab_backends.py mapping surf vote

  kernel   knn_pallas (a few block shapes) against knn_tiled at the
           mapping widths (Q = 8192 stack queries, 65,536-capacity local
           map), both checked against float64
  mapping  staged pipeline (bench.bench_single): frames/s and the mapping
           stage with knn_backend "pallas" against "xla"
  surf     the same with surf_knn "grid" against "tiled" (odometry stage)
  vote     the odometry stage with the plane vote on against off (the
           vote's time inside the step), and the XLA vote alone at B=8

Each A/B runs in this one process, in alternating turns (A B, B A, ...).
Every line carries the card's name and power limit; a JSON summary goes
to chiprun_out/ab_backends.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from bench import bench_single, make_frames  # noqa: E402
from chip_smoke import DIST_TOL, check_knn  # noqa: E402
from light_loam_tpu.config import HDL64_KITTI  # noqa: E402
from light_loam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from light_loam_tpu.utils.device import nvidia_smi_line, require_gpu  # noqa: E402

TURNS = 4


def log(*a):
    print(*a, flush=True)


def _time(fn, n=20, reps=5):
    """Median over ``reps`` windows of the seconds per call of fn()."""
    jax.block_until_ready(fn())
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        jax.block_until_ready(r)
        out.append((time.perf_counter() - t0) / n)
    return float(np.median(out))


def ab_kernel(cfg):
    from light_loam_tpu.ops import knn
    from light_loam_tpu.ops.pallas_knn import knn_pallas
    from light_loam_tpu.ops.voxel import voxel_downsample
    from light_loam_tpu.utils.synthetic import World, simulate_scan

    m = cfg.mapping
    world = World.urban(seed=0)
    scans = [simulate_scan(world, np.array([0.8 * i, 0.0, 0.0]),
                           n_azimuth=1800, noise=0.01, seed=i)
             for i in range(4)]
    refs = np.concatenate(scans[:3]).astype(np.float32)
    pad = lambda p, cap: np.pad(p, ((0, cap - len(p)), (0, 0)))
    ref, _, ref_m, _ = voxel_downsample(
        jnp.asarray(pad(refs, 3 * 131072)), jnp.zeros(3 * 131072),
        jnp.arange(3 * 131072) < len(refs), m.plane_resolution,
        m.local_surf_capacity)
    qs = scans[3].astype(np.float32) + np.float32([0.05, 0.02, 0.0])
    query, _, q_m, _ = voxel_downsample(
        jnp.asarray(pad(qs, 131072)), jnp.zeros(131072),
        jnp.arange(131072) < len(qs), m.plane_resolution,
        m.stack_surf_capacity)
    n_q, n_r = int(q_m.sum()), int(ref_m.sum())
    log(f"kernel widths: Q={query.shape[0]} ({n_q} live), "
        f"N={ref.shape[0]} ({n_r} live)")
    q_h, r_h, m_h = (np.asarray(a) for a in (query, ref, ref_m))

    tiled = jax.jit(lambda: knn.knn_tiled(query, ref, ref_m, k=m.knn_k,
                                          tile=m.knn_tile, ref_count=n_r))
    rec = {"Q": int(query.shape[0]), "Q_live": n_q, "N": int(ref.shape[0]),
           "N_live": n_r, "xla_ms": _time(tiled) * 1e3, "pallas_ms": {}}
    for qb, tile in ((8, 512), (4, 512), (8, 1024), (16, 512), (8, 256)):
        fn = jax.jit(lambda: knn_pallas(
            query, ref, ref_m, k=m.knn_k, q_block=qb, tile=tile,
            query_count=n_q, ref_count=n_r))
        d, i = fn()
        err, bad, rows = check_knn(np.asarray(d)[:n_q], np.asarray(i)[:n_q],
                                   q_h[:n_q], r_h, m_h, m.knn_k)
        if not (err <= DIST_TOL and bad == 0):
            raise SystemExit(f"knn_pallas q_block={qb} tile={tile}: "
                             f"err {err}, {bad}/{rows} index mismatches")
        key = f"q_block={qb},tile={tile}"
        rec["pallas_ms"][key] = _time(fn) * 1e3
        log(f"kernel {key}: {rec['pallas_ms'][key]:.4f} ms "
            f"(max |d-d64| {err:.1e} m², 0/{rows} index mismatches)")
    log(f"knn_tiled (XLA): {rec['xla_ms']:.4f} ms")
    return rec


def _alternate(cfgs, frames, stage):
    """TURNS alternating bench_single runs per named config."""
    names = list(cfgs)
    out = {n: {"fps": [], f"{stage}_ms": []} for n in names}
    for turn in range(TURNS):
        for n in (names if turn % 2 == 0 else names[::-1]):
            fps, ex = bench_single(cfgs[n], frames)
            out[n]["fps"].append(fps)
            out[n][f"{stage}_ms"].append(ex["stage_ms"][stage])
            log(f"turn {turn} {n}: {fps:.2f} frames/s, {stage} "
                f"{ex['stage_ms'][stage]:.3f} ms")
    return out


def _with(cfg, part, **kw):
    return dataclasses.replace(
        cfg, **{part: dataclasses.replace(getattr(cfg, part), **kw)})


def ab_vote_alone(cfg, batch=8):
    """The plane vote of one odometry step (6 outer iterations) alone,
    at the odometry's shapes, vmapped over ``batch`` lanes."""
    from light_loam_tpu.ops.graphvote import simple_vote

    o = cfg.odometry
    Q = cfg.scan.max_flat
    K = Q // o.plane_vote_regions + o.plane_vote_regions
    rng = np.random.default_rng(0)
    src = jnp.asarray(rng.uniform(-60, 60, (batch, Q, 3)), jnp.float32)
    tgt = src + jnp.asarray(rng.normal(0, 0.3, (batch, Q, 3)), jnp.float32)
    valid = jnp.asarray(rng.random((batch, Q)) < 0.8)

    def one(s, t, v):
        def body(c, _):
            r = simple_vote(s + c, t, v, o.plane_vote_regions, K)
            return c + 1e-3 * r.weight[0], None
        return jax.lax.scan(body, jnp.float32(0), None,
                            length=o.outer_iterations)[0]

    fn = jax.jit(jax.vmap(one))
    return _time(lambda: fn(src, tgt, valid)) * 1e3


def main():
    dev = require_gpu("ab_backends.py")
    enable_compile_cache()
    smi = nvidia_smi_line()
    log(f"device {dev.device_kind}; nvidia-smi: {smi}")
    cfg = HDL64_KITTI
    which = sys.argv[1:] or ["kernel", "mapping", "surf", "vote"]
    res = {"device": dev.device_kind, "nvidia_smi": smi}
    frames = None if which == ["kernel"] else make_frames(cfg, 12)
    if "kernel" in which:
        res["kernel"] = ab_kernel(cfg)
    if "mapping" in which:
        res["mapping"] = _alternate(
            {"pallas": _with(cfg, "mapping", knn_backend="pallas"),
             "xla": _with(cfg, "mapping", knn_backend="xla")},
            frames, "mapping")
    if "surf" in which:
        res["surf"] = _alternate(
            {"grid": _with(cfg, "odometry", surf_knn="grid"),
             "tiled": _with(cfg, "odometry", surf_knn="tiled")},
            frames, "odometry")
    if "vote" in which:
        res["vote"] = _alternate(
            {"simple": cfg, "off": _with(cfg, "odometry",
                                         plane_vote_mode="off")},
            frames, "odometry")
        res["vote"]["alone_b8_ms"] = ab_vote_alone(cfg)
        log(f"vote alone, one odometry step's 6 calls, B=8: "
            f"{res['vote']['alone_b8_ms']:.3f} ms")
    os.makedirs(REPO / "chiprun_out", exist_ok=True)
    (REPO / "chiprun_out" / "ab_backends.json").write_text(json.dumps(res))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
