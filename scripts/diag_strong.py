"""Strong-axis scaling diagnosis: per-stage pinned timing of the sharded
mapping step.

The r04 snapshot's strong axis regressed to 0.59 @ 2 dev / 0.33 @ 4 dev
(SCALING.json) from ~1.0 earlier in the round, while the n=1 step got
5.6x faster (931 -> 165 ms).  This script decomposes the step into its
stages — each one its own shard_map program, timed with the same pinned
one-core methodology as bench_scaling — so the n-scaling overhead can be
attributed instead of guessed at:

  floor30      30 chained scalar psums (collective rendezvous floor)
  a2a_payload  4 all_to_alls with the knn exchange's payload shapes
  gather_local recenter + 5x5x3 compaction of this device's store shard
  owner_stack  owner-compact + per-shard voxel downsample + all_gather
  stack_repl   the PRE-a1adfd0 replicated full-input stack downsample
  knn_merge    local top-k vs shard + all_to_all + sliced merge (1 iter)
  fit_solve    line/plane fit on the device slice + psum'd LM (1 iter)
  merge_store  registered stack merged into the owned store shards
  full         the real sharded_mapping_step

full ~= gather_local + owner_stack + outer_iterations*(knn_merge +
fit_solve) + merge_store + glue; stage-vs-full residual is fusion lost
at the materialization boundaries.

Run ALONE on an idle host (CLAUDE.md: pinned timings are poisoned by any
concurrent load):  python scripts/diag_strong.py [--out /tmp/diag.json]
"""

import argparse
import json
import os
import statistics
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")

from jax.sharding import PartitionSpec as P

from bench_scaling import pinned_cpu
from light_loam_tpu.core import quaternion as quat
from light_loam_tpu.core.frame import PointCloud
from light_loam_tpu.models.mapping import (
    MapStore,
    MappingState,
    _cell_linear,
    _cube_of,
    _gather_local,
    _recenter,
    line_fit_factors,
    plane_fit_factors,
)
from light_loam_tpu.models.pipeline import PROFILES
from light_loam_tpu.ops.voxel import compact_rows, voxel_downsample
from light_loam_tpu.parallel.sharded import (
    AXIS,
    _merged_knn_sliced,
    make_mesh,
    shard_mapping_state,
    sharded_mapping_step,
    voxel_owner,
)
from light_loam_tpu.solver import FactorSet, lm_solve
from light_loam_tpu.utils.synthetic import World, simulate_scan


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def fixture(cfg):
    world = World.urban(seed=2)
    rng = np.random.default_rng(0)

    def cloud(n_pts, cap, seed):
        pts = simulate_scan(world, np.zeros(3), n_azimuth=1100, noise=0.01,
                            seed=seed)
        idx = rng.permutation(len(pts))[:n_pts]
        xyz = np.zeros((cap, 3), np.float32)
        m = np.zeros(cap, bool)
        xyz[: len(idx)] = pts[idx]
        m[: len(idx)] = True
        return PointCloud(xyz=jnp.asarray(xyz), rel=jnp.zeros(cap),
                          mask=jnp.asarray(m))

    return cloud(900, 1024, 3), cloud(4000, 4096, 4)


STORE_SPECS = MapStore(xyz=P(AXIS, None), cell=P(AXIS), mask=P(AXIS))
STATE_SPECS = MappingState(
    corner=STORE_SPECS, surf=STORE_SPECS, cen=P(), q_wm=P(), t_wm=P(),
    frame=P(),
)
CLOUD_SPEC = PointCloud(xyz=P(), rel=P(), mask=P())


def build_stages(cfg, mesh, n):
    """Return {name: (jitted_fn, make_args(env) -> args)}; env carries the
    shared device-resident inputs."""

    def smap(f, in_specs, out_specs):
        return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    # ---- collective floors ----
    def floor30(x):
        for _ in range(30):
            x = jax.lax.psum(x, AXIS) * 1e-8 + x
        return x

    def a2a_payload(d, near):
        Qc, k = d.shape
        for _ in range(2):
            d = jax.lax.all_to_all(
                d.reshape(n, Qc // n, k), AXIS, split_axis=0,
                concat_axis=0, tiled=False,
            ).reshape(Qc, k) + 1e-8
            near = jax.lax.all_to_all(
                near.reshape(n, Qc // n, k, 3), AXIS, split_axis=0,
                concat_axis=0, tiled=False,
            ).reshape(Qc, k, 3) + 1e-8
        return d, near

    def pose(state, q_odom, t_odom):
        q_w = quat.quat_normalize(quat.quat_multiply(state.q_wm, q_odom))
        t_w = quat.quat_rotate(state.q_wm, t_odom) + state.t_wm
        return q_w, t_w

    # ---- gather_local ----
    def g_local(state, q_odom, t_odom):
        q_w, t_w = pose(state, q_odom, t_odom)
        corner_store, surf_store, cen, center = _recenter(state, t_w, cfg)
        lc, lcm, _ = _gather_local(
            corner_store, center, cfg, cfg.local_corner_capacity // n,
            cell_ordered=False,
        )
        ls, lsm, _ = _gather_local(
            surf_store, center, cfg, cfg.local_surf_capacity // n,
            cell_ordered=False,
        )
        return lc, lcm, ls, lsm

    # ---- owner_stack (HEAD path) ----
    def owner_stack_one(cloud, leaf, out_cap_shard, in_cap_shard):
        dev = jax.lax.axis_index(AXIS)
        mine = cloud.mask & (voxel_owner(cloud.xyz, leaf, n) == dev)
        m_c, xyz_c, rel_c = compact_rows(mine, in_cap_shard, cloud.xyz,
                                         cloud.rel)
        sx, sr, sm, _ = voxel_downsample(xyz_c, rel_c, m_c, leaf,
                                         out_cap_shard)
        return sx, sm

    def gathered(x_d, cap):
        g = jax.lax.all_gather(x_d, AXIS)
        return g.reshape((cap,) + x_d.shape[1:])

    def g_stack(corner_last, surf_last):
        in_c = (corner_last.xyz.shape[0] if n == 1
                else corner_last.xyz.shape[0] // n * 2)
        in_s = (surf_last.xyz.shape[0] if n == 1
                else surf_last.xyz.shape[0] // n * 2)
        scd, scmd = owner_stack_one(corner_last, cfg.line_resolution,
                                    cfg.stack_corner_capacity // n, in_c)
        ssd, ssmd = owner_stack_one(surf_last, cfg.plane_resolution,
                                    cfg.stack_surf_capacity // n, in_s)
        return (
            gathered(scd, cfg.stack_corner_capacity),
            gathered(scmd, cfg.stack_corner_capacity),
            gathered(ssd, cfg.stack_surf_capacity),
            gathered(ssmd, cfg.stack_surf_capacity),
            scd, scmd, ssd, ssmd,
        )

    # ---- pre-a1adfd0 replicated stack ----
    def g_stack_repl(corner_last, surf_last):
        scx, _, scm, _ = voxel_downsample(
            corner_last.xyz, corner_last.rel, corner_last.mask,
            cfg.line_resolution, cfg.stack_corner_capacity,
        )
        ssx, _, ssm, _ = voxel_downsample(
            surf_last.xyz, surf_last.rel, surf_last.mask,
            cfg.plane_resolution, cfg.stack_surf_capacity,
        )
        return scx, scm, ssx, ssm

    # ---- knn + exchange + merge (one outer iteration's worth) ----
    def g_knn(lc, lcm, ls, lsm, stack_c_xyz, stack_s_xyz, state, q_odom,
              t_odom):
        q_w, t_w = pose(state, q_odom, t_odom)
        p_sel_c = quat.quat_rotate(q_w[None, :], stack_c_xyz) + t_w[None, :]
        d_c, near_c = _merged_knn_sliced(p_sel_c, lc, lcm, cfg, n)
        p_sel_s = quat.quat_rotate(q_w[None, :], stack_s_xyz) + t_w[None, :]
        d_s, near_s = _merged_knn_sliced(p_sel_s, ls, lsm, cfg, n)
        return d_c, near_c, d_s, near_s

    # ---- fit + solve (one outer iteration's worth) ----
    def g_fit(scd, scmd, ssd, ssmd, d_c, near_c, d_s, near_s, state,
              q_odom, t_odom):
        q_w, t_w = pose(state, q_odom, t_odom)
        ef = line_fit_factors(scd, scmd, d_c, near_c, cfg)
        pf = plane_fit_factors(ssd, ssmd, d_s, near_s, cfg)
        q2, t2, _ = lm_solve(
            q_w, t_w, FactorSet(edge=ef, plane_norm=pf),
            n_iterations=cfg.inner_iterations,
            huber_delta=cfg.huber_delta, axis_name=AXIS,
        )
        return q2, t2

    # ---- merge into store ----
    def g_merge(state, stack_c_xyz, stack_c_mask, stack_s_xyz,
                stack_s_mask, q_odom, t_odom):
        q_w, t_w = pose(state, q_odom, t_odom)
        corner_store, surf_store, cen, center = _recenter(state, t_w, cfg)

        def merge(store, sx, sm, leaf, capacity):
            reg = quat.quat_rotate(q_w[None, :], sx) + t_w[None, :]
            ijk = _cube_of(reg, cen, cfg)
            dims = jnp.asarray(
                [cfg.cube_width, cfg.cube_height, cfg.cube_depth], jnp.int32
            )
            inside = jnp.all((ijk >= 0) & (ijk < dims[None, :]), axis=-1)
            cell = jnp.where(inside, _cell_linear(ijk, cfg), 0).astype(
                jnp.int32
            )
            mine = voxel_owner(reg, leaf, n) == jax.lax.axis_index(AXIS)
            new_mask = sm & inside & mine
            all_xyz = jnp.concatenate([store.xyz, reg], axis=0)
            all_cell = jnp.concatenate([store.cell, cell], axis=0)
            all_mask = jnp.concatenate([store.mask, new_mask], axis=0)
            xyz, _, mask, out_cell = voxel_downsample(
                all_xyz, jnp.zeros(all_xyz.shape[0], jnp.float32),
                all_mask, leaf, capacity // n, extra_key=all_cell,
            )
            return MapStore(xyz=xyz, cell=out_cell, mask=mask)

        c2 = merge(corner_store, stack_c_xyz, stack_c_mask,
                   cfg.line_resolution, cfg.map_corner_capacity)
        s2 = merge(surf_store, stack_s_xyz, stack_s_mask,
                   cfg.plane_resolution, cfg.map_surf_capacity)
        return c2, s2

    stages = {
        "floor30": (
            smap(floor30, (P(),), P()),
            lambda env: (jnp.float32(1.0),),
        ),
        "a2a_payload": (
            smap(a2a_payload, (P(AXIS), P(AXIS, None, None)),
                 (P(AXIS), P(AXIS, None, None))),
            lambda env: (env["d_s"], env["near_s"]),
        ),
        "gather_local": (
            smap(g_local, (STATE_SPECS, P(), P()),
                 (P(AXIS, None), P(AXIS), P(AXIS, None), P(AXIS))),
            lambda env: (env["state"], env["q_odom"], env["t_odom"]),
        ),
        "owner_stack": (
            smap(g_stack, (CLOUD_SPEC, CLOUD_SPEC),
                 (P(), P(), P(), P(),
                  P(AXIS, None), P(AXIS), P(AXIS, None), P(AXIS))),
            lambda env: (env["corner"], env["surf"]),
        ),
        "stack_repl": (
            smap(g_stack_repl, (CLOUD_SPEC, CLOUD_SPEC),
                 (P(), P(), P(), P())),
            lambda env: (env["corner"], env["surf"]),
        ),
        "knn_merge": (
            smap(g_knn,
                 (P(AXIS, None), P(AXIS), P(AXIS, None), P(AXIS),
                  P(), P(), STATE_SPECS, P(), P()),
                 (P(AXIS), P(AXIS, None, None),
                  P(AXIS), P(AXIS, None, None))),
            lambda env: (env["lc"], env["lcm"], env["ls"], env["lsm"],
                         env["stack_c_xyz"], env["stack_s_xyz"],
                         env["state"], env["q_odom"], env["t_odom"]),
        ),
        "fit_solve": (
            smap(g_fit,
                 (P(AXIS, None), P(AXIS), P(AXIS, None), P(AXIS),
                  P(AXIS), P(AXIS, None, None), P(AXIS),
                  P(AXIS, None, None), STATE_SPECS, P(), P()),
                 (P(), P())),
            lambda env: (env["scd"], env["scmd"], env["ssd"], env["ssmd"],
                         env["d_c"], env["near_c"], env["d_s"],
                         env["near_s"], env["state"], env["q_odom"],
                         env["t_odom"]),
        ),
        "merge_store": (
            smap(g_merge,
                 (STATE_SPECS, P(), P(), P(), P(), P(), P()),
                 (STORE_SPECS, STORE_SPECS)),
            lambda env: (env["state"], env["stack_c_xyz"],
                         env["stack_c_mask"], env["stack_s_xyz"],
                         env["stack_s_mask"], env["q_odom"],
                         env["t_odom"]),
        ),
    }
    return stages


def time_fn(fn, args, reps, repeats, pinned=True):
    out = fn(*args)
    jax.block_until_ready(out)  # compile + warm (CPU: reliable barrier)
    runs = []
    for _ in range(repeats):
        with pinned_cpu(pinned):
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(*args)
            jax.block_until_ready(out)
            runs.append((time.perf_counter() - t0) / reps * 1000)
    return round(statistics.median(runs), 3), [round(r, 3) for r in runs]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--counts", default="1,2,4")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="/tmp/diag_strong.json")
    args = ap.parse_args()

    cfg = PROFILES["hdl64-small"].mapping
    corner, surf = fixture(PROFILES["hdl64-small"])
    result = {"host_cores": os.cpu_count(), "reps": args.reps,
              "repeats": args.repeats, "counts": {}}

    for n in [int(x) for x in args.counts.split(",")]:
        log(f"== n={n} ==")
        mesh = make_mesh(n)
        state = shard_mapping_state(MappingState.init(cfg), mesh, cfg)
        q_odom = quat.quat_identity()
        t_odom = jnp.asarray(np.array([0.4, 0.0, 0.0], np.float32))
        # seed + warm exactly like bench_scaling
        state, _ = sharded_mapping_step(state, corner, surf, q_odom,
                                        jnp.zeros(3), cfg, mesh)
        state, out = sharded_mapping_step(state, corner, surf, q_odom,
                                          t_odom, cfg, mesh)
        jax.block_until_ready(out)

        stages = build_stages(cfg, mesh, n)
        env = {"state": state, "corner": corner, "surf": surf,
               "q_odom": q_odom, "t_odom": t_odom}
        # populate env by running producers once
        sfn, sargs = stages["owner_stack"]
        (env["stack_c_xyz"], env["stack_c_mask"], env["stack_s_xyz"],
         env["stack_s_mask"], env["scd"], env["scmd"], env["ssd"],
         env["ssmd"]) = sfn(*sargs(env))
        gfn, gargs = stages["gather_local"]
        env["lc"], env["lcm"], env["ls"], env["lsm"] = gfn(*gargs(env))
        kfn, kargs = stages["knn_merge"]
        env["d_c"], env["near_c"], env["d_s"], env["near_s"] = (
            kfn(*kargs(env)))
        jax.block_until_ready(env["near_s"])

        row = {}
        for name, (fn, mk) in stages.items():
            ms, runs = time_fn(fn, mk(env), args.reps, args.repeats)
            row[name] = {"ms": ms, "runs": runs}
            log(f"  {name:13s} {ms:9.3f} ms  {runs}")

        def full_step():
            _, o = sharded_mapping_step(state, corner, surf, q_odom,
                                        t_odom, cfg, mesh)
            return o

        ms, runs = time_fn(lambda: full_step(), (), args.reps,
                           args.repeats)
        row["full"] = {"ms": ms, "runs": runs}
        oi = cfg.outer_iterations
        acct = (row["gather_local"]["ms"] + row["owner_stack"]["ms"]
                + oi * (row["knn_merge"]["ms"] + row["fit_solve"]["ms"])
                + row["merge_store"]["ms"])
        row["accounted_ms"] = round(acct, 3)
        log(f"  {'full':13s} {ms:9.3f} ms  (stages account for "
            f"{acct:.1f} ms, outer_iterations={oi})")
        result["counts"][str(n)] = row

    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: {s: v["ms"] if isinstance(v, dict) else v
                          for s, v in row.items()}
                      for k, row in result["counts"].items()}, indent=1))


if __name__ == "__main__":
    main()
