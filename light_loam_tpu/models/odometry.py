"""Scan-to-scan odometry front end (reference: src/laserOdometry.cpp).

One jitted step per frame replicating the live-path schedule:

  * 3 outer re-association iterations (ref:439), each rebuilding
    correspondences with the current incremental pose and running 4 LM
    iterations (Ceres max_num_iterations=4, ref:822);
  * corner features → LidarEdgeFactor for every valid match, unweighted
    (ref:615-617);
  * planar features → frames ≤ 5: all valid matches at weight 1
    (ref:781-787); frames > 5: only graph-vote-selected matches at the
    vote weight (ref:794-810);
  * world-pose integration t_w += q_w·t_lc, q_w *= q_lc (ref:830-831);
  * feature clouds swap into the "last" role for the next frame
    (ref:882-896); the incremental pose warm-starts the next solve (the
    reference never resets para_q/para_t).

The first frame initializes state without solving (ref:427-431); here that
falls out naturally: the empty "last" clouds yield zero valid factors and
the LM no-ops, so the step is branch-free.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from light_loam_tpu.config import OdometryConfig
from light_loam_tpu.core import quaternion as quat
from light_loam_tpu.core.frame import PointCloud, ScanFeatures
from light_loam_tpu.ops import graphvote, knn
from light_loam_tpu.solver import (
    EdgeFactors,
    EdgeScalarFactors,
    FactorSet,
    lm_solve,
    make_plane_factors,
)


def _run_vote(mode: str, src, tgt, valid, n_regions, chunk_cap, cfg):
    """Dispatch to the configured vote kernel; returns (selected, weight)."""
    return graphvote.run_vote(
        mode, src, tgt, valid,
        n_regions=n_regions, chunk_capacity=chunk_cap,
        score_threshold=cfg.vote_score_threshold,
        resolution=cfg.vote_resolution,
        selected_ratio=cfg.vote_selected_ratio,
        low_vote_count=cfg.vote_low_vote_count,
        low_vote_weight=cfg.vote_low_vote_weight,
        high_vote_weight=cfg.vote_high_vote_weight,
    )


class OdometryState(NamedTuple):
    corner_last: PointCloud  # previous less-sharp cloud
    surf_last: PointCloud    # previous less-flat cloud
    q_w: jnp.ndarray         # (4,) world←current rotation
    t_w: jnp.ndarray         # (3,)
    q_lc: jnp.ndarray        # (4,) last←current increment (warm start)
    t_lc: jnp.ndarray        # (3,)
    frame: jnp.ndarray       # int32 — `now_frame` counter

    @staticmethod
    def init(corner_capacity: int, surf_capacity: int) -> "OdometryState":
        return OdometryState(
            corner_last=PointCloud.zeros(corner_capacity),
            surf_last=PointCloud.zeros(surf_capacity),
            q_w=quat.quat_identity(),
            t_w=jnp.zeros(3),
            q_lc=quat.quat_identity(),
            t_lc=jnp.zeros(3),
            frame=jnp.int32(0),
        )


class OdometryOutput(NamedTuple):
    q_w: jnp.ndarray
    t_w: jnp.ndarray
    corner_count: jnp.ndarray
    plane_count: jnp.ndarray


def _transform_to_start(q, t, pc: PointCloud, distortion: bool, scan_period: float):
    """TransformToStart (laserOdometry.cpp:77-95): s ≡ 1 unless the
    undistortion hook is enabled."""
    if distortion:
        s = (pc.rel - jnp.floor(pc.rel)) / scan_period
    else:
        s = jnp.ones_like(pc.rel)
    qb = jnp.broadcast_to(q, pc.xyz.shape[:1] + (4,))
    qs = quat.quat_slerp_identity(qb, s)
    return quat.quat_rotate(qs, pc.xyz) + s[:, None] * t[None, :], s


def transform_to_end(q, t, pc: PointCloud, distortion: bool = False,
                     scan_period: float = 0.1) -> PointCloud:
    """TransformToEnd (laserOdometry.cpp:99-114): undistort to sweep start,
    then re-express in the end-of-sweep (current) frame and strip the time
    fraction from the rel channel.  Dormant in the reference live path
    (the `if (0)` block at laserOdometry.cpp:861-880) — provided for
    capability parity."""
    start_xyz, _s = _transform_to_start(q, t, pc, distortion, scan_period)
    qi = quat.quat_inverse(q)
    end_xyz = quat.quat_rotate(
        jnp.broadcast_to(qi, pc.xyz.shape[:1] + (4,)), start_xyz - t[None, :]
    )
    return PointCloud(xyz=end_xyz, rel=jnp.floor(pc.rel), mask=pc.mask)


@partial(jax.jit, static_argnames=("cfg", "scan_period"))
def odometry_step(
    state: OdometryState,
    feats: ScanFeatures,
    cfg: OdometryConfig,
    scan_period: float = 0.1,
) -> Tuple[OdometryState, OdometryOutput]:
    sharp, flat = feats.sharp, feats.flat
    q, t = state.q_lc, state.t_lc

    n_flat_cap = flat.capacity
    chunk_cap = n_flat_cap // cfg.plane_vote_regions + cfg.plane_vote_regions

    surf_knn = cfg.surf_knn
    # tiled mode: the stored surf_last is live-prefix compacted at
    # hand-off (below), so the tile sweeps skip dead tiles.  ~40 % live
    # at flagship capacity → both correspondence passes drop ~half
    # their tiles; matches are bitwise-identical (same live set, same
    # relative order → same masked mins, same gathered rows).
    surf_ref_count = state.surf_last.count() if surf_knn == "tiled" else None

    corner_valid = jnp.zeros_like(sharp.mask)
    plane_valid = jnp.zeros_like(flat.mask)

    # The re-association loop runs as ONE lax.scan body instead of a
    # Python unroll: the body (kNN tiles + vote + LM solve) is by far the
    # largest subgraph in the program, and unrolling it outer_iterations
    # times made XLA compile that graph 6x over for zero runtime benefit
    # (iterations are strictly sequential); runtime semantics are
    # identical (static trip count, same body).
    def _outer(carry, _):
        q, t, corner_valid, plane_valid = carry
        sharp_sel, s_sharp = _transform_to_start(
            q, t, sharp, cfg.distortion, scan_period
        )
        flat_sel, s_flat = _transform_to_start(
            q, t, flat, cfg.distortion, scan_period
        )

        cm = knn.corner_correspondences(
            sharp_sel, sharp.mask, state.corner_last,
            cfg.distance_sq_threshold, cfg.nearby_scan,
        )
        if surf_knn == "grid":
            # single-pass search over the ring-slotted less-flat layout
            # (R inferred from the range image — static at trace time)
            sm = knn.surf_correspondences_grid(
                flat_sel, flat.mask, state.surf_last,
                feats.full.xyz.shape[0],
                cfg.distance_sq_threshold, cfg.nearby_scan,
            )
        else:
            sm = knn.surf_correspondences(
                flat_sel, flat.mask, state.surf_last,
                cfg.distance_sq_threshold, cfg.nearby_scan,
                ref_count=surf_ref_count,
            )

        use_vote = state.frame > cfg.vote_start_frame

        edge_scalar = None
        if cfg.corner_vote_mode == "off":
            # live path: plain 3-dim edge factors for every valid match,
            # never vote-gated (laserOdometry.cpp:615-617)
            edge = EdgeFactors(
                cp=sharp.xyz,
                a=state.corner_last.xyz[cm.a_idx],
                b=state.corner_last.xyz[cm.b_idx],
                s=s_sharp,
                weight=jnp.ones_like(s_sharp),
                mask=cm.valid,
            )
        else:
            # latent path (laserOdometry.cpp:628-643): vote-selected
            # corners as weighted scalar edge factors once active
            c_chunk_cap = sharp.capacity // cfg.corner_vote_regions + cfg.corner_vote_regions
            c_sel, c_w = _run_vote(
                cfg.corner_vote_mode, sharp.xyz,
                state.corner_last.xyz[cm.a_idx], cm.valid,
                cfg.corner_vote_regions, c_chunk_cap, cfg,
            )
            edge = EdgeFactors(
                cp=sharp.xyz,
                a=state.corner_last.xyz[cm.a_idx],
                b=state.corner_last.xyz[cm.b_idx],
                s=s_sharp,
                weight=jnp.ones_like(s_sharp),
                mask=cm.valid & ~use_vote,
            )
            edge_scalar = EdgeScalarFactors(
                cp=sharp.xyz,
                a=state.corner_last.xyz[cm.a_idx],
                b=state.corner_last.xyz[cm.b_idx],
                s=s_sharp,
                weight=c_w,
                mask=cm.valid & c_sel & use_vote,
            )

        # graph vote on plane correspondences: src is the RAW current point,
        # tgt the matched 1-NN (laserOdometry.cpp:751-757)
        p_sel_mask, p_weight = _run_vote(
            cfg.plane_vote_mode, flat.xyz,
            state.surf_last.xyz[sm.a_idx], sm.valid,
            cfg.plane_vote_regions, chunk_cap, cfg,
        )
        plane_weight = jnp.where(use_vote, p_weight, 1.0)
        plane_mask = sm.valid & jnp.where(use_vote, p_sel_mask, True)

        plane = make_plane_factors(
            cp=flat.xyz,
            a=state.surf_last.xyz[sm.a_idx],
            b=state.surf_last.xyz[sm.b_idx],
            c=state.surf_last.xyz[sm.c_idx],
            s=s_flat,
            weight=plane_weight,
            mask=plane_mask,
        )

        q, t, _cost = lm_solve(
            q, t, FactorSet(edge=edge, plane=plane, edge_scalar=edge_scalar),
            n_iterations=cfg.inner_iterations,
            huber_delta=cfg.huber_delta,
        )
        return (q, t, cm.valid, plane_mask), None

    (q, t, corner_valid, plane_valid), _ = jax.lax.scan(
        _outer, (q, t, corner_valid, plane_valid), None,
        length=cfg.outer_iterations,
    )

    # world pose integration (laserOdometry.cpp:830-831)
    t_w = state.t_w + quat.quat_rotate(state.q_w, t)
    q_w = quat.quat_normalize(quat.quat_multiply(state.q_w, q))

    if cfg.distortion:
        # undistorted hand-off (the reference's dormant TransformToEnd
        # block, laserOdometry.cpp:861-880): with motion compensation on,
        # the stored "last" clouds must live in the end-of-sweep frame —
        # otherwise the next frame matches its undistorted points against
        # raw distorted ones and the model is inconsistent (measured: the
        # hook HURTS accuracy without this).  [DEV] the reference ships
        # the block disabled because it also ships DISTORTION 0.
        corner_keep = transform_to_end(q, t, feats.less_sharp, True, scan_period)
        surf_keep = transform_to_end(q, t, feats.less_flat, True, scan_period)
    else:
        corner_keep = feats.less_sharp
        surf_keep = feats.less_flat

    if surf_knn == "tiled":
        # live-prefix compaction so the next frame's tile sweeps can
        # skip dead tiles (~60 % of the ring-slotted layout's slots are
        # holes at flagship capacity).  Ring identity travels in `rel`
        # (PointCloud.ring() = floor(rel)), so no layout is lost; the
        # grid path keeps the ring-slotted cloud it structurally needs.
        from light_loam_tpu.ops.voxel import compact_rows

        km, kx, kr = compact_rows(
            surf_keep.mask, surf_keep.capacity, surf_keep.xyz, surf_keep.rel
        )
        surf_keep = PointCloud(xyz=kx, rel=kr, mask=km)

    new_state = OdometryState(
        corner_last=corner_keep,
        surf_last=surf_keep,
        q_w=q_w,
        t_w=t_w,
        q_lc=q,
        t_lc=t,
        frame=state.frame + 1,
    )
    out = OdometryOutput(
        q_w=q_w,
        t_w=t_w,
        corner_count=jnp.sum(corner_valid.astype(jnp.int32)),
        plane_count=jnp.sum(plane_valid.astype(jnp.int32)),
    )
    return new_state, out
