"""Batched multi-sequence SLAM — throughput scaling on one device.

The reference is a single-stream real-time system; batch evaluation over
KITTI sequences 00-10 means running it eleven times.  Here the whole
frame step (features → odometry → mapping) is a pure function of
fixed-shape state, so B independent sequences vmap into one program whose
kernels process B frames at once — amortizing kernel-launch latency and
filling a device that a single 100k-point frame leaves mostly idle.

Semantics are EXACTLY the single-stream pipeline per lane (vmap of the
same jitted functions); lanes never interact.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from light_loam_tpu.config import PipelineConfig
from light_loam_tpu.models.mapping import MappingOutput, MappingState, mapping_step
from light_loam_tpu.models.odometry import (
    OdometryOutput,
    OdometryState,
    odometry_step,
)
from light_loam_tpu.ops.features import extract_features


class BatchState(NamedTuple):
    odometry: OdometryState  # leaves have leading batch dim
    mapping: MappingState


def init_batch_state(cfg: PipelineConfig, batch: int) -> BatchState:
    odo = OdometryState.init(cfg.scan.max_less_sharp, cfg.scan.max_less_flat)
    mp = MappingState.init(cfg.mapping)
    stack = lambda tree: jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), tree
    )
    return BatchState(odometry=stack(odo), mapping=stack(mp))


def _batched_body(
    state: BatchState,
    xyz: jnp.ndarray,   # (B, max_points, 3)
    mask: jnp.ndarray,  # (B, max_points)
    cfg: PipelineConfig,
) -> Tuple[BatchState, OdometryOutput, MappingOutput]:
    """One SLAM frame for B independent sequences (traced body shared by
    the per-frame and chunked entry points)."""

    def one(odo_state, map_state, xyz, mask):
        feats = extract_features(xyz, mask, cfg.scan)
        odo_state, odo = odometry_step(
            odo_state, feats, cfg.odometry, cfg.scan.scan_period
        )
        map_state, mout = mapping_step(
            map_state,
            odo_state.corner_last,
            odo_state.surf_last,
            odo.q_w,
            odo.t_w,
            cfg.mapping,
        )
        return odo_state, map_state, odo, mout

    odo_state, map_state, odo, mout = jax.vmap(one)(
        state.odometry, state.mapping, xyz, mask
    )
    return BatchState(odometry=odo_state, mapping=map_state), odo, mout


batched_frame_step = partial(jax.jit, static_argnames=("cfg",))(
    _batched_body
)


@partial(jax.jit, static_argnames=("cfg",))
def batched_chunk_step(
    state: BatchState,
    xyz: jnp.ndarray,   # (K, B, max_points, 3)
    mask: jnp.ndarray,  # (K, B, max_points)
    cfg: PipelineConfig,
) -> Tuple[BatchState, Tuple[jnp.ndarray, jnp.ndarray,
                             jnp.ndarray, jnp.ndarray]]:
    """K frames × B sequences per dispatch — lax.scan of the batched
    body, composing the two throughput axes (models/fused.py's chunk
    amortizes dispatch 1/K; the vmap fills the device with B lanes).  The
    outputs are the per-frame poses only, (K, B, …) each:
    (odom_q, odom_t, map_q, map_t) — stacking the full cloud outputs
    over K would hold K copies of working-set-sized arrays for no
    benchmark or replay use."""

    def body(carry, inp):
        x, m = inp
        carry, odo, mout = _batched_body(carry, x, m, cfg)
        return carry, (odo.q_w, odo.t_w, mout.q_w, mout.t_w)

    state, outs = jax.lax.scan(body, state, (xyz, mask))
    return state, outs
