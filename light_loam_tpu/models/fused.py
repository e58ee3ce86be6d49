"""Whole-frame SLAM step as ONE XLA program — the latency mode.

The staged pipeline (models/pipeline.py) dispatches three programs per
frame (features → odometry → mapping) with a host round-trip between
odometry and mapping for divergence containment.  Fusing the whole
frame into one jitted program removes two program launches and the
mid-frame host sync — the single-stream analog of models/batch.py's
batched program.

Semantics match the staged path exactly, including the divergence
containment that pipeline.py performs on the host
(models/pipeline.py:152-168): a non-finite odometry translation keeps
the previous world pose, resets the warm-start increment to identity,
and feeds the contained pose to mapping.  Here that policy is a
`jnp.where` on device, so no host readback interrupts the frame.

The staged path remains the default and is required for:
  * async mapping (drop policy needs the odometry result while the
    previous mapping step is still in flight);
  * skip_frame_num > 1 (non-mapping frames run features+odometry only).
Reference scope: this fuses scanRegistration.cpp + laserOdometry.cpp +
laserMapping.cpp's per-frame work into one program; their ROS-thread
overlap is the staged path's async mode instead.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from light_loam_tpu.config import PipelineConfig
from light_loam_tpu.core import quaternion as quat
from light_loam_tpu.models.mapping import MappingOutput, MappingState, mapping_step
from light_loam_tpu.models.odometry import (
    OdometryOutput,
    OdometryState,
    odometry_step,
)
from light_loam_tpu.ops.features import extract_features


def _fused_frame_body(
    odo_state: OdometryState,
    map_state: MappingState,
    xyz: jnp.ndarray,   # (max_points, 3)
    mask: jnp.ndarray,  # (max_points,)
    cfg: PipelineConfig,
) -> Tuple[OdometryState, MappingState, OdometryOutput, MappingOutput,
           jnp.ndarray]:
    """One full SLAM frame (traced body shared by the per-frame and
    chunked entry points); returns (..., diverged) where ``diverged`` is
    a bool scalar for the host's failure counter."""
    feats = extract_features(xyz, mask, cfg.scan)
    prev_q, prev_t = odo_state.q_w, odo_state.t_w
    odo_state, odo = odometry_step(
        odo_state, feats, cfg.odometry, cfg.scan.scan_period
    )

    # In-graph divergence containment (pipeline.py:152-168 semantics:
    # the check is on the translation, the warm start resets to
    # identity, the feature-cloud swap is kept).
    finite = jnp.isfinite(odo.t_w).all()
    q_w = jnp.where(finite, odo_state.q_w, prev_q)
    t_w = jnp.where(finite, odo_state.t_w, prev_t)
    odo_state = odo_state._replace(
        q_w=q_w,
        t_w=t_w,
        q_lc=jnp.where(finite, odo_state.q_lc, quat.quat_identity()),
        t_lc=jnp.where(finite, odo_state.t_lc, jnp.zeros(3)),
    )
    odo = odo._replace(q_w=q_w, t_w=t_w)

    map_state, mout = mapping_step(
        map_state,
        odo_state.corner_last,
        odo_state.surf_last,
        q_w,
        t_w,
        cfg.mapping,
    )
    return odo_state, map_state, odo, mout, ~finite


# jitted per-frame entry point (the Pipeline latency mode)
fused_frame_step = partial(jax.jit, static_argnames=("cfg",))(
    _fused_frame_body
)


class ChunkOutput(NamedTuple):
    """Per-frame outputs of a chunk, each with leading axis K."""

    odom_q: jnp.ndarray         # (K, 4)
    odom_t: jnp.ndarray         # (K, 3)
    map_q: jnp.ndarray          # (K, 4)
    map_t: jnp.ndarray          # (K, 3)
    diverged: jnp.ndarray       # (K,) bool
    map_corner_points: jnp.ndarray  # (K,)
    map_surf_points: jnp.ndarray    # (K,)
    local_overflow: jnp.ndarray     # (K,)


@partial(jax.jit, static_argnames=("cfg",))
def fused_chunk_step(
    odo_state: OdometryState,
    map_state: MappingState,
    xyz: jnp.ndarray,   # (K, max_points, 3)
    mask: jnp.ndarray,  # (K, max_points)
    cfg: PipelineConfig,
) -> Tuple[OdometryState, MappingState, "ChunkOutput"]:
    """K consecutive frames of ONE sequence as ONE program — the offline
    single-sequence throughput mode.

    `lax.scan` of the fused frame body over the chunk's leading axis:
    one dispatch and one compile per K frames instead of per frame
    (the scan body compiles once regardless of K), while the map/odometry
    state threads through iterations exactly as in the per-frame modes.
    Complements models/batch.py (B *independent* sequences vmapped) for
    replaying a single long sequence, where lanes aren't available.

    Semantics per frame are identical to `fused_frame_step` including
    in-graph divergence containment.  Host-side policies that need a
    per-frame readback (mapping back-pressure drops, skip_frame_num
    decimation) do not apply inside a chunk — this is the offline
    sync-mapping regime, every frame maps (the reference's equivalent is
    replaying with the mapping thread keeping up, laserMapping.cpp's
    backlog never filling).
    """

    def body(carry, inp):
        odo_state, map_state = carry
        x, m = inp
        odo_state, map_state, odo, mout, diverged = _fused_frame_body(
            odo_state, map_state, x, m, cfg
        )
        return (odo_state, map_state), ChunkOutput(
            odom_q=odo.q_w,
            odom_t=odo.t_w,
            map_q=mout.q_w,
            map_t=mout.t_w,
            diverged=diverged,
            map_corner_points=mout.map_corner_points,
            map_surf_points=mout.map_surf_points,
            local_overflow=mout.local_overflow,
        )

    (odo_state, map_state), outs = jax.lax.scan(
        body, (odo_state, map_state), (xyz, mask)
    )
    return odo_state, map_state, outs


def run_chunked(frame_iter, cfg: PipelineConfig, chunk_size: int = 8):
    """Replay a frame stream through `fused_chunk_step` — the offline
    single-sequence runner (one dispatch per `chunk_size` frames).

    ``frame_iter`` yields (xyz (N,3), mask (N,)) host arrays.  The tail
    chunk is padded with empty (all-masked) frames — an empty scan
    degrades gracefully (damped solve, pose holds) and contributes no
    map points — and its outputs are trimmed, so the returned
    trajectories have exactly one row per input frame.  (The returned
    *states* do include the empty-frame passes: pose unchanged, map
    untouched, warm-start increment decayed toward identity.)

    Returns (odo_state, map_state, outs) where each ChunkOutput leaf is
    stacked over ALL input frames.
    """
    import numpy as np

    odo_state = OdometryState.init(cfg.scan.max_less_sharp,
                                   cfg.scan.max_less_flat)
    map_state = MappingState.init(cfg.mapping)
    collected = []
    buf = []

    def flush():
        nonlocal odo_state, map_state
        if not buf:
            return
        n = len(buf)
        xs = np.stack([b[0] for b in buf])
        ms = np.stack([b[1] for b in buf])
        if n < chunk_size:  # pad the tail; outputs trimmed below
            pad = chunk_size - n
            xs = np.concatenate([xs, np.zeros((pad,) + xs.shape[1:],
                                              xs.dtype)])
            ms = np.concatenate([ms, np.zeros((pad,) + ms.shape[1:],
                                              ms.dtype)])
        odo_state, map_state, outs = fused_chunk_step(
            odo_state, map_state, jnp.asarray(xs), jnp.asarray(ms), cfg)
        collected.append(jax.tree_util.tree_map(
            lambda a: np.asarray(a)[:n], outs))
        buf.clear()

    for xyz, mask in frame_iter:
        buf.append((xyz, mask))
        if len(buf) == chunk_size:
            flush()
    flush()
    if not collected:
        raise ValueError("run_chunked: empty frame stream")
    outs = jax.tree_util.tree_map(
        lambda *leaves: np.concatenate(leaves), *collected)
    return odo_state, map_state, outs
