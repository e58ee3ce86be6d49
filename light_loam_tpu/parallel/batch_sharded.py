"""Data-parallel batched SLAM over a device mesh.

The batched multi-sequence mode (models/batch.py) vmaps B independent
sequences into one program; here those batch lanes are sharded over a
1-D ``data`` mesh axis.  Lanes never interact, so the partitioned program
contains ZERO collectives — pure weak scaling, the throughput-oriented
multi-chip mode (BASELINE.md "frames/s scaling efficiency" target).  The
complementary axis — voxel-hash map sharding with psum'd Gauss-Newton,
which DOES communicate — lives in parallel/sharded.py.

Mechanism: inputs and state are placed with NamedSharding(mesh,
P("data", ...)) on the leading (batch) dim, and the SAME batched body
(models/batch.py) runs under ``shard_map`` over that axis: each device
steps its own lanes, so one code path serves 1..N devices and the fused
GPU kernels (custom calls that XLA's partitioner cannot split) run on
local lanes only.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from light_loam_tpu.config import PipelineConfig
from light_loam_tpu.models.batch import (
    BatchState,
    _batched_body,
    init_batch_state,
)

AXIS = "data"


def make_data_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(devs[:n], (AXIS,))


def _lane_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    return NamedSharding(mesh, P(AXIS, *([None] * (ndim - 1))))


def shard_batch_state(state: BatchState, mesh: Mesh) -> BatchState:
    """Place every leaf sharded on its leading (batch) dim."""
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, _lane_sharding(mesh, x.ndim)), state
    )


def init_sharded_batch_state(
    cfg: PipelineConfig, batch: int, mesh: Mesh
) -> BatchState:
    if batch % mesh.shape[AXIS] != 0:
        raise ValueError(
            f"batch {batch} must divide evenly over {mesh.shape[AXIS]} devices"
        )
    return shard_batch_state(init_batch_state(cfg, batch), mesh)


def put_frames(xyz, mask, mesh: Mesh) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Place (B, P, 3)/(B, P) host frames lane-sharded on the mesh."""
    return (
        jax.device_put(xyz, _lane_sharding(mesh, 3)),
        jax.device_put(mask, _lane_sharding(mesh, 2)),
    )


def _mesh_of(xyz) -> Mesh:
    sharding = getattr(xyz, "sharding", None)
    if not isinstance(sharding, NamedSharding):
        raise ValueError(
            "lane-sharded steps take frames placed by put_frames / "
            "put_chunk_frames (NamedSharding over the data mesh)")
    return sharding.mesh


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _lane_frame_step(state, xyz, mask, cfg, mesh):
    return jax.shard_map(
        partial(_batched_body, cfg=cfg), mesh=mesh,
        in_specs=P(AXIS), out_specs=P(AXIS), check_vma=False,
    )(state, xyz, mask)


def sharded_batched_frame_step(state, xyz, mask, cfg: PipelineConfig):
    """One SLAM frame for B lane-sharded sequences: every device steps
    its own lanes (no collectives)."""
    return _lane_frame_step(state, xyz, mask, cfg=cfg, mesh=_mesh_of(xyz))


def put_chunk_frames(xyz, mask, mesh: Mesh) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Place (K, B, P, 3)/(K, B, P) host chunks lane-sharded on dim 1
    (the scan axis K stays unsharded — it is sequential by nature)."""
    return (
        jax.device_put(xyz, NamedSharding(mesh, P(None, AXIS, None, None))),
        jax.device_put(mask, NamedSharding(mesh, P(None, AXIS, None))),
    )


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _lane_chunk_step(state, xyz, mask, cfg, mesh):
    def local(state, xyz, mask):
        def body(carry, inp):
            carry, odo, mout = _batched_body(carry, *inp, cfg)
            return carry, (odo.q_w, odo.t_w, mout.q_w, mout.t_w)

        return jax.lax.scan(body, state, (xyz, mask))

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS), P(None, AXIS), P(None, AXIS)),
        out_specs=(P(AXIS), P(None, AXIS)), check_vma=False,
    )(state, xyz, mask)


def sharded_batched_chunk_step(state, xyz, mask, cfg: PipelineConfig):
    """K frames × B lane-sharded sequences per dispatch: the scan of
    models/batch.batched_chunk_step run per device on its own lanes,
    zero collectives, ONE dispatch per K frames.  Returns (state,
    (odom_q, odom_t, map_q, map_t)) with (K, B, …) poses."""
    return _lane_chunk_step(state, xyz, mask, cfg=cfg, mesh=_mesh_of(xyz))
