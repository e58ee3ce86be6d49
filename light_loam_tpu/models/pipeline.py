"""End-to-end SLAM pipeline: the host frame loop replacing the reference's
four ROS processes and pub/sub topics (SURVEY.md §1 dataflow).

Stage graph per frame (all device compute, host only moves bytes):

    raw cloud ──▶ extract_features ──▶ odometry_step ──▶ mapping_step
                   (E2, 10 Hz)          (E3, 10 Hz)       (E4, ≤10 Hz)

The reference's real-time back-pressure — mapping drains its backlog and
drops frames (laserMapping.cpp:1571-1575) — is preserved through JAX's
async dispatch: a mapping step is only dispatched when the previous one
has retired (`is_ready`), otherwise the frame is dropped for mapping while
odometry continues at full rate.  The `mapping_skip_frame` decimation
(laserOdometry.cpp:898-919) is applied before the drop policy, like the
reference's publish gate.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from light_loam_tpu.config import (
    HDL32,
    HDL64_KITTI,
    HDL64_SMALL,
    M2DGR_VLP32C,
    VLP16,
    PipelineConfig,
)
from light_loam_tpu.core import quaternion as quat
from light_loam_tpu.models.mapping import MappingState, mapping_step
from light_loam_tpu.models.odometry import OdometryState, odometry_step
from light_loam_tpu.ops.features import extract_features
from light_loam_tpu.utils.timing import StageTimers

PROFILES = {
    "hdl64": HDL64_KITTI,
    "vlp16": VLP16,
    "hdl32": HDL32,
    "m2dgr": M2DGR_VLP32C,
    "hdl64-small": HDL64_SMALL,  # fast-compile profile for tests
}


@dataclass
class FrameResult:
    frame: int
    odom_q: np.ndarray
    odom_t: np.ndarray
    mapped: bool
    map_q: Optional[np.ndarray] = None
    map_t: Optional[np.ndarray] = None


@dataclass
class Pipeline:
    cfg: PipelineConfig = field(default_factory=lambda: HDL64_KITTI)

    def __post_init__(self):
        scan = self.cfg.scan
        self.odo_state = OdometryState.init(scan.max_less_sharp, scan.max_less_flat)
        self.map_state = MappingState.init(self.cfg.mapping)
        self.frame = 0
        self.dropped_mapping_frames = 0
        self.diverged_frames = 0
        self._last_odo_pose = (
            np.asarray([0.0, 0.0, 0.0, 1.0], np.float32),
            np.zeros(3, np.float32),
        )
        self._keyframes: list = []
        # full-length mapped-pose history (positions only, 3 floats/frame)
        # — the /aft_mapped_path analog; _keyframes is a bounded window
        # for refinement and must not be used as a trajectory record.
        self._map_trajectory: list = []
        self._map_quats: list = []
        self.map_saturation_events = 0
        self.local_overflow_events = 0
        self.timers = StageTimers(budget_ms=self.cfg.frame_budget_ms)
        self._pending_map_out = None
        self._pending_map_state = None
        self._pending_kf = None
        self._last_map_pose = (
            np.asarray(quat.quat_identity()),
            np.zeros(3, np.float32),
        )

    # -- mapping back-pressure ------------------------------------------
    def _mapping_busy(self) -> bool:
        if self._pending_map_out is None:
            return False
        try:
            return not self._pending_map_out.t_w.is_ready()
        except AttributeError:
            return False

    def _retire_mapping(self, wait: bool) -> None:
        if self._pending_map_out is None:
            return
        if wait or self._pending_map_out.t_w.is_ready():
            out = self._pending_map_out
            self.map_state = self._pending_map_state
            self._last_map_pose = (np.asarray(out.q_w), np.asarray(out.t_w))
            # the mapped-pose history records each step's own pose AT
            # retirement (not the previous pose at dispatch) so the
            # trajectory is exact in async mode too
            self._map_trajectory.append(np.asarray(out.t_w).copy())
            self._map_quats.append(np.asarray(out.q_w).copy())
            # keyframes buffer at retirement too, so the mapped pose, the
            # odometry pose and the surf stack all belong to the SAME
            # frame (buffering at dispatch paired the current frame's
            # cloud/odometry with the PREVIOUS retired pose in async
            # mode, and duplicated traj indices under drops)
            if self._pending_kf is not None:
                q_odo, t_odo, sx, sm = self._pending_kf
                self._keyframes.append((
                    np.asarray(out.q_w), np.asarray(out.t_w),
                    sx, sm, len(self._map_trajectory) - 1, q_odo, t_odo,
                ))
                if len(self._keyframes) > 16:
                    self._keyframes.pop(0)
                self._pending_kf = None
            # saturation watch: the voxel-dedup store drops overflow
            # silently; surface it for operators (capacity should be
            # raised, or the sequence has outgrown the cube window)
            if int(out.map_surf_points) >= self.cfg.mapping.map_surf_capacity \
                    or int(out.map_corner_points) >= self.cfg.mapping.map_corner_capacity:
                self.map_saturation_events += 1
            # local-map gather overflow (whole cells dropped): same class
            # of observability as map_saturation_events
            if int(out.local_overflow) > 0:
                self.local_overflow_events += 1
            self._pending_map_out = None
            self._pending_map_state = None

    # -- one frame ------------------------------------------------------
    def process_frame(self, xyz: np.ndarray, mask: np.ndarray) -> FrameResult:
        cfg = self.cfg
        if (
            cfg.fused_step
            and cfg.sync_mapping
            and self.frame % cfg.odometry.skip_frame_num == 0
        ):
            return self._process_frame_fused(xyz, mask)
        with self.timers.stage("features"):
            feats = extract_features(jnp.asarray(xyz), jnp.asarray(mask), cfg.scan)
        with self.timers.stage("odometry"):
            self.odo_state, odo = odometry_step(
                self.odo_state, feats, cfg.odometry, cfg.scan.scan_period
            )

        # failure containment: a non-finite odometry pose (degenerate
        # geometry, empty scan) must not poison downstream state — keep
        # the previous pose and flag it (the reference's analog is its
        # runtime warnings + frame dropping, SURVEY §5)
        if not np.isfinite(np.asarray(odo.t_w)).all():
            self.diverged_frames += 1
            self.odo_state = self.odo_state._replace(
                q_w=jnp.asarray(self._last_odo_pose[0]),
                t_w=jnp.asarray(self._last_odo_pose[1]),
                q_lc=jnp.asarray([0.0, 0.0, 0.0, 1.0]),
                t_lc=jnp.zeros(3),
            )
            odo = odo._replace(
                q_w=self.odo_state.q_w, t_w=self.odo_state.t_w
            )
        else:
            self._last_odo_pose = (np.asarray(odo.q_w), np.asarray(odo.t_w))

        mapped = False
        if self.frame % cfg.odometry.skip_frame_num == 0:
            self._retire_mapping(wait=not cfg.drop_mapping_backlog)
            if self._mapping_busy():
                # previous mapping still in flight → drop this frame
                # (laserMapping.cpp:1571-1575)
                self.dropped_mapping_frames += 1
            else:
                with self.timers.stage("mapping_dispatch"):
                    new_state, map_out = mapping_step(
                        self.map_state,
                        self.odo_state.corner_last,
                        self.odo_state.surf_last,
                        odo.q_w,
                        odo.t_w,
                        cfg.mapping,
                    )
                self._pending_map_out = map_out
                self._pending_map_state = new_state
                # stash keyframe material for THIS step (the odometry
                # pose it consumed + its surf stack); buffered with the
                # mapped pose when the step retires
                self._pending_kf = (
                    np.asarray(odo.q_w), np.asarray(odo.t_w),
                    *self._keyframe_stack(),
                )
                mapped = True

        result = FrameResult(
            frame=self.frame,
            odom_q=np.asarray(odo.q_w),
            odom_t=np.asarray(odo.t_w),
            mapped=mapped,
        )
        if mapped:
            self._retire_mapping(wait=cfg.sync_mapping)
            # async mode: this is the last *retired* pose (stale by up to
            # one step, as documented on PipelineConfig.sync_mapping)
            result.map_q, result.map_t = self._last_map_pose
        self.frame += 1
        self.timers.frame_done()
        return result

    def _process_frame_fused(self, xyz: np.ndarray, mask: np.ndarray) -> FrameResult:
        """Latency mode: the whole frame as one program (models/fused.py).

        Bookkeeping (keyframe buffering, trajectory, saturation watch) is
        shared with the staged path via the pending/_retire_mapping
        machinery; mapping retires synchronously because this path only
        engages with sync_mapping.
        """
        from light_loam_tpu.models.fused import fused_frame_step

        cfg = self.cfg
        with self.timers.stage("fused_step"):
            self.odo_state, new_state, odo, map_out, diverged = fused_frame_step(
                self.odo_state, self.map_state,
                jnp.asarray(xyz), jnp.asarray(mask), cfg,
            )
        # dispatch the keyframe-stack downsample BEFORE any host sync so
        # it queues behind the fused program on device; the first host
        # readback below then covers both programs in one wait
        kf_stack = self._keyframe_stack()
        if bool(diverged):
            self.diverged_frames += 1
        else:
            self._last_odo_pose = (np.asarray(odo.q_w), np.asarray(odo.t_w))
        self._pending_map_out = map_out
        self._pending_map_state = new_state
        self._pending_kf = (
            np.asarray(odo.q_w), np.asarray(odo.t_w), *kf_stack,
        )
        self._retire_mapping(wait=True)
        result = FrameResult(
            frame=self.frame,
            odom_q=np.asarray(odo.q_w),
            odom_t=np.asarray(odo.t_w),
            mapped=True,
            map_q=self._last_map_pose[0],
            map_t=self._last_map_pose[1],
        )
        self.frame += 1
        self.timers.frame_done()
        return result

    # -- windowed refinement (models/refine.py) -------------------------
    def refine_recent_keyframes(
        self, n_keyframes: int = 4,
        n_landmarks: int = 512, n_iterations: int = 4,
        apply: bool = False,
    ):
        """Jointly re-refine the most recent keyframe poses against plane
        landmarks extracted from the map (the Schur-complement window —
        a capability beyond the reference's frame-at-a-time back end).

        Returns (q (K,4), t (K,3)) refined poses for the stored window,
        or None if fewer than 2 keyframes are buffered.  A keyframe is
        buffered automatically for every RETIRED mapping step, carrying
        that step's mapped pose, odometry pose and surf stack (all of the
        same frame, in async/drop regimes too).

        ``apply=True`` integrates the result: the stored keyframes and the
        mapped trajectory rows they came from are rewritten with the
        refined poses, and the odom→map correction (q_wm, t_wm — the
        transformUpdate state, laserMapping.cpp:119-123) is re-anchored on
        the newest refined pose so subsequent frames continue from it.
        """
        import jax.numpy as jnp
        from light_loam_tpu.models.refine import (
            extract_landmarks, refine_window,
        )

        if len(self._keyframes) < 2:
            return None
        self._retire_mapping(wait=True)
        kfs = self._keyframes[-n_keyframes:]
        K = len(kfs)
        qs = jnp.asarray(np.stack([k[0] for k in kfs]))
        ts = jnp.asarray(np.stack([k[1] for k in kfs]))
        stacks = jnp.asarray(np.stack([k[2] for k in kfs]))
        masks = jnp.asarray(np.stack([k[3] for k in kfs]))
        lm = extract_landmarks(
            self.map_state.surf.xyz, self.map_state.surf.mask, n_landmarks
        )
        q, t, _ = refine_window(
            qs, ts, stacks, masks, lm, n_iterations=n_iterations
        )
        q, t = np.asarray(q), np.asarray(t)

        if apply:
            base = len(self._keyframes) - K
            for i in range(K):
                kf = self._keyframes[base + i]
                self._keyframes[base + i] = (q[i], t[i], *kf[2:])
                idx = kf[4]
                if idx is not None and 0 <= idx < len(self._map_trajectory):
                    self._map_trajectory[idx] = t[i].copy()
                    self._map_quats[idx] = q[i].copy()
            self._last_map_pose = (q[-1].copy(), t[-1].copy())
            # re-anchor the odom→map correction on the refined newest pose
            # — paired with the odometry pose OF THAT SAME FRAME (stored
            # with the keyframe; _last_odo_pose can be a later frame's in
            # async/drop regimes, which would fold the intervening motion
            # into the correction)
            newest = self._keyframes[-1]
            q_odo = jnp.asarray(newest[5])
            t_odo = jnp.asarray(newest[6])
            q_wm = quat.quat_normalize(
                quat.quat_multiply(
                    jnp.asarray(q[-1]), quat.quat_inverse(q_odo)
                )
            )
            t_wm = jnp.asarray(t[-1]) - quat.quat_rotate(q_wm, t_odo)
            self.map_state = self.map_state._replace(q_wm=q_wm, t_wm=t_wm)
        return q, t

    def _keyframe_stack(self, stack_points: int = 2048):
        """(stack_xyz, stack_mask) for the surf cloud a mapping step is
        about to consume — captured at dispatch, buffered at retirement."""
        from light_loam_tpu.ops.voxel import voxel_downsample

        surf = self.odo_state.surf_last
        sx, _, sm, _ = voxel_downsample(
            surf.xyz, surf.rel, surf.mask,
            self.cfg.mapping.plane_resolution, stack_points,
        )
        return np.asarray(sx), np.asarray(sm)

    # -- checkpoint / resume (SURVEY §5: snapshot map + pose state) ------
    def save(self, path: str) -> None:
        from light_loam_tpu.utils.checkpoint import save_state

        self._retire_mapping(wait=True)
        extra = {
            # divergence-containment fallback poses must survive resume:
            # without them a non-finite pose on the first post-resume frame
            # would reset the world pose to the identity (origin)
            "last_odo_q": self._last_odo_pose[0],
            "last_odo_t": self._last_odo_pose[1],
            "last_map_q": self._last_map_pose[0],
            "last_map_t": self._last_map_pose[1],
        }
        if self._map_trajectory:
            extra["map_trajectory"] = np.stack(self._map_trajectory)
            extra["map_quats"] = np.stack(self._map_quats)
        save_state(path, self.odo_state, self.map_state, frame=self.frame,
                   extra=extra)

    def load(self, path: str) -> None:
        from light_loam_tpu.utils.checkpoint import load_state

        self.odo_state, self.map_state, self.frame, extra = load_state(
            path, self.odo_state, self.map_state
        )
        traj = extra.get("map_trajectory")
        self._map_trajectory = [] if traj is None else list(traj)
        quats = extra.get("map_quats")
        if quats is None and self._map_trajectory:
            # legacy checkpoint (trajectory saved before quats were):
            # identity rotations keep the lists in lockstep so
            # mapped_trajectory()/save() don't crash on np.stack.  The
            # package layout is xyzw (quat_identity() == [0,0,0,1]);
            # [1,0,0,0] here would be a 180-deg x-rotation silently
            # persisted as real data on the next save().
            quats = [np.asarray(quat.quat_identity(), np.float32)
                     for _ in self._map_trajectory]
        self._map_quats = [] if quats is None else list(quats)
        # restore containment fallbacks (older checkpoints without the
        # extras fall back to the restored odometry/mapping state poses)
        if "last_odo_q" in extra:
            self._last_odo_pose = (
                np.asarray(extra["last_odo_q"], np.float32),
                np.asarray(extra["last_odo_t"], np.float32),
            )
        else:
            self._last_odo_pose = (
                np.asarray(self.odo_state.q_w, np.float32),
                np.asarray(self.odo_state.t_w, np.float32),
            )
        if "last_map_q" in extra:
            self._last_map_pose = (
                np.asarray(extra["last_map_q"], np.float32),
                np.asarray(extra["last_map_t"], np.float32),
            )
        else:
            ms = self.map_state
            q = np.asarray(quat.quat_multiply(ms.q_wm, self.odo_state.q_w))
            t = np.asarray(
                quat.quat_rotate(ms.q_wm, self.odo_state.t_w)
            ) + np.asarray(ms.t_wm)
            self._last_map_pose = (q.astype(np.float32), t.astype(np.float32))

    def mapped_positions(self) -> np.ndarray:
        """(N, 3) mapped-pose positions for every mapped frame so far —
        the /aft_mapped_path analog (laserMapping.cpp:2297-2305).  Waits
        for any in-flight mapping step first."""
        self._retire_mapping(wait=True)
        if not self._map_trajectory:
            return np.zeros((0, 3), np.float32)
        return np.stack(self._map_trajectory)

    def mapped_trajectory(self):
        """Full mapped-pose history as (q (N, 4), t (N, 3)) — one row per
        *retired* mapping step, exactly the poses the reference's mapping
        thread writes to RESULT_PATH (laserMapping.cpp:2284-2326).  Under
        back-pressure drops there are fewer rows than input frames, like
        the reference.  Waits for any in-flight step first."""
        self._retire_mapping(wait=True)
        if not self._map_trajectory:
            return np.zeros((0, 4), np.float32), np.zeros((0, 3), np.float32)
        return np.stack(self._map_quats), np.stack(self._map_trajectory)

    # -- map exports (the /laser_cloud_surround, /laser_cloud_map rviz
    #    surface, laserMapping.cpp:2171-2203) ---------------------------
    def export_map(self, path_prefix: str) -> dict:
        from light_loam_tpu.models.mapping import full_map_cloud
        from light_loam_tpu.utils.export import write_ply

        self._retire_mapping(wait=True)
        (cx, cm), (sx, sm) = full_map_cloud(self.map_state)
        n_c = write_ply(f"{path_prefix}_corner.ply", np.asarray(cx), np.asarray(cm))
        n_s = write_ply(f"{path_prefix}_surf.ply", np.asarray(sx), np.asarray(sm))
        return {"corner": n_c, "surf": n_s}

    # -- current best pose (the high-frequency publish path,
    #    laserMapping.cpp:168-247, without the rslidar Euler remap) ------
    def high_freq_pose(self, odo_q: np.ndarray, odo_t: np.ndarray):
        ms = self.map_state
        q = np.asarray(
            quat.quat_multiply(ms.q_wm, jnp.asarray(odo_q))
        )
        t = np.asarray(quat.quat_rotate(ms.q_wm, jnp.asarray(odo_t))) + np.asarray(
            ms.t_wm
        )
        return q, t


def _live_viz(pipe, prefix: str, every: int, frame_idx: int, gt=None):
    """Refresh the PNG/HTML dashboard in place every ``every`` frames —
    the live-view analog of the reference's rviz session (keep the HTML
    open in a browser and reload).  Waits for in-flight mapping and
    pulls the map stores to host, so it trades throughput for
    observability; gate it with ``every``."""
    if not prefix or not every or (frame_idx + 1) % every:
        return
    from light_loam_tpu.utils import viz

    viz.render_pipeline(pipe, prefix, gt=gt)


def run_synthetic(
    n_frames: int = 20,
    profile: str = "hdl64",
    n_azimuth: int = 1800,
    speed: float = 1.0,
    seed: int = 0,
    fused: bool = False,
    viz_prefix: Optional[str] = None,
    viz_every: int = 0,
):
    """Drive the pipeline over a simulated straight run; returns
    (pipeline, results, true positions)."""
    from light_loam_tpu.utils.synthetic import World, simulate_scan, pad_cloud

    cfg = PROFILES[profile]
    if fused:
        cfg = dataclasses.replace(cfg, fused_step=True)
    pipe = Pipeline(cfg)
    world = World.urban(seed=seed)
    results = []
    truth = []
    for i in range(n_frames):
        pos = np.array([speed * i, 0.02 * i, 0.0])
        pts = simulate_scan(
            world, pos, n_rings=cfg.scan.n_scans,
            lower_deg=cfg.scan.lower_bound_deg,
            upper_deg=cfg.scan.upper_bound_deg,
            n_azimuth=n_azimuth, noise=0.01, seed=100 + i,
        )
        xyz, mask = pad_cloud(pts, cfg.scan.max_points)
        results.append(pipe.process_frame(xyz, mask))
        truth.append(pos)
        _live_viz(pipe, viz_prefix, viz_every, i, gt=np.asarray(truth))
    pipe._retire_mapping(wait=True)
    return pipe, results, np.asarray(truth)


def run_kitti(
    dataset_folder: str,
    sequence: str,
    result_path: str,
    profile: str = "hdl64",
    max_frames: Optional[int] = None,
    pose_source: str = "mapped",
    fused: bool = False,
    chunk_size: int = 0,
    viz_prefix: Optional[str] = None,
    viz_every: int = 0,
):
    """KITTI sequence → trajectory file (the reference's RESULT_PATH
    artifact, laserMapping.cpp:2284-2326).

    ``pose_source``:
      * "mapped" (default, reference-faithful): one row per *retired*
        mapping step, written from the mapping thread's own poses like
        laserMapping.cpp:2284-2326 — under back-pressure drops the file
        has fewer rows than input frames, exactly like the reference;
      * "high_freq": one row per input frame from the low-latency
        composed pose (the /aft_mapped_to_init_high_frec analog,
        laserMapping.cpp:168-247) — denser but odometry-grade on frames
        mapping dropped.

    ``chunk_size`` > 1 switches to the offline chunked runner
    (models/fused.run_chunked): K frames per device dispatch via
    lax.scan — the fastest way to replay a whole sequence.  Implies
    pose_source="mapped" semantics with every frame mapping (no drop
    policy, no skip decimation); returns the ChunkOutput instead of a
    Pipeline.
    """
    from light_loam_tpu.io.kitti import KittiPoseWriter, KittiSequence

    if pose_source not in ("mapped", "high_freq"):
        raise ValueError(f"unknown pose_source: {pose_source!r}")
    cfg = PROFILES[profile]
    if fused:
        cfg = dataclasses.replace(cfg, fused_step=True)
    seq = KittiSequence(dataset_folder, sequence)
    writer = KittiPoseWriter(result_path)
    n = len(seq) if max_frames is None else min(len(seq), max_frames)

    if chunk_size and chunk_size > 1:
        from light_loam_tpu.models.fused import run_chunked

        def frame_stream():
            count = 0
            for ts, xyz, mask in seq.padded_frames(cfg.scan.max_points):
                if count >= n:
                    break
                yield xyz, mask
                count += 1

        odo_state, map_state, outs = run_chunked(
            frame_stream(), cfg, chunk_size=chunk_size)
        for q, t in zip(outs.map_q, outs.map_t):
            R = np.asarray(quat.quat_to_matrix(jnp.asarray(q)))
            writer.write(R, t)
        return outs

    pipe = Pipeline(cfg)
    count = 0
    for ts, xyz, mask in seq.padded_frames(cfg.scan.max_points):
        if count >= n:
            break
        res = pipe.process_frame(xyz, mask)
        if pose_source == "high_freq":
            q, t = pipe.high_freq_pose(res.odom_q, res.odom_t)
            R = np.asarray(quat.quat_to_matrix(jnp.asarray(q)))
            writer.write(R, t)
        _live_viz(pipe, viz_prefix, viz_every, count)
        count += 1
    pipe._retire_mapping(wait=True)
    if pose_source == "mapped":
        qs, ts_ = pipe.mapped_trajectory()
        for q, t in zip(qs, ts_):
            R = np.asarray(quat.quat_to_matrix(jnp.asarray(q)))
            writer.write(R, t)
    return pipe


def main(argv=None):
    from light_loam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(description="light_loam_tpu SLAM pipeline")
    ap.add_argument("--dataset", help="KITTI dataset folder (kittiHelper layout)")
    ap.add_argument("--sequence", default="04")
    ap.add_argument("--result", default="trajectory.txt")
    ap.add_argument("--profile", default="hdl64", choices=sorted(PROFILES))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="run on the synthetic world instead of KITTI data")
    ap.add_argument("--viz", metavar="PREFIX", default=None,
                    help="write PNG quick-looks (PREFIX_traj.png, "
                         "PREFIX_map.png) after the run — the headless "
                         "stand-in for the reference's rviz launch")
    ap.add_argument("--viz-every", type=int, default=0, metavar="N",
                    help="with --viz: ALSO refresh the dashboard in "
                         "place every N frames (live view — keep "
                         "PREFIX_view.html open and reload; waits for "
                         "in-flight mapping each refresh)")
    ap.add_argument("--fused", action="store_true",
                    help="latency mode: run each frame as ONE fused "
                         "device program (models/fused.py) instead of "
                         "three staged dispatches")
    ap.add_argument("--chunk", type=int, default=0, metavar="K",
                    help="offline mode: replay K frames per device "
                         "dispatch (lax.scan in one program, "
                         "models/fused.run_chunked) — fastest whole-"
                         "sequence replay; every frame maps")
    args = ap.parse_args(argv)

    t0 = time.time()
    gt = None
    if args.synthetic or not args.dataset:
        if args.chunk > 1:
            from light_loam_tpu.models.fused import run_chunked
            from light_loam_tpu.utils.synthetic import (
                World, pad_cloud, simulate_scan,
            )

            cfg = PROFILES[args.profile]
            world = World.urban(seed=0)
            n = args.frames or 20
            truth = np.asarray([[1.0 * i, 0.02 * i, 0.0] for i in range(n)])

            def stream():
                for i in range(n):
                    pts = simulate_scan(
                        world, truth[i], n_rings=cfg.scan.n_scans,
                        lower_deg=cfg.scan.lower_bound_deg,
                        upper_deg=cfg.scan.upper_bound_deg,
                        n_azimuth=1800, noise=0.01, seed=100 + i,
                    )
                    yield pad_cloud(pts, cfg.scan.max_points)

            _, _, outs = run_chunked(stream(), cfg, chunk_size=args.chunk)
            err = np.linalg.norm(np.asarray(outs.map_t)[-1] - truth[-1])
            print(f"frames: {n} (chunk={args.chunk})  "
                  f"final mapped pose error: {err:.3f} m")
            print(f"wall: {time.time()-t0:.2f}s")
            return
        pipe, results, truth = run_synthetic(
            n_frames=args.frames or 20, profile=args.profile,
            fused=args.fused,
            viz_prefix=args.viz, viz_every=args.viz_every,
        )
        gt = truth
        err = np.linalg.norm(pipe.mapped_positions()[-1] - truth[-1])
        err_odo = np.linalg.norm(results[-1].odom_t - truth[-1])
        print(f"frames: {len(results)}  final mapped pose error: "
              f"{err:.3f} m (odometry alone: {err_odo:.3f} m)")
    else:
        out = run_kitti(args.dataset, args.sequence, args.result,
                        args.profile, args.frames, fused=args.fused,
                        chunk_size=args.chunk,
                        viz_prefix=args.viz, viz_every=args.viz_every)
        print(f"trajectory written to {args.result}")
        if args.chunk > 1:
            print(f"wall: {time.time()-t0:.2f}s  (chunked replay, "
                  f"{args.chunk} frames/dispatch)")
            return
        pipe = out
    dt = time.time() - t0
    print(f"wall: {dt:.2f}s  dropped mapping frames: {pipe.dropped_mapping_frames}")
    print(pipe.timers.report())
    if args.viz:
        from light_loam_tpu.utils import viz

        out = viz.render_pipeline(pipe, args.viz, gt=gt)
        print("viz:", " ".join(sorted(out.values())))


if __name__ == "__main__":
    main()
